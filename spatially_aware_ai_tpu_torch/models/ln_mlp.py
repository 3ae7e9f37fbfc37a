"""Kernel B2: fused LayerNorm -> Dense(H) -> activation -> Dense(D) ->
residual, the transformer / ConvNeXt "MLP sub-block":

    out = residual + gamma * (act(LN(x) @ w1 + b1) @ w2 + b2)

Counterpart of spatially_aware_ai_tpu/models/pallas_mlp.py (`fused_ln_mlp`).
LN and accumulation are f32; matmul operands are rounded to the activation
dtype (f32 or bf16). act is "quick_gelu" (CLIP: x * sigmoid(1.702 x)) or
"gelu" (exact erf). The CUDA kernels are csrc/ln_mlp.cu. On CUDA tensors
`fused_ln_mlp` launches them (or raises); on CPU tensors it runs the plain
PyTorch version below.

On the card a call first makes the weight planes, K-major, read from the
callers' nn.Linear layout `w1.t()` [H, D] / `w2.t()` [D, H] in place of a
copy: for f32 the split pass, once per weight (big / small TF32 planes, K
permuted as the route's fragments need); for bf16 the cast pass, one launch
for both (K as it is). Then one of two routes (`route`): the fused kernel
for D <= 256, or the two phases (h = act(LN(x) w1 + b1) to device memory,
then the residual block) for D > 256; in bf16 a pre-pass writes LN(x) for
phase 1 and each phase's tile follows M (tile_for in csrc/ln_mlp.cu).
`launches` counts one per `fused_ln_mlp` call that launched them, whatever
the route.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

# launches of the CUDA kernel, for runs that check the path went through it
launches = 0

_SIGNATURES = {
    "sai_ln_mlp": (ctypes.c_int, [
        ctypes.c_int, ctypes.c_int, *[ctypes.c_void_p] * 12, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]),
    "sai_ln_mlp_split": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p]),
    "sai_ln_mlp_cast": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p]),
    "sai_ln_mlp_tile": (ctypes.c_int, [ctypes.c_int] * 3),
}

_ACTS = {"quick_gelu": 0, "gelu": 1}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def activation(h, act: str):
    """quick_gelu, or the exact (erf) gelu through F.gelu. Not torch.erf:
    on the CPU its first threaded call in a process sometimes computes the
    calling thread's share with an erf about 2e-4 off (ROADMAP C9; F.gelu
    has its own erf)."""
    if act == "quick_gelu":
        return h * torch.sigmoid(1.702 * h)
    if act == "gelu":
        return torch.nn.functional.gelu(h)
    raise ValueError(f"unknown activation: {act}")


def ln_mlp_plain(x, residual, ln_scale, ln_bias, w1, b1, w2, b2, gamma=None,
                 *, act: str = "gelu", eps: float = 1e-6):
    """The plain PyTorch version: the kernel's arithmetic with unfused
    ops."""
    dt = x.dtype
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    lnx = (xf - mu) * torch.rsqrt(var + eps) * ln_scale.float() \
        + ln_bias.float()
    lnx = lnx.to(dt).float()
    h = lnx @ w1.to(dt).float() + b1.float()
    g = activation(h, act).to(dt).float()
    out = g @ w2.to(dt).float() + b2.float()
    if gamma is not None:
        out = out * gamma.float()
    return (residual.float() + out).to(dt)


def route(D: int, H: int) -> int:
    """The kernels' route for widths D, H: 1 fused (D <= 256), 2 two
    phases (D > 256), 0 not supported (D a multiple of 64 up to 1536, H a
    multiple of 64). Mirrors sai_ln_mlp_route in csrc/ln_mlp.cu."""
    if D <= 0 or D % 64 or D > 1536 or H <= 0 or H % 64:
        return 0
    return 1 if D <= 256 else 2


# the f32 split pass's K order for (w1, w2) by route (src_k in
# csrc/ln_mlp.cu): 0 as it is, 1 the fused GEMM2's accumulator order, 2 the
# two-phase order. bf16 planes keep the callers' order on both routes.
PLANE_MODES = {1: (0, 1), 2: (2, 2)}


def plane_order(K: int, mode: int):
    """Source K index of each stored position of an f32 plane row (numpy
    int64 [K]): mirrors src_k in csrc/ln_mlp.cu. Mode 1: within groups of
    8, position s holds 2s (s < 4) or 2(s - 4) + 1, the column order of a
    wgmma accumulator row pair; mode 2: within slabs of 32, position 8kk + s
    holds 8(s % 4) + 2kk + s // 4, so that thread t's fragment columns are
    contiguous."""
    p = np.arange(K)
    if mode == 1:
        s = p % 8
        return p - s + np.where(s < 4, 2 * s, 2 * (s - 4) + 1)
    if mode == 2:
        q = p % 32
        kk, s = q // 8, q % 8
        return p - q + 8 * (s % 4) + 2 * kk + s // 4
    return p


def swizzle_offset(row, col, rows: int):
    """Byte offset of bf16 element (row, col) in a K-major tile of 64-column
    blocks, each [rows][128 B] with the 128-byte swizzle (16-byte chunk j of
    row r stored at chunk j ^ (r % 8)): where route 1's consumers write
    LN(x) for wgmma to read, as TMA writes its boxes. Mirrors sw128_offset
    in csrc/ln_mlp.cu; numpy arrays or ints."""
    block, c = col // 64, col % 64
    return (block * rows * 128 + row * 128 + ((c // 8) ^ (row % 8)) * 16
            + (c % 8) * 2)


def weight_planes(w, mode: int = 0):
    """The f32 split pass on the card: w [N, K] (any strides, f32 or bf16)
    -> big / small TF32 planes [2, N, K] f32 (big + small == w, big with
    its low 13 mantissa bits zero), K permuted within each group as `mode`
    says."""
    from ..native_cuda import check, load

    if w.device.type != "cuda" or w.dim() != 2:
        raise ValueError("weight_planes takes a 2-D CUDA tensor")
    if w.dtype not in _DTYPES:
        w = w.float()
    N, K = w.shape
    planes = torch.empty((2, N, K), dtype=torch.float32, device=w.device)
    fn = load("ln_mlp", _SIGNATURES).sai_ln_mlp_split
    err = fn(w.data_ptr(), _DTYPES[w.dtype], w.stride(0), w.stride(1), N, K,
             mode, planes.data_ptr(), torch.cuda.current_stream().cuda_stream)
    check(err, "ln_mlp split")
    return planes


def bf16_planes(w1t, w2t):
    """The bf16 cast pass on the card, one launch for both weights: w1t
    [H, D] and w2t [D, H] (any strides, f32 or bf16; the callers'
    `fc.weight` layout) -> contiguous bf16 copies, K as it is."""
    from ..native_cuda import check, load

    H, D = w1t.shape
    if tuple(w2t.shape) != (D, H):
        raise ValueError(f"w2t must be [{D}, {H}], got {tuple(w2t.shape)}")
    if w1t.device.type != "cuda" or w2t.device.type != "cuda":
        raise ValueError("bf16_planes takes CUDA tensors")
    w1t, w2t = (w if w.dtype in _DTYPES else w.float() for w in (w1t, w2t))
    p1 = torch.empty((H, D), dtype=torch.bfloat16, device=w1t.device)
    p2 = torch.empty((D, H), dtype=torch.bfloat16, device=w1t.device)
    fn = load("ln_mlp", _SIGNATURES).sai_ln_mlp_cast
    err = fn(w1t.data_ptr(), _DTYPES[w1t.dtype], w1t.stride(0), w1t.stride(1),
             w2t.data_ptr(), _DTYPES[w2t.dtype], w2t.stride(0), w2t.stride(1),
             D, H, p1.data_ptr(), p2.data_ptr(),
             torch.cuda.current_stream().cuda_stream)
    check(err, "ln_mlp cast")
    return p1, p2


def fused_ln_mlp(x, residual, ln_scale, ln_bias, w1, b1, w2, b2, gamma=None,
                 *, act: str = "gelu", eps: float = 1e-6):
    """x, residual [M, D] (f32 or bf16); ln_scale, ln_bias, b2, gamma [D];
    w1 [D, H]; b1 [H]; w2 [H, D] (the callers pass nn.Linear weights
    transposed, `fc.weight.t()`, which the kernels read as they are).
    Returns [M, D] in x.dtype."""
    if act not in _ACTS:
        raise ValueError(f"unknown activation: {act}")
    if x.dim() != 2 or residual.shape != x.shape:
        raise ValueError(f"x and residual must be [M, D], got "
                         f"{tuple(x.shape)}, {tuple(residual.shape)}")
    M, D = x.shape
    H = w1.shape[1]
    if tuple(w1.shape) != (D, H) or tuple(w2.shape) != (H, D):
        raise ValueError(f"w1 must be [D, H] and w2 [H, D], got "
                         f"{tuple(w1.shape)}, {tuple(w2.shape)}")
    vecs = {"ln_scale": (ln_scale, D), "ln_bias": (ln_bias, D), "b1": (b1, H),
            "b2": (b2, D)}
    if gamma is not None:
        vecs["gamma"] = (gamma, D)
    for name, (v, n) in vecs.items():
        if tuple(v.shape) != (n,):
            raise ValueError(f"{name} must be [{n}], got {tuple(v.shape)}")
    tensors = [x, residual, w1, w2] + [v for v, _ in vecs.values()]
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"fused_ln_mlp tensors on several devices: "
                         f"{devices}")
    dev = devices.pop()
    if dev.type == "cpu":
        return ln_mlp_plain(x, residual, ln_scale, ln_bias, w1, b1, w2, b2,
                            gamma, act=act, eps=eps)
    if dev.type != "cuda":
        raise ValueError(f"fused_ln_mlp runs on cpu or cuda, not {dev}")
    if x.dtype not in _DTYPES or residual.dtype != x.dtype:
        raise TypeError(f"fused_ln_mlp takes f32 or bf16 x and residual of "
                        f"one dtype, got {x.dtype}, {residual.dtype}")
    r = route(D, H)
    if r == 0:
        raise ValueError(f"fused_ln_mlp kernel needs D a multiple of 64 up to "
                         f"1536 and H a multiple of 64, got D={D}, H={H}")
    if not (x.is_contiguous() and residual.is_contiguous()):
        raise ValueError("x and residual must be contiguous")
    if x.data_ptr() % 16 or residual.data_ptr() % 16:
        raise ValueError("x and residual must be 16-byte aligned")
    # the weights as the kernels read them, K-major: w1.t() [H, D] and
    # w2.t() [D, H] (views; the split and cast passes read any strides)
    if x.dtype == torch.bfloat16:
        p1, p2 = bf16_planes(w1.t(), w2.t())
    else:
        m1, m2 = PLANE_MODES[r]
        p1, p2 = weight_planes(w1.t(), m1), weight_planes(w2.t(), m2)
    vec = {k: v.to(torch.float32).contiguous() for k, (v, _) in vecs.items()}
    out = torch.empty_like(x)
    # route 2's scratch: the hidden activation, and each row's LN mean and
    # 1/std (f32) or LN(x) itself (bf16)
    scratch = (None, None)
    if r == 2:
        lnx = (torch.empty((M, 2), dtype=torch.float32, device=dev)
               if x.dtype == torch.float32 else torch.empty_like(x))
        scratch = (torch.empty((M, H), dtype=x.dtype, device=dev), lnx)
    return _launch(x, residual, vec, p1, p2, out, scratch, act, eps)


def _launch(x, residual, vec, p1, p2, out, scratch, act, eps):
    from ..native_cuda import check, count_launch, load

    fn = load("ln_mlp", _SIGNATURES).sai_ln_mlp
    M, D = x.shape
    gamma = vec.get("gamma")
    err = fn(_DTYPES[x.dtype], _ACTS[act], x.data_ptr(), residual.data_ptr(),
             vec["ln_scale"].data_ptr(), vec["ln_bias"].data_ptr(),
             p1.data_ptr(), vec["b1"].data_ptr(), p2.data_ptr(),
             vec["b2"].data_ptr(),
             gamma.data_ptr() if gamma is not None else None,
             out.data_ptr(),
             *(t.data_ptr() if t is not None else None for t in scratch), M, D, vec["b1"].shape[0], float(eps),
             torch.cuda.current_stream().cuda_stream)
    count_launch(__name__)
    check(err, "ln_mlp")
    return out
