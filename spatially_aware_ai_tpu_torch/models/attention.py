"""Kernel B5: multi-head attention for the CLIP towers.

Counterpart of the Pallas probe kernel in benchmarks/probe_mosaic_attn.py
(`attn_kernel`) and of the plain XLA attention of the JAX CLIP
(spatially_aware_ai_tpu/models/clip/model.py, Attention):

    o[b, t, h*hd:(h+1)*hd] = softmax(q[b,h] k[b,h]^T / sqrt(hd) + mask) v[b,h]

with q, k, v [B, H, T, hd] and the causal mask (j > i) when asked. The
scores and the softmax are f32; in bf16 the scores and the probabilities
are rounded to bf16 where the JAX CLIP's einsums store them (its
`att.astype(x.dtype)`), and the output is stored in the input dtype.

The CUDA kernel is csrc/attention.cu (hd = 64, T <= 128, f32 or bf16):
both products on the tensor cores (mma.sync; f32 as 3xTF32), the score
rows in registers, Q K^T's accumulator fed to P V as its A operand with V
staged in `v_stage_order` (f32). On CUDA tensors `attention` launches it
or raises; on CPU tensors it runs the plain PyTorch version below. q, k
and v may be any strided views whose last axis is contiguous, such as the
head views of a fused qkv projection, so no copy is made. `launches`
counts kernel launches (CUDA tensors only).
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

# launches of the CUDA kernel, for runs that check the path went through it
launches = 0

_SIGNATURES = {"sai_attention": (ctypes.c_int, [
    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIM = 64
MAX_TOKENS = 128


def attention_plain(q, k, v, causal: bool = False):
    """The plain PyTorch version: [B, H, T, hd] -> [B, T, H * hd]."""
    B, H, T, hd = q.shape
    att = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
    if causal:
        mask = torch.full((T, T), float("-inf"), device=q.device)
        att = att + torch.triu(mask, diagonal=1).to(att.dtype)
    att = torch.softmax(att.float(), dim=-1).to(q.dtype)
    return (att @ v).transpose(1, 2).reshape(B, T, H * hd)


def v_stage_order(n: int, bf16: bool):
    """Source key of each stored V row of the kernel's shared memory (numpy
    int64 [n], n a multiple of 8). f32: within each group of 8 keys, stored
    row s holds key 2s (s < 4) or 2(s - 4) + 1, so that the m16n8k8 A
    fragment's columns t and t + 4 are the keys 2t and 2t + 1 that Q K^T's
    accumulator holds; bf16: as they are (the m16n8k16 A fragment takes the
    accumulator pairs in key order). Mirrors load_item in
    csrc/attention.cu."""
    p = np.arange(n)
    if bf16:
        return p
    s = p % 8
    return p - s + np.where(s < 4, 2 * s, 2 * (s - 4) + 1)


def bf16_ulps(got, want):
    """|got - want| in bf16 ulps of the largest |want| of each output row
    (the last axis), the measure B5's bf16 limit is stated in: near-zero
    outputs of a softmax-weighted sum carry the rounding of the row's large
    terms, so an element's own ulp is no measure."""
    want = want.double()
    top = want.abs().amax(dim=-1, keepdim=True)
    ulp = torch.exp2(torch.floor(torch.log2(top.clamp_min(1e-30))) - 7)
    return (got.double() - want).abs() / ulp


def _check(q, k, v):
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must be [B, H, T, hd] of one shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v of several dtypes: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    devices = {q.device, k.device, v.device}
    if len(devices) != 1:
        raise ValueError(f"attention tensors on several devices: {devices}")
    return devices.pop()


def attention(q, k, v, causal: bool = False):
    """softmax(q k^T / sqrt(hd)) v per (batch, head), causal if asked.
    q, k, v [B, H, T, hd] with a contiguous last axis -> [B, T, H * hd] in
    q's dtype."""
    dev = _check(q, k, v)
    if dev.type == "cpu":
        return attention_plain(q, k, v, causal)
    if dev.type != "cuda":
        raise ValueError(f"attention runs on cpu or cuda, not {dev}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"attention kernel takes f32 or bf16, got {q.dtype}")
    B, H, T, hd = q.shape
    if hd != HEAD_DIM or not 1 <= T <= MAX_TOKENS:
        raise ValueError(f"attention kernel takes hd = {HEAD_DIM} and "
                         f"1 <= T <= {MAX_TOKENS}, got hd={hd}, T={T}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("q, k, v need a contiguous last axis")
    out = torch.empty((B, T, H * hd), dtype=q.dtype, device=dev)
    if B == 0 or H == 0:
        return out
    return _launch(q, k, v, out, causal)


def _launch(q, k, v, out, causal):
    global launches
    from ..native_cuda import check, load

    B, H, T, hd = q.shape
    # (batch, head, token) strides of q, k and v, in elements
    strides = (ctypes.c_longlong * 9)(*(s for t in (q, k, v)
                                        for s in t.stride()[:3]))
    fn = load("attention", _SIGNATURES).sai_attention
    err = fn(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
             out.data_ptr(), B, H, T, hd, ctypes.addressof(strides),
             int(causal), 1.0 / math.sqrt(hd),
             torch.cuda.current_stream().cuda_stream)
    launches += 1
    check(err, "attention")
    return out
