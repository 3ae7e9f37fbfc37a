"""Kernels B1 (feature splat), B2 (fused LN->MLP) and B5 (attention) of
the PyTorch port: their plain PyTorch versions (what the wrappers run on
CPU tensors) held against the JAX package's Pallas kernels in interpret
mode and its XLA formulations, on the same numpy inputs. The CUDA kernels
themselves run only on the card (tests/test_torch_cuda.py, and
chip_smoke.py's kernels phase)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from spatially_aware_ai_tpu.grid.fusion import einsum_feature_splat
from spatially_aware_ai_tpu.grid.pallas_fusion import fused_feature_splat
from spatially_aware_ai_tpu.models.pallas_mlp import (
    fused_ln_mlp as jax_fused_ln_mlp,
)
from spatially_aware_ai_tpu_torch.grid import splat as S
from spatially_aware_ai_tpu_torch.models import attention as A
from spatially_aware_ai_tpu_torch.models import ln_mlp as L

RNG = np.random.default_rng(7)


def _splat_inputs(N, C, F, Py, Px, rng):
    feat_sum = rng.normal(size=(N, C)).astype(np.float32)
    feat_imgs = rng.normal(size=(F, Py, Px, C)).astype(np.float32)
    # interior, boundary and out-of-grid coordinates; half the frames
    # invalid
    uvw = np.stack(
        [rng.uniform(-1.5, Px + 0.5, size=(N, F)),
         rng.uniform(-1.5, Py + 0.5, size=(N, F)),
         rng.integers(0, 2, size=(N, F)).astype(np.float64)],
        axis=-1,
    ).astype(np.float32)
    return feat_sum, feat_imgs, uvw


def test_splat_matches_pallas_and_einsum():
    """Dense splat (tol 1e-4, as tests/test_pallas_fusion.py) against both
    JAX formulations of the same function."""
    N, C, F, Py, Px = 256, 8, 3, 4, 5
    feat_sum, feat_imgs, uvw = _splat_inputs(N, C, F, Py, Px, RNG)
    got = S.splat(torch.from_numpy(feat_sum.copy()), torch.from_numpy(uvw),
                  torch.from_numpy(feat_imgs)).numpy()
    pallas = np.asarray(fused_feature_splat(
        jnp.asarray(feat_sum), jnp.asarray(uvw), jnp.asarray(feat_imgs),
        tile=128, interpret=True))
    einsum = np.asarray(einsum_feature_splat(
        jnp.asarray(feat_sum), jnp.asarray(uvw), jnp.asarray(feat_imgs)))
    np.testing.assert_allclose(got, pallas, atol=1e-4)
    np.testing.assert_allclose(got, einsum, atol=1e-4)


def test_splat_scatter_drops_dead_slots():
    """ROADMAP trap C2: the sparse branch pads its active set with the
    dead index N (JAX scatters with mode="drop"; torch's index_add_ would
    raise). Rows outside the active set stay untouched."""
    N, K, C, F, Py, Px = 50, 24, 8, 3, 4, 5
    feat_sum, feat_imgs, uvw = _splat_inputs(K, C, F, Py, Px, RNG)
    feat_sum = RNG.normal(size=(N, C)).astype(np.float32)
    live = np.sort(RNG.choice(N, size=15, replace=False))
    active = np.full(K, N, np.int64)
    active[:15] = live
    got = S.splat_scatter(torch.from_numpy(feat_sum.copy()),
                          torch.from_numpy(active), torch.from_numpy(uvw),
                          torch.from_numpy(feat_imgs)).numpy()
    contrib = einsum_feature_splat(jnp.zeros((K, C)), jnp.asarray(uvw),
                                   jnp.asarray(feat_imgs))
    want = np.asarray(jnp.asarray(feat_sum).at[jnp.asarray(active)].add(
        contrib, mode="drop"))
    np.testing.assert_allclose(got, want, atol=1e-4)
    untouched = np.setdiff1d(np.arange(N), live)
    np.testing.assert_array_equal(got[untouched], feat_sum[untouched])


def test_splat_wrapper_checks():
    f = torch.zeros(4, 8)
    u = torch.zeros(4, 2, 3)
    im = torch.zeros(2, 3, 3, 8)
    with pytest.raises(TypeError):
        S.splat(f.double(), u, im)
    with pytest.raises(ValueError):
        S.splat(f, torch.zeros(4, 2, 2), im)
    with pytest.raises(ValueError):
        S.splat(f, u, torch.zeros(2, 3, 3, 4))
    with pytest.raises(ValueError):
        S.splat_scatter(f, torch.zeros(3, dtype=torch.int64), u, im)
    with pytest.raises(ValueError):
        S.splat(f, u.transpose(0, 1), im)


def _mlp_inputs(M, D, H, with_gamma, rng):
    def n(*shape, scale=1.0, loc=0.0):
        return (loc + scale * rng.normal(size=shape)).astype(np.float32)

    return dict(
        x=n(M, D), res=n(M, D), lns=n(D, scale=0.1, loc=1.0),
        lnb=n(D, scale=0.1), w1=n(D, H, scale=D ** -0.5),
        b1=n(H, scale=0.1), w2=n(H, D, scale=H ** -0.5), b2=n(D, scale=0.1),
        gamma=n(D, scale=0.1, loc=0.5) if with_gamma else None,
    )


@pytest.mark.parametrize("act,eps,with_gamma", [
    ("gelu", 1e-6, True),          # ConvNeXt block
    ("quick_gelu", 1e-5, False),   # CLIP MLP
])
def test_ln_mlp_matches_pallas(act, eps, with_gamma):
    """f32, M not a tile multiple; atol 1e-4 (tighter than the 2e-3 of
    tests/test_pallas_mlp.py: both sides are f32, the Pallas erf is a
    polynomial within 1.5e-7)."""
    M, D, H = 100, 256, 1024
    p = _mlp_inputs(M, D, H, with_gamma, RNG)
    order = ["x", "res", "lns", "lnb", "w1", "b1", "w2", "b2", "gamma"]
    t = [None if p[k] is None else torch.from_numpy(p[k]) for k in order]
    got = L.fused_ln_mlp(*t, act=act, eps=eps).numpy()
    j = [None if p[k] is None else jnp.asarray(p[k]) for k in order]
    want = np.asarray(jax_fused_ln_mlp(*j, act=act, eps=eps, tm=64, th=256,
                                       interpret=True))
    assert got.shape == (M, D)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_ln_mlp_bf16_matches_pallas():
    """bf16 activations: both round LN(x) and the hidden activation to
    bf16 and accumulate in f32; a sum-order difference can move a bf16
    rounding by one ulp, hence atol 3e-2."""
    M, D, H = 40, 128, 512
    p = _mlp_inputs(M, D, H, True, RNG)
    order = ["x", "res", "lns", "lnb", "w1", "b1", "w2", "b2", "gamma"]
    t = [torch.from_numpy(p[k]) for k in order]
    t[0], t[1] = t[0].bfloat16(), t[1].bfloat16()
    got = L.fused_ln_mlp(*t, act="gelu", eps=1e-6).float().numpy()
    j = [jnp.asarray(p[k]) for k in order]
    j[0], j[1] = j[0].astype(jnp.bfloat16), j[1].astype(jnp.bfloat16)
    want = np.asarray(jax_fused_ln_mlp(*j, act="gelu", eps=1e-6, tm=32,
                                       th=128, interpret=True)
                      .astype(jnp.float32))
    np.testing.assert_allclose(got, want, atol=3e-2, rtol=2e-2)


def test_ln_mlp_wrapper_checks():
    p = _mlp_inputs(8, 64, 256, False, RNG)
    t = {k: torch.from_numpy(v) for k, v in p.items() if v is not None}
    with pytest.raises(ValueError):
        L.fused_ln_mlp(t["x"], t["res"], t["lns"], t["lnb"], t["w1"].T,
                       t["b1"], t["w2"], t["b2"], act="gelu")
    with pytest.raises(ValueError):
        L.fused_ln_mlp(t["x"], t["res"], t["lns"], t["lnb"], t["w1"],
                       t["b1"], t["w2"], t["b2"], act="relu")
    assert [L.route(d, 4 * d) for d in (64, 256, 320, 768, 1536, 100,
                                         2048)] == [1, 1, 2, 2, 2, 0, 0]
    assert (L.route(256, 1000), L.route(256, 64)) == (0, 1)
    assert L.PLANE_MODES == {1: (0, 1), 2: (2, 2)}


def test_ln_mlp_weight_passes_check_their_inputs():
    """The weight passes run on the card only (the CPU path makes no
    planes), and the bf16 cast pass takes w2t as [D, H] beside w1t [H, D],
    the callers' `fc.weight` layout of both, before it looks at the
    device."""
    w1t = torch.zeros(256, 64)
    with pytest.raises(ValueError, match=r"must be \[64, 256\]"):
        L.bf16_planes(w1t, torch.zeros(256, 64))
    with pytest.raises(ValueError, match="CUDA"):
        L.bf16_planes(w1t, torch.zeros(64, 256))
    with pytest.raises(ValueError, match="CUDA"):
        L.weight_planes(w1t, 0)


def test_ln_mlp_takes_the_callers_weight_layout():
    """nn.Linear weights passed transposed (`fc.weight.t()`, as the ConvNeXt
    block and the CLIP MLP pass them) give the same result as contiguous
    [D, H] / [H, D] weights, with no copy made by the caller."""
    p = _mlp_inputs(33, 128, 512, True, RNG)
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    fc1 = torch.nn.Linear(128, 512)
    fc2 = torch.nn.Linear(512, 128)
    with torch.no_grad():
        fc1.weight.copy_(t["w1"].T)
        fc2.weight.copy_(t["w2"].T)
    args = (t["x"], t["res"], t["lns"], t["lnb"])
    via_view = L.fused_ln_mlp(*args, fc1.weight.t(), t["b1"], fc2.weight.t(),
                              t["b2"], t["gamma"], act="gelu", eps=1e-6)
    contiguous = L.fused_ln_mlp(*args, t["w1"], t["b1"], t["w2"], t["b2"],
                                t["gamma"], act="gelu", eps=1e-6)
    assert torch.equal(via_view, contiguous)


def test_cpu_gelu_does_not_go_through_torch_erf():
    """ROADMAP C9: on the CPU, torch.erf's first threaded call in a process
    sometimes computed the calling thread's share of the tensor with an erf
    about 2e-4 off (fresh-process sweeps of the ConvNeXt block: the drift of
    test_convnext_block_matches_jax_fused, rows 0-98 of 198, the main
    thread's half). The port's exact gelu therefore goes through F.gelu,
    whose erf is its own. The old formulation, 0.5 h (1 + erf(h / sqrt 2)),
    dispatches aten::erf and fails here; the values stay those of the exact
    gelu (float64, 2e-6 at |h| < 12)."""
    from scipy.special import erf
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.seen.add(func.overloadpacket.__name__)
            return func(*args, **(kwargs or {}))

    h = torch.from_numpy((RNG.normal(size=(198, 256)) * 3).astype(np.float32))
    with Ops() as ops:
        g = L.activation(h, "gelu")
    assert "erf" not in ops.seen and "gelu" in ops.seen
    hd = h.double().numpy()
    np.testing.assert_allclose(g.numpy(), 0.5 * hd * (1 + erf(hd / np.sqrt(2))),
                               atol=2e-6, rtol=0)


# The A-register slots the kernels fill for thread column group t (t = lane
# % 4) at k-step kk of a slab, as a source column of the slab (route 2,
# f32) or of the 64-wide hidden chunk (route 1, from the GEMM1 accumulator,
# whose n8 tile j holds columns 8j + 2t and 8j + 2t + 1 of rows g and g +
# 8). tf32 k8 steps have slots t (a0, a1) and t + 4 (a2, a3); bf16 k16
# steps slots 2t, 2t + 1 (a0, a1) and 2t + 8, 2t + 9 (a2, a3). bf16 route 2
# reads A from shared memory (test_swizzle_offset_matches_the_wgmma_walk).
_SLOT_RULES = {
    # route 2, f32: thread t holds columns 8t .. 8t + 7 of the slab
    ("phase", False): (32, 8, lambda kk, t: {t: 8 * t + 2 * kk,
                                             t + 4: 8 * t + 2 * kk + 1}),
    # route 1 GEMM2, f32: k-step j of the chunk takes accumulator tile j
    ("fused", False): (64, 8, lambda kk, t: {t: 8 * kk + 2 * t,
                                             t + 4: 8 * kk + 2 * t + 1}),
    # route 1 GEMM2, bf16: k16 step kk takes tiles 2kk and 2kk + 1
    ("fused", True): (64, 16, lambda kk, t: {
        2 * t: 16 * kk + 2 * t, 2 * t + 1: 16 * kk + 2 * t + 1,
        2 * t + 8: 16 * kk + 8 + 2 * t, 2 * t + 9: 16 * kk + 9 + 2 * t}),
}


@pytest.mark.parametrize("route,bf16", list(_SLOT_RULES))
def test_plane_order_matches_the_kernels_fragments(route, bf16):
    """A numpy walk of the kernels' k-steps: the A slots each thread fills
    (as the kernels fill them) times the weight planes in their stored
    order (f32: `plane_order`'s, the split pass's mirrored; bf16: the
    callers' order, the cast pass's) must give A @ W. This pins the K
    permutation that lets f32 route 2 read contiguous A columns and route 1
    feed GEMM1's accumulator straight into GEMM2."""
    slab, step, rule = _SLOT_RULES[(route, bf16)]
    mode = {"phase": 2, "fused": 1}[route]
    rng = np.random.default_rng(9)
    K, N = 128, 16
    a = rng.normal(size=(3, K))
    w = rng.normal(size=(K, N))
    stored = w if bf16 else w[L.plane_order(K, mode)]  # plane row p
    got = np.zeros((3, N))
    for s0 in range(0, K, slab):
        for kk in range(slab // step):
            frag = np.zeros((3, step))
            filled = set()
            for t in range(4):
                for slot, col in rule(kk, t).items():
                    frag[:, slot] = a[:, s0 + col]
                    filled.add(slot)
            assert filled == set(range(step))
            got += frag @ stored[s0 + kk * step:s0 + (kk + 1) * step]
    np.testing.assert_allclose(got, a @ w, rtol=1e-12, atol=1e-12)


def test_swizzle_offset_matches_the_wgmma_walk():
    """bf16 A from shared memory: route 1's consumers write LN(x) at
    `swizzle_offset` (sw128_offset in the kernel), and wgmma reads a 64-row
    K-major operand by descriptor, k-step kk of a 64-column block at start
    address block + 32 kk, 8-row groups 1024 bytes apart (SBO), with the
    128-byte swizzle applied to the address (bits 4-6 XOR bits 7-9). A numpy
    walk of those reads over a [128, 192] tile must find every element
    where it was written, and the writes must fill the tile once."""
    rows, cols = 128, 192
    r, c = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    written = L.swizzle_offset(r, c, rows)
    assert np.array_equal(np.sort(written.ravel()),
                          np.arange(0, rows * cols * 2, 2))
    for wg in range(2):                      # the warpgroups' 64-row halves
        for block in range(cols // 64):
            for kk in range(4):
                start = block * rows * 128 + wg * 64 * 128 + kk * 32
                for row in range(64):
                    for j in range(16):      # the k16 step's columns
                        logical = (start + (row // 8) * 1024
                                   + (row % 8) * 128 + 2 * j)
                        physical = logical ^ (((logical >> 7) & 7) << 4)
                        assert physical == written[wg * 64 + row,
                                                   64 * block + 16 * kk + j]


def test_attention_plain_matches_the_probes_xla_formula():
    """B5's plain version against benchmarks/probe_mosaic_attn.py's XLA
    baseline (`xla_attn`, written out here: it is local to the probe's
    main) on bf16 inputs at the probe's per-crop shape [B, 12, 50, 64]:
    within 2 bf16 ulps of each row's largest output (both round the scores
    and the probabilities to bf16 and sum in f32; they read 0.5)."""
    B, H, T, HD = 6, 12, 50, 64
    rng = np.random.default_rng(11)
    q, k, v = (rng.normal(size=(B, H, T, HD)).astype(np.float32)
               for _ in range(3))
    qj, kj, vj = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    s = jnp.einsum("bhqd,bhkd->bhqk", qj, kj) / np.sqrt(HD)
    p = jax.nn.softmax(s.astype(jnp.float32), axis=-1).astype(qj.dtype)
    want = np.asarray(jnp.einsum("bhqk,bhkd->bhqd", p, vj)
                      .astype(jnp.float32)).transpose(0, 2, 1, 3)
    got = A.attention(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)))
    assert got.dtype == torch.bfloat16 and got.shape == (B, T, H * HD)
    got = got.view(B, T, H, HD)
    assert float(A.bf16_ulps(got, torch.from_numpy(want)).max()) <= 2


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_reads_strided_views_of_qkv(causal, dtype):
    """The head views of a fused [B, T, 3 * H * hd] projection (last axis
    contiguous, no copy) give exactly what contiguous q, k, v give."""
    B, T, H, HD = 3, 77, 4, 64
    qkv = torch.from_numpy(np.random.default_rng(12).normal(
        size=(B, T, 3 * H * HD)).astype(np.float32)).to(dtype)
    q, k, v = qkv.view(B, T, 3, H, HD).permute(2, 0, 3, 1, 4)
    assert not q.is_contiguous() and q.stride(-1) == 1
    got = A.attention(q, k, v, causal)
    want = A.attention(q.contiguous(), k.contiguous(), v.contiguous(), causal)
    assert got.shape == (B, T, H * HD)
    assert torch.equal(got, want)


def test_attention_causal_rows_see_only_earlier_tokens():
    """Row i of the causal attention is the softmax-weighted sum over the
    first i + 1 tokens alone (against float64, 1e-6)."""
    B, H, T, HD = 2, 3, 9, 64
    q, k, v = (np.random.default_rng(13 + i).normal(size=(B, H, T, HD))
               .astype(np.float32) for i in range(3))
    got = A.attention(*map(torch.from_numpy, (q, k, v)), causal=True)
    got = got.numpy().reshape(B, T, H, HD)
    for i in range(T):
        s = np.einsum("bhd,bhkd->bhk", q[:, :, i], k[:, :, :i + 1]) / 8.0
        p = np.exp(s - s.max(-1, keepdims=True))
        p /= p.sum(-1, keepdims=True)
        want = np.einsum("bhk,bhkd->bhd", p, v[:, :, :i + 1])
        np.testing.assert_allclose(got[:, i], want, atol=1e-6, rtol=0)


def test_attention_wrapper_checks():
    q = torch.zeros(2, 3, 5, 64)
    with pytest.raises(ValueError):
        A.attention(q, q[:, :2], q)
    with pytest.raises(TypeError):
        A.attention(q, q.bfloat16(), q)
    assert (A.HEAD_DIM, A.MAX_TOKENS) == (64, 128)


# ---- B5's tensor-core design, walked in numpy
#
# PTX fragment layouts, lane = 4 g + t: (row, column) of each register
# element. m16n8k8 TF32: A a0..a3, B b0, b1; m16n8k16 bf16: A a0..a3 and B
# b0, b1 each hold two elements (the lower half first); the f32
# accumulator is the same for both.


def _frag_a(g, t, bf16):
    if not bf16:
        return [(g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)]
    return [(g, 2 * t), (g, 2 * t + 1), (g + 8, 2 * t), (g + 8, 2 * t + 1),
            (g, 2 * t + 8), (g, 2 * t + 9), (g + 8, 2 * t + 8),
            (g + 8, 2 * t + 9)]


def _frag_b(g, t, bf16):
    if not bf16:
        return [(t, g), (t + 4, g)]
    return [(2 * t, g), (2 * t + 1, g), (2 * t + 8, g), (2 * t + 9, g)]


def _frag_c(g, t):
    return [(g, 2 * t), (g, 2 * t + 1), (g + 8, 2 * t), (g + 8, 2 * t + 1)]


def _mma(a_regs, b_regs, c_regs, bf16):
    """One warp's mma.sync: the lanes' register values placed by the PTX
    layouts, multiplied, and handed back in the accumulator layout."""
    k = 16 if bf16 else 8
    A, B = np.full((16, k), np.nan), np.full((k, 8), np.nan)
    for lane in range(32):
        g, t = divmod(lane, 4)
        for (r, c), x in zip(_frag_a(g, t, bf16), a_regs[lane]):
            A[r, c] = x
        for (r, c), x in zip(_frag_b(g, t, bf16), b_regs[lane]):
            B[r, c] = x
    assert not np.isnan(A).any() and not np.isnan(B).any()
    D = A @ B
    return [[c + D[r, col] for c, (r, col) in zip(c_regs[lane],
                                                  _frag_c(*divmod(lane, 4)))]
            for lane in range(32)]


def _ldmatrix_x4_trans(Vs, row0, col0):
    """ldmatrix.x4.trans as attention.cu's `values` addresses it: lane l
    gives row row0 + (l & 7) + 8 ((l >> 3) & 1), column col0 + 8 (l >> 4)
    of matrix l // 8; lane (g, t) receives, of each matrix, elements
    (2t, g) and (2t + 1, g) of the 8x8 block at those rows."""
    addr = [(row0 + (l & 7) + 8 * ((l >> 3) & 1), col0 + 8 * (l >> 4))
            for l in range(32)]
    out = []
    for lane in range(32):
        g, t = divmod(lane, 4)
        regs = []
        for m in range(4):
            for i in (2 * t, 2 * t + 1):
                r, c = addr[8 * m + i]
                regs.append(Vs[r, c + g])
        out.append(regs)
    return out


@pytest.mark.parametrize("bf16", [False, True])
def test_attention_fragments_give_qk_and_pv(bf16):
    """A numpy walk of csrc/attention.cu's `scores` and `values` for one
    warp (16 query rows, 32 keys, hd 64): the Q and K registers as the
    kernel reads them from shared memory, Q K^T's accumulators reused as
    P V's A operand as the kernel packs them, and V's B registers from V
    stored in `v_stage_order` (f32) or through ldmatrix.trans (bf16). The
    result must be q k^T and p v (any p laid out as the accumulator)."""
    rng = np.random.default_rng(31)
    R, T, HD = 16, 32, 64
    q, k, v = rng.normal(size=(R, HD)), rng.normal(size=(T, HD)), \
        rng.normal(size=(T, HD))
    NT = T // 8
    zero = [[0.0] * 4 for _ in range(32)]
    s = [zero] * NT
    for kk in range(HD // (16 if bf16 else 8)):
        a = []
        for lane in range(32):
            g, t = divmod(lane, 4)
            if bf16:   # 32-bit words 8kk + t and 8kk + t + 4 of rows g, g + 8
                c = 16 * kk + 2 * t
                a.append([q[g, c], q[g, c + 1], q[g + 8, c], q[g + 8, c + 1],
                          q[g, c + 8], q[g, c + 9], q[g + 8, c + 8],
                          q[g + 8, c + 9]])
            else:
                c = 8 * kk + t
                a.append([q[g, c], q[g + 8, c], q[g, c + 4], q[g + 8, c + 4]])
        for n in range(NT):
            b = []
            for lane in range(32):
                g, t = divmod(lane, 4)
                j = 8 * n + g
                if bf16:
                    c = 16 * kk + 2 * t
                    b.append([k[j, c], k[j, c + 1], k[j, c + 8], k[j, c + 9]])
                else:
                    c = 8 * kk + t
                    b.append([k[j, c], k[j, c + 4]])
            s[n] = _mma(a, b, s[n], bf16)
    S = np.zeros((R, T))
    for n in range(NT):
        for lane in range(32):
            for (r, c), x in zip(_frag_c(*divmod(lane, 4)), s[n][lane]):
                S[r, 8 * n + c] = x
    np.testing.assert_allclose(S, q @ k.T, rtol=1e-12, atol=1e-12)

    p = s   # any P laid out as the accumulator; here the scores themselves
    Vs = v[A.v_stage_order(T, bf16)]
    o = [zero] * 8
    if bf16:
        for kk in range(T // 16):
            a = [p[2 * kk][lane][:2] + p[2 * kk][lane][2:]
                 + p[2 * kk + 1][lane][:2] + p[2 * kk + 1][lane][2:]
                 for lane in range(32)]
            for npair in range(4):
                b = _ldmatrix_x4_trans(Vs, 16 * kk, 16 * npair)
                o[2 * npair] = _mma(a, [r[:4] for r in b], o[2 * npair], True)
                o[2 * npair + 1] = _mma(a, [r[4:] for r in b],
                                        o[2 * npair + 1], True)
    else:
        for kk in range(NT):
            # A columns t, t + 4 are the accumulator's keys 2t, 2t + 1
            a = [[p[kk][lane][0], p[kk][lane][2], p[kk][lane][1],
                  p[kk][lane][3]] for lane in range(32)]
            for n in range(8):
                b = []
                for lane in range(32):
                    g, t = divmod(lane, 4)
                    b.append([Vs[8 * kk + t, 8 * n + g],
                              Vs[8 * kk + t + 4, 8 * n + g]])
                o[n] = _mma(a, b, o[n], False)
    O = np.zeros((R, HD))
    for n in range(8):
        for lane in range(32):
            for (r, c), x in zip(_frag_c(*divmod(lane, 4)), o[n][lane]):
                O[r, 8 * n + c] = x
    np.testing.assert_allclose(O, S @ v, rtol=1e-12, atol=1e-12)


def test_v_stage_order():
    np.testing.assert_array_equal(A.v_stage_order(16, False),
                                  [0, 2, 4, 6, 1, 3, 5, 7,
                                   8, 10, 12, 14, 9, 11, 13, 15])
    np.testing.assert_array_equal(A.v_stage_order(16, True), np.arange(16))


def _tf32_split(x):
    """attention.cu's `split` on float32 x: big = x with its low 13
    mantissa bits zero, small = the rest rounded to TF32 (cvt.rna: to
    nearest, ties away from zero)."""
    x = np.ascontiguousarray(x, np.float32)
    big = (x.view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)
    rest = (x - big).view(np.uint32)
    small = ((rest + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)
    return big, small


def _mm_3xtf32(x, y):
    """x @ y as 3xTF32 (small*big + big*small + big*big, each product
    exact, the sum rounded to f32 once)."""
    xb, xs = _tf32_split(x)
    yb, ys = _tf32_split(y)
    f = np.float64
    return (xs.astype(f) @ yb.astype(f) + xb.astype(f) @ ys.astype(f)
            + xb.astype(f) @ yb.astype(f)).astype(np.float32)


@pytest.mark.parametrize("B,H,T,causal", [(8, 12, 50, False),
                                           (3, 8, 77, True)])
def test_attention_3xtf32_meets_the_f32_limit(B, H, T, causal):
    """The f32 kernel's arithmetic emulated on the CPU (3xTF32 products,
    f32 softmax with the kernel's expf and division, the scale applied to
    the f32 scores) at 8 crops of the vision shape and at the text shape,
    on the card tests' inputs: within their 1e-5 of attention_plain in
    float64, the limit the kernel is held to on the card."""
    rng = np.random.default_rng(21)
    qkv = rng.normal(size=(B, T, 3 * H * 64)).astype(np.float32)
    q, k, v = qkv.reshape(B, T, 3, H, 64).transpose(2, 0, 3, 1, 4)
    want = A.attention_plain(*(torch.from_numpy(np.ascontiguousarray(a))
                               .double() for a in (q, k, v)), causal)
    want = want.numpy().reshape(B, T, H, 64)
    got = np.empty_like(want, dtype=np.float32)
    mask = np.triu(np.ones((T, T), bool), 1) if causal else \
        np.zeros((T, T), bool)
    for b in range(B):
        for h in range(H):
            s = _mm_3xtf32(q[b, h], k[b, h].T) * np.float32(0.125)
            s[mask] = -np.inf
            e = np.exp(s - s.max(-1, keepdims=True))
            p = (e / e.sum(-1, keepdims=True, dtype=np.float32)).astype(
                np.float32)
            got[b, :, h] = _mm_3xtf32(p, v[b, h])
    assert float(np.abs(got - want).max()) <= 1e-5


# ---- B1's work counts


@pytest.mark.parametrize("entry", ["splat", "splat_scatter"])
def test_splat_work_matches_a_loop(entry):
    """splat_work against a plain Python loop over rows, frames and
    corners: touched rows, weighted in-grid corners, bytes, flops and the
    corner-row bytes. The dense entry reads every uvw row and no index
    array; the scatter entry reads its int64 indices and the uvw rows of
    valid destinations only."""
    rng = np.random.default_rng(41)
    K, F, Py, Px, C = 40, 3, 4, 5, 8
    _, _, uvw = _splat_inputs(K, C, F, Py, Px, rng)
    uvw[rng.uniform(size=K) < 0.2, :, 2] = 0.0
    scatter = entry == "splat_scatter"
    rows_valid = rng.uniform(size=K) < 0.8 if scatter else np.ones(K, bool)
    touched = corners = 0
    for r in range(K):
        if not rows_valid[r] or not (uvw[r, :, 2] != 0).any():
            continue
        touched += 1
        for f in range(F):
            if uvw[r, f, 2] == 0:
                continue
            x0, y0 = np.floor(uvw[r, f, 0]), np.floor(uvw[r, f, 1])
            corners += sum(0 <= x0 + dx < Px and 0 <= y0 + dy < Py
                           for dy in (0, 1) for dx in (0, 1))
    got = S.splat_work(torch.from_numpy(uvw), Py, Px, C,
                       rows_valid=torch.from_numpy(rows_valid) if scatter
                       else None)
    uvw_bytes = int(rows_valid.sum()) * F * 3 * 4
    assert got == {
        "touched_rows": touched, "corners": corners,
        "bytes": 2 * touched * C * 4 + uvw_bytes + (K * 8 if scatter else 0)
        + F * Py * Px * C * 4,
        "flops": 2.0 * corners * C, "corner_bytes": corners * C * 4}
    assert 0 < touched < K and corners > 0
    assert (uvw_bytes < uvw.size * 4) == scatter
