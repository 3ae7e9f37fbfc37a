"""Kernels B1 (feature splat) and B2 (fused LN->MLP) of the PyTorch port:
their plain PyTorch versions (what the wrappers run on CPU tensors) held
against the JAX package's Pallas kernels in interpret mode and its XLA
formulations, on the same numpy inputs. The CUDA kernels themselves run
only on the card (tests/test_torch_cuda.py, and chip_smoke.py's kernels
phase)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from spatially_aware_ai_tpu.grid.fusion import einsum_feature_splat
from spatially_aware_ai_tpu.grid.pallas_fusion import fused_feature_splat
from spatially_aware_ai_tpu.models.pallas_mlp import (
    fused_ln_mlp as jax_fused_ln_mlp,
)
from spatially_aware_ai_tpu_torch.grid import splat as S
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


# The A-register slots the kernels fill for thread column group t (t = lane
# % 4) at k-step kk of a slab, as a source column of the slab (route 2) or
# of the 64-wide hidden chunk (route 1, from the GEMM1 accumulator, whose
# n8 tile j holds columns 8j + 2t and 8j + 2t + 1 of rows g and g + 8).
# tf32 k8 steps have slots t (a0, a1) and t + 4 (a2, a3); bf16 k16 steps
# slots 2t, 2t + 1 (a0, a1) and 2t + 8, 2t + 9 (a2, a3).
_SLOT_RULES = {
    # route 2, f32: thread t holds columns 8t .. 8t + 7 of the slab
    ("phase", False): (32, 8, lambda kk, t: {t: 8 * t + 2 * kk,
                                             t + 4: 8 * t + 2 * kk + 1}),
    # route 2, bf16: thread t holds columns 16t .. 16t + 15
    ("phase", True): (64, 16, lambda kk, t: {
        2 * t: 16 * t + 4 * kk, 2 * t + 1: 16 * t + 4 * kk + 1,
        2 * t + 8: 16 * t + 4 * kk + 2, 2 * t + 9: 16 * t + 4 * kk + 3}),
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
    (as the kernels fill them) times the weight planes in `plane_order`'s
    order (the split pass's, mirrored) must give A @ W. This pins the K
    permutation that lets route 2 read contiguous A columns and route 1
    feed GEMM1's accumulator straight into GEMM2."""
    slab, step, rule = _SLOT_RULES[(route, bf16)]
    mode = {"phase": 2, "fused": 1}[route]
    rng = np.random.default_rng(9)
    K, N = 128, 16
    a = rng.normal(size=(3, K))
    w = rng.normal(size=(K, N))
    stored = w[L.plane_order(K, mode, bf16)]        # plane row p, K-major
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
