"""The port's CUDA kernels (B1 feature splat, B2 fused LN->MLP, B3 panoptic
paint, B4 tile sample) against their plain PyTorch versions on the card,
and the wrappers' dispatch.

This file imports neither jax nor the JAX package, so it also runs on a
machine with a card and no JAX:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

(tests/conftest.py imports jax). Without a card the `cuda` tests skip;
chip_smoke.py runs the same comparison at the main path's shapes.
"""
import numpy as np
import pytest
import torch

from spatially_aware_ai_tpu_torch.grid import splat as S
from spatially_aware_ai_tpu_torch.grid import tiledma as T
from spatially_aware_ai_tpu_torch.models import ln_mlp as L
from spatially_aware_ai_tpu_torch.models.kmax import paint as P


def _splat_inputs(N, K, C, F, Py, Px, rng):
    feat_sum = rng.normal(size=(N, C)).astype(np.float32)
    feat_imgs = rng.normal(size=(F, Py, Px, C)).astype(np.float32)
    # interior, boundary and out-of-grid coordinates; half the frames
    # invalid
    uvw = np.stack(
        [rng.uniform(-1.5, Px + 0.5, size=(K, F)),
         rng.uniform(-1.5, Py + 0.5, size=(K, F)),
         rng.integers(0, 2, size=(K, F)).astype(np.float64)],
        axis=-1,
    ).astype(np.float32)
    return feat_sum, feat_imgs, uvw


def _mlp_inputs(M, D, with_gamma, rng):
    H = 4 * D

    def n(*shape, scale=1.0, loc=0.0):
        return torch.from_numpy(
            (loc + scale * rng.normal(size=shape)).astype(np.float32))

    return [n(M, D), n(M, D), n(D, scale=0.1, loc=1.0), n(D, scale=0.1),
            n(D, H, scale=D ** -0.5), n(H, scale=0.1),
            n(H, D, scale=H ** -0.5), n(D, scale=0.1),
            n(D, scale=0.1, loc=0.5) if with_gamma else None]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def test_cpu_tensors_take_the_plain_version_without_counting():
    rng = np.random.default_rng(0)
    feat_sum, feat_imgs, uvw = _splat_inputs(16, 16, 8, 2, 3, 4, rng)
    s0, l0 = S.launches, L.launches
    got = S.splat(torch.from_numpy(feat_sum.copy()), torch.from_numpy(uvw),
                  torch.from_numpy(feat_imgs))
    want = S.splat_plain(torch.from_numpy(feat_sum.copy()),
                         torch.from_numpy(uvw), torch.from_numpy(feat_imgs))
    assert torch.equal(got, want)
    args = _mlp_inputs(5, 64, False, rng)
    assert torch.equal(L.fused_ln_mlp(*args, act="quick_gelu", eps=1e-5),
                       L.ln_mlp_plain(*args, act="quick_gelu", eps=1e-5))
    assert (S.launches, L.launches) == (s0, l0)


@pytest.mark.cuda
def test_splat_kernel_on_card():
    """Both entries against the plain version, tol 1e-4 (sum order); dead
    slots (index N) dropped, rows outside the active set untouched; one
    count per launch."""
    dev = _card()
    rng = np.random.default_rng(1)
    N, K, C, F, Py, Px = 300, 96, 64, 4, 5, 7
    feat_sum, feat_imgs, uvw = _splat_inputs(N, N, C, F, Py, Px, rng)
    fs, u, im = (torch.from_numpy(a).to(dev) for a in (feat_sum, uvw,
                                                        feat_imgs))
    n0 = S.launches
    got = S.splat(fs.clone(), u, im)
    assert S.launches == n0 + 1
    torch.testing.assert_close(got, S.splat_plain(fs.clone(), u, im),
                               atol=1e-4, rtol=0)

    live = np.sort(rng.choice(N, size=60, replace=False))
    active = np.full(K, N, np.int64)
    active[:60] = live
    act = torch.from_numpy(active).to(dev)
    ua = u[:K].contiguous()
    got = S.splat_scatter(fs.clone(), act, ua, im)
    torch.testing.assert_close(
        got, S.splat_scatter_plain(fs.clone(), act, ua, im), atol=1e-4,
        rtol=0)
    untouched = torch.from_numpy(np.setdiff1d(np.arange(N), live)).to(dev)
    assert torch.equal(got[untouched], fs[untouched])


@pytest.mark.cuda
@pytest.mark.parametrize("act,eps,with_gamma,dtype,D,M", [
    ("quick_gelu", 1e-5, False, torch.float32, 512, 77),   # CLIP text
    ("quick_gelu", 1e-5, False, torch.bfloat16, 768, 200),  # CLIP vision
    ("quick_gelu", 1e-5, False, torch.float32, 64, 131),   # tiny CLIP
    ("gelu", 1e-6, True, torch.float32, 192, 45),          # ConvNeXt
    ("gelu", 1e-6, True, torch.bfloat16, 384, 45),
])
def test_ln_mlp_kernel_on_card(act, eps, with_gamma, dtype, D, M):
    """Tolerances as chip_smoke.py: f32 3e-4 abs, no rel term (3xTF32
    reads about 1e-4, a single TF32 pass about 1.7e-3); bf16 3e-2 abs +
    2e-2 rel (a sum-order difference can move a bf16 rounding of the
    hidden activation by one ulp)."""
    dev = _card()
    args = [None if a is None else a.to(dev)
            for a in _mlp_inputs(M, D, with_gamma, np.random.default_rng(2))]
    args[0], args[1] = args[0].to(dtype), args[1].to(dtype)
    n0 = L.launches
    got = L.fused_ln_mlp(*args, act=act, eps=eps)
    assert L.launches == n0 + 1 and got.dtype == dtype
    atol, rtol = (3e-4, 0.0) if dtype == torch.float32 else (3e-2, 2e-2)
    torch.testing.assert_close(got.float(),
                               L.ln_mlp_plain(*args, act=act, eps=eps).float(),
                               atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["linear_view", "contiguous"])
@pytest.mark.parametrize("act,eps,with_gamma", [
    ("gelu", 1e-6, True), ("quick_gelu", 1e-5, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [128, 384])   # route 1 (fused), route 2
def test_ln_mlp_routes_on_card(D, dtype, act, eps, with_gamma, layout):
    """Both routes against the plain version at ragged M (1, 45, 129,
    1003), with the weights as the callers hold them (nn.Linear weights
    transposed, `fc.weight.t()`) and as contiguous [D, H] / [H, D];
    tolerances as test_ln_mlp_kernel_on_card. One count per call."""
    dev = _card()
    assert L.route(D, 4 * D) == (1 if D <= 256 else 2)
    for M in (1, 45, 129, 1003):
        args = [None if a is None else a.to(dev)
                for a in _mlp_inputs(M, D, with_gamma,
                                     np.random.default_rng(M))]
        args[0], args[1] = args[0].to(dtype), args[1].to(dtype)
        if layout == "linear_view":
            args[4] = args[4].t().contiguous().t()
            args[6] = args[6].t().contiguous().t()
            assert not args[4].is_contiguous()
        n0 = L.launches
        got = L.fused_ln_mlp(*args, act=act, eps=eps)
        assert L.launches == n0 + 1 and got.dtype == dtype
        atol, rtol = (3e-4, 0.0) if dtype == torch.float32 else (3e-2, 2e-2)
        torch.testing.assert_close(
            got.float(), L.ln_mlp_plain(*args, act=act, eps=eps).float(),
            atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_ln_mlp_split_pass_on_card(mode):
    """The split pass: big + small == w exactly, big's low 13 mantissa
    bits zero, in the order `plane_order` gives; bf16 the rounded weight in
    that order. From a transposed view, as the callers pass weights."""
    dev = _card()
    rng = np.random.default_rng(8)
    w = torch.from_numpy(rng.normal(size=(192, 256)).astype(np.float32))
    w = w.to(dev).t()                                  # [256, 192] view
    order = torch.from_numpy(L.plane_order(192, mode, False)).to(dev)
    planes = L.weight_planes(w, torch.float32, mode)
    big, small = planes[0], planes[1]
    assert torch.equal(big + small, w[:, order])
    assert not (big.view(torch.int32) & 0x1FFF).any()
    order = torch.from_numpy(L.plane_order(192, mode, True)).to(dev)
    assert torch.equal(L.weight_planes(w, torch.bfloat16, mode),
                       w[:, order].to(torch.bfloat16))


def _paint_inputs(F, N, h, w, rng):
    """Query-softmaxed probabilities of random logits, random paint orders
    and keep flags (about 70% kept)."""
    logits = rng.normal(size=(F, N, h, w)) * 3.0
    e = np.exp(logits - logits.max(axis=1, keepdims=True))
    probs = (e / e.sum(axis=1, keepdims=True)).astype(np.float32)
    order = np.stack([rng.permutation(N) for _ in range(F)]).astype(np.int32)
    keep = (rng.uniform(size=(F, N)) < 0.7).astype(np.int32)
    return [torch.from_numpy(a) for a in (probs, order, keep)]


def test_paint_cpu_tensors_take_the_plain_version():
    args = _paint_inputs(2, 8, 5, 7, np.random.default_rng(3))
    kw = dict(overlap_threshold=0.8, pixel_threshold=0.4)
    n0 = P.launches
    for got, want in zip(P.paint_masks(*args, **kw),
                         P.paint_masks_plain(*args, **kw)):
        assert torch.equal(got, want)
    assert P.launches == n0


@pytest.mark.cuda
@pytest.mark.parametrize("F,N,h,w", [
    (2, 128, 61, 83),     # planes not 16-byte aligned, hw % 32 == 11
    (8, 128, 241, 321),   # the kMaX path's shape
    (3, 16, 61, 83),      # few queries
])
def test_paint_kernel_on_card(F, N, h, w):
    """The claims and the accepted flags equal the plain version's exactly;
    one count per call (three launches)."""
    dev = _card()
    args = [a.to(dev) for a in _paint_inputs(F, N, h, w,
                                             np.random.default_rng(4))]
    kw = dict(overlap_threshold=0.8, pixel_threshold=0.4)
    n0 = P.launches
    got = P.paint_masks(*args, **kw)
    torch.cuda.synchronize()
    assert P.launches == n0 + 1
    want = P.paint_masks_plain(*args, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (want[0] >= 0).any() and (want[0] < 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("overlap,pixel", [(0.8, 0.4), (0.0, 0.4),
                                           (0.0, 0.0), (0.95, 0.1),
                                           (0.5, 0.05)])
def test_paint_kernel_on_card_void_frame_and_thresholds(overlap, pixel):
    """Frame 1 keeps no query; in frame 2 the second query painted lies
    wholly under the first, so at overlap 0 it is accepted and paints
    nothing. At (0.95, 0.1) and (0.5, 0.05) the masks overlap and most
    kept steps are rejected between accepted ones (the resolve step
    restarts at each change of outcome). Claims and accepted flags equal
    the plain version's exactly; one count per call."""
    dev = _card()
    probs, order, keep = _paint_inputs(3, 128, 61, 83,
                                       np.random.default_rng(9))
    keep[1] = 0
    over, under = order[2, 0], order[2, 1]
    probs[2, over, :10, :10] = 0.9
    probs[2, under] = probs[2, over] * 0.99
    keep[2, :2] = 1
    args = [a.to(dev) for a in (probs, order, keep)]
    kw = dict(overlap_threshold=overlap, pixel_threshold=pixel)
    n0 = P.launches
    got = P.paint_masks(*args, **kw)
    torch.cuda.synchronize()
    assert P.launches == n0 + 1
    want = P.paint_masks_plain(*args, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (want[0][1] < 0).all() and not want[1][1].any()
    if overlap > 0.9:
        assert (want[1] == 0).sum() > 2 * want[1].sum()
    if overlap == 0.0:
        painted = torch.zeros_like(want[1])
        for f in range(3):
            painted[f, want[0][f][want[0][f] >= 0].unique().long()] = True
        assert (want[1] & ~painted).any()


@pytest.mark.cuda
@pytest.mark.parametrize("overlap,pixel", [(0.0, 0.4), (0.0, 0.0)])
def test_panoptic_batch_on_card_at_zero_thresholds(overlap, pixel):
    """panoptic_inference_batch on the card (B3) at zero thresholds, where
    accepted queries may paint nothing: the maps equal the scalar reference
    run on the CPU. Frame 0 is random; in frame 1 thing 1 lies wholly
    under thing 0 and thing 2 is painted after both, so its segment id
    counts the accepted thing that painted nothing."""
    import dataclasses

    from spatially_aware_ai_tpu_torch.models.kmax import model as KM

    dev = _card()
    cfg = dataclasses.replace(KM.KMAX_TINY_TEST, overlap_threshold=overlap,
                              pixel_confidence_threshold=pixel)
    rng = np.random.default_rng(5)
    cls = rng.normal(size=(2, 16, 134)).astype(np.float32) * 4.0
    masks = rng.normal(size=(2, 20, 30, 16)).astype(np.float32) * 3.0
    cls[1], masks[1] = -6.0, -8.0
    cls[1, 0, 3], masks[1, :, :20, 0] = 8.0, 6.0
    cls[1, 1, 3], masks[1, :, :20, 1] = 7.0, 6.0
    cls[1, 2, 5], masks[1, 16:, 22:, 2] = 8.0, 5.9
    cls[1, 3, -1], masks[1, 16:, 22:, 3] = 10.0, 6.0   # void beside it
    cls, masks = torch.from_numpy(cls), torch.from_numpy(masks)
    n0 = P.launches
    cat, seg = KM.panoptic_inference_batch(cls.to(dev), masks.to(dev), cfg)
    assert P.launches == n0 + 1
    if pixel > 0:
        assert set(seg[1].unique().tolist()) == {0, 1, 3}
    for f in range(2):
        want = KM.panoptic_inference(cls[f], masks[f], cfg)
        assert torch.equal(cat[f].cpu(), want[0])
        assert torch.equal(seg[f].cpu(), want[1])


def _tile_inputs(NB, F, C, H, W, V, tile_h, tile_w, rng):
    """Brick-coherent pixels (each brick's voxels within ~40 px of a random
    centre, some past the image and some sentinelled to -1e6, a few
    half-integers), the image and the bboxes brick_tile_bboxes gives."""
    img = rng.normal(size=(F, C, H, W)).astype(np.float32)
    centre = rng.uniform([-20, -20], [W + 20, H + 20], size=(NB, F, 1, 2))
    uv = centre + rng.normal(scale=20.0, size=(NB, F, V, 2))
    uv[rng.uniform(size=uv.shape) < 0.05] = -1e6
    half = rng.uniform(size=uv.shape) < 0.05
    uv[half] = np.floor(uv[half]) + 0.5
    uv = torch.from_numpy(uv.astype(np.float32))
    z = torch.ones(uv.shape[:3])
    bbox, _ = T.brick_tile_bboxes(uv, T.in_image_mask(uv, z, H, W), tile_h,
                                  tile_w, H, W)
    return (torch.from_numpy(img), uv.permute(0, 1, 3, 2).contiguous(),
            bbox.contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("NB,F,C,H,W,V,tile", [
    (7, 3, 2, 100, 300, 64, (64, 128)),         # small, ragged image
    (392, 8, 2, 768, 1024, 512, (256, 256)),    # the probe's shape
    (11, 3, 3, 100, 300, 63, (64, 128)),        # rows not 16-byte aligned
])
def test_tile_sample_kernel_on_card(NB, F, C, H, W, V, tile):
    """Samples and in_tile equal the plain version's exactly; one count per
    launch."""
    dev = _card()
    img, uv, bbox = (a.to(dev) for a in _tile_inputs(
        NB, F, C, H, W, V, *tile, np.random.default_rng(6)))
    n0 = T.launches
    got = T.tile_sample_nearest(img, uv, bbox, *tile)
    torch.cuda.synchronize()
    assert T.launches == n0 + 1
    want = T.tile_sample_nearest_plain(img, uv, bbox, *tile)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert want[1].any() and not want[1].all()


def test_tile_sample_cpu_tensors_take_the_plain_version():
    args = _tile_inputs(3, 2, 2, 40, 200, 32, 16, 128,
                        np.random.default_rng(7))
    n0 = T.launches
    for got, want in zip(T.tile_sample_nearest(*args, 16, 128),
                         T.tile_sample_nearest_plain(*args, 16, 128)):
        assert torch.equal(got, want)
    assert T.launches == n0
