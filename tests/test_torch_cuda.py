"""The port's CUDA kernels (B1 feature splat, B2 fused LN->MLP, B3 panoptic
paint, B4 tile sample, B5 attention) against their plain PyTorch versions
on the card, and the wrappers' dispatch; the port's f32 forwards (kMaX,
CLIP, DGCNN) against the caller's TF32 flags; the DGCNN on the card
against the CPU; the small kMaX in bf16 on the card against the CPU, its
first-index argmax on tied bf16 logits and its batch-split bits.

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
from spatially_aware_ai_tpu_torch.models import attention as A
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
@pytest.mark.parametrize("F,Py,Px,C", [
    (1, 5, 7, 64), (3, 5, 7, 64), (8, 5, 7, 64),
    (1, 5, 7, 512), (3, 5, 7, 512), (8, 5, 7, 512),   # the paths' chunks
    (8, 15, 16, 64),      # no 32-channel slice fits: the L2 route
    (3, 4, 5, 72),        # a partial last slice
    (3, 4, 5, 32),        # one float a lane
])
def test_splat_kernel_routes_on_card(F, Py, Px, C):
    """Both entries at each shared-memory slice width and on the L2
    route, against the plain version (1e-4); the scatter's dead slots
    dropped and rows outside the live set untouched; one count per launch;
    the kernel takes the L2 route exactly at the shape meant for it."""
    from spatially_aware_ai_tpu_torch.native_cuda import load

    dev = _card()
    smem = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    kernel_choice = load("feature_splat", S._SIGNATURES).sai_feature_splat_slice
    assert (kernel_choice(F, Py * Px, C, smem) == 0) == (Py * Px == 240)
    rng = np.random.default_rng(F * 1000 + C)
    N, K = 3000, 1024
    feat_sum, feat_imgs, uvw = _splat_inputs(N, N, C, F, Py, Px, rng)
    uvw[rng.uniform(size=N) < 0.5, :, 2] = 0.0   # rows no frame sees
    fs, u, im = (torch.from_numpy(a).to(dev) for a in (feat_sum, uvw,
                                                        feat_imgs))
    n0 = S.launches
    got = S.splat(fs.clone(), u, im)
    assert S.launches == n0 + 1
    torch.testing.assert_close(got, S.splat_plain(fs.clone(), u, im),
                               atol=1e-4, rtol=0)

    live = np.sort(rng.choice(N, size=700, replace=False))
    active = np.full(K, N, np.int64)
    active[:700] = live
    act = torch.from_numpy(active).to(dev)
    ua = u[:K].contiguous()
    got = S.splat_scatter(fs.clone(), act, ua, im)
    assert S.launches == n0 + 2
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
    ("gelu", 1e-6, True, torch.bfloat16, 192, 1003),       # ConvNeXt os4
    # bf16 tiles: route 1 at each D, route 2's 128-row tiles (WN 256, 128)
    # and its small-M tiles (64 rows, WN 64 / 32)
    ("quick_gelu", 1e-5, False, torch.bfloat16, 64, 131),
    ("gelu", 1e-6, True, torch.bfloat16, 128, 129),
    ("gelu", 1e-6, True, torch.bfloat16, 256, 77),
    ("quick_gelu", 1e-5, False, torch.bfloat16, 768, 14000),
    ("quick_gelu", 1e-5, False, torch.bfloat16, 512, 231),
    ("gelu", 1e-6, True, torch.bfloat16, 1536, 1003),
    ("gelu", 1e-6, True, torch.bfloat16, 384, 20000),
])
def test_ln_mlp_kernel_on_card(act, eps, with_gamma, dtype, D, M):
    """Tolerances as chip_smoke.py: f32 3e-4 abs, no rel term (3xTF32
    reads about 1e-4, a single TF32 pass about 1.7e-3); bf16 3e-2 abs +
    2e-2 rel (a sum-order difference can move a bf16 rounding of the
    hidden activation by one ulp). The bf16 cases cover every tile the
    route can choose (tile_for in csrc/ln_mlp.cu)."""
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
@pytest.mark.parametrize("D", [128, 320, 384])   # route 1, route 2 (twice)
def test_ln_mlp_routes_on_card(D, dtype, act, eps, with_gamma, layout):
    """Both routes against the plain version at ragged M (1, 45, 77, 129,
    231, 1003, 20000: in bf16 route 2's small-M tiles of WN 32 and 64 and
    its 128-row tiles of WN 256, 128 and 64), with the weights as the
    callers hold them (nn.Linear weights transposed, `fc.weight.t()`) and
    as contiguous [D, H] / [H, D]; tolerances as
    test_ln_mlp_kernel_on_card. One count per call."""
    dev = _card()
    assert L.route(D, 4 * D) == (1 if D <= 256 else 2)
    for M in (1, 45, 77, 129, 231, 1003, 20000):
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
    """The f32 split pass: big + small == w exactly, big's low 13 mantissa
    bits zero, in the order `plane_order` gives. The bf16 cast pass (one
    launch for both weights): the rounded weights in the callers' order,
    from f32 and from bf16. From transposed views, as the callers pass
    weights."""
    dev = _card()
    rng = np.random.default_rng(8)
    w = torch.from_numpy(rng.normal(size=(192, 256)).astype(np.float32))
    w = w.to(dev).t()                                  # [256, 192] view
    order = torch.from_numpy(L.plane_order(192, mode)).to(dev)
    planes = L.weight_planes(w, mode)
    big, small = planes[0], planes[1]
    assert torch.equal(big + small, w[:, order])
    assert not (big.view(torch.int32) & 0x1FFF).any()
    w2 = torch.from_numpy(rng.normal(size=(256, 192)).astype(np.float32))
    w2 = w2.to(dev).t()                                # [192, 256] view
    src2 = w2 if mode != 2 else w2.to(torch.bfloat16)
    p1, p2 = L.bf16_planes(w, src2)
    assert p1.is_contiguous() and p2.is_contiguous()
    assert torch.equal(p1, w.to(torch.bfloat16))
    assert torch.equal(p2, src2.to(torch.bfloat16))


# route 2's bf16 tile (wide, WN) at the path shapes on a 132-SM card
_PATH_TILES = {
    (650752 // 4, 4 * 384): (0, 256), (650752 // 4, 384): (0, 128),
    (40672, 3072): (0, 256), (40672, 768): (0, 256),
    (10168, 6144): (0, 256), (10168, 1536): (0, 256),
    (14000, 3072): (0, 256), (14000, 768): (0, 256),
    (231, 2048): (1, 32), (231, 512): (1, 32), (77, 2048): (1, 32),
    (1003, 1536): (1, 64), (1003, 384): (1, 32), (20000, 320): (0, 64),
}


@pytest.mark.cuda
def test_ln_mlp_tile_choice_on_card():
    """The kernel's tile choice (sai_ln_mlp_tile, read by chip_smoke's L2
    byte counts) at the path shapes, and for every M and N a tile that
    divides N into the two warpgroups' 64 x WN products. Whatever the tile,
    K is summed in the same order: test_ln_mlp_rows_do_not_depend_on_m_on_card
    holds that bit for bit."""
    from spatially_aware_ai_tpu_torch.native_cuda import load

    _card()
    fn = load("ln_mlp", L._SIGNATURES).sai_ln_mlp_tile
    for (M, N), want in _PATH_TILES.items():
        code = fn(M, N, 132)
        assert (code // 65536, code % 65536) == want, (M, N)
    for sms in (132, 114, 1):
        for N in range(64, 6144 + 1, 64):
            for M in (1, 63, 64, 65, 127, 128, 231, 1003, 8191, 40672,
                      650752):
                wide, wn = divmod(fn(M, N, sms), 65536)
                assert wide in (0, 1) and wn in (32, 64, 128, 256)
                assert N % (wn * (1 + wide)) == 0, (M, N, sms)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,act,eps,with_gamma", [
    (192, "gelu", 1e-6, True),            # route 1
    (512, "quick_gelu", 1e-5, False),     # route 2, CLIP text
    (768, "quick_gelu", 1e-5, False),     # route 2, CLIP vision
])
def test_ln_mlp_rows_do_not_depend_on_m_on_card(dtype, D, act, eps,
                                                 with_gamma):
    """C14 for B2: rows [a:b] of a call over M rows are bitwise equal to a
    call over those rows alone, for M on different tile choices (in bf16
    route 2 14,000 rows take 128-row tiles of WN 256, 231 and 77 rows
    64-row tiles of WN 32), at any place in the batch."""
    dev = _card()
    args = [None if a is None else a.to(dev)
            for a in _mlp_inputs(14000, D, with_gamma,
                                 np.random.default_rng(D))]
    args[0], args[1] = args[0].to(dtype), args[1].to(dtype)

    def call(lo, hi):
        part = [args[0][lo:hi].contiguous(), args[1][lo:hi].contiguous(),
                *args[2:]]
        return L.fused_ln_mlp(*part, act=act, eps=eps)

    whole = call(0, 14000)
    for lo, hi in ((0, 231), (5000, 5231), (13923, 14000), (77, 154)):
        assert torch.equal(call(lo, hi), whole[lo:hi]), (lo, hi)
    small = call(1000, 1231)
    assert torch.equal(call(1100, 1177), small[100:177])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,M", [(192, 1003), (768, 14000), (512, 231)])
def test_ln_mlp_is_bitwise_repeatable_on_card(dtype, D, M):
    """C15 for B2: the same call again, on a fresh stream, gives the same
    bits (no atomics; every sum in a fixed order)."""
    dev = _card()
    args = [None if a is None else a.to(dev)
            for a in _mlp_inputs(M, D, True, np.random.default_rng(M))]
    args[0], args[1] = args[0].to(dtype), args[1].to(dtype)
    first = L.fused_ln_mlp(*args, act="gelu", eps=1e-6)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        again = L.fused_ln_mlp(*args, act="gelu", eps=1e-6)
    torch.cuda.current_stream().wait_stream(stream)
    assert torch.equal(first, again)


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


# ---------------------------------------------------------------- B5


def _qkv(B, H, T_, dtype, dev, rng, layout):
    """q, k, v [B, H, T, 64]: the head views of a fused qkv projection
    (last axis contiguous) or contiguous tensors."""
    qkv = torch.from_numpy(rng.normal(size=(B, T_, 3 * H * 64)).astype(
        np.float32)).to(dev, dtype)
    q, k, v = qkv.view(B, T_, 3, H, 64).permute(2, 0, 3, 1, 4)
    if layout == "contiguous":
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    return q, k, v


def test_attention_cpu_tensors_take_the_plain_version():
    q, k, v = _qkv(2, 3, 11, torch.float32, "cpu",
                   np.random.default_rng(20), "view")
    n0 = A.launches
    assert torch.equal(A.attention(q, k, v, True),
                       A.attention_plain(q, k, v, True))
    assert A.launches == n0


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["view", "contiguous"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,T_,causal", [
    (280, 12, 50, False),   # the vision tower over one chunk's tiles
    (3, 8, 77, True),       # the text tower
    (2, 2, 128, True),      # the longest sequence it takes
    (5, 3, 1, False),
])
def test_attention_kernel_on_card(B, H, T_, causal, dtype, layout):
    """B5 against its plain version on the same inputs: f32 within 1e-5 abs
    (the plain version's products with TF32 off; sums in other orders),
    bf16 within 2 bf16 ulps of each row's largest output; one count per
    launch."""
    from spatially_aware_ai_tpu_torch.core.device import full_f32

    dev = _card()
    q, k, v = _qkv(B, H, T_, dtype, dev, np.random.default_rng(21), layout)
    n0 = A.launches
    got = A.attention(q, k, v, causal)
    torch.cuda.synchronize()
    assert A.launches == n0 + 1
    assert got.shape == (B, T_, H * 64) and got.dtype == dtype
    with full_f32():
        want = A.attention_plain(q, k, v, causal)
    if dtype == torch.float32:
        assert float((got - want).abs().max()) <= 1e-5
    else:
        assert float(A.bf16_ulps(got.view(B, T_, H, 64),
                                 want.view(B, T_, H, 64)).max()) <= 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("T_", [1, 16, 17, 50, 64, 65, 77, 128])
def test_attention_kernel_tokens_on_card(T_, causal, dtype):
    """B5 at every padding case of its 16-row tiles and 64-row items (T a
    multiple of 16, one over, the CLIP towers' 50 and 77, the most it
    takes), on the head views of a fused qkv tensor: f32 within 1e-5, bf16
    within 2 bf16 ulps of each row's largest output; one count per
    launch."""
    from spatially_aware_ai_tpu_torch.core.device import full_f32

    dev = _card()
    B, H = 7, 5
    q, k, v = _qkv(B, H, T_, dtype, dev, np.random.default_rng(T_), "view")
    n0 = A.launches
    got = A.attention(q, k, v, causal)
    torch.cuda.synchronize()
    assert A.launches == n0 + 1
    with full_f32():
        want = A.attention_plain(q, k, v, causal)
    if dtype == torch.float32:
        assert float((got - want).abs().max()) <= 1e-5
    else:
        assert float(A.bf16_ulps(got.view(B, T_, H, 64),
                                 want.view(B, T_, H, 64)).max()) <= 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernel_at_the_text_towers_shape_on_card(dtype):
    """B5 at the shape the text tower gives it on the main paths (3
    prompts, 8 heads, T=77, causal), in f32 and in bf16 (the bf16
    engine's): f32 within 1e-5, bf16 within 2 bf16 ulps of each row's
    largest output; one count per launch."""
    from spatially_aware_ai_tpu_torch.core.device import full_f32

    dev = _card()
    B, H, T_ = 3, 8, 77
    q, k, v = _qkv(B, H, T_, dtype, dev, np.random.default_rng(77), "view")
    n0 = A.launches
    got = A.attention(q, k, v, True)
    torch.cuda.synchronize()
    assert A.launches == n0 + 1 and got.dtype == dtype
    with full_f32():
        want = A.attention_plain(q, k, v, True)
    if dtype == torch.float32:
        assert float((got - want).abs().max()) <= 1e-5
    else:
        assert float(A.bf16_ulps(got.view(B, T_, H, 64),
                                 want.view(B, T_, H, 64)).max()) <= 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernel_takes_unaligned_views(dtype):
    """Head views that start 4 bytes (f32) or 2 bytes (bf16) past a
    16-byte boundary, which 16-byte cp.async cannot read: the kernel's
    plain load path gives what contiguous copies give."""
    dev = _card()
    B, T_, H = 4, 50, 3
    rng = np.random.default_rng(22)
    wide = torch.from_numpy(rng.normal(size=(B, T_, 3 * H * 64 + 1)).astype(
        np.float32)).to(dev, dtype)
    q, k, v = wide[..., 1:].unflatten(-1, (3, H, 64)).permute(2, 0, 3, 1, 4)
    assert q.data_ptr() % 16 != 0 and q.stride(-1) == 1
    for causal in (False, True):
        got = A.attention(q, k, v, causal)
        want = A.attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal)
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_attention_kernel_refuses_what_it_does_not_take():
    dev = _card()
    q = torch.zeros(2, 2, 10, 32, device=dev)
    with pytest.raises(ValueError, match="hd"):
        A.attention(q, q, q)
    q = torch.zeros(1, 2, 129, 64, device=dev)
    with pytest.raises(ValueError, match="T"):
        A.attention(q, q, q)
    q = torch.zeros(1, 2, 10, 64, device=dev, dtype=torch.float16)
    with pytest.raises(TypeError):
        A.attention(q, q, q)
    q = torch.zeros(1, 2, 10, 128, device=dev)[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        A.attention(q, q, q)


# ---------------------------------------------------------------- C10

_FLAG_STATES = {
    "default": "",
    "legacy_high": "torch.set_float32_matmul_precision('high'); "
                   "torch.backends.cudnn.allow_tf32 = True",
    "legacy_off": "torch.backends.cuda.matmul.allow_tf32 = False; "
                  "torch.backends.cudnn.allow_tf32 = False",
    "new_api_tf32": "torch.backends.cuda.matmul.fp32_precision = 'tf32'; "
                    "torch.backends.cudnn.conv.fp32_precision = 'tf32'",
    "generic_tf32": "torch.backends.fp32_precision = 'tf32'",
}


@pytest.mark.parametrize("state", list(_FLAG_STATES))
def test_full_f32_pins_and_restores_the_callers_flags(state):
    """In a fresh process set up with the caller's flags: inside full_f32
    every TF32 getter reads off (and none raises), and on exit every getter
    reads as before."""
    import subprocess
    import sys
    import textwrap

    code = textwrap.dedent(f"""
        import torch
        from spatially_aware_ai_tpu_torch.core.device import full_f32
        {_FLAG_STATES[state]}
        def read():
            out = []
            for get in (torch.get_float32_matmul_precision,
                        lambda: torch.backends.cuda.matmul.allow_tf32,
                        lambda: torch.backends.cudnn.allow_tf32):
                try:
                    out.append(get())
                except RuntimeError:
                    out.append("raises")
            b = torch.backends
            spaces = (b.cuda.matmul, b.mkldnn.matmul, b.cudnn.conv,
                      b.cudnn.rnn)
            out += [s.fp32_precision for s in spaces
                    if hasattr(s, "fp32_precision")]
            return out
        before = read()
        with full_f32():
            inside = read()
        assert read() == before, (read(), before)
        assert inside[:3] == ["highest", False, False], inside
        assert "tf32" not in inside[3:], inside
        print("ok")
    """)
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         env=dict(os.environ, PYTHONPATH=root),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def _small_kmax(dev, compute_dtype=None):
    """A small kMaX the card's kernels take (ConvNeXt depths 1, 1, 2, 1 at
    widths 64-256, the tiny decoder), random weights from seed 0, with the
    class head x20 and the mask-logit BN x100 so that frames are painted,
    in `compute_dtype` (f32 by default)."""
    import dataclasses

    from spatially_aware_ai_tpu_torch.models.kmax import model as KM
    from spatially_aware_ai_tpu_torch.models.kmax.convnext import (
        ConvNeXtConfig)

    cfg = dataclasses.replace(
        KM.KMAX_TINY_TEST,
        backbone=ConvNeXtConfig(depths=(1, 1, 2, 1), dims=(64, 128, 192, 256)))
    seg = KM.KmaxSegmenter.random(cfg, seed=0, device=dev,
                                  compute_dtype=compute_dtype)
    pred = seg.model.sem_seg_head.predictor
    with torch.no_grad():
        pred._transformer_class_head.weight.mul_(20.0)
        pred._transformer_class_head.bias.mul_(20.0)
        pred._pixel_space_mask_batch_norm.weight.mul_(100.0)
    return seg


@pytest.mark.cuda
def test_small_kmax_bf16_card_matches_cpu():
    """The small kMaX in bf16 (compute_dtype) on the card against the CPU
    from one state dict, unit by unit as chip_smoke's crosscheck_kmax
    (models/kmax/diagnostics.py): every unit call of the CPU's forward run
    again on the card on the CPU's inputs, within UNIT_KINDS' limit (2
    bf16 ulps of the output's largest magnitude, or twice the unit's own
    bf16 rounding on those inputs where that is more), with the ConvNeXt
    layer scales at 0.1 so that B2 shows in a block's output; a ConvBN
    whose BN scale is 5% off fails it. Whole forward, each k-means
    assignment taken from the CPU's run: class and mask logits in bf16,
    finite; B2 launched once per ConvNeXt block."""
    import copy

    from spatially_aware_ai_tpu_torch.data import SyntheticSceneDataset
    from spatially_aware_ai_tpu_torch.models.kmax import diagnostics as D
    from spatially_aware_ai_tpu_torch.models.kmax import model as KM

    dev = _card()
    bf = torch.bfloat16
    small = _small_kmax("cpu", bf)
    sd = {k: torch.full_like(v, 0.1) if k.endswith(".gamma") else v
          for k, v in small.model.state_dict().items()}
    cpu, card = (KM.KmaxSegmenter(small.cfg, sd, device=d, compute_dtype=bf)
                 for d in ("cpu", dev))
    ds = SyntheticSceneDataset(num_frames=2, width=128, height=96)
    rgbs = torch.from_numpy(np.stack([ds[i].rgb for i in range(2)]))
    new_h, new_w, pad_h, pad_w = cpu._test_shape(96, 128)
    imgs = KM.prep_batch(rgbs, new_h, new_w, pad_h, pad_w)
    with torch.inference_mode():
        with D.kmeans_logits(cpu.model) as recorded, \
                D.unit_calls(cpu.model) as calls:
            cpu.model(imgs)
        dists = D.unit_distances(card.model, cpu.model, calls)
        over = [d for d in dists if d[3] > d[5]]
        assert not over, over[:5]
        assert {d[0] for d in dists} == set(D.UNIT_KINDS)
        _, unit, _, args, want = next(
            c for c in calls if c[1].endswith("_pixel_space_head_last_convbn"))
        broken = copy.deepcopy(card.model.get_submodule(unit))
        broken.norm.weight.mul_(1.05)
        limit = next(d[5] for d in dists if d[1] == unit)
        assert A.max_bf16_ulps(broken(args[0].to(dev)), want) > limit
        n0 = L.launches
        with D.kmeans_logits(card.model, recorded):
            got = card.model(imgs.to(dev))
    assert L.launches == n0 + sum(card.cfg.backbone.depths)
    assert all(g.dtype == bf and bool(torch.isfinite(g.float()).all())
               for g in got)


@pytest.mark.cuda
def test_bf16_argmax_takes_the_first_tied_maximum_on_card():
    """bf16 mask logits tie often; the k-means assignment takes the first
    maximal index (jnp.argmax's rule) on the card as on the CPU, at the
    full-width os8 shape ([20336, 128]) with rows that tie two, three or
    all of the queries, and the pooled update of a k-means layer fed those
    logits takes the same pixels into the same clusters on both."""
    from spatially_aware_ai_tpu_torch.models.kmax import model as KM

    dev = _card()
    rng = np.random.default_rng(23)
    P, N = 164 * 124, 128
    logits = (0.1 * rng.normal(size=(P, N))).astype(np.float32)
    rows = rng.choice(P, size=3000, replace=False)
    for i, r in enumerate(rows):
        k = (2, 3, N)[i % 3]
        qs = rng.choice(N, size=k, replace=False)
        # 0.5 + j * 2^-16 (j < 128) rounds to 0.5 in bf16
        logits[r, qs] = 0.5 + np.arange(k) * 2.0 ** -16
    lt = torch.from_numpy(logits).to(torch.bfloat16)
    tied = lt == lt.amax(-1, keepdim=True)
    first = torch.where(tied, torch.arange(N), N).amin(-1)
    assert torch.equal(lt.argmax(-1), first)
    assert torch.equal(lt.to(dev).argmax(-1).cpu(), first)
    assert int(tied.sum(-1).max()) == N and int((tied.sum(-1) > 1).sum()) \
        >= len(rows)

    seg = KM.KmaxSegmenter.random(KM.KMAX_TINY_TEST, seed=0, device="cpu",
                                  compute_dtype=torch.bfloat16)
    lay = seg.model.sem_seg_head.transformer_decoder \
        ._kmax_transformer_layers[0]
    h, w = 4, 6
    small = torch.from_numpy(logits[rows[:h * w], :16].reshape(1, h, w, 16)
                             ).to(torch.bfloat16)
    query = torch.from_numpy(rng.normal(size=(1, 16, 32)).astype(
        np.float32)).to(torch.bfloat16)
    pixel = torch.from_numpy(rng.normal(size=(1, h, w, 32)).astype(
        np.float32)).to(torch.bfloat16)
    with torch.inference_mode():
        want = lay(query, pixel, small)
        lay.to(dev)
        got = lay(query.to(dev), pixel.to(dev), small.to(dev)).cpu()
    assert A.max_bf16_ulps(got, want) <= 2.0


@pytest.mark.cuda
def test_small_kmax_bf16_logits_do_not_depend_on_the_batch_split():
    """C14 in bf16 on the card: the small kMaX's logits of 4 frames in one
    batch and in 2-frame slices are the same bits, and so are its fused
    labels."""
    from spatially_aware_ai_tpu_torch.data import SyntheticSceneDataset
    from spatially_aware_ai_tpu_torch.models.kmax import model as KM

    dev = _card()
    seg = _small_kmax(dev, torch.bfloat16)
    ds = SyntheticSceneDataset(num_frames=4, width=128, height=96)
    rgbs = torch.from_numpy(np.stack([ds[i].rgb for i in range(4)])).to(dev)
    new_h, new_w, pad_h, pad_w = seg._test_shape(96, 128)
    with torch.inference_mode():
        imgs = KM.prep_batch(rgbs, new_h, new_w, pad_h, pad_w)
        whole = seg.model(imgs)
        parts = [seg.model(imgs[i:i + 2]) for i in (0, 2)]
    for j in range(2):
        assert whole[j].dtype == torch.bfloat16
        assert torch.equal(whole[j], torch.cat([p[j] for p in parts]))
    labels = seg.run_on_batch_fused_labels(rgbs, as_numpy=False)
    split = torch.cat([seg.run_on_batch_fused_labels(rgbs[i:i + 2],
                                                     as_numpy=False)
                       for i in (0, 2)])
    assert (labels != KM.NULL_ID).any() and torch.equal(labels, split)


@pytest.mark.cuda
def test_f32_forwards_do_not_depend_on_the_callers_tf32_flags():
    """ROADMAP C10: kMaX's logits and fused labels, CLIP's image and text
    features and the DGCNN's logits on the card are the same under torch's
    default flags and after a caller allows TF32 everywhere as under both
    flags off (within 1e-6 of each output's scale: the same kernels on the
    same inputs; one TF32 pass moves them by about 1e-3)."""
    from spatially_aware_ai_tpu_torch.data import SyntheticSceneDataset
    from spatially_aware_ai_tpu_torch.models.clip.engine import (
        SMALL_CARD_CONFIG, ClipEngine)
    from spatially_aware_ai_tpu_torch.models.dgcnn import DGCNN, DGCNNConfig
    from spatially_aware_ai_tpu_torch.models.kmax import model as KM

    dev = _card()
    ds = SyntheticSceneDataset(num_frames=2, width=128, height=96)
    rgbs = torch.from_numpy(np.stack([ds[i].rgb for i in range(2)]))
    seg = _small_kmax(dev)
    clip = ClipEngine.random(SMALL_CARD_CONFIG, seed=0, device=dev)
    net = DGCNN(DGCNNConfig()).init_random_(
        torch.Generator().manual_seed(0)).to(dev).eval()
    pts = torch.from_numpy(np.random.default_rng(22).normal(
        size=(8, 30, 518)).astype(np.float32)).to(dev)
    H, W = rgbs.shape[1:3]
    new_h, new_w, pad_h, pad_w = seg._test_shape(H, W)

    def outputs():
        with torch.inference_mode():
            imgs = KM.prep_batch(rgbs.to(dev), new_h, new_w, pad_h, pad_w)
            cls, masks = seg.model(imgs)
            return {"kmax_class": cls, "kmax_masks": masks,
                    "labels": seg.run_on_batch_fused_labels(
                        rgbs, as_numpy=False),
                    "clip_image": clip.img_inference_tiled_batch(
                        rgbs.to(dev), 64, 32),
                    "clip_text": clip._encode_text(clip.tokenizer(
                        ["a red box", "the floor"])),
                    "dgcnn": net(pts)}

    def with_flags(matmul, cudnn):
        torch.set_float32_matmul_precision(matmul)
        torch.backends.cudnn.allow_tf32 = cudnn
        try:
            return outputs()
        finally:
            torch.set_float32_matmul_precision("highest")
            torch.backends.cudnn.allow_tf32 = True   # torch's defaults

    off = with_flags("highest", False)
    assert (off["labels"] != KM.NULL_ID).any()
    for run in (outputs(), with_flags("high", True)):
        assert torch.equal(run["labels"], off["labels"])
        for name in ("kmax_class", "kmax_masks", "clip_image", "clip_text",
                     "dgcnn"):
            scale = float(off[name].abs().max())
            err = float((run[name] - off[name]).abs().max())
            assert err <= 1e-6 * scale, (name, err, scale)


@pytest.mark.cuda
def test_dgcnn_on_card_matches_the_cpu():
    """The full-width DGCNN (k 20, emb 1024) in eval mode on the card
    against the same module on the CPU, in float64: 1e-4 abs. In f32 the
    two sum in other orders, and the kNN choice is discrete: where two
    candidates nearly tie for a point's 20th neighbour, a last-bit
    difference can pick the other one. In f32 on these inputs one logit of
    800 moved by 0.0104, the rest by under 1e-6. The f32 path on the card
    is held by the TF32 test above."""
    from spatially_aware_ai_tpu_torch.models.dgcnn import DGCNN, DGCNNConfig

    dev = _card()
    rng = np.random.default_rng(23)
    net = DGCNN(DGCNNConfig()).init_random_(torch.Generator().manual_seed(1))
    for mod in net.modules():   # BatchNorm statistics off their initial values
        if hasattr(mod, "running_var"):
            mod.running_mean.copy_(torch.from_numpy(
                0.1 * rng.normal(size=mod.running_mean.shape)))
            mod.running_var.copy_(torch.from_numpy(
                rng.uniform(0.5, 2.0, size=mod.running_var.shape)))
    net.double().eval()
    pts = torch.from_numpy(rng.normal(size=(16, 30, 518)))
    with torch.no_grad():
        want = net(pts)
        got = net.to(dev)(pts.to(dev)).cpu()
    assert float((got - want).abs().max()) <= 1e-4


# ---------------------------------------------------------------- serving


@pytest.mark.cuda
def test_create_app_on_the_card_answers_text_query_through_b5(tmp_path):
    """The port's HTTP app over a manager on the card: /reprocess_scan
    fuses a small scene with B1, B2 and B5; a /text_query whose label bank
    changed encodes it through B5 and B2; the answer equals the CPU
    manager's on the same weights: faces equal, vertices within 1e-4 m
    (marching cubes divides the tsdf's rounding by its step across an
    edge), colours within 1e-4."""
    import io
    import json
    import os
    from urllib.parse import urlencode

    from spatially_aware_ai_tpu_torch.data import (
        ColorSegmenter, SyntheticScene)
    from spatially_aware_ai_tpu_torch.manager import InSituManager
    from spatially_aware_ai_tpu_torch.models.clip.engine import (
        SMALL_CARD_CONFIG, ClipEngine)
    from spatially_aware_ai_tpu_torch.server import create_app

    _card()
    d = tmp_path / "scans" / "demo" / "v00"
    os.makedirs(d)
    (d / "synthetic_scene.json").write_text(json.dumps(
        {"num_frames": 6, "width": 96, "height": 72}))

    def post(app, path, data):
        body = urlencode(data).encode()
        out = {}
        chunks = app({"REQUEST_METHOD": "POST", "PATH_INFO": path,
                      "CONTENT_TYPE": "application/x-www-form-urlencoded",
                      "CONTENT_LENGTH": str(len(body)),
                      "wsgi.input": io.BytesIO(body), "QUERY_STRING": ""},
                     lambda status, headers: out.update(status=status))
        return int(out["status"].split()[0]), json.loads(b"".join(chunks))

    answers = {}
    for dev in ("cpu", "cuda"):
        manager = InSituManager(
            scan_dir=str(tmp_path / "scans"), scan_name="demo",
            dataset="synthetic", output_dir=str(tmp_path / f"out_{dev}"),
            device=dev, voxel_size=0.06, trunc_vox=2, clip_patch_size=48,
            clip_patch_stride=24, frame_chunk=3, auto_reconstruct=False,
            clip_engine=ClipEngine.random(SMALL_CARD_CONFIG, seed=0,
                                          device=dev),
            seg_model=ColorSegmenter(SyntheticScene.demo_room()))
        app = create_app(manager)
        S.launches = L.launches = A.launches = 0
        assert post(app, "/reprocess_scan", {"version": 0})[0] == 200
        fused = (S.launches, L.launches, A.launches)
        L.launches = A.launches = 0
        status, answers[dev] = post(app, "/text_query",
                                    {"text_query": "show me the table"})
        assert status == 200
        if dev == "cuda":
            assert all(n > 0 for n in fused), fused
            assert A.launches > 0 and L.launches > 0
        manager._wait_for_save()
    a, b = answers["cpu"], answers["cuda"]
    assert a["faces"] == b["faces"]
    np.testing.assert_allclose(a["vertices"], b["vertices"], atol=1e-4)
    np.testing.assert_allclose(a["colors"], b["colors"], atol=1e-4)


# ---------------------------------------------------------------- live


@pytest.mark.cuda
def test_device_upsample_on_card_matches_host_sampler():
    """core/upsample.py on the card, with the caller allowing TF32 for
    cuBLAS: the enlarged depth within 1 mm of the host's cubic evaluation
    (sample_upsampled_u16, f32 on the CPU) at 20,000 pixels of a 192x256
    frame enlarged 4x (one TF32 pass would move metres of depth by
    millimetres: the products are pinned to full f32)."""
    from spatially_aware_ai_tpu_torch.core.upsample import (
        sample_upsampled_u16, upsample_depth_u16_device)

    dev = _card()
    rng = np.random.default_rng(5)
    d = rng.integers(300, 6000, (2, 192, 256)).astype(np.uint16)
    d[:, ::7, ::5] = 0
    saved = (torch.get_float32_matmul_precision(),
             torch.backends.cuda.matmul.allow_tf32)
    torch.set_float32_matmul_precision("high")
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = upsample_depth_u16_device(d, 4, device=dev).cpu().numpy()
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cuda.matmul.allow_tf32 = saved[1]
    assert got.shape == (2, 768, 1024) and got.dtype == np.float32
    uu, vv = rng.integers(0, 1024, 20000), rng.integers(0, 768, 20000)
    for f in range(2):
        ref = sample_upsampled_u16(d[f], uu, vv, 4)
        assert np.abs(got[f, vv, uu] - ref).max() <= 1e-3


@pytest.mark.cuda
def test_i420_decode_on_card_matches_host_decode():
    """core/yuv.py: the card's decode of packed 4:2:0 planes, rounded to
    u8, within one step of the host decode (the same inverse matrix)."""
    from spatially_aware_ai_tpu_torch.core.yuv import (
        i420_to_rgb_device, i420_to_rgb_u8, rgb_u8_to_i420)

    dev = _card()
    rgb = np.random.default_rng(6).integers(0, 256, (3, 72, 96, 3),
                                            dtype=np.uint8)
    planes = rgb_u8_to_i420(rgb)
    got = i420_to_rgb_device(planes, 72, device=dev)
    assert got.device.type == "cuda" and got.dtype == torch.float32
    got = np.rint(got.cpu().numpy() * 255.0)
    assert np.abs(got - i420_to_rgb_u8(planes).astype(np.float64)).max() <= 1


@pytest.mark.cuda
def test_live_copy_unchanged_by_a_concurrent_push_on_card():
    """The live session's in-place trap on the card: a preview copy and a
    snapshot copy taken under the session lock keep the grid as it was
    while a push on another thread integrates the next chunk (through
    kernel B1, the hybrid) into the live grid right after."""
    import threading

    from spatially_aware_ai_tpu_torch.data import (
        ColorSegmenter, SyntheticScene, SyntheticSceneDataset)
    from spatially_aware_ai_tpu_torch.manager.live import LiveScanSession
    from spatially_aware_ai_tpu_torch.models.clip.engine import (
        SMALL_CARD_CONFIG, ClipEngine)
    from spatially_aware_ai_tpu_torch.pipeline import FusionConfig

    dev = _card()
    st = SyntheticSceneDataset(num_frames=9, width=96,
                               height=72).stacked_u8()
    depth = np.rint(st["depth"] * 1000).astype(np.uint16)
    sess = LiveScanSession(
        ClipEngine.random(SMALL_CARD_CONFIG, seed=0, device=dev),
        ColorSegmenter(SyntheticScene.demo_room()),
        FusionConfig(voxel_size=0.06, trunc_vox=2, clip_patch_size=48,
                     clip_patch_stride=24, frame_chunk=3, with_labels=True),
        device=dev)
    assert sess._integrator() == "einsum"
    sess.push(st["rgb"][:3], depth[:3], st["pose"][:3], st["K"][:3])
    keys = ("tsdf_sum", "tsdf_w", "rgb_sum", "feat_sum", "w", "label_hist")
    before = {k: getattr(sess.grid, k).cpu() for k in keys}
    S.launches = 0
    preview = sess.preview_grid()
    snap = sess.snapshot_state()["grid"]
    pusher = threading.Thread(target=sess.push, args=(
        st["rgb"][3:9], depth[3:9], st["pose"][3:9], st["K"][3:9]))
    pusher.start()
    pusher.join()
    torch.cuda.synchronize()
    assert sess.frames_integrated == 9 and S.launches == 2
    assert not torch.equal(sess.grid.tsdf_w.cpu(), before["tsdf_w"])
    for copy in (preview, snap):
        for k in keys:
            assert torch.equal(getattr(copy, k).cpu(), before[k]), k


def _shard_scene(dev, N_side=(40, 36, 30), F=4, H=96, W=128, C=64, seed=3):
    """A box of voxels in front of F jittered cameras, with random depth,
    rgb, feature images and labels, on `dev`."""
    from spatially_aware_ai_tpu_torch.grid.voxel_grid import FrameBatch

    rng = np.random.default_rng(seed)
    pose = np.tile(np.eye(4, dtype=np.float32), (F, 1, 1))
    pose[:, :3, 3] = rng.normal(scale=0.05, size=(F, 3))
    K = np.tile(np.array([[100.0, 0, W / 2], [0, 100.0, H / 2], [0, 0, 1]],
                         np.float32), (F, 1, 1))

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    batch = FrameBatch(
        depth=t(rng.uniform(0.6, 1.6, (F, H, W)).astype(np.float32)),
        rgb=t(rng.uniform(0, 1, (F, H, W, 3)).astype(np.float32)),
        pose=t(pose), K=t(K),
        feat_img=t(rng.normal(size=(F, 4, 5, C)).astype(np.float32)),
        labels=t(rng.integers(0, 20, (F, H, W)).astype(np.int32)),
        frame_valid=t(np.ones(F, bool)))
    grid_kw = dict(origin=np.array([-0.4, -0.36, 0.5], np.float32),
                   voxel_size=0.02, nvox=N_side, trunc=0.06, feature_dim=C,
                   with_labels=True, num_classes=20)
    return grid_kw, batch


@pytest.mark.cuda
@pytest.mark.parametrize("integrator", ["einsum", "sparse", "brick", "scan"])
def test_sharded_integrators_on_a_two_entry_card_mesh(integrator):
    """Each integrator on a mesh of 2 x cuda:0 (two shards, two streams)
    against the unsharded run on the card and the CPU: integer
    accumulators exact, float sums within 1e-5; B1 launches once per
    shard for the kernel integrators."""
    from spatially_aware_ai_tpu_torch.grid.brick import integrate_frames_brick
    from spatially_aware_ai_tpu_torch.grid.fusion import (
        integrate_frames,
        integrate_frames_pallas,
        integrate_frames_sparse,
    )
    from spatially_aware_ai_tpu_torch.grid.voxel_grid import create_grid
    from spatially_aware_ai_tpu_torch.parallel import (
        gather_grid,
        integrate_frames_sharded,
        make_mesh,
        shard_grid,
    )
    from spatially_aware_ai_tpu_torch.parallel.sharded import frames_to

    dev = _card()
    grid_kw, batch = _shard_scene(dev)
    one_fn = {"einsum": integrate_frames_pallas,
              "sparse": integrate_frames_sparse,
              "brick": integrate_frames_brick,
              "scan": integrate_frames}[integrator]
    mesh = make_mesh(devices=["cuda:0"] * 2)
    assert len(mesh.distinct) == 1
    sg = shard_grid(mesh, create_grid(pad_to=2, min_padding=1, device=dev,
                                      **grid_kw))
    s0 = S.launches
    with torch.inference_mode():
        integrate_frames_sharded(mesh, sg, batch, integrator=integrator)
    launches = S.launches - s0
    got = gather_grid(sg)
    torch.cuda.synchronize()
    assert launches == (0 if integrator == "scan" else 2)
    refs = []
    for d in (dev, torch.device("cpu")):
        g = create_grid(pad_to=2, min_padding=1, device=d, **grid_kw)
        with torch.inference_mode():
            one_fn(g, frames_to(batch, d))
        refs.append(g)
    for ref in refs:
        for k in ("tsdf_w", "w", "label_hist"):
            a, b = getattr(got, k).cpu(), getattr(ref, k).cpu()
            if a.dtype == torch.uint16:
                a, b = a.view(torch.int16), b.view(torch.int16)
            assert torch.equal(a, b), k
        for k in ("tsdf_sum", "rgb_sum", "feat_sum"):
            torch.testing.assert_close(getattr(got, k).cpu(),
                                       getattr(ref, k).cpu(), rtol=0,
                                       atol=1e-5)
    assert int(got.w.sum()) > 0


@pytest.mark.cuda
def test_depthscaled_tiles_on_card_match_the_cpu():
    """The depth-scaled tiler on the card (B2 and B5 in the forward)
    against the CPU on one state dict: cosine >= 0.9999 per cell, 1e-4
    absolute; cells of centres with no depth zero on both."""
    from spatially_aware_ai_tpu_torch.models.clip.engine import (
        SMALL_CARD_CONFIG,
        ClipEngine,
    )

    dev = _card()
    cpu = ClipEngine.random(SMALL_CARD_CONFIG, seed=0, device="cpu")
    card = ClipEngine(SMALL_CARD_CONFIG, cpu.model.state_dict(),
                      device=dev)
    rng = np.random.default_rng(4)
    F, H, W = 2, 96, 128
    img = rng.uniform(size=(F, H, W, 3)).astype(np.float32)
    depth = rng.uniform(0.5, 3.0, size=(F, H, W)).astype(np.float32)
    depth[:, 32, :] = 0
    K = np.tile(np.array([[90.0, 0, W / 2], [0, 90.0, H / 2], [0, 0, 1]],
                         np.float32), (F, 1, 1))
    l0, a0 = L.launches, A.launches
    got = card.img_inference_tiled_depthscaled(img, depth, K, 32,
                                               footprint_m=0.5).cpu()
    assert L.launches > l0 and A.launches > a0
    want = cpu.img_inference_tiled_depthscaled(img, depth, K, 32,
                                               footprint_m=0.5)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    a, b = got.reshape(-1, got.shape[-1]), want.reshape(-1, got.shape[-1])
    live = b.norm(dim=1) > 0
    cos = (a[live] * b[live]).sum(1) / (a[live].norm(dim=1)
                                        * b[live].norm(dim=1))
    assert float(cos.min()) >= 0.9999
    assert torch.equal(a[~live], b[~live])


# ------------------------------------------------ checkpoints and repeats


@pytest.mark.cuda
def test_converted_small_models_equal_their_sources_on_card(tmp_path):
    """A small CLIP converted through cli.convert_clip (open_clip names)
    and a small kMaX through convert_kmax_checkpoint, loaded with
    `from_checkpoint` on the card: image and text features, kMaX logits
    and fused labels bitwise equal to the source models'."""
    import dataclasses
    import gzip
    import pickle

    from spatially_aware_ai_tpu_torch.cli import convert_clip
    from spatially_aware_ai_tpu_torch.data import SyntheticSceneDataset
    from spatially_aware_ai_tpu_torch.models.clip.engine import (
        SMALL_CARD_CONFIG, ClipEngine)
    from spatially_aware_ai_tpu_torch.models.kmax import model as KM
    from spatially_aware_ai_tpu_torch.models.kmax.convert import (
        convert_kmax_checkpoint)

    dev = _card()
    merges = str(tmp_path / "merges.txt.gz")
    with gzip.open(merges, "wt", encoding="utf-8") as f:
        f.write("#version: 0.2\nr e\nre d</w>\nb o\nbo x</w>\n")
    clip = ClipEngine.random(SMALL_CARD_CONFIG, seed=0, bpe_path=merges,
                             device=dev)
    torch.save({k: v.cpu() for k, v in clip.model.state_dict().items()},
               tmp_path / "clip.bin")
    convert_clip.main([str(tmp_path / "clip.bin"),
                       str(tmp_path / "clip.pkl")])
    conv = ClipEngine.from_checkpoint(str(tmp_path / "clip.pkl"),
                                      bpe_path=merges, device=dev)
    assert conv.cfg == SMALL_CARD_CONFIG
    seg = _small_kmax(dev)
    sd = {k: v.cpu() for k, v in seg.model.state_dict().items()}
    with open(tmp_path / "kmax.pkl", "wb") as f:
        pickle.dump({"format": "sai_kmax_variables",
                     "config": dataclasses.asdict(seg.cfg),
                     "variables": convert_kmax_checkpoint(sd, seg.cfg)}, f)
    seg_conv = KM.KmaxSegmenter.from_checkpoint(str(tmp_path / "kmax.pkl"),
                                                device=dev)
    ds = SyntheticSceneDataset(num_frames=2, width=128, height=96)
    rgbs = torch.from_numpy(np.stack([ds[i].rgb for i in range(2)]))
    tokens = clip.tokenizer(["a red box", "the floor"])
    new_h, new_w, pad_h, pad_w = seg._test_shape(96, 128)
    with torch.inference_mode():
        imgs = KM.prep_batch(rgbs.to(dev), new_h, new_w, pad_h, pad_w)
        assert torch.equal(clip.img_inference_tiled_batch(rgbs.to(dev), 64,
                                                          32),
                           conv.img_inference_tiled_batch(rgbs.to(dev), 64,
                                                          32))
        assert torch.equal(clip._encode_text(tokens),
                           conv._encode_text(tokens))
        for x, y in zip(seg.model(imgs), seg_conv.model(imgs)):
            assert torch.equal(x, y)
    labels = seg_conv.run_on_batch_fused_labels(rgbs, as_numpy=False)
    assert (labels != KM.NULL_ID).any()
    assert torch.equal(seg.run_on_batch_fused_labels(rgbs, as_numpy=False),
                       labels)


@pytest.mark.cuda
def test_text_encodes_are_bitwise_repeatable_on_card():
    """ROADMAP C15: the full-width CLIP's prompt-ensemble encode of one
    label bank gives the same bits on every call, on the calling thread
    and on a fresh one (the HTTP server answers on handler threads)."""
    import threading

    from spatially_aware_ai_tpu_torch.models.clip.engine import ClipEngine
    from spatially_aware_ai_tpu_torch.query.text import CONTROL_OBJECTS

    dev = _card()
    engine = ClipEngine.random(seed=0, device=dev)
    bank = CONTROL_OBJECTS[:6]
    first = engine.encode_text_with_prompt_ensemble(bank)
    again = [engine.encode_text_with_prompt_ensemble(bank) for _ in range(2)]
    box = []
    t = threading.Thread(target=lambda: box.append(
        engine.encode_text_with_prompt_ensemble(bank)))
    t.start()
    t.join(timeout=120)
    assert not t.is_alive() and len(box) == 1
    for other in again + box:
        np.testing.assert_array_equal(other, first)


@pytest.mark.cuda
def test_object_query_pooling_is_bitwise_repeatable_on_card():
    """ROADMAP C15: the manager's per-object pooling gives the same bits
    on every call (index_add_'s float atomics did not), and agrees with
    the CPU within 1e-5 of the logits' scale."""
    from spatially_aware_ai_tpu_torch.manager.manager import (
        _object_query_logits)

    dev = _card()
    rng = np.random.default_rng(31)
    V, C, S = 200_000, 512, 23
    feats = rng.normal(size=(V, C)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    seg = rng.integers(0, S, V)
    text = rng.normal(size=(40, C)).astype(np.float32)
    args = [torch.from_numpy(a) for a in (feats, seg, text)]
    on_card = [_object_query_logits(*[a.to(dev) for a in args], S)
               for _ in range(4)]
    for other in on_card[1:]:
        assert torch.equal(other, on_card[0])
    cpu = _object_query_logits(*args, S)
    scale = float(cpu.abs().max())
    assert float((on_card[0].cpu() - cpu).abs().max()) <= 1e-5 * scale


@pytest.mark.cuda
def test_full_width_kmax_labels_do_not_depend_on_the_batch_split():
    """ROADMAP C14, pinned: the full-width painting kMaX on 4 frames of
    1024x768 in one batch and in 2-frame slices gives the same fused
    labels on 100% of the pixels (before the head ran one frame at a time,
    99.45% at 8 frames) and the same logits."""
    from spatially_aware_ai_tpu_torch.data import SyntheticSceneDataset
    from spatially_aware_ai_tpu_torch.models.kmax import model as KM

    dev = _card()
    seg = KM.KmaxSegmenter.random(seed=0, device=dev)
    pred = seg.model.sem_seg_head.predictor
    with torch.no_grad():
        pred._transformer_class_head.weight.mul_(20.0)
        pred._transformer_class_head.bias.mul_(20.0)
        pred._pixel_space_mask_batch_norm.weight.mul_(100.0)
    ds = SyntheticSceneDataset(num_frames=4, width=1024, height=768)
    rgbs = torch.from_numpy(np.stack([ds[i].rgb for i in range(4)])).to(dev)
    new_h, new_w, pad_h, pad_w = seg._test_shape(768, 1024)
    with torch.inference_mode():
        imgs = KM.prep_batch(rgbs, new_h, new_w, pad_h, pad_w)
        whole = seg.model(imgs)
        parts = [seg.model(imgs[i:i + 2]) for i in (0, 2)]
    for j in range(2):
        assert torch.equal(whole[j], torch.cat([p[j] for p in parts]))
    labels = seg.run_on_batch_fused_labels(rgbs, as_numpy=False)
    split = torch.cat([seg.run_on_batch_fused_labels(rgbs[i:i + 2],
                                                     as_numpy=False)
                       for i in (0, 2)])
    assert (labels != KM.NULL_ID).any()
    assert float((labels == split).float().mean()) == 1.0


# --------------------------------------- offline CLIs and native helpers


@pytest.mark.cuda
def test_img_inference_tiled_on_card_matches_the_cpu():
    """One frame's tiled features (cli.test2d's path) on the card, B2 and
    B5 in the forward, against the CPU on one state dict: 1e-4 absolute,
    cosine >= 0.9999 per patch; 256/128 tiles take the whole-frame resize,
    40/20 the per-tile one."""
    from spatially_aware_ai_tpu_torch.models.clip.engine import (
        SMALL_CARD_CONFIG,
        ClipEngine,
    )

    dev = _card()
    cpu = ClipEngine.random(SMALL_CARD_CONFIG, seed=0, device="cpu")
    card = ClipEngine(SMALL_CARD_CONFIG, cpu.model.state_dict(),
                      device=dev)
    rng = np.random.default_rng(6)
    for (H, W), (ps, st) in (((384, 512), (256, 128)), ((60, 80), (40, 20))):
        img = rng.uniform(size=(H, W, 3)).astype(np.float32)
        l0, a0 = L.launches, A.launches
        got = card.img_inference_tiled(img, ps, st).cpu()
        assert L.launches - l0 == A.launches - a0 == \
            SMALL_CARD_CONFIG.vision_layers
        want = cpu.img_inference_tiled(img, ps, st)
        assert got.shape == want.shape == (
            (H - ps) // st + 1, (W - ps) // st + 1, SMALL_CARD_CONFIG.embed_dim)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
        a = got.reshape(-1, got.shape[-1])
        b = want.reshape(-1, got.shape[-1])
        cos = (a * b).sum(1) / (a.norm(dim=1) * b.norm(dim=1))
        assert float(cos.min()) >= 0.9999


@pytest.mark.cuda
def test_doctor_device_check_on_card():
    from spatially_aware_ai_tpu_torch.cli import doctor

    _card()
    out = doctor._check_device(120.0)
    assert out["status"] == "ok", out
    assert tuple(out["capability"]) >= (9, 0)
    assert out["n_devices"] == torch.cuda.device_count()
    assert out["device_name"] == torch.cuda.get_device_name(0)


@pytest.mark.cuda
def test_native_helpers_build_on_the_cards_machine():
    """The C++ helpers build there (g++), and the native marching cubes
    give numpy's geometry; the components equal scipy's."""
    from spatially_aware_ai_tpu_torch import native
    from spatially_aware_ai_tpu_torch.meshing.marching import marching_cubes
    from spatially_aware_ai_tpu_torch.scene import objects

    _card()
    assert native.get_lib() is not None
    x, y, z = np.meshgrid(*[np.linspace(-1, 1, 20)] * 3, indexing="ij")
    vol = (np.sqrt(x ** 2 + y ** 2 + z ** 2) - 0.6).astype(np.float32)
    vol[:4, :4, :4] = np.nan
    nv, nf = native.marching_cubes_native(vol)
    pv, pf = marching_cubes(vol)
    assert len(nv) == len(pv) and len(nf) == len(pf) > 100
    np.testing.assert_allclose(np.sort(nv, axis=0), np.sort(pv, axis=0),
                               atol=1e-6)
    grid = np.random.default_rng(3).integers(0, 4, size=(10, 9, 8))
    grid = grid.astype(np.int32)
    grid[grid == 3] = 133
    comps = objects.connected_components_3d(grid)
    saved = native.connected_components_native
    try:
        native.connected_components_native = lambda g, null_id=133: None
        plain = objects.connected_components_3d(grid)
    finally:
        native.connected_components_native = saved
    assert len(comps) == len(plain) > 3
    for (c1, v1), (c2, v2) in zip(comps, plain):
        assert c1 == c2
        for a, b in zip(v1, v2):
            np.testing.assert_array_equal(a, b)
