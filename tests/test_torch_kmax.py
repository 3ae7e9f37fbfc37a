"""The port's kMaX-DeepLab slice on the CPU against the JAX package: the
ConvNeXt block (B2's plain version vs the Pallas kernel in interpret mode)
and the tiny KMaxDeepLab forward within 1e-4 abs; detectron2-named weights
loaded and converted both ways; the claim paint (B3's plain version vs the
Pallas kernel in interpret mode), panoptic inference, the nearest resize
and the seam nulling exactly; and fuse_scan through the device-fused
labels branch with the same label histogram and TSDF weights. Then the
model in bf16 against the JAX package's compute_dtype=jnp.bfloat16, module
by module and whole (each k-means assignment shared), in bf16 ulps of the
largest magnitude."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatially_aware_ai_tpu.data import SyntheticSceneDataset as JaxDataset
from spatially_aware_ai_tpu.models.clip.engine import ClipEngine as JaxEngine
from spatially_aware_ai_tpu.models.kmax import convnext as JC
from spatially_aware_ai_tpu.models.kmax import model as JM
from spatially_aware_ai_tpu.models.kmax.convert import convert_kmax_checkpoint
from spatially_aware_ai_tpu.models.kmax.pallas_paint import (
    paint_masks as jax_paint_masks,
)
from spatially_aware_ai_tpu.pipeline import (
    FusionConfig as JaxConfig,
    fuse_scan as jax_fuse_scan,
)
from spatially_aware_ai_tpu_torch.data import SyntheticSceneDataset
from spatially_aware_ai_tpu_torch.models.attention import max_bf16_ulps
from spatially_aware_ai_tpu_torch.models.clip.engine import ClipEngine
from spatially_aware_ai_tpu_torch.models.kmax import convnext as TC
from spatially_aware_ai_tpu_torch.models.kmax import model as TM
from spatially_aware_ai_tpu_torch.models.kmax.convert import (
    kmax_state_dict_from_jax,
)
from spatially_aware_ai_tpu_torch.models.kmax.diagnostics import kmeans_logits
from spatially_aware_ai_tpu_torch.models.kmax.paint import paint_masks_plain
from spatially_aware_ai_tpu_torch.pipeline import FusionConfig, fuse_scan

CFG = JM.KMAX_TINY_TEST


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=1)
def _initial_variables():
    """The tiny JAX KMaxDeepLab's initial variables (numpy); their shapes
    do not depend on the image size."""
    probe = jnp.zeros((1, 64, 64, 3), jnp.float32)
    return _np_tree(jax.jit(JM.KMaxDeepLab(CFG).init)(jax.random.PRNGKey(0),
                                                      probe))


def _jax_variables(seed, perturb=True):
    """The initial variables with BN statistics, relative-position biases
    and layer scales moved off their initial values (from `seed`), so that
    every conversion is exercised."""
    rng = np.random.default_rng(seed)

    def walk(t, path):
        if isinstance(t, dict):
            return {k: walk(s, path + (k,)) for k, s in t.items()}
        leaf, noise = path[-1], rng.normal(size=t.shape).astype(np.float32)
        if not perturb:
            return t
        if leaf == "var":
            return (t * rng.uniform(0.8, 1.25, t.shape)).astype(np.float32)
        if leaf in ("scale", "bias", "mean") and "bn" in "".join(path[-2:]):
            return t + 0.05 * noise
        if leaf in ("rel_bias", "gamma"):
            return 0.05 * noise
        return t

    return walk(_initial_variables(), ())


def _torch_model(variables, cfg=CFG):
    m = TM.KMaxDeepLab(cfg)
    m.load_state_dict(kmax_state_dict_from_jax(variables))
    return m.eval()


def _dwconv_f64(x, p):
    """The block's depthwise 7x7 SAME conv in float64."""
    x = x.astype(np.float64)
    k = p["dwconv"]["kernel"].astype(np.float64)  # [7, 7, 1, C]
    H, W = x.shape[1:3]
    xp = np.pad(x, ((0, 0), (3, 3), (3, 3), (0, 0)))
    return sum(xp[:, dy:dy + H, dx:dx + W] * k[dy, dx, 0]
               for dy in range(7) for dx in range(7)) + p["dwconv"]["bias"]


def _convnext_block_f64(x, p):
    """The ConvNeXt block evaluated in float64 with numpy: depthwise 7x7
    SAME conv, LayerNorm (eps 1e-6), Dense, exact gelu, Dense, layer scale
    and residual."""
    from scipy.special import erf

    h = _dwconv_f64(x, p)
    x = x.astype(np.float64)
    mu = h.mean(-1, keepdims=True)
    var = ((h - mu) ** 2).mean(-1, keepdims=True)
    h = (h - mu) / np.sqrt(var + 1e-6) * p["norm"]["scale"] \
        + p["norm"]["bias"]
    h = h @ p["pwconv1"]["kernel"].astype(np.float64) + p["pwconv1"]["bias"]
    h = 0.5 * h * (1.0 + erf(h / np.sqrt(2.0)))
    h = h @ p["pwconv2"]["kernel"].astype(np.float64) + p["pwconv2"]["bias"]
    return x + h * p["gamma"]


@pytest.fixture
def fresh_jax_programs(monkeypatch):
    """Programs compiled in this process, with every path pinned: no
    executable from the in-memory jit caches or the persistent compilation
    cache (which pipeline and CLI tests switch on for the rest of their
    worker), and none of the environment switches that select the fused
    MLP, its tiles or the depthwise formulation."""
    for var in ("SAI_FUSED_MLP", "SAI_FUSED_MLP_TM", "SAI_FUSED_MLP_TH",
                "SAI_DWCONV"):
        monkeypatch.delenv(var, raising=False)
    was = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    jax.clear_caches()
    try:
        with jax.default_matmul_precision("highest"):
            yield
    finally:
        jax.config.update("jax_enable_compilation_cache", was)


def _convnext_block_params(x, rng):
    """Parameters of a D=64 JAX ConvNeXt block made with numpy: the tree's
    shapes from jax.eval_shape (which traces and runs no program), values at
    flax's initial scales (kernels N(0, 1/fan_in)) with biases, LN affine
    and the layer scale moved off their initial values."""
    jblk = JC.ConvNeXtBlock(64, 1e-6, fused_mlp=True, shift_dwconv=False)
    shapes = jax.eval_shape(jblk.init, jax.random.PRNGKey(1),
                            jax.ShapeDtypeStruct(x.shape, jnp.float32))

    def draw(path, leaf):
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        shape = leaf.shape
        if name.endswith("kernel"):
            scale = np.prod(shape[:-1]) ** -0.5
        elif name.endswith("scale"):
            return (1.0 + 0.1 * rng.normal(size=shape)).astype(np.float32)
        else:  # biases and gamma
            scale = 0.1 if not name.endswith("gamma") else 1.0
        return (scale * rng.normal(size=shape)).astype(np.float32)

    return jblk, jax.tree_util.tree_map_with_path(draw, shapes)


def test_convnext_block_matches_jax_fused(fresh_jax_programs):
    """D=64: B2's plain version vs the Pallas kernel in interpret mode,
    within 1e-4 of each other; each side within 1e-5 of a float64
    evaluation (both read about 3e-6), so a drift names its side. The port
    runs first, before any JAX program of this test has run (ROADMAP C9:
    the port's side drifted in a few processes and read right when
    recomputed later in the same process)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 9, 11, 64)).astype(np.float32)
    jblk, v = _convnext_block_params(x, rng)
    p = v["params"]
    blk = TC.ConvNeXtBlock(64)
    blk.load_state_dict({
        "dwconv.weight": torch.from_numpy(
            p["dwconv"]["kernel"].transpose(3, 2, 0, 1).copy()),
        "dwconv.bias": torch.from_numpy(p["dwconv"]["bias"].copy()),
        "norm.weight": torch.from_numpy(p["norm"]["scale"].copy()),
        "norm.bias": torch.from_numpy(p["norm"]["bias"].copy()),
        "pwconv1.weight": torch.from_numpy(p["pwconv1"]["kernel"].T.copy()),
        "pwconv1.bias": torch.from_numpy(p["pwconv1"]["bias"].copy()),
        "pwconv2.weight": torch.from_numpy(p["pwconv2"]["kernel"].T.copy()),
        "pwconv2.bias": torch.from_numpy(p["pwconv2"]["bias"].copy()),
        "gamma": torch.from_numpy(p["gamma"].copy()),
    })
    with torch.no_grad():
        got = blk(torch.from_numpy(x.copy())).numpy().copy()
        # should the port's side drift again, where from: its depthwise
        # conv against float64, and the block recomputed in this process
        conv = TC.conv2d_nhwc(torch.from_numpy(x.copy()), blk.dwconv)
        again = blk(torch.from_numpy(x.copy())).numpy()
    want = np.array(jblk.apply(jax.tree_util.tree_map(jnp.array, v),
                               jnp.array(x)))
    ref = _convnext_block_f64(x, p)
    np.testing.assert_allclose(want, ref, atol=1e-5, rtol=0,
                               err_msg="JAX (Pallas interpret) vs float64")
    rows = np.abs(got - ref).reshape(-1, 64).max(1) > 1e-5
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0, err_msg=(
        f"port vs float64; drifting rows {np.flatnonzero(rows)[:20]}; conv "
        f"vs float64 {np.abs(conv.numpy() - _dwconv_f64(x, p)).max():.3g}; "
        f"recomputed block vs float64 {np.abs(again - ref).max():.3g}"))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_kmax_forward_matches_jax():
    x = np.random.default_rng(3).normal(size=(2, 64, 96, 3)).astype(
        np.float32)
    v = _jax_variables(0)
    cj, mj = jax.jit(JM.KMaxDeepLab(CFG).apply)(v, jnp.asarray(x))
    with torch.no_grad():
        ct, mt = _torch_model(v)(torch.from_numpy(x))
    assert ct.shape == (2, 16, 134) and mt.shape == (2, 16, 24, 16)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-4, rtol=0)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), atol=1e-4, rtol=0)


def test_logits_do_not_depend_on_the_batch_split():
    """ROADMAP C14: a frame's logits and fused labels are the same bits
    whether it runs in a batch of 4 or in 2-frame slices (the head runs one
    frame at a time; before, the ASPP's pooled 1x1 conv, a product over
    the batch's rows, rounded differently by batch size and the k-means
    argmax amplified it)."""
    rng = np.random.default_rng(8)
    x = rng.normal(size=(4, 64, 96, 3)).astype(np.float32)
    v = _jax_variables(2)
    model = _torch_model(v)
    with torch.inference_mode():
        whole = model(torch.from_numpy(x))
        parts = [model(torch.from_numpy(x[i:i + 2])) for i in (0, 2)]
    for j in range(2):
        assert torch.equal(whole[j], torch.cat([p[j] for p in parts]))
    seg = TM.KmaxSegmenter(CFG, model.state_dict(), device="cpu")
    rgb = rng.uniform(size=(4, 72, 96, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        seg.run_on_batch_fused_labels(rgb),
        np.concatenate([seg.run_on_batch_fused_labels(rgb[i:i + 2])
                        for i in (0, 2)]))


def test_detectron2_state_dict_loads_and_round_trips():
    """A random detectron2-named state dict (the torch mirror of the JAX
    package's converter test) loads into the port as it is, gives the JAX
    model's logits after convert_kmax_checkpoint, and comes back unchanged
    through kmax_state_dict_from_jax."""
    from test_kmax_convert import D2KMax, randomize_bn_stats

    torch.manual_seed(0)
    mirror = D2KMax(CFG).eval()
    randomize_bn_stats(mirror, torch.Generator().manual_seed(1))
    sd = mirror.state_dict()
    port = TM.KMaxDeepLab(CFG).eval()
    port.load_state_dict(sd)  # strict: the same names and shapes

    variables = convert_kmax_checkpoint(sd, CFG)
    back = kmax_state_dict_from_jax(_np_tree(variables))
    assert sorted(back) == sorted(sd)
    for k, t in sd.items():
        assert torch.equal(back[k], t), k

    x = np.random.default_rng(4).normal(size=(1, 64, 64, 3)).astype(
        np.float32)
    cj, mj = jax.jit(JM.KMaxDeepLab(CFG).apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        ct, mt = port(torch.from_numpy(x))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-4, rtol=0)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), atol=1e-4, rtol=0)


def _softmax(x, axis):
    e = np.exp(x - x.max(axis=axis, keepdims=True))
    return (e / e.sum(axis=axis, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_paint_plain_matches_jax_kernel(seed):
    """Unaligned h / w; keep flags random; half the probability mass near
    the pixel threshold."""
    rng = np.random.default_rng(seed)
    F, N, h, w = 3, 16, 19, 27
    probs = _softmax(rng.normal(size=(F, N, h, w)) * 3.0, axis=1)
    order = np.stack([rng.permutation(N) for _ in range(F)]).astype(np.int32)
    keep = (rng.uniform(size=(F, N)) < 0.7).astype(np.int32)
    kw = dict(overlap_threshold=0.8, pixel_threshold=0.4)
    want = np.asarray(jax_paint_masks(jnp.asarray(probs), jnp.asarray(order),
                                      jnp.asarray(keep), interpret=True, **kw))
    got, accepted = paint_masks_plain(
        torch.from_numpy(probs), torch.from_numpy(order),
        torch.from_numpy(keep), **kw)
    assert got.dtype == torch.int32 and accepted.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want >= 0).any() and (want < 0).any()
    # overlap_threshold > 0: accepted is exactly "claimed a pixel"
    for f in range(F):
        claimed = np.zeros(N, bool)
        claimed[np.unique(want[f][want[f] >= 0])] = True
        np.testing.assert_array_equal(accepted[f].numpy(), claimed)


def _jax_panoptic(cls, masks, cfg=CFG):
    ref = jax.vmap(lambda c, m: JM.panoptic_inference(c, m, cfg))(
        jnp.asarray(cls), jnp.asarray(masks))
    kern = JM.panoptic_inference_batch(jnp.asarray(cls), jnp.asarray(masks),
                                       cfg, use_pallas=True, interpret=True)
    return [np.asarray(a) for a in (*ref, *kern)]


def _torch_panoptic(cls, masks, cfg=CFG):
    c, m = torch.from_numpy(cls), torch.from_numpy(masks)
    cat, seg = TM.panoptic_inference_batch(c, m, cfg)
    scalar = [TM.panoptic_inference(c[i], m[i], cfg) for i in range(len(c))]
    return (cat.numpy(), seg.numpy(),
            np.stack([s[0].numpy() for s in scalar]),
            np.stack([s[1].numpy() for s in scalar]))


def _assert_panoptic_equal(cls, masks, cfg=CFG):
    cat_r, seg_r, cat_k, seg_k = _jax_panoptic(cls, masks, cfg)
    np.testing.assert_array_equal(cat_k, cat_r)
    np.testing.assert_array_equal(seg_k, seg_r)
    cat, seg, cat_s, seg_s = _torch_panoptic(cls, masks, cfg)
    for a in (cat, cat_s):
        np.testing.assert_array_equal(a, cat_r)
    for a in (seg, seg_s):
        np.testing.assert_array_equal(a, seg_r)
    return cat, seg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_panoptic_inference_matches_jax(seed):
    F, N, C, h, w = 3, 16, 133, 24, 33
    rng = np.random.default_rng(seed)
    cls = rng.normal(size=(F, N, C + 1)).astype(np.float32) * 4.0
    masks = rng.normal(size=(F, h, w, N)).astype(np.float32) * 3.0
    cat, seg = _assert_panoptic_equal(cls, masks)
    assert (cat != 133).any() and seg.max() >= 2


@pytest.mark.parametrize("overlap,pixel", [(0.0, 0.4), (0.8, 0.0),
                                           (0.0, 0.0)])
def test_panoptic_inference_at_zero_thresholds(overlap, pixel):
    """overlap_threshold 0 accepts queries that paint nothing (they still
    take a segment id); pixel_threshold 0 makes every mask the whole frame.
    The batch path (B3's accepted flags) equals both scalar references."""
    import dataclasses

    cfg = dataclasses.replace(CFG, overlap_threshold=overlap,
                              pixel_confidence_threshold=pixel)
    F, N, C, h, w = 3, 16, 133, 20, 30
    rng = np.random.default_rng(8)
    cls = rng.normal(size=(F, N, C + 1)).astype(np.float32) * 4.0
    masks = rng.normal(size=(F, h, w, N)).astype(np.float32) * 3.0
    # and a frame where thing 1 lies wholly under thing 0 (both at
    # probability 0.5) and thing 4, at probability 0.475 beside a void
    # query, is painted after them
    hand_cls, hand_masks = _hand_built_frames()
    hand_masks[0, :, 12:22, 1] = -8.0
    hand_masks[0, :, :20, 1] = 6.0
    hand_cls[0, 4, 5], hand_masks[0, 16:, 22:, 4] = 8.0, 5.9
    hand_cls[0, 5, -1], hand_masks[0, 16:, 22:, 5] = 10.0, 6.0
    cat, seg = _assert_panoptic_equal(np.concatenate([cls, hand_cls[:1]]),
                                      np.concatenate([masks, hand_masks[:1]]),
                                      cfg)
    assert (cat != 133).any()
    if overlap == 0.0 and pixel > 0.0:
        # stuff 1, thing 0 2, the covered thing 3 (accepted, paints
        # nothing), thing 4 4
        assert set(np.unique(seg[-1])) == {0, 1, 2, 4}


def _hand_built_frames():
    """The hand-built frames of tests/test_kmax_paint.py: a mostly covered
    weaker thing that the overlap threshold drops, two disjoint stuff masks
    of one class that share a segment id; and an all-void frame."""
    N, C, h, w = 16, CFG.num_classes, 20, 30
    cls = np.full((2, N, C + 1), -6.0, np.float32)
    masks = np.full((2, h, w, N), -8.0, np.float32)
    cls[0, 0, 3], masks[0, :, :20, 0] = 8.0, 6.0
    cls[0, 1, 3], masks[0, :, 12:22, 1] = 7.0, 5.9
    cls[0, 2, 100], masks[0, :5, 22:, 2] = 8.0, 6.0
    cls[0, 3, 100], masks[0, 10:15, 22:, 3] = 7.5, 6.0
    cls[1, :, :] = 0.0
    cls[1, :, -1] = 10.0  # every query predicts void
    masks[1] = 0.0
    return cls, masks


def test_paint_plain_matches_jax_kernel_on_hand_built_frames():
    cls, masks = _hand_built_frames()
    _, _, keep, probs, _, _, order = TM.query_stats(
        torch.from_numpy(cls), torch.from_numpy(masks), CFG)
    probs = probs.permute(0, 3, 1, 2).contiguous()
    keep = keep.gather(1, order).int()
    kw = dict(overlap_threshold=0.8, pixel_threshold=0.4)
    got = paint_masks_plain(probs, order, keep, **kw)[0].numpy()
    want = np.asarray(jax_paint_masks(
        jnp.asarray(probs.numpy()), jnp.asarray(order.int().numpy()),
        jnp.asarray(keep.numpy()), interpret=True, **kw))
    np.testing.assert_array_equal(got, want)
    assert (got[0, :, 20:22] < 0).all() and (got[1] < 0).all()


def _pack_model(probs, order, keep, pixel_threshold):
    """Numpy model of B3's pack step (csrc/paint_masks.cu): the kept steps'
    masks as bits [F, N, nwp] uint32 in paint order, bit i of word k the
    pixel 32k + i, zero past the last pixel (the ragged tail word and the
    padding of each row to 4 words); steps with keep 0 stay 0 (the kernel
    never writes or reads them); area [F, N] int32, the popcount of each
    step's words."""
    F, N, h, w = probs.shape
    hw = h * w
    nwp = 4 * -(-hw // 128)
    planes = probs.reshape(F, N, hw)[np.arange(F)[:, None], order]
    m = (planes > np.float32(pixel_threshold)) & (keep[..., None] != 0)
    padded = np.zeros((F, N, nwp * 32), bool)
    padded[..., :hw] = m
    weights = np.uint64(1) << np.arange(32, dtype=np.uint64)
    bits = (padded.reshape(F, N, nwp, 32) * weights).sum(-1).astype(
        np.uint32)
    area = np.bitwise_count(bits).sum(-1).astype(np.int32)
    return bits, area


_NEVER = 2 ** 31 - 1


def _least_accepted(a, overlap_threshold):
    """The resolve step's integer rule: the least |new| with
    f32(|new|) / f32(max(a, 1)) >= threshold, found by binary search (the
    division is monotone in |new|); a + 1 if none, _NEVER for a == 0."""
    if a <= 0:
        return _NEVER
    lo, hi = 0, a + 1
    while lo < hi:
        mid = (lo + hi) // 2
        if np.float32(mid) / np.float32(a) >= np.float32(overlap_threshold):
            hi = mid
        else:
            lo = mid + 1
    return lo


def _paint_by_bits(probs, order, keep, *, overlap_threshold,
                   pixel_threshold, group=4):
    """B3's three steps in numpy. Pack; resolve, which walks each frame's
    kept steps in groups of `group` rows, counting every row's |new| =
    sum of popcount(bits & ~claimed) with the claimed mask grown by all the
    rows before it or by none (the guess that they decide as the last
    decided step did: accept, or reject), then deciding the rows in order
    with the integer rule up to the first non-empty one that decides
    otherwise and restarting after it with the guess flipped; stamp, the
    first accepted step whose bit is set at each pixel."""
    F, N, h, w = probs.shape
    hw = h * w
    bits, area = _pack_model(probs, order, keep, pixel_threshold)
    accepted = np.zeros((F, N), bool)
    claim = np.full((F, hw), -1, np.int32)
    for f in range(F):
        kept = np.flatnonzero(keep[f])
        need = [_least_accepted(int(area[f, j]), overlap_threshold)
                for j in kept]
        claimed = np.zeros(bits.shape[-1], np.uint32)
        guess = True
        for g0 in range(0, len(kept), group):
            g_end = min(len(kept), g0 + group)
            q0 = g0
            while q0 < g_end:
                grown, counts = claimed.copy(), []
                for q in range(q0, g_end):
                    row = bits[f, kept[q]]
                    counts.append(int(np.bitwise_count(row & ~grown).sum()))
                    if guess:
                        grown |= row
                decided = g_end - q0
                for i, n_new in enumerate(counts[:decided]):
                    q = q0 + i
                    accept = n_new >= need[q]
                    if accept:
                        accepted[f, kept[q]] = True
                        claimed |= bits[f, kept[q]]
                    if accept != guess and need[q] != _NEVER:
                        decided, guess = i + 1, accept
                        break
                q0 += decided
        steps = np.flatnonzero(accepted[f])
        if len(steps):
            word = bits[f, steps][:, np.arange(hw) // 32]
            set_ = (word >> (np.arange(hw) % 32).astype(np.uint32)) & 1 == 1
            first = set_.argmax(axis=0)
            claim[f] = np.where(set_.any(axis=0), steps[first], -1)
    return claim.reshape(F, h, w), accepted


def _paint_case(case):
    """(probs [F, N, h, w], order, keep, thresholds) for the bit model's
    cases: random frames of the seeds above, the hand-built frames, a map
    of 7x9 pixels (hw = 63, not a multiple of 32), a frame with every keep
    0 beside a random one, zero overlap thresholds with a query wholly
    under an earlier one (accepted, paints nothing), and thresholds at
    which overlapping masks are mostly rejected between accepted ones (the
    resolve restarts at each change of outcome)."""
    kw = dict(overlap_threshold=0.8, pixel_threshold=0.4)
    if case == "hand_built":
        cls, masks = _hand_built_frames()
        _, _, keep, probs, _, _, order = TM.query_stats(
            torch.from_numpy(cls), torch.from_numpy(masks), CFG)
        return (probs.permute(0, 3, 1, 2).numpy(), order.int().numpy(),
                keep.gather(1, order).int().numpy(), kw)
    seed, (F, N, h, w) = {
        "seed0": (0, (3, 16, 19, 27)), "seed1": (1, (3, 16, 19, 27)),
        "seed2": (2, (3, 16, 19, 27)), "ragged_hw": (3, (2, 16, 7, 9)),
        "void_frame": (4, (2, 16, 19, 27)),
        "rejecting": (6, (3, 16, 19, 27))}.get(case, (5, (2, 16, 12, 14)))
    rng = np.random.default_rng(seed)
    probs = _softmax(rng.normal(size=(F, N, h, w)) * 3.0, axis=1)
    order = np.stack([rng.permutation(N) for _ in range(F)]).astype(np.int32)
    keep = (rng.uniform(size=(F, N)) < 0.7).astype(np.int32)
    if case == "void_frame":
        keep[1] = 0
    if case.startswith("zero"):
        # frame 1: query order[1, 1] lies wholly under order[1, 0]
        under, over = order[1, 1], order[1, 0]
        probs[1] = 0.01
        probs[1, over] = 0.0
        probs[1, over, :, :8], probs[1, under, :, 2:5] = 0.9, 0.6
        keep[1, :2] = 1
        kw = dict(overlap_threshold=0.0,
                  pixel_threshold=0.0 if case == "zero_both" else 0.4)
    if case == "rejecting":
        kw = dict(overlap_threshold=0.9, pixel_threshold=0.1)
    return probs, order, keep, kw


@pytest.mark.parametrize("case", ["seed0", "seed1", "seed2", "hand_built",
                                  "ragged_hw", "void_frame", "zero_overlap",
                                  "zero_both", "rejecting"])
def test_paint_bit_decomposition_matches_jax_and_plain(case):
    """B3's pack / resolve / stamp decomposition (numpy model of the card
    kernel's word layout) gives the JAX kernel's claims (interpret mode) and
    the plain version's claims and accepted flags bit for bit."""
    probs, order, keep, kw = _paint_case(case)
    claim, accepted = _paint_by_bits(probs, order, keep, **kw)
    want = np.asarray(jax_paint_masks(jnp.asarray(probs), jnp.asarray(order),
                                      jnp.asarray(keep), interpret=True, **kw))
    np.testing.assert_array_equal(claim, want)
    plain_claim, plain_acc = paint_masks_plain(
        torch.from_numpy(probs), torch.from_numpy(order),
        torch.from_numpy(keep), **kw)
    np.testing.assert_array_equal(claim, plain_claim.numpy())
    np.testing.assert_array_equal(accepted, plain_acc.numpy())
    assert (claim >= 0).any()
    if case == "ragged_hw":
        assert probs.shape[2] * probs.shape[3] % 32 != 0
    if case == "void_frame":
        assert (claim[1] < 0).all() and not accepted[1].any()
    if case == "rejecting":
        _, area = _pack_model(probs, order, keep, kw["pixel_threshold"])
        rejected = (keep != 0) & (area > 0) & ~accepted
        assert rejected.sum() > accepted.sum()
    if case.startswith("zero"):
        # an accepted query that paints nothing
        painted = np.zeros_like(accepted)
        for f in range(len(claim)):
            painted[f, np.unique(claim[f][claim[f] >= 0])] = True
        assert (accepted & ~painted).any()


def test_panoptic_overlap_stuff_merge_and_void_frames():
    cat, seg = _assert_panoptic_equal(*_hand_built_frames())
    assert (cat[0, :, :12] == 3).all() and (cat[0, :, 20:22] == 133).all()
    assert seg[0, 2, 25] == seg[0, 12, 25] and cat[0, 2, 25] == 100
    assert (cat[1] == 133).all() and (seg[1] == 0).all()


def test_panoptic_ties_keep_a_stable_order():
    """Trap C4: equal scores and zero-area queries tie; both packages paint
    ties in query order (a stable sort)."""
    N, C, h, w = 16, CFG.num_classes, 12, 14
    cls = np.full((1, N, C + 1), -6.0, np.float32)
    masks = np.full((1, h, w, N), -8.0, np.float32)
    for q in range(6):  # six equal things over one region: first one wins
        cls[0, q, 7] = 8.0
        masks[0, :6, :, q] = 6.0
    for q in range(6, 10):  # equal stuff, disjoint strips, one segment
        cls[0, q, 120] = 8.0
        masks[0, 6 + (q - 6) // 2 * 3:9 + (q - 6) // 2 * 3, :, q] = 6.0
    cat, seg = _assert_panoptic_equal(cls, masks)
    assert (cat[0, 6:] == 120).all()


def test_nearest_resize_indices_match_jax():
    """Trap C8, at the path's 241 -> 768 and 321 -> 1024 and a downscale."""
    for n_in, n_out in ((241, 768), (321, 1024), (97, 40), (24, 72)):
        got = TM.nearest_indices(n_in, n_out).numpy()
        src = jnp.arange(n_in, dtype=jnp.float32)[:, None]
        want = np.asarray(jax.image.resize(src, (n_out, 1),
                                           method="nearest"))[:, 0]
        np.testing.assert_array_equal(got, want.astype(np.int64))
    rng = np.random.default_rng(5)
    a = rng.integers(0, 133, size=(2, 13, 17)).astype(np.int32)
    b = rng.integers(0, 9, size=(2, 13, 17)).astype(np.int32)
    ta, tb = TM.resize_nearest_int2(torch.from_numpy(a), torch.from_numpy(b),
                                    (40, 51))
    for i in range(2):
        ja, jb = JM._resize_nearest_int2(jnp.asarray(a[i]), jnp.asarray(b[i]),
                                         (40, 51))
        np.testing.assert_array_equal(ta[i].numpy(), np.asarray(ja))
        np.testing.assert_array_equal(tb[i].numpy(), np.asarray(jb))


@pytest.mark.parametrize("dilate", [0, 2])
def test_null_same_class_instance_seams_match_jax(dilate):
    rng = np.random.default_rng(6)
    cat = rng.choice([3, 7, 133], size=(2, 21, 26)).astype(np.int32)
    seg = rng.integers(0, 4, size=(2, 21, 26)).astype(np.int32)
    got = TM.null_same_class_instance_seams(
        torch.from_numpy(cat), torch.from_numpy(seg), dilate=dilate).numpy()
    for i in range(2):
        want = JM.null_same_class_instance_seams(
            jnp.asarray(cat[i]), jnp.asarray(seg[i]), dilate=dilate)
        np.testing.assert_array_equal(got[i], np.asarray(want))
    assert (got == 133).sum() > (cat == 133).sum()


def _painting_variables(seed):
    """Tiny JAX variables whose random weights paint: class logits x20 and
    the mask-logit BN scale x60 lift class scores over 0.5 / 0.7 and mask
    probabilities over 0.4 on a good share of the pixels."""
    v = _jax_variables(seed)
    pr = v["params"]["predictor"]
    pr["class_head"] = {k: a * 20.0 for k, a in pr["class_head"].items()}
    pr["mask_bn_scale"] = pr["mask_bn_scale"] * 60.0
    return v


def test_segmenter_panoptic_matches_jax():
    v = _painting_variables(1)
    jseg = JM.KmaxSegmenter(CFG, params=v)
    tseg = TM.KmaxSegmenter.from_jax_params(CFG, v, device="cpu")
    rgbs = np.random.default_rng(7).uniform(size=(2, 72, 96, 3)).astype(
        np.float32)
    jcat, jseg_ids = jseg.run_on_batch_panoptic(rgbs)
    tcat, tseg_ids = tseg.run_on_batch_panoptic(rgbs)
    np.testing.assert_array_equal(tcat, jcat)
    np.testing.assert_array_equal(tseg_ids, jseg_ids)
    assert (tcat != 133).mean() > 0.2
    np.testing.assert_array_equal(tseg.run_on_image(rgbs[1]), tcat[1])
    labels = tseg.run_on_batch_fused_labels(torch.from_numpy(rgbs),
                                            as_numpy=False)
    assert isinstance(labels, torch.Tensor) and labels.dtype == torch.int32
    np.testing.assert_array_equal(
        labels.numpy(), np.asarray(jseg.run_on_batch_fused_labels(rgbs)))


def test_tiny_segmenter_refuses_the_card(monkeypatch):
    """Its ConvNeXt widths (16..64) are below what kernel B2 takes."""
    monkeypatch.setattr(TM, "resolve_device",
                        lambda device: torch.device("cuda", 0))
    with pytest.raises(ValueError, match="kernel B2"):
        TM.KmaxSegmenter.tiny()


def test_fuse_scan_with_fused_kmax_labels_matches_jax():
    """fuse_scan through run_on_batch_fused_labels (device-fused labels,
    the tiny kMaX with the same weights on both sides): the label histogram
    and the TSDF weights are equal."""
    v = _painting_variables(2)
    jeng = JaxEngine.tiny()
    teng = ClipEngine.from_jax_params(jeng.cfg, _np_tree(jeng.params),
                                      device="cpu")
    cfg = dict(voxel_size=0.06, trunc_vox=2.0, clip_patch_size=48,
               clip_patch_stride=24, frame_chunk=4, with_labels=True,
               integrator="sparse")
    scan = dict(num_frames=6, width=96, height=72)
    jseg = JM.KmaxSegmenter(CFG, params=v)
    tseg = TM.KmaxSegmenter.from_jax_params(CFG, v, device="cpu")
    jr = jax_fuse_scan(JaxDataset(**scan), jeng, JaxConfig(**cfg),
                       segmenter=jseg.run_on_image)
    tr = fuse_scan(SyntheticSceneDataset(**scan), teng, FusionConfig(**cfg),
                   segmenter=tseg.run_on_image, device="cpu")
    n = int(np.prod(tr.nvox))
    hist = tr.grid.label_hist.numpy()[:n]
    np.testing.assert_array_equal(hist, np.asarray(jr.grid.label_hist)[:n])
    np.testing.assert_array_equal(tr.grid.tsdf_w.numpy()[:n],
                                  np.asarray(jr.grid.tsdf_w)[:n])
    votes = hist.astype(np.int64)
    assert votes[:, :133].sum() > 0.1 * votes.sum() > 0


@pytest.mark.parametrize("out_hw", [(72, 99), (10, 13)])
def test_panoptic_class_map_matches_jax(out_hw):
    """One frame's category map resized nearest (trap C8), up and down:
    ids equal to the JAX package's."""
    rng = np.random.default_rng(7)
    N, C, h, w = 16, 133, 24, 33
    cls = rng.normal(size=(N, C + 1)).astype(np.float32) * 4.0
    masks = rng.normal(size=(h, w, N)).astype(np.float32) * 3.0
    got = TM.panoptic_class_map(torch.from_numpy(cls),
                                torch.from_numpy(masks), out_hw, CFG)
    want = JM.panoptic_class_map(jnp.asarray(cls), jnp.asarray(masks),
                                 out_hw, CFG)
    assert got.dtype == torch.int32 and tuple(got.shape) == out_hw
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() != 133).any()


# ---------------------------------------------------------------------------
# bf16: the JAX package's `compute_dtype=jnp.bfloat16`
#
# Tolerances are in bf16 ulps of the compared tensor's largest magnitude
# (`max_bf16_ulps`). XLA on the CPU keeps some bf16 intermediates of a
# fusion in f32 where the port rounds at each module's output, so one
# module reads up to 1-2 ulps from the JAX package's; a chain of modules
# sums them.
# ---------------------------------------------------------------------------

BF16 = torch.bfloat16


def _bf16(a):
    """A numpy array rounded to bf16 (both packages round to nearest even):
    (torch bf16 tensor, jnp bf16 array)."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(BF16)
    return t, jnp.asarray(t.float().numpy(), jnp.bfloat16)


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32)) \
        if not isinstance(a, torch.Tensor) else a.float().numpy()


@pytest.fixture(scope="module")
def bf16_forward():
    """One JAX bf16 forward of the tiny model on 2 frames (seed-0
    variables, BN statistics moved), every module's output and every
    predictor call kept; and the port's bf16 model on the same weights."""
    x = np.random.default_rng(3).normal(size=(2, 64, 96, 3)).astype(
        np.float32)
    v = _jax_variables(0)
    jm = JM.KMaxDeepLab(CFG, dtype=jnp.bfloat16)
    (cj, mj), st = jax.jit(lambda v, x: jm.apply(
        v, x, capture_intermediates=lambda m, n: True,
        mutable=["intermediates"]))(v, jnp.asarray(x))
    m = TM.KMaxDeepLab(CFG, dtype=BF16)
    m.load_state_dict(kmax_state_dict_from_jax(v))
    return dict(x=x, v=v, cls=_f32(cj), masks=_f32(mj), model=m.eval(),
                inter=jax.tree_util.tree_map(_f32, st["intermediates"]))


def _jax_out(inter, *path, call=0):
    t = inter
    for p in path:
        t = t[p]
    return t["__call__"][call] if "__call__" in t else t


def test_frozen_bn_and_convbn_bf16_match_jax(bf16_forward):
    """FrozenBatchNorm (bf16 statistics on a bf16 input, and on an f32
    input as the axial attention's output BN takes it) and ConvBN (1x1,
    3x3 dilated + gelu, depthwise 5x5 + gelu, the query conv1d) against
    the JAX modules with dtype=bf16 on the same bf16 inputs: within 1 ulp
    (one rounding apart at most: the port rounds the conv's output before
    the BN, XLA may not)."""
    v = jax.tree_util.tree_map(jnp.asarray, bf16_forward["v"]["params"])
    m = bf16_forward["model"]
    pd, pred = m.sem_seg_head.pixel_decoder, m.sem_seg_head.predictor
    td = m.sem_seg_head.transformer_decoder
    rng = np.random.default_rng(11)
    xt, xj = _bf16(rng.normal(size=(2, 5, 7, 64)))
    bn = v["pixel_decoder"]["aspp"]["conv1"]["bn"]
    want = JM.FrozenBatchNorm(dtype=jnp.bfloat16).apply(
        {"params": bn}, xj[..., :32])
    got = pd._aspp._conv1.norm(xt[..., :32])
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    assert max_bf16_ulps(got.float(), _f32(want)) <= 1.0
    xf = rng.normal(size=(2, 5, 7, 32)).astype(np.float32)
    want = JM.FrozenBatchNorm(dtype=jnp.bfloat16).apply(
        {"params": bn}, jnp.asarray(xf))
    got = pd._aspp._conv1.norm(torch.from_numpy(xf), BF16)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    assert max_bf16_ulps(got, _f32(want)) <= 1.0
    cases = [
        (pd._aspp._conv0, v["pixel_decoder"]["aspp"]["conv0"],
         dict(features=32, kernel=(1, 1), act="gelu"), xt, xj),
        (pd._aspp._conv2, v["pixel_decoder"]["aspp"]["conv2"],
         dict(features=32, kernel=(3, 3), dilation=2, act="gelu"), xt, xj),
    ]
    pt, pj = _bf16(rng.normal(size=(2, 6, 9, 32)))
    cases.append((pred._pixel_space_head_conv0bnact,
                  v["predictor"]["pixel_conv0"],
                  dict(features=32, kernel=(5, 5), groups=32, act="gelu"),
                  pt, pj))
    qt, qj = _bf16(rng.normal(size=(2, 16, 32)))
    cases.append((td._kmax_transformer_layers[0]._query_qkv_conv_bn,
                  v["kmax_layer0"]["qkv"], dict(features=96, kernel=(1,)),
                  qt, qj))
    for mod, p, kw, a, b in cases:
        want = JM.ConvBN(dtype=jnp.bfloat16, **kw).apply({"params": p}, b)
        got = mod(a)
        assert got.dtype == BF16 and want.dtype == jnp.bfloat16
        assert max_bf16_ulps(got.float(), _f32(want)) <= 1.0, kw


def test_convnext_block_bf16_matches_jax_fused(fresh_jax_programs,
                                               monkeypatch):
    """D=64 in bf16: B2's plain version vs the JAX package's fused block
    (SAI_FUSED_MLP=1, the Pallas kernel in interpret mode), both with LN
    statistics and accumulation in f32 and the weights, LN output and
    activation rounded to bf16: within 1 ulp (the depthwise conv's bias is
    added before its rounding here, after it in flax)."""
    monkeypatch.setenv("SAI_FUSED_MLP", "1")
    rng = np.random.default_rng(12)
    x = rng.normal(size=(2, 9, 11, 64)).astype(np.float32)
    _, v = _convnext_block_params(x, rng)
    p = v["params"]
    jblk = JC.ConvNeXtBlock(64, 1e-6, dtype=jnp.bfloat16, fused_mlp=True,
                            shift_dwconv=False)
    blk = TC.ConvNeXtBlock(64)
    blk.load_state_dict({
        "dwconv.weight": torch.from_numpy(
            p["dwconv"]["kernel"].transpose(3, 2, 0, 1).copy()),
        "dwconv.bias": torch.from_numpy(p["dwconv"]["bias"].copy()),
        "norm.weight": torch.from_numpy(p["norm"]["scale"].copy()),
        "norm.bias": torch.from_numpy(p["norm"]["bias"].copy()),
        "pwconv1.weight": torch.from_numpy(p["pwconv1"]["kernel"].T.copy()),
        "pwconv1.bias": torch.from_numpy(p["pwconv1"]["bias"].copy()),
        "pwconv2.weight": torch.from_numpy(p["pwconv2"]["kernel"].T.copy()),
        "pwconv2.bias": torch.from_numpy(p["pwconv2"]["bias"].copy()),
        "gamma": torch.from_numpy(p["gamma"].copy()),
    })
    xt, xj = _bf16(x)
    with torch.no_grad():
        got = blk(xt)
    want = jblk.apply(jax.tree_util.tree_map(jnp.array, v), xj)
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    assert max_bf16_ulps(got.float(), _f32(want)) <= 1.0


@pytest.mark.parametrize("axis", [1, 2])
def test_axial_attention_bf16_matches_jax(bf16_forward, axis):
    """One axial attention of the os16 block on a bf16 input: the logits
    in bf16, then f32 from the scale on (the JAX package divides by a
    numpy scalar), the output BN's parameters in bf16 on the f32 sum:
    an f32 output within 2 bf16 ulps of the JAX module's (a logit one
    rounding apart moves its softmax row)."""
    v = jax.tree_util.tree_map(
        jnp.asarray,
        bf16_forward["v"]["params"]["pixel_decoder"]["stage_os16_block0"])
    blk = bf16_forward["model"].sem_seg_head.pixel_decoder._stages[1][0]
    name = {1: "attn_h", 2: "attn_w"}[axis]
    xt, xj = _bf16(np.random.default_rng(13).normal(size=(2, 6, 9, 12)))
    want = JM.AxialAttention(12, 4, axis=axis, span=16,
                             dtype=jnp.bfloat16).apply(
        {"params": v[name]}, xj)
    with torch.no_grad():
        got = getattr(blk, f"_{name}")(xt)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    assert max_bf16_ulps(got, _f32(want)) <= 2.0


def test_kmax_layer_bf16_matches_jax_on_its_mask_logits(bf16_forward):
    """Each k-means layer of the JAX forward, fed that forward's own
    query, pixel features and mask logits (so that no argmax can flip
    before it): the port's layer within 2 ulps."""
    inter, m = bf16_forward["inter"], bf16_forward["model"]
    layers = m.sem_seg_head.transformer_decoder._kmax_transformer_layers
    mlogs = inter["predictor"]["mask_logits"]
    centers = bf16_forward["v"]["params"]["cluster_centers"]
    for li, lv in enumerate(("os32", "os16", "os8")):
        query = (np.broadcast_to(centers, (2, *centers.shape)) if li == 0
                 else _jax_out(inter, f"kmax_layer{li - 1}"))
        with torch.no_grad():
            got = layers[li](_bf16(query)[0],
                             _bf16(_jax_out(inter, f"pixel_space_{lv}"))[0],
                             _bf16(mlogs[li])[0])
        assert got.dtype == BF16
        assert max_bf16_ulps(got.float(),
                             _jax_out(inter, f"kmax_layer{li}")) <= 2.0


def test_bf16_argmax_takes_the_first_tied_maximum(bf16_forward):
    """bf16 mask logits tie often; jnp.argmax takes the first maximal
    index, and so does the port's assignment: a hand-built map whose
    pixels tie two, three or all of the queries (values equal in bf16, not
    in f32) gives the JAX layer's pooled update exactly."""
    N, h, w = 16, 4, 6
    rng = np.random.default_rng(14)
    logits = rng.normal(size=(1, h, w, N)).astype(np.float32) * 0.1
    top = np.float32(0.5)
    ties = [(0, 0, [3, 9]), (0, 1, [9, 3, 15]), (1, 2, list(range(N))),
            (2, 3, [0, 1]), (3, 5, [14, 15])]
    for r, c, qs in ties:
        for j, q in enumerate(qs):
            # 0.5 + j * 2^-14 (j < 16) rounds to 0.5 in bf16
            logits[0, r, c, q] = top + np.float32(j) * np.float32(2 ** -14)
    lt, lj = _bf16(logits)
    first = np.asarray(jnp.argmax(lj.reshape(-1, N), axis=-1))
    np.testing.assert_array_equal(lt.reshape(-1, N).argmax(-1).numpy(),
                                  first)
    for r, c, qs in ties:
        assert first[r * w + c] == min(qs)
    v = jax.tree_util.tree_map(jnp.asarray,
                               bf16_forward["v"]["params"]["kmax_layer0"])
    lay = bf16_forward["model"].sem_seg_head.transformer_decoder \
        ._kmax_transformer_layers[0]
    qt, qj = _bf16(rng.normal(size=(1, N, 32)))
    pt, pj = _bf16(rng.normal(size=(1, h, w, 32)))
    want = JM.KMaxTransformerLayer(CFG, dtype=jnp.bfloat16).apply(
        {"params": v}, qj, pj, lj)
    with torch.no_grad():
        got = lay(qt, pt, lt)
    assert max_bf16_ulps(got.float(), _f32(want)) <= 2.0


def _forced_forward(model, x, mlogs):
    """The port's forward with each k-means layer's assignment taken from
    the JAX forward's mask logits `mlogs` (per layer, [B, h, w, N]), so
    that a flipped argmax cannot carry a rounding difference into the
    cluster centres."""
    replay = [torch.from_numpy(m[f:f + 1]) for f in range(len(x))
              for m in mlogs[:len(model.sem_seg_head.transformer_decoder
                                  ._kmax_transformer_layers)]]
    with torch.no_grad(), kmeans_logits(model, replay):
        return model(torch.from_numpy(x))


def _top2_margin_ulps(a):
    """Each row's top-2 gap over the last axis, in bf16 ulps of the whole
    array's largest magnitude."""
    s = np.sort(a, axis=-1)
    top = np.abs(a).max()
    return (s[..., -1] - s[..., -2]) / 2.0 ** (np.floor(np.log2(top)) - 7)


def test_kmax_bf16_forward_matches_jax(bf16_forward):
    """The whole tiny model in bf16, each k-means assignment taken from the
    JAX forward's own mask logits: class and mask logits within 48 ulps of
    their largest magnitudes (about forty modules in a chain, each 1-2 ulps
    from the JAX package's; seeds 0-3 read 3-33 and 8-36). The categories,
    each pixel's query and each query's class, agree wherever JAX's top-2
    margin exceeds 16 ulps (a logit's own difference is not a margin's:
    over those seeds the categories differed only at margins up to 11.5).
    Free running, the port's bf16 logits are finite and in bf16 (on random
    weights' near-tied logits a flipped k-means argmax moves them about as
    far from the JAX package's bf16 as its own f32 forward is from it)."""
    d = bf16_forward
    cls, masks = _forced_forward(d["model"], d["x"],
                                 d["inter"]["predictor"]["mask_logits"])
    assert cls.dtype == BF16 and masks.dtype == BF16
    assert cls.shape == (2, 16, 134) and masks.shape == (2, 16, 24, 16)
    cls, masks = cls.float().numpy(), masks.float().numpy()
    assert max_bf16_ulps(cls, d["cls"]) <= 48.0
    assert max_bf16_ulps(masks, d["masks"]) <= 48.0
    covered = []
    for got, want in ((cls, d["cls"]), (masks, d["masks"])):
        sure = _top2_margin_ulps(want) > 16.0
        covered.append(int(sure.sum()))
        np.testing.assert_array_equal(got.argmax(-1)[sure],
                                      want.argmax(-1)[sure])
    assert covered[0] >= 1 and covered[1] >= 0.2 * masks[..., 0].size
    with torch.no_grad():
        free = d["model"](torch.from_numpy(d["x"]))
    assert all(t.dtype == BF16 and bool(torch.isfinite(t.float()).all())
               for t in free)


def test_bf16_logits_do_not_depend_on_the_batch_split():
    """C14 in bf16: a frame's logits and fused labels are the same bits in
    a batch of 4 and in 2-frame slices."""
    rng = np.random.default_rng(9)
    x = rng.normal(size=(4, 64, 96, 3)).astype(np.float32)
    v = _jax_variables(2)
    seg = TM.KmaxSegmenter.from_jax_params(CFG, v, device="cpu",
                                           compute_dtype=BF16)
    with torch.inference_mode():
        whole = seg.model(torch.from_numpy(x))
        parts = [seg.model(torch.from_numpy(x[i:i + 2])) for i in (0, 2)]
    for j in range(2):
        assert whole[j].dtype == BF16
        assert torch.equal(whole[j], torch.cat([p[j] for p in parts]))
    rgb = rng.uniform(size=(4, 72, 96, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        seg.run_on_batch_fused_labels(rgb),
        np.concatenate([seg.run_on_batch_fused_labels(rgb[i:i + 2])
                        for i in (0, 2)]))


def test_segmenter_compute_dtype(tmp_path):
    """compute_dtype reaches the model through every constructor; None is
    f32; anything but f32 and bf16 is refused; the bf16 segmenter's
    panoptic maps are int32 of the frame's size, painted, with segments."""
    import pickle

    v = _painting_variables(1)
    sd = kmax_state_dict_from_jax(v)
    path = tmp_path / "kmax.pkl"
    with open(path, "wb") as f:
        pickle.dump(v, f)
    segs = {
        "init": TM.KmaxSegmenter(CFG, sd, device="cpu", compute_dtype=BF16),
        "random": TM.KmaxSegmenter.random(CFG, device="cpu",
                                          compute_dtype=BF16),
        "tiny": TM.KmaxSegmenter.tiny(device="cpu", compute_dtype=BF16),
        "from_jax_params": TM.KmaxSegmenter.from_jax_params(
            CFG, v, device="cpu", compute_dtype=BF16),
        "from_checkpoint": TM.KmaxSegmenter.from_checkpoint(
            str(path), CFG, device="cpu", compute_dtype=BF16),
    }
    for name, seg in segs.items():
        assert seg.compute_dtype == BF16 and seg.model.dtype == BF16, name
        assert all(p.dtype == torch.float32
                   for p in seg.model.parameters()), name
    assert TM.KmaxSegmenter(CFG, sd, device="cpu").model.dtype == \
        torch.float32
    assert TM.KmaxSegmenter.from_checkpoint(
        str(path), CFG, device="cpu").compute_dtype == torch.float32
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        TM.KmaxSegmenter(CFG, sd, device="cpu", compute_dtype=torch.float16)
    rgbs = np.random.default_rng(7).uniform(size=(2, 72, 96, 3)).astype(
        np.float32)
    cat, seg_ids = segs["init"].run_on_batch_panoptic(rgbs)
    assert cat.dtype == np.int32 and cat.shape == (2, 72, 96)
    assert (cat != 133).mean() > 0.2 and seg_ids.max() >= 2
    np.testing.assert_array_equal(
        segs["from_checkpoint"].run_on_batch_panoptic(rgbs)[0], cat)
