"""The port's CLIP towers, tiling and text/query engine against the JAX
package, with the JAX package's random weights carried across
(models/clip/convert.py). Tolerance: 1e-4 absolute on embeddings of the
tiny config (f32 on both sides; LayerNorm and matmul sum orders differ);
the bf16 towers against the JAX package's compute_dtype=jnp.bfloat16
within 4 bf16 ulps of the largest magnitude."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatially_aware_ai_tpu.models.clip.engine import ClipEngine as JaxEngine
from spatially_aware_ai_tpu.query import text as JQ
from spatially_aware_ai_tpu_torch.models.attention import max_bf16_ulps
from spatially_aware_ai_tpu_torch.models.clip.engine import (
    TINY_CONFIG,
    ClipEngine,
)
from spatially_aware_ai_tpu_torch.models.clip.model import CLIP
from spatially_aware_ai_tpu_torch.models.clip.tiling import resize_bilinear
from spatially_aware_ai_tpu_torch.query import text as TQ

RNG = np.random.default_rng(5)


@pytest.fixture(scope="module")
def engines():
    jeng = JaxEngine.tiny(seed=1)
    params = jax.tree_util.tree_map(np.asarray, jeng.params)
    return jeng, ClipEngine.from_jax_params(jeng.cfg, params, device="cpu")


def test_config_and_converted_state_dict_complete(engines):
    jeng, teng = engines
    assert teng.cfg == TINY_CONFIG
    from spatially_aware_ai_tpu_torch.models.clip.convert import (
        clip_state_dict_from_jax,
    )

    sd = clip_state_dict_from_jax(jax.tree_util.tree_map(np.asarray,
                                                         jeng.params))
    assert set(sd) == set(CLIP(TINY_CONFIG).state_dict())


def test_image_tower_matches_jax(engines):
    jeng, teng = engines
    imgs = RNG.normal(size=(3, 224, 224, 3)).astype(np.float32)
    want = np.asarray(jeng.encode_image(jnp.asarray(imgs)))
    got = teng.encode_image(torch.from_numpy(imgs)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_text_tower_and_inference_match_jax(engines):
    jeng, teng = engines
    texts = ["a red box", "a chair", "the floor"]
    np.testing.assert_allclose(teng.text_inference(texts),
                               jeng.text_inference(texts), atol=1e-5)
    templates = ["a photo of {}.", "the {}."]
    np.testing.assert_allclose(
        teng.encode_text_with_prompt_ensemble(["chair"], templates),
        jeng.encode_text_with_prompt_ensemble(["chair"], templates),
        atol=1e-5)


@pytest.mark.parametrize("shape,ps,stride", [
    ((2, 384, 512, 3), 256, 128),   # resize-once fast prep (downscale)
    ((2, 72, 96, 3), 48, 24),       # per-patch path (upscale)
])
def test_tiled_features_match_jax(engines, shape, ps, stride):
    jeng, teng = engines
    imgs = RNG.uniform(size=shape).astype(np.float32)
    want = np.asarray(jeng.img_inference_tiled_batch(jnp.asarray(imgs), ps,
                                                     stride))
    got = teng.img_inference_tiled_batch(torch.from_numpy(imgs), ps,
                                         stride).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("src,dst", [(256, 224), (48, 224), (1024, 896)])
def test_bilinear_resize_equals_jax_image_resize(src, dst):
    """ROADMAP trap C5: F.interpolate(bilinear, align_corners=False,
    antialias=False) equals jax.image.resize(bilinear, antialias=False)
    on the tiling's down- and upscales (1e-5: rounding only)."""
    img = RNG.normal(size=(2, 3, src, src // 2)).astype(np.float32)
    got = resize_bilinear(torch.from_numpy(img), (dst, dst // 2)).numpy()
    want = np.asarray(jax.image.resize(
        jnp.asarray(img), (2, 3, dst, dst // 2), method="bilinear",
        antialias=False))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_query_math_matches_jax(engines):
    jeng, teng = engines
    feats = RNG.normal(size=(50, 32)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    labels = ["wall", "floor", "a red box"]
    np.testing.assert_allclose(teng.run_query(feats, labels),
                               jeng.run_query(feats, labels), atol=1e-5)
    text = RNG.normal(size=(4, 32)).astype(np.float32)
    img = feats[None]
    np.testing.assert_allclose(
        TQ.clip_feature_surgery_fast(torch.from_numpy(img),
                                     torch.from_numpy(text)).numpy(),
        np.asarray(JQ.clip_feature_surgery_fast(jnp.asarray(img),
                                                jnp.asarray(text))),
        atol=1e-5)
    np.testing.assert_allclose(
        TQ.clip_feature_surgery(torch.from_numpy(img),
                                torch.from_numpy(text)).numpy(),
        np.asarray(JQ.clip_feature_surgery(jnp.asarray(img),
                                           jnp.asarray(text))),
        atol=1e-5)
    rel = RNG.normal(size=200).astype(np.float32)
    np.testing.assert_allclose(TQ.query_relevance_postprocess(rel),
                               JQ.query_relevance_postprocess(rel), atol=1e-6)
    np.testing.assert_array_equal(TQ.surgery_relevance_2sigma(rel),
                                  JQ.surgery_relevance_2sigma(rel))
    assert TQ.PROMPT_TEMPLATES_85 == JQ.PROMPT_TEMPLATES_85
    assert TQ.CONTROL_OBJECTS == JQ.CONTROL_OBJECTS


def test_bf16_engine_runs_close_to_f32(engines):
    _, teng = engines
    sd = teng.model.state_dict()
    bf = ClipEngine(TINY_CONFIG, sd, compute_dtype=torch.bfloat16,
                    device="cpu")
    imgs = torch.from_numpy(RNG.normal(size=(2, 224, 224, 3))
                            .astype(np.float32))
    a, b = teng.encode_image(imgs), bf.encode_image(imgs)
    assert b.dtype == torch.float32
    cos = torch.nn.functional.cosine_similarity(a, b, dim=-1)
    assert float(cos.min()) > 0.99


def test_random_engine_is_seeded():
    a = ClipEngine.tiny(seed=3, device="cpu").model.state_dict()
    b = ClipEngine.tiny(seed=3, device="cpu").model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("causal", [False, True])
def test_attention_layer_matches_jax_f32(causal):
    """The port's CLIP Attention (in_proj, kernel B5's plain version on the
    CPU, out_proj) against the JAX CLIP's Attention at f32 on one set of
    weights, at the text tower's T = 77 with its triu mask and without:
    1e-5 abs (f32 on both sides, sum orders differ)."""
    from spatially_aware_ai_tpu.models.clip.model import (
        Attention as JaxAttention,
    )
    from spatially_aware_ai_tpu_torch.models.clip.model import Attention

    B, T, D, H = 2, 77, 128, 2
    rng = np.random.default_rng(21)
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    w = {"in_proj": {"kernel": rng.normal(size=(D, 3 * D)) / np.sqrt(D),
                     "bias": 0.1 * rng.normal(size=3 * D)},
         "out_proj": {"kernel": rng.normal(size=(D, D)) / np.sqrt(D),
                      "bias": 0.1 * rng.normal(size=D)}}
    w = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), w)
    mask = None
    if causal:
        mask = jnp.triu(jnp.full((T, T), -jnp.inf), k=1)
    want = np.asarray(JaxAttention(D, H).apply({"params": w}, jnp.asarray(x),
                                               mask))
    att = Attention(D, H)
    att.load_state_dict({
        "in_proj_weight": torch.from_numpy(w["in_proj"]["kernel"].T.copy()),
        "in_proj_bias": torch.from_numpy(w["in_proj"]["bias"]),
        "out_proj.weight": torch.from_numpy(w["out_proj"]["kernel"].T.copy()),
        "out_proj.bias": torch.from_numpy(w["out_proj"]["bias"])})
    with torch.no_grad():
        got = att(torch.from_numpy(x), causal).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_depthscaled_tiles_match_jax(engines):
    """Depth-scaled tiles (a crop of constant physical footprint per
    stride centre) against the JAX package's, frame by frame there, the
    whole batch in one forward here; centres with no depth (a zeroed row
    and column) take weight 0, and a cell they alone cover stays zero."""
    jeng, teng = engines
    F, H, W = 2, 48, 64
    img = RNG.uniform(size=(F, H, W, 3)).astype(np.float32)
    depth = RNG.uniform(0.5, 3.0, size=(F, H, W)).astype(np.float32)
    depth[0, 16, :] = 0
    depth[1, :, 32] = 0
    K = np.tile(np.array([[50.0, 0, W / 2], [0, 52.0, H / 2], [0, 0, 1]],
                         np.float32), (F, 1, 1))
    want = np.stack([np.asarray(jeng.img_inference_tiled_depthscaled(
        img[f], depth[f], K[f], 16, footprint_m=0.4)) for f in range(F)])
    got = teng.img_inference_tiled_depthscaled(img, depth, K, 16,
                                               footprint_m=0.4).numpy()
    assert got.shape == want.shape == (F, 2, 3, teng.feature_dim)
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert 0 < (np.abs(got).sum(-1) == 0).sum() < got[..., 0].size
    one = teng.img_inference_tiled_depthscaled(img[1], depth[1], K[1], 16,
                                               footprint_m=0.4).numpy()
    np.testing.assert_allclose(one, got[1], atol=1e-6)


def test_patch_tokens_unfolds_and_quick_gelu_match_jax(engines):
    """CLIP.encode_image_tokens (the tower after the stem) on the stem's
    own tokens equals encode_image, and both the JAX package's token entry;
    get_patches / get_patches_cf / the single-frame tiled_image_features and
    quick_gelu against the JAX package's."""
    from spatially_aware_ai_tpu.models.clip import model as JMOD
    from spatially_aware_ai_tpu.models.clip import tiling as JT
    from spatially_aware_ai_tpu_torch.models.clip import model as TMOD
    from spatially_aware_ai_tpu_torch.models.clip import tiling as TT

    jeng, teng = engines
    imgs = RNG.normal(size=(2, 224, 224, 3)).astype(np.float32)
    tokens = teng.model.visual.patchify(
        torch.from_numpy(imgs).permute(0, 3, 1, 2))
    got = teng.model.encode_image_tokens(tokens)
    assert torch.equal(got, teng.model.encode_image(torch.from_numpy(imgs)))
    want = np.asarray(jeng._encode_tokens(jeng.params,
                                          jnp.asarray(tokens.numpy())))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)

    img = RNG.uniform(size=(48, 64, 3)).astype(np.float32)
    for ps, st in ((32, 16), (24, 8), (20, 4)):
        np.testing.assert_array_equal(
            TT.get_patches(torch.from_numpy(img), ps, st).numpy(),
            np.asarray(JT.get_patches(jnp.asarray(img), ps, st)))
    cf = RNG.uniform(size=(2, 3, 48, 64)).astype(np.float32)
    np.testing.assert_array_equal(
        TT.get_patches_cf(torch.from_numpy(cf), 32, 16).numpy(),
        np.asarray(JT.get_patches_cf(jnp.asarray(cf), 32, 16)))
    with pytest.raises(ValueError):
        TT.get_patches_cf(torch.from_numpy(cf), 24, 16)
    with pytest.raises(ValueError):
        TT.get_patches(torch.from_numpy(img), 30, 16)
    got = TT.tiled_image_features(
        torch.from_numpy(img), patch_size=32, patch_stride=16,
        encode_fn=teng.model.encode_image_nchw)
    want = JT.tiled_image_features(
        jeng.params, jnp.asarray(img), patch_size=32, patch_stride=16,
        encode_fn=jeng._encode_image)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    x = RNG.normal(size=(500,)).astype(np.float32) * 4
    np.testing.assert_allclose(TMOD.quick_gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(JMOD.quick_gelu(jnp.asarray(x))),
                               atol=1e-6)


@pytest.fixture(scope="module")
def bf16_engines(engines):
    """The `engines` weights with compute_dtype bf16 in both packages."""
    jeng, teng = engines
    params = jax.tree_util.tree_map(np.asarray, jeng.params)
    return (JaxEngine(jeng.cfg, jeng.params, compute_dtype=jnp.bfloat16),
            ClipEngine.from_jax_params(jeng.cfg, params,
                                       compute_dtype=torch.bfloat16,
                                       device="cpu"))


def test_bf16_towers_match_jax_bf16(engines, bf16_engines):
    """Image and text embeddings of the bf16 towers against the JAX
    package's ClipEngine(compute_dtype=jnp.bfloat16): within 4 bf16 ulps of
    the largest magnitude (the two round at other points inside each block:
    the tiny towers read 1.5 and 2.8), in f32, and not the f32 engine's."""
    _, tf32 = engines
    jeng, teng = bf16_engines
    imgs = RNG.normal(size=(3, 224, 224, 3)).astype(np.float32)
    want = np.asarray(jeng.encode_image(jnp.asarray(imgs)))
    got = teng.encode_image(torch.from_numpy(imgs))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    assert max_bf16_ulps(got, want) <= 4.0
    assert not torch.equal(got, tf32.encode_image(torch.from_numpy(imgs)))
    texts = ["a red box", "a chair", "the floor"]
    want = np.asarray(jeng.text_inference(texts))
    got = np.asarray(teng.text_inference(texts))
    assert max_bf16_ulps(got, want) <= 4.0
    assert not np.array_equal(got, tf32.text_inference(texts))


@pytest.mark.parametrize("shape,ps,stride", [
    ((2, 384, 512, 3), 256, 128),   # resize-once fast prep (downscale)
    ((2, 72, 96, 3), 48, 24),       # per-patch path (upscale)
])
def test_bf16_tiled_features_match_jax_bf16(bf16_engines, shape, ps,
                                            stride):
    """The tiler with prep in bf16 (`prep_dtype`, the JAX package's
    tiling.py) and the bf16 tower: within 4 bf16 ulps of the JAX package's
    bf16 features (2.3 read), every patch's feature by cosine >= 0.9999."""
    jeng, teng = bf16_engines
    imgs = RNG.uniform(size=shape).astype(np.float32)
    want = np.asarray(jeng.img_inference_tiled_batch(jnp.asarray(imgs), ps,
                                                     stride))
    got = teng.img_inference_tiled_batch(torch.from_numpy(imgs), ps,
                                         stride).numpy()
    assert got.shape == want.shape
    assert max_bf16_ulps(got, want) <= 4.0
    cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1)
                                  * np.linalg.norm(want, axis=-1))
    assert cos.min() >= 0.9999


# the JAX package's fused-stem test config (tests/test_tiling.py): ViT
# patch 32, so a 224-tile's 7x7 tokens start at 112 / 32 = 3.5 patches
# apart and no two tiles share a token grid
PATCH32_CONFIG = dict(
    embed_dim=32, image_size=224, patch_size=32, vision_width=64,
    vision_layers=2, vision_heads=4, vocab_size=49408, context_length=77,
    text_width=64, text_heads=4, text_layers=2)


@pytest.fixture(scope="module")
def patch32_engines():
    from spatially_aware_ai_tpu.models.clip.model import CLIPConfig as JCfg

    jeng = JaxEngine.random(JCfg(**PATCH32_CONFIG), seed=2)
    params = jax.tree_util.tree_map(np.asarray, jeng.params)
    return jeng, ClipEngine.from_jax_params(jeng.cfg, params, device="cpu")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("pair,patch", [("engines", 56),
                                        ("patch32_engines", 32)])
def test_fused_stem_matches_jax_and_the_unfused_tiler(request, pair, patch,
                                                      dtype):
    """The fused conv stem through the resize-once branch (2 x 384x512,
    256/128: 3.5 tokens between tiles at patch 32) against the JAX
    package's fused tiler on one set of weights: f32 within 1e-4; bf16
    (prep and tower in bf16 on both sides) within 4 bf16 ulps of the
    largest magnitude, every tile's feature by cosine >= 0.9999. Against
    the port's unfused tiler: equal, since both give F.linear the same
    [tiles * g * g, 3 * p * p] values against the same weight."""
    from spatially_aware_ai_tpu.models.clip import tiling as JT
    from spatially_aware_ai_tpu_torch.models.clip import tiling as TT

    jeng, teng = request.getfixturevalue(pair)
    if dtype == "bf16":
        params = jax.tree_util.tree_map(np.asarray, jeng.params)
        jeng = JaxEngine(jeng.cfg, jeng.params, compute_dtype=jnp.bfloat16)
        teng = ClipEngine.from_jax_params(jeng.cfg, params,
                                          compute_dtype=torch.bfloat16,
                                          device="cpu")
    assert teng.cfg.patch_size == patch
    imgs = np.random.default_rng(15).uniform(
        size=(2, 384, 512, 3)).astype(np.float32)
    want = np.asarray(JT.tiled_image_features_batch(
        jeng.params, jnp.asarray(imgs), patch_size=256, patch_stride=128,
        encode_fn=jeng._encode_image, prep_dtype=jeng.compute_dtype,
        conv_kernel_fn=jeng._conv_kernel,
        encode_tokens_fn=jeng._encode_tokens, conv_patch=patch))
    kw = dict(patch_size=256, patch_stride=128,
              encode_fn=teng.model.encode_image_nchw,
              prep_dtype=teng.compute_dtype)
    with torch.inference_mode():
        x = torch.from_numpy(imgs)
        got = TT.tiled_image_features_batch(
            x, **kw, conv_kernel_fn=teng._conv_kernel,
            encode_tokens_fn=teng.model.encode_image_tokens,
            conv_patch=patch)
        unfused = TT.tiled_image_features_batch(x, **kw)
    assert got.dtype == torch.float32 and got.shape == (2, 2, 3, 32)
    assert torch.equal(got, unfused)
    got = got.numpy()
    if dtype == "f32":
        np.testing.assert_allclose(got, want, atol=1e-4)
        return
    assert max_bf16_ulps(got, want) <= 4.0
    cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1)
                                  * np.linalg.norm(want, axis=-1))
    assert cos.min() >= 0.9999


def test_fused_stem_unfolds_the_token_matrix_in_one_copy():
    """The stem's unfold makes the token matrix with one copy, of exactly
    the matrix's elements, and feeds it to one product; no channels-last
    copy comes first (the resized frames stay channels-last in memory).
    Any spelling torch dispatches a copy or a product as counts."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from spatially_aware_ai_tpu_torch.models.clip import tiling as TT

    copy_ops = ("clone", "copy_", "contiguous", "_to_copy")
    product_ops = ("mm", "addmm", "bmm", "linear", "matmul")

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.copies, self.products = [], []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__
            if name in copy_ops:
                self.copies.append(out.numel())
            self.products += [name] if name in product_ops else []
            return out

    small = torch.rand(2, 336, 448, 3).permute(0, 3, 1, 2)
    kernel = torch.rand(64, 3, 32, 32)
    with Ops() as ops:
        tokens = TT._stem_tokens(small, kernel, 224, 112, 32)
    assert tokens.shape == (2 * 2 * 3, 49, 64)
    assert ops.copies == [2 * 2 * 3 * 49 * 3 * 32 * 32]
    assert len(ops.products) == 1, ops.products


@pytest.mark.parametrize("shape,ps,stride,fused", [
    ((2, 384, 512, 3), 256, 128, True),   # resize-once: the fused stem
    ((2, 72, 96, 3), 48, 24, False),      # per-patch: unfused
])
def test_sai_fused_stem_engine_matches_jax(engines, monkeypatch, shape, ps,
                                           stride, fused):
    """The port's img_inference_tiled_batch, which always takes the stem
    on the resize-once branch, against the JAX engine built with
    SAI_FUSED_STEM=1 (its stem taken on the same branch): within 1e-4,
    the tokens handed to the tower once on that branch and never on the
    per-patch one, and equal to the port's tiler without the stem."""
    from spatially_aware_ai_tpu_torch.models.clip import tiling as TT

    jeng0, teng = engines
    monkeypatch.setenv("SAI_FUSED_STEM", "1")
    jeng = JaxEngine(jeng0.cfg, jeng0.params)
    assert jeng._use_fused_stem
    calls = []
    tokens_fn = teng.model.encode_image_tokens
    monkeypatch.setattr(teng.model, "encode_image_tokens",
                        lambda t: calls.append(t.shape) or tokens_fn(t))
    imgs = np.random.default_rng(16).uniform(size=shape).astype(np.float32)
    want = np.asarray(jeng.img_inference_tiled_batch(jnp.asarray(imgs), ps,
                                                     stride))
    got = teng.img_inference_tiled_batch(torch.from_numpy(imgs), ps, stride)
    assert calls == ([(2 * want.shape[1] * want.shape[2], 16, 64)] if fused
                     else [])
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    with torch.inference_mode():
        unfused = TT.tiled_image_features_batch(
            torch.from_numpy(imgs), patch_size=ps, patch_stride=stride,
            encode_fn=teng.model.encode_image_nchw,
            vit_size=teng.cfg.image_size)
    assert torch.equal(got, unfused)
