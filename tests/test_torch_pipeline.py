"""The port's whole slice on the CPU against the JAX package: fuse_scan ->
extract_mesh -> flood_fill_3d -> run_query on the hermetic synthetic scene
with ColorSegmenter labels and the JAX package's tiny CLIP weights carried
across, through the sparse, hybrid and brick integrators. Integer accumulators and labels match exactly; features by cosine
>= 0.9999; tsdf / rgb within 1e-5; the same mesh faces (vertices within
1e-4 voxel), the same objects, and query relevance within 1e-4; and
fuse_scan with both tiny models in bf16 against the JAX package's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatially_aware_ai_tpu.data import SyntheticSceneDataset as JaxDataset
from spatially_aware_ai_tpu.data.synthetic import (
    ColorSegmenter as JaxColorSegmenter,
    SyntheticScene as JaxScene,
)
from spatially_aware_ai_tpu.models.clip.engine import ClipEngine as JaxEngine
from spatially_aware_ai_tpu.pipeline import (
    FusionConfig as JaxConfig,
    fuse_scan as jax_fuse_scan,
)
from spatially_aware_ai_tpu.scene import flood_fill_3d as jax_flood_fill
from spatially_aware_ai_tpu_torch.data import (
    ColorSegmenter,
    SyntheticScene,
    SyntheticSceneDataset,
)
from spatially_aware_ai_tpu_torch.models.clip.engine import ClipEngine
from spatially_aware_ai_tpu_torch.pipeline import FusionConfig, fuse_scan
from spatially_aware_ai_tpu_torch.scene import flood_fill_3d

BASE = dict(voxel_size=0.06, trunc_vox=2.0, clip_patch_size=48,
            clip_patch_stride=24, frame_chunk=4, with_labels=True)
SCAN = dict(num_frames=10, width=96, height=72)  # last chunk padded
PROMPTS = ["wall", "a chair", "a red box"]


@pytest.fixture(scope="module")
def engines():
    jeng = JaxEngine.tiny()
    params = jax.tree_util.tree_map(np.asarray, jeng.params)
    return jeng, ClipEngine.from_jax_params(jeng.cfg, params, device="cpu")


@pytest.fixture(scope="module", params=["sparse", "pallas", "brick"])
def runs(request, engines):
    jeng, teng = engines
    cfg = dict(BASE, integrator=request.param)
    jr = jax_fuse_scan(JaxDataset(**SCAN), jeng, JaxConfig(**cfg),
                       segmenter=JaxColorSegmenter(
                           JaxScene.demo_room()).run_on_image)
    tr = fuse_scan(SyntheticSceneDataset(**SCAN), teng, FusionConfig(**cfg),
                   segmenter=ColorSegmenter(SyntheticScene.demo_room())
                   .run_on_image, device="cpu")
    return jeng, teng, jr, tr


def test_fused_grid_matches_jax(runs):
    _, _, jr, tr = runs
    assert tr.nvox == jr.nvox
    n = int(np.prod(tr.nvox))
    for k in ("weight", "tsdf_weight", "class_id"):
        np.testing.assert_array_equal(tr.values[k], jr.values[k], err_msg=k)
    np.testing.assert_array_equal(tr.grid.label_hist.numpy()[:n],
                                  np.asarray(jr.grid.label_hist)[:n])
    assert tr.values["weight"].sum() > 1000
    for k in ("tsdf", "rgb"):
        np.testing.assert_allclose(tr.values[k], jr.values[k], atol=1e-5)
    a = tr.feat_grid.reshape(n, -1).double().numpy()
    b = np.asarray(jr.feat_grid).reshape(n, -1).astype(np.float64)
    seen = tr.values["weight"] > 0
    cos = (a[seen] * b[seen]).sum(1) / (np.linalg.norm(a[seen], axis=1)
                                        * np.linalg.norm(b[seen], axis=1))
    assert cos.min() >= 0.9999
    assert np.abs(a[~seen]).max() == 0


def _canonical(mesh):
    """(vertex order, faces): the permutation that sorts the vertices
    lexicographically, and the faces renumbered by it, each rotated to
    start at its smallest index (orientation kept), then sorted. The JAX
    package's native extractor numbers vertices in another order than the
    numpy marching cubes, with the same geometry."""
    v = mesh["verts_voxel"]
    order = np.lexsort(np.round(v, 3).T[::-1])
    rank = np.empty(len(v), np.int64)
    rank[order] = np.arange(len(v))
    f = rank[mesh["faces"]]
    f = np.stack([np.roll(t, -int(np.argmin(t))) for t in f])
    f = f[np.lexsort(f.T[::-1])]
    return order, f


def test_mesh_objects_and_query_match_jax(runs):
    jeng, teng, jr, tr = runs
    nvox = tr.nvox
    tsk, tids = flood_fill_3d(tr.values["class_id"].reshape(nvox), None,
                              tr.feat_grid, tr.values["rgb"].reshape(*nvox, 3))
    jsk, jids = jax_flood_fill(jr.values["class_id"].reshape(nvox), None,
                               np.asarray(jr.feat_grid),
                               jr.values["rgb"].reshape(*nvox, 3))
    assert sorted(tsk["unique_objects"]) == sorted(jsk["unique_objects"])
    assert {"chair:1", "suitcase:1", "table:1"} <= set(tsk["unique_objects"])
    np.testing.assert_array_equal(tids, jids)

    jm = jr.extract_mesh(voxel_obj_idx=jids)
    tm = tr.extract_mesh(voxel_obj_idx=tids)
    assert len(tm["verts_world"]) == len(jm["verts_world"]) > 300
    t_order, t_faces = _canonical(tm)
    j_order, j_faces = _canonical(jm)
    np.testing.assert_array_equal(t_faces, j_faces)
    for k in ("verts_voxel", "colors"):
        np.testing.assert_allclose(tm[k][t_order], jm[k][j_order], atol=1e-4,
                                   err_msg=k)
    np.testing.assert_array_equal(tm["obj_idx"][t_order],
                                  jm["obj_idx"][j_order])

    def normed(f):
        f = np.asarray(f, np.float32)
        return f / np.maximum(np.linalg.norm(f, axis=-1, keepdims=True), 1e-8)

    t_rel = teng.run_query(normed(tm["clip_feats"]), PROMPTS)
    j_rel = jeng.run_query(normed(jm["clip_feats"]), PROMPTS)
    assert t_rel.shape == (len(tm["verts_world"]), len(PROMPTS))
    np.testing.assert_allclose(t_rel[t_order], j_rel[j_order], atol=1e-4)


def test_depth_scaled_patches_match_jax(engines):
    """fuse_scan with scale_patches_by_depth (a constant physical footprint
    per CLIP crop) against the JAX package's, with ColorSegmenter labels:
    integer accumulators equal, features within 1e-4, tsdf / rgb within
    1e-5."""
    jeng, teng = engines
    cfg = dict(BASE, integrator="sparse", scale_patches_by_depth=True,
               patch_footprint_m=0.4)
    scan = dict(SCAN, num_frames=6)
    jr = jax_fuse_scan(JaxDataset(**scan), jeng, JaxConfig(**cfg),
                       segmenter=JaxColorSegmenter(
                           JaxScene.demo_room()).run_on_image)
    tr = fuse_scan(SyntheticSceneDataset(**scan), teng, FusionConfig(**cfg),
                   segmenter=ColorSegmenter(SyntheticScene.demo_room())
                   .run_on_image, device="cpu")
    for k in ("weight", "tsdf_weight", "class_id"):
        np.testing.assert_array_equal(tr.values[k], jr.values[k], err_msg=k)
    for k in ("tsdf", "rgb"):
        np.testing.assert_allclose(tr.values[k], jr.values[k], atol=1e-5)
    np.testing.assert_allclose(tr.feat_grid.numpy(),
                               np.asarray(jr.feat_grid), atol=1e-4)
    assert tr.values["weight"].sum() > 100
    # the crops differ from the fixed tiles: so do the features
    fixed = fuse_scan(SyntheticSceneDataset(**scan), teng,
                      FusionConfig(**dict(cfg, scale_patches_by_depth=False)),
                      segmenter=ColorSegmenter(SyntheticScene.demo_room())
                      .run_on_image, device="cpu")
    assert not torch.allclose(fixed.values["feat"], tr.values["feat"])


def test_einsum_integrator_runs_the_hybrid(engines):
    """integrator="einsum" runs through fuse_scan as the hybrid (JAX's
    einsum and Pallas hybrids compute one function): the same grid."""
    _, teng = engines
    ds = SyntheticSceneDataset(num_frames=4, width=96, height=72)
    seg = ColorSegmenter(SyntheticScene.demo_room()).run_on_image
    a, b = (fuse_scan(ds, teng, FusionConfig(**BASE, integrator=i),
                      segmenter=seg, device="cpu")
            for i in ("einsum", "pallas"))
    for k in ("weight", "tsdf_weight", "class_id", "tsdf", "rgb"):
        np.testing.assert_array_equal(a.values[k], b.values[k], err_msg=k)
    assert torch.equal(a.values["feat"], b.values["feat"])
    assert a.values["weight"].sum() > 100


def test_cuda_entry_points_never_fall_back():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        ClipEngine.tiny()
    with pytest.raises(RuntimeError, match="CUDA"):
        fuse_scan(SyntheticSceneDataset(num_frames=2, width=96, height=72),
                  None, FusionConfig(**BASE))


def test_panoptic_seams_and_segment_stride_match_jax(engines):
    """Batch-panoptic segmenters go through the same-class seam nulling,
    segment_stride=2 leaves every other frame's labels at -1 (no votes),
    and quantize_transfer=False uploads f32 frames; the label histograms
    match the JAX package exactly."""
    from spatially_aware_ai_tpu.data.synthetic import (
        ColorPanopticSegmenter as JaxPanoptic,
    )
    from spatially_aware_ai_tpu_torch.data.synthetic import (
        ColorPanopticSegmenter,
    )

    jeng, teng = engines
    cfg = dict(BASE, integrator="sparse", segment_stride=2,
               quantize_transfer=False)
    scan = dict(SCAN, num_frames=6)
    jr = jax_fuse_scan(JaxDataset(**scan), jeng, JaxConfig(**cfg),
                       segmenter=JaxPanoptic(JaxScene.demo_room()).run_on_image)
    tr = fuse_scan(SyntheticSceneDataset(**scan), teng, FusionConfig(**cfg),
                   segmenter=ColorPanopticSegmenter(
                       SyntheticScene.demo_room()).run_on_image,
                   device="cpu")
    n = int(np.prod(tr.nvox))
    hist = tr.grid.label_hist.numpy()[:n]
    np.testing.assert_array_equal(hist, np.asarray(jr.grid.label_hist)[:n])
    assert 0 < hist.astype(np.int64).sum() < tr.values["weight"].sum()


def test_geometry_aware_segmenter_matches_jax(engines):
    """A `needs_geometry` segmenter (GeometricSegmenter) gets each frame's
    depth / K / pose; the label histograms match the JAX package exactly."""
    from spatially_aware_ai_tpu.models.kmax.heuristic import (
        GeometricSegmenter as JaxGeometric,
    )
    from spatially_aware_ai_tpu_torch.models.kmax.heuristic import (
        GeometricSegmenter,
    )

    jeng, teng = engines
    cfg = dict(BASE, integrator="sparse")
    scan = dict(SCAN, num_frames=6)
    jr = jax_fuse_scan(JaxDataset(**scan), jeng, JaxConfig(**cfg),
                       segmenter=JaxGeometric().run_on_image)
    tr = fuse_scan(SyntheticSceneDataset(**scan), teng, FusionConfig(**cfg),
                   segmenter=GeometricSegmenter().run_on_image, device="cpu")
    n = int(np.prod(tr.nvox))
    hist = tr.grid.label_hist.numpy()[:n]
    np.testing.assert_array_equal(hist, np.asarray(jr.grid.label_hist)[:n])
    assert hist[:, 87].sum() > 0  # floor-wood from the depth normals


class _JaxLabels:
    """A device-fused segmenter for the port's fuse_scan that hands on the
    JAX segmenter's labels for each chunk it is given."""

    def __init__(self, jseg):
        self.jseg = jseg

    def run_on_batch_fused_labels(self, rgbs, dilate=2, as_numpy=True):
        want = np.asarray(self.jseg.run_on_batch_fused_labels(
            rgbs.cpu().numpy(), dilate=dilate))
        return want if as_numpy else torch.from_numpy(want)


class _Recorded:
    """The port's segmenter, keeping each chunk it labels (rgb and the
    labels it gave)."""

    def __init__(self, seg):
        self.seg, self.chunks = seg, []

    def run_on_batch_fused_labels(self, rgbs, dilate=2, as_numpy=True):
        out = self.seg.run_on_batch_fused_labels(rgbs, dilate=dilate,
                                                 as_numpy=as_numpy)
        self.chunks.append((np.array(rgbs.cpu()), np.array(
            out.cpu() if isinstance(out, torch.Tensor) else out)))
        return out


def test_fuse_scan_with_bf16_models_matches_jax():
    """fuse_scan with the tiny CLIP and the tiny kMaX in bf16 in both
    packages (compute_dtype), the kMaX through the device-fused labels:
    the tsdf weights and the observation counts are equal, each observed
    voxel's feature by cosine >= 0.9999 (0.99997 read). The port's own
    bf16 labels, chunk by chunk as fuse_scan took them, equal the JAX
    package's label function (its panoptic_inference_batch, nearest
    resize and seam nulling) applied to the port's bf16 logits of that
    chunk, and they vote. Where the labels are equal, so are the label
    histograms: the port's fuse_scan fed the JAX segmenter's bf16 labels
    gives the JAX package's histograms exactly.

    The labels themselves are not held equal to the JAX package's: on
    random weights the bf16 logits are ill-conditioned (a k-means layer's
    self-attention reads queries of pooled sums over many pixels, so one
    rounding apart moves them far) and near-tied, and a top-2 margin of
    16 bf16 ulps covers under 1% of these pixels. Measured on these
    chunks: the port's bf16 labels equal the JAX package's bf16 labels on
    92.3% / 52.8% of the pixels, the f32 labels (the two packages' are
    equal) on 70.2% / 27.3%; with seeds 2-5 the port's bf16 is the closer
    one on 7 of 8 chunks; test_kmax_bf16_forward_matches_jax holds the
    model's logits."""
    from test_torch_kmax import CFG, JM, TM, _painting_variables

    v = _painting_variables(2)
    j0 = JaxEngine.tiny()
    jeng = JaxEngine(j0.cfg, j0.params, compute_dtype=jnp.bfloat16)
    teng = ClipEngine.from_jax_params(
        j0.cfg, jax.tree_util.tree_map(np.asarray, j0.params),
        compute_dtype=torch.bfloat16, device="cpu")
    jseg = JM.KmaxSegmenter(CFG, params=v, compute_dtype=jnp.bfloat16)
    tseg = TM.KmaxSegmenter.from_jax_params(CFG, v, device="cpu",
                                            compute_dtype=torch.bfloat16)
    cfg = dict(BASE, integrator="sparse")
    scan = dict(SCAN, num_frames=6)
    jr = jax_fuse_scan(JaxDataset(**scan), jeng, JaxConfig(**cfg),
                       segmenter=jseg.run_on_image)
    rec = _Recorded(tseg)
    tr = fuse_scan(SyntheticSceneDataset(**scan), teng, FusionConfig(**cfg),
                   segmenter=rec.run_on_batch_fused_labels, device="cpu")
    n = int(np.prod(tr.nvox))
    for k in ("tsdf_w", "w"):
        np.testing.assert_array_equal(getattr(tr.grid, k).numpy()[:n],
                                      np.asarray(getattr(jr.grid, k))[:n])
    a = tr.grid.feat_sum.numpy()[:n].astype(np.float64)
    b = np.asarray(jr.grid.feat_sum)[:n].astype(np.float64)
    seen = tr.grid.w.numpy()[:n] > 0
    cos = (a[seen] * b[seen]).sum(1) / (np.linalg.norm(a[seen], axis=1)
                                        * np.linalg.norm(b[seen], axis=1))
    assert seen.sum() > 1000 and cos.min() >= 0.9999
    hist = tr.grid.label_hist.numpy()[:n].astype(np.int64)
    assert hist[:, :133].sum() > 0.1 * hist.sum() > 0

    H, W = scan["height"], scan["width"]
    new_h, new_w, pad_h, pad_w = tseg._test_shape(H, W)

    @jax.jit
    def jax_labels(cls, masks):
        cat, seg = JM.panoptic_inference_batch(cls, masks, CFG)
        return jax.vmap(lambda c, s: JM.null_same_class_instance_seams(
            *JM._resize_nearest_int2(c, s, (H, W)),
            dilate=FusionConfig(**cfg).instance_boundary_dilate))(cat, seg)

    assert len(rec.chunks) == 2
    for rgbs, labels in rec.chunks:
        with torch.inference_mode():
            cls, masks = tseg.model(TM.prep_batch(
                torch.from_numpy(rgbs), new_h, new_w, pad_h, pad_w))
        masks = masks[:, :-(-new_h // 4), :-(-new_w // 4)]
        np.testing.assert_array_equal(labels, np.asarray(jax_labels(
            jnp.asarray(cls.float().numpy()),
            jnp.asarray(masks.float().numpy()))))

    fed = fuse_scan(SyntheticSceneDataset(**scan), teng, FusionConfig(**cfg),
                    segmenter=_JaxLabels(jseg).run_on_batch_fused_labels,
                    device="cpu")
    np.testing.assert_array_equal(fed.grid.label_hist.numpy()[:n],
                                  np.asarray(jr.grid.label_hist)[:n])
