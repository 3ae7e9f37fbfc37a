"""The port imports without JAX and without the JAX package, and each of
its copies of the JAX package's numpy-only modules gives the same output
as the original, so the two cannot drift apart."""
import os
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "spatially_aware_ai_tpu_torch")
RNG = np.random.default_rng(17)


def test_port_imports_with_jax_blocked():
    code = textwrap.dedent("""
        import importlib, importlib.abc, pkgutil, sys
        BLOCKED = ("jax", "jaxlib", "flax", "optax", "spatially_aware_ai_tpu")

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError(f"blocked import: {name}")
                return None

        for name in list(sys.modules):
            if name.split(".")[0] in BLOCKED:
                del sys.modules[name]
        sys.meta_path.insert(0, Block())
        import spatially_aware_ai_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                       pkg.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        for name in ("grid.brick", "grid.tiledma", "grid.splat",
                     "models.ln_mlp", "models.kmax.paint", "models.attention",
                     "models.dgcnn.model", "models.dgcnn.convert",
                     "models.dgcnn.insitu", "utils.atomic"):
            assert pkg.__name__ + "." + name in names, name
        assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
        print(len(names))
    """)
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20


def test_no_jax_import_lines():
    pat = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|"
                     r"spatially_aware_ai_tpu)\b")
    files = [os.path.join(ROOT, n) for n in (
        "chip_smoke.py", "kernel_ab.py", os.path.join("tools",
                                                      "c9_erf_probe.py"))]
    for d, _, names in os.walk(PORT):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    bad = [f"{f}:{i + 1}" for f in files
           for i, line in enumerate(open(f)) if pat.match(line)]
    assert not bad


def test_colors_copy():
    from spatially_aware_ai_tpu.scene import colors as J
    from spatially_aware_ai_tpu_torch.scene import colors as T

    for k in ("NULL_CLASS_ID", "NUM_CLASSES_WITH_SPARE",
              "COCO_PANOPTIC_CLASSES", "PREDEFINED_CLASSES"):
        assert getattr(T, k) == getattr(J, k), k
    np.testing.assert_array_equal(T.PREDEFINED_COLORS, J.PREDEFINED_COLORS)


def test_objects_copy():
    from spatially_aware_ai_tpu.scene import objects as J
    from spatially_aware_ai_tpu_torch.scene import objects as T

    grid = RNG.choice([-1, 133, 28, 56, 87], size=(12, 10, 9),
                      p=[0.4, 0.1, 0.2, 0.15, 0.15]).astype(np.int32)
    feats = RNG.normal(size=(12, 10, 9, 4)).astype(np.float32)
    rgb = RNG.uniform(size=(12, 10, 9, 3)).astype(np.float32)
    tsk, tids = T.flood_fill_3d(grid, None, feats, rgb)
    jsk, jids = J.flood_fill_3d(grid, None, feats, rgb)
    assert tsk == jsk
    np.testing.assert_array_equal(tids, jids)
    assert len(tsk["unique_objects"]) > 2
    first = sorted(tsk["unique_objects"])[:2]
    out_t = T.merge_objects(tsk, tids.copy(), None, first, "thing")
    out_j = J.merge_objects(jsk, jids.copy(), None, first, "thing")
    assert out_t == out_j


def test_synthetic_data_copy():
    from spatially_aware_ai_tpu.data import synthetic as J
    from spatially_aware_ai_tpu_torch.data import synthetic as T

    jds = J.SyntheticSceneDataset(num_frames=3, width=48, height=36, seed=2)
    tds = T.SyntheticSceneDataset(num_frames=3, width=48, height=36, seed=2)
    for a, b in zip(tds.stacked_u8([0, 2]).values(),
                    jds.stacked_u8([0, 2]).values()):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tds.bounds_samples(), jds.bounds_samples()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tds.render_labels(1), jds.render_labels(1))
    rgb = tds[1].rgb
    scene_t, scene_j = T.SyntheticScene.demo_room(), J.SyntheticScene.demo_room()
    np.testing.assert_array_equal(T.ColorSegmenter(scene_t).run_on_image(rgb),
                                  J.ColorSegmenter(scene_j).run_on_image(rgb))
    for a, b in zip(
            T.ColorPanopticSegmenter(scene_t).run_on_batch_panoptic(rgb[None]),
            J.ColorPanopticSegmenter(scene_j).run_on_batch_panoptic(rgb[None])):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        T.NoisySegmenter(T.ColorSegmenter(scene_t), 2, 0.1).run_on_image(rgb),
        J.NoisySegmenter(J.ColorSegmenter(scene_j), 2, 0.1).run_on_image(rgb))


def test_bounds_copy():
    from spatially_aware_ai_tpu.core import bounds as J
    from spatially_aware_ai_tpu_torch.core import bounds as T

    depth = RNG.uniform(0.2, 5.0, size=(4, 30, 40)).astype(np.float32)
    depth[0, :5] = 0
    poses = np.tile(np.eye(4, dtype=np.float32), (4, 1, 1))
    poses[:, :3, 3] = RNG.normal(size=(4, 3))
    Ks = np.tile(np.array([[30, 0, 20], [0, 30, 15], [0, 0, 1]], np.float32),
                 (4, 1, 1))
    a = T.backproject_sparse_cloud(depth, poses, Ks, max_depth=4.0)
    b = J.backproject_sparse_cloud(depth, poses, Ks, max_depth=4.0)
    np.testing.assert_array_equal(a, b)
    lo_t, hi_t = T.percentile_bounds(a, 0.1)
    lo_j, hi_j = J.percentile_bounds(b, 0.1)
    np.testing.assert_array_equal(lo_t, lo_j)
    np.testing.assert_array_equal(T.compute_grid_dims(lo_t, hi_t, 0.05),
                                  J.compute_grid_dims(lo_j, hi_j, 0.05))


@pytest.mark.parametrize("fn", ["marching_cubes", "marching_tetrahedra"])
def test_marching_copy(fn):
    from spatially_aware_ai_tpu.meshing import marching as J
    from spatially_aware_ai_tpu.meshing import mc_tables as JT
    from spatially_aware_ai_tpu_torch.meshing import marching as T
    from spatially_aware_ai_tpu_torch.meshing import mc_tables as TT

    x, y, z = np.meshgrid(*[np.linspace(-1, 1, 14)] * 3, indexing="ij")
    vol = (np.sqrt(x ** 2 + y ** 2 + z ** 2) - 0.6
           + 0.05 * RNG.normal(size=x.shape)).astype(np.float32)
    vol[:3, :3, :3] = np.nan
    va, fa = getattr(T, fn)(vol)
    vb, fb = getattr(J, fn)(vol)
    assert len(fa) > 100
    np.testing.assert_array_equal(va, vb)
    np.testing.assert_array_equal(fa, fb)
    assert TT.build_tables() == JT.build_tables()


def test_ply_copy(tmp_path):
    from spatially_aware_ai_tpu.meshing import ply as J
    from spatially_aware_ai_tpu_torch.meshing import ply as T

    v = RNG.normal(size=(20, 3)).astype(np.float32)
    f = RNG.integers(0, 20, size=(10, 3))
    c = RNG.uniform(size=(20, 3)).astype(np.float32)
    T.write_ply(str(tmp_path / "t.ply"), v, f, c)
    J.write_ply(str(tmp_path / "j.ply"), v, f, c)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    for a, b in zip(T.read_ply(str(tmp_path / "j.ply")),
                    J.read_ply(str(tmp_path / "t.ply"))):
        np.testing.assert_array_equal(a, b)


def test_tokenizer_copy():
    from spatially_aware_ai_tpu.models.clip.tokenizer import ClipTokenizer as J
    from spatially_aware_ai_tpu_torch.models.clip.tokenizer import (
        ClipTokenizer as T,
    )

    texts = ["a red box", "There is the sofa in the scene.", "émigré 42!"]
    np.testing.assert_array_equal(T()(texts), J()(texts))


def test_atomic_copy(tmp_path):
    from spatially_aware_ai_tpu.utils import atomic as J
    from spatially_aware_ai_tpu_torch.utils import atomic as T

    for mod, name in ((T, "t.bin"), (J, "j.bin")):
        with mod.atomic_path(str(tmp_path / name)) as tmp:
            with open(tmp, "wb") as f:
                f.write(b"artifact")
    assert (tmp_path / "t.bin").read_bytes() == (tmp_path / "j.bin").read_bytes()
    assert (tmp_path / "t.bin").stat().st_mode == (tmp_path / "j.bin").stat().st_mode
    with pytest.raises(RuntimeError):
        with T.atomic_path(str(tmp_path / "t.bin")) as tmp:
            open(tmp, "wb").close()
            raise RuntimeError("writer failed")
    assert sorted(os.listdir(tmp_path)) == ["j.bin", "t.bin"]
    assert (tmp_path / "t.bin").read_bytes() == b"artifact"
    obj = {"labels": [None, "my_mug:1"], "w": np.arange(3.0)}
    for mod, name in ((T, "t"), (J, "j")):
        mod.atomic_json_dump(str(tmp_path / f"{name}.json"), obj["labels"],
                             default=str)
        mod.atomic_pickle_dump(str(tmp_path / f"{name}.pkl"), obj)
    for ext in ("json", "pkl"):
        assert (tmp_path / f"t.{ext}").read_bytes() == \
            (tmp_path / f"j.{ext}").read_bytes()


def test_heuristic_segmenters_copy():
    from spatially_aware_ai_tpu.data.synthetic import (
        SyntheticSceneDataset as JaxDataset,
    )
    from spatially_aware_ai_tpu.models.kmax import heuristic as J
    from spatially_aware_ai_tpu_torch.models.kmax import heuristic as T

    frame = JaxDataset(num_frames=2, width=64, height=48, seed=3)[1]
    rgb = np.asarray(frame.rgb, np.float32)
    np.testing.assert_array_equal(T.HeuristicSegmenter().run_on_image(rgb),
                                  J.HeuristicSegmenter().run_on_image(rgb))
    t = T.GeometricSegmenter().segment(rgb, frame.depth, frame.K, frame.pose)
    j = J.GeometricSegmenter().segment(rgb, frame.depth, frame.K, frame.pose)
    np.testing.assert_array_equal(t, j)
    assert T.GeometricSegmenter.needs_geometry
    assert {87, 131} & set(np.unique(t).tolist())
