"""The seeded room scan: deterministic, seed-dependent, in the iPhone
loader's form, and taken by the port's fuse_scan."""
import numpy as np
import torch

from perfbench.scenes.room import RoomScan
from perfbench.tests import tiny


def _scene(frames=4):
    return dict(tiny.traffic("scan")["scene"], frames=frames)


def test_same_seed_same_frames():
    a = RoomScan(2 ** 31 + 11, _scene(), device="cpu")
    b = RoomScan(2 ** 31 + 11, _scene(), device="cpu")
    for k in ("rgb", "depth", "pose", "K"):
        assert np.array_equal(getattr(a, k), getattr(b, k)), k


def test_different_seeds_differ():
    a = RoomScan(5, _scene(), device="cpu")
    b = RoomScan(6, _scene(), device="cpu")
    assert not np.array_equal(a.rgb, b.rgb)
    assert not np.array_equal(a.depth, b.depth)
    assert not np.array_equal(a.pose, b.pose)


def test_room_seed_fixes_the_room_and_the_seed_the_path():
    from perfbench.scenes.room import make_layout

    scene = _scene()
    assert "room_seed" in scene
    a, b = make_layout(5, scene), make_layout(6, scene)
    for k in ("boxes", "colors", "periods"):
        assert torch.equal(a[k], b[k]), k
    assert not torch.equal(a["pose"], b["pose"])
    free = {k: v for k, v in scene.items() if k != "room_seed"}
    assert not torch.equal(make_layout(5, free)["boxes"],
                           make_layout(6, free)["boxes"])


def test_every_seed_has_the_same_sizes():
    shapes = {tuple(RoomScan(s, _scene(), device="cpu").stacked_u8(
        native_depth=True)["depth"].shape) for s in (1, 2 ** 31 + 3)}
    assert len(shapes) == 1


def test_loader_form_matches_the_iphone_loader():
    """IPhone3DScannerDataset.stacked_u8(..., native_depth=True): rgb uint8
    [F, H, W, 3], depth uint16 [F, H/4, W/4], pose / K float32, index,
    depth_upsample 4; native_depth_scale 4; bounds_samples' 7x7."""
    s = RoomScan(3, _scene(), device="cpu")
    out = s.stacked_u8([0, 2, 3], native_depth=True)
    W, H = s.imwidth, s.imheight
    assert out["rgb"].dtype == np.uint8 and out["rgb"].shape == (3, H, W, 3)
    assert out["depth"].dtype == np.uint16
    assert out["depth"].shape == (3, H // 4, W // 4)
    assert out["pose"].dtype == np.float32 and out["pose"].shape == (3, 4, 4)
    assert out["K"].dtype == np.float32 and out["K"].shape == (3, 3, 3)
    assert list(out["index"]) == [0, 2, 3]
    assert out["depth_upsample"] == 4 == s.native_depth_scale
    depth, uu, vv, pose, K = s.bounds_samples()
    assert depth.shape == (4, 49) and uu.shape == vv.shape == (49,)
    assert (depth > 0).all() and (depth < 8).all()
    R = s.pose[:, :3, :3]
    assert np.allclose(R @ R.transpose(0, 2, 1), np.eye(3), atol=1e-5)


def test_fuse_scan_takes_it_on_the_cpu():
    from spatially_aware_ai_tpu_torch.models.clip.engine import ClipEngine
    from spatially_aware_ai_tpu_torch.pipeline import FusionConfig, fuse_scan

    s = RoomScan(9, _scene(frames=3), device="cpu")
    engine = ClipEngine.tiny(device="cpu")
    res = fuse_scan(s, engine, FusionConfig(voxel_size=0.15, frame_chunk=2),
                    device="cpu")
    assert res.timings["upload_s"] >= 0
    assert int((torch.as_tensor(res.values["weight"]) > 0).sum()) > 0
