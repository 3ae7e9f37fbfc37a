"""A seeded room scan, rendered on the device and handed to the port in
the iPhone LiDAR loader's form.

The room is an axis-aligned box (floor at y = 0, y up) with furniture
boxes standing on the floor. The camera walks a hand-held loop around the
room's middle, looking outward all round. Every frame is ray-cast on the
device: rgb at the full size, depth at the sensor's size (a quarter on
each axis), each at its own pixel centres. Surfaces are shaded by a fixed
light and textured by a pattern of their own, so that tiles differ.

`RoomScan` keeps the frames on the host as the loader would hold them
after decoding: rgb uint8 [F, H, W, 3], depth uint16 millimetres
[F, H/4, W/4], and offers `stacked_u8(indices, native_depth=True)` with
`native_depth_scale = 4`, as `IPhone3DScannerDataset` does, plus the
depth-only `bounds_samples`.

Every size and count comes from the traffic file's "scene" block. Its
"room_seed" places and turns a fixed set of boxes and colours the surfaces;
the run's seed jitters the path. The room's size, the boxes' sizes and the
number of frames are the same for every seed.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..reference.scan import bounds_samples


def _uniform(gen, lo, hi, *shape):
    return lo + (hi - lo) * torch.rand(shape, generator=gen,
                                       dtype=torch.float64)


def make_layout(seed: int, p: dict) -> dict:
    """The room, its boxes, colours and camera poses (host, float64, CPU
    generators so that every device gets the same scan). The room's seed is
    the scene's "room_seed" where it has one, else `seed`: it places and
    turns a fixed set of boxes and colours the surfaces. `seed` jitters the
    camera's path. With a room_seed every run seed scans the same room, so
    that the work a scan makes stays the same from seed to seed."""
    room_seed = p.get("room_seed", seed)
    gen = torch.Generator().manual_seed(int(room_seed) % (2 ** 63))
    X, Y, Z = (float(v) for v in p["room_m"])
    sizes = [p["boxes_m"][int(i)] for i in torch.randperm(
        len(p["boxes_m"]), generator=gen)]
    boxes = []
    margin = 0.05
    for sx, sy, sz in sizes:
        if float(torch.rand(1, generator=gen)) < 0.5:
            sx, sz = sz, sx
        # against a wall or free-standing, never over the camera's loop
        for _ in range(1000):
            x0 = float(_uniform(gen, margin, X - sx - margin))
            z0 = float(_uniform(gen, margin, Z - sz - margin))
            cx, cz = x0 + sx / 2 - X / 2, z0 + sz / 2 - Z / 2
            if math.hypot(cx, cz) > p["loop_radius_m"] + 0.6:
                break
        else:
            raise ValueError("no place for a box outside the camera's loop")
        boxes.append([x0, 0.0, z0, x0 + sx, sy, z0 + sz])
    n_surf = 6 + len(boxes)
    colors = _uniform(gen, 0.15, 0.9, n_surf, 3)
    periods = _uniform(gen, *p["texture_period_m"], n_surf, 2)

    gen = torch.Generator().manual_seed(int(seed) % (2 ** 63) ^ 0x5EED)
    F = int(p["frames"])
    r = float(p["loop_radius_m"])
    theta = (torch.arange(F, dtype=torch.float64) * 2 * math.pi / F
             + _uniform(gen, -0.03, 0.03, F))
    yaw = theta + _uniform(gen, -0.25, 0.25, F)
    pitch = _uniform(gen, *p["pitch_down_rad"], F)
    height = _uniform(gen, *p["camera_height_m"], F)
    pos = torch.stack([X / 2 + r * torch.cos(theta)
                       + _uniform(gen, -0.05, 0.05, F), height,
                       Z / 2 + r * torch.sin(theta)
                       + _uniform(gen, -0.05, 0.05, F)], -1)
    fwd = torch.stack([torch.cos(yaw) * torch.cos(pitch), -torch.sin(pitch),
                       torch.sin(yaw) * torch.cos(pitch)], -1)
    up = torch.tensor([0.0, 1.0, 0.0], dtype=torch.float64).expand(F, 3)
    right = torch.nn.functional.normalize(torch.cross(fwd, up, dim=-1),
                                          dim=-1)
    down = torch.cross(fwd, right, dim=-1)
    pose = torch.zeros(F, 4, 4, dtype=torch.float64)
    pose[:, :3, 0], pose[:, :3, 1], pose[:, :3, 2] = right, down, fwd
    pose[:, :3, 3] = pos
    pose[:, 3, 3] = 1.0
    W, H = int(p["width"]), int(p["height"])
    f = W / 2 / math.tan(math.radians(p["hfov_deg"]) / 2)
    K = torch.tensor([[f, 0.0, (W - 1) / 2], [0.0, f, (H - 1) / 2],
                      [0.0, 0.0, 1.0]], dtype=torch.float64)
    return {"room": (X, Y, Z),
            "boxes": torch.tensor(boxes, dtype=torch.float64).reshape(-1, 6),
            "colors": colors, "periods": periods, "pose": pose, "K": K}


def _native_K(K, s: int):
    """Intrinsics of the sensor's frames, a factor s smaller, whose pixel
    centres sit at the rgb's ((j + 0.5) * s - 0.5)."""
    Kn = K.clone()
    Kn[0, 0] /= s
    Kn[1, 1] /= s
    Kn[0, 2] = (K[0, 2] + 0.5) / s - 0.5
    Kn[1, 2] = (K[1, 2] + 0.5) / s - 0.5
    return Kn


def _cast(layout, pose, K, H, W, device):
    """Ray-cast frames: pose [F, 4, 4], K [3, 3] -> (depth along the
    optical axis [F, H, W], surface id [F, H, W], hit point [F, H, W, 3])
    in float32 on `device`."""
    X, Y, Z = layout["room"]
    v, u = torch.meshgrid(
        torch.arange(H, device=device, dtype=torch.float32),
        torch.arange(W, device=device, dtype=torch.float32), indexing="ij")
    Kd = K.to(device, torch.float32)
    cam = torch.stack([(u - Kd[0, 2]) / Kd[0, 0], (v - Kd[1, 2]) / Kd[1, 1],
                       torch.ones_like(u)], -1)            # z = 1 rays
    R = pose[:, :3, :3].to(device, torch.float32)
    o = pose[:, :3, 3].to(device, torch.float32)
    d = torch.einsum("fij,hwj->fhwi", R, cam)               # [F, H, W, 3]
    o = o[:, None, None, :]
    inv = 1.0 / torch.where(d.abs() < 1e-9, torch.full_like(d, 1e-9), d)
    lo = torch.zeros(3, device=device)
    hi = torch.tensor([X, Y, Z], device=device, dtype=torch.float32)
    # the room's inside: the nearest wall the ray leaves through
    t_axis = torch.maximum((lo - o) * inv, (hi - o) * inv)  # [F, H, W, 3]
    t, axis = t_axis.min(dim=-1)
    positive = torch.gather(d, -1, axis[..., None])[..., 0] > 0
    surf = axis * 2 + positive.long()                       # 0..5
    boxes = layout["boxes"].to(device, torch.float32)
    for b in range(boxes.shape[0]):
        t1 = (boxes[b, :3] - o) * inv
        t2 = (boxes[b, 3:] - o) * inv
        tn = torch.minimum(t1, t2).amax(dim=-1)
        tf = torch.maximum(t1, t2).amin(dim=-1)
        hit = (tn <= tf) & (tn > 1e-3) & (tn < t)
        t = torch.where(hit, tn, t)
        surf = torch.where(hit, 6 + b, surf)
    return t, surf, o + d * t[..., None]


def _shade(layout, surf, point, device):
    """rgb in [0, 1]: each surface's colour, a pattern in the surface's
    plane and a fixed directional light."""
    colors = layout["colors"].to(device, torch.float32)
    periods = layout["periods"].to(device, torch.float32)
    base = colors[surf]
    per = periods[surf]
    # the two in-plane coordinates: drop the axis the surface faces
    # (walls and floor by their id, boxes by the nearest face)
    x, y, z = point[..., 0], point[..., 1], point[..., 2]
    walls = surf < 6
    axis = torch.where(walls, surf // 2, torch.zeros_like(surf))
    if layout["boxes"].shape[0]:
        bx = layout["boxes"].to(device, torch.float32)[
            (surf - 6).clamp_min(0)]
        dist = torch.stack([torch.minimum((x - bx[..., 0]).abs(),
                                          (x - bx[..., 3]).abs()),
                            torch.minimum((y - bx[..., 1]).abs(),
                                          (y - bx[..., 4]).abs()),
                            torch.minimum((z - bx[..., 2]).abs(),
                                          (z - bx[..., 5]).abs())], -1)
        axis = torch.where(walls, axis, dist.argmin(dim=-1))
    a = torch.where(axis == 0, z, x)
    b = torch.where(axis == 1, z, y)
    pattern = (0.8 + 0.12 * torch.sin(2 * math.pi * a / per[..., 0])
               * torch.sin(2 * math.pi * b / per[..., 1])
               + 0.08 * torch.sign(torch.sin(2 * math.pi * (a + b)
                                             / (3 * per[..., 0]))))
    normal_light = torch.tensor([0.55, 0.85, 0.35], device=device)
    lam = normal_light[axis].abs()
    return (base * pattern[..., None] * (0.45 + 0.55 * lam[..., None])
            ).clamp(0.0, 1.0)


class RoomScan:
    """The seeded scan in the iPhone loader's form (see the module
    docstring). Frames are rendered on `device` in chunks and kept on the
    host."""

    native_depth_scale = 4

    def __init__(self, seed: int, scene: dict, device="cuda",
                 chunk: int = 8):
        self.layout = make_layout(seed, scene)
        s = self.native_depth_scale
        self.imwidth = int(scene["width"])
        self.imheight = int(scene["height"])
        if self.imwidth % s or self.imheight % s:
            raise ValueError(f"frame size must be a multiple of {s}")
        K = self.layout["K"]
        Kn = _native_K(K, s)
        pose = self.layout["pose"]
        F = pose.shape[0]
        rgbs, depths = [], []
        with torch.no_grad():
            for i in range(0, F, chunk):
                p = pose[i:i + chunk]
                _, surf, point = _cast(self.layout, p, K, self.imheight,
                                       self.imwidth, device)
                rgb = _shade(self.layout, surf, point, device)
                rgbs.append((rgb * 255.0).round().to(torch.uint8))
                t, _, _ = _cast(self.layout, p, Kn, self.imheight // s,
                                self.imwidth // s, device)
                depths.append((t * 1000.0).round().clamp(0, 65535)
                              .to(torch.int32))
            self.rgb = torch.cat(rgbs).cpu().numpy()
            self.depth = torch.cat(depths).cpu().numpy().astype(np.uint16)
        self.pose = pose.numpy().astype(np.float32)
        self.K = np.broadcast_to(K.numpy().astype(np.float32),
                                 (F, 3, 3)).copy()

    def __len__(self):
        return len(self.rgb)

    def stacked_u8(self, indices=None, native_depth=False):
        """rgb uint8 [F, H, W, 3], depth uint16 mm at the sensor's size
        [F, h, w] with "depth_upsample": 4, pose, K, index (the loader's
        native-depth form; fuse_scan asks for it because
        `native_depth_scale` is 4)."""
        if not native_depth:
            raise ValueError("the scan holds the sensor's depth only: ask "
                             "for native_depth=True")
        idx = np.arange(len(self)) if indices is None else np.asarray(
            list(indices), np.int64)
        return {"rgb": self.rgb[idx], "depth": self.depth[idx],
                "pose": self.pose[idx], "K": self.K[idx], "index": idx,
                "depth_upsample": self.native_depth_scale}

    def bounds_samples(self, uv_size: int = 7):
        """(depth [F, P] m, uu, vv, pose, K): the enlarged depth at the
        bounds subsample, worked out from the sensor's frames only."""
        if uv_size != 7:
            raise ValueError("the scan's bounds subsample is 7x7")
        depth, uu, vv = bounds_samples(self.depth, self.native_depth_scale,
                                       self.imwidth, self.imheight)
        return depth, uu, vv, self.pose, self.K
