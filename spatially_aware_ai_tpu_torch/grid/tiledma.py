"""Kernel B4: nearest-pixel sampling of brick voxels inside an image tile.

Counterpart of spatially_aware_ai_tpu/grid/pallas_tiledma.py. The brick
integrator's depth(+label) pass samples the image at every voxel's
projection; voxels of a small brick project into a small image box, so
per (brick, frame) the samples can be read from one tile of the image at
`bbox`. Voxels whose pixel falls outside the tile read 0 and are flagged
`in_tile=False` (a caller would read them through the plain gather).

- `brick_voxel_uv`: brick-major pixel coordinates of every voxel of a dense
  grid, with invalid projections (z <= 0, non-finite uv) moved to -1e6, far
  outside every tile, so that in-tile implies in-image and z > 0;
- `in_image_mask`: the nearest-rounded in-image test of the plain gather;
- `brick_tile_bboxes`: per (brick, frame) tile origins, aligned to (8, 128)
  and clamped into the image as the TPU kernel's DMA needed (Hopper does
  not, but bbox and `fits` then equal the JAX package's exactly);
- `tile_sample_nearest`: the sample itself. On CUDA tensors it launches the
  kernel in csrc/tile_sample.cu (or raises); on CPU tensors it runs
  `tile_sample_nearest_plain`. `launches` counts kernel launches.

Pixels round half to even (torch.round, as jnp.round). Non-finite uv is out
of every tile; the JAX kernel's cast of NaN is undefined, so such inputs
are outside the contract the two packages are compared on. A pixel outside
the image is out of the tile too, which changes nothing for tiles from
`brick_tile_bboxes` and keeps every read in bounds for any other bbox.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.geometry import project_points, world_to_cam

# launches of the CUDA kernel, for runs that check the path went through it
launches = 0

# the TPU tile offsets' (sublane, lane) alignment, kept so that bboxes equal
# the JAX package's
_SUB = 8
_LANE = 128
# |round(u)| beyond this is out of every tile; mirrors kMaxCoord in
# csrc/tile_sample.cu
_MAX_COORD = 2.0 ** 30

_SIGNATURES = {"sai_tile_sample": (ctypes.c_int, [
    *[ctypes.c_void_p] * 5, *[ctypes.c_int] * 8, ctypes.c_void_p])}


def brick_voxel_uv(nvox, origin, voxel_size, poses, Ks, brick: int = 8,
                   device="cuda"):
    """Brick-major projected pixel coordinates of every voxel of a dense
    grid in cubic bricks of `brick`^3 voxels.

    poses [F, 4, 4] and Ks [F, 3, 3] (arrays or tensors). Returns (uv
    [NB, F, V, 2] f32, z [NB, F, V] f32) on `device`. A component of uv is
    -1e6 where it is not finite or z <= 0 (a voxel behind the camera
    projects to a mirrored finite uv that could land in a tile)."""
    dev = resolve_device(device)
    nb = [-(-int(n) // brick) for n in nvox]
    axes = [torch.arange(n, device=dev) for n in nb]
    base = torch.stack(torch.meshgrid(*axes, indexing="ij"), -1)
    base = base.reshape(-1, 3) * brick                          # [NB, 3]
    o = torch.arange(brick, device=dev)
    offs = torch.stack(torch.meshgrid(o, o, o, indexing="ij"), -1)
    offs = offs.reshape(-1, 3)                                  # [V, 3]
    idx = base[:, None, :] + offs[None, :, :]                   # [NB, V, 3]
    xyz = (idx.to(torch.float32)
           * torch.tensor(float(voxel_size), dtype=torch.float32, device=dev)
           + torch.as_tensor(np.asarray(origin, np.float32), device=dev))
    NB, V = xyz.shape[0], brick ** 3
    pts = xyz.reshape(-1, 3)
    poses = torch.as_tensor(np.asarray(poses, np.float32), device=dev)
    Ks = torch.as_tensor(np.asarray(Ks, np.float32), device=dev)
    uvs, zs = [], []
    for pose, K in zip(poses, Ks):
        uv, z = project_points(world_to_cam(pts, pose), K)
        uvs.append(uv.reshape(NB, V, 2))
        zs.append(z.reshape(NB, V))
    uv = torch.stack(uvs, 1)                                 # [NB, F, V, 2]
    z = torch.stack(zs, 1)
    invalid = ~torch.isfinite(uv) | (z <= 0)[..., None]
    uv = torch.where(invalid, torch.full_like(uv, -1e6), uv)
    return uv, z


def in_image_mask(uv, z, H: int, W: int):
    """[...] bool: the nearest pixel of uv [..., 2] lies in the H x W image
    and z > 0 (the plain gather's convention)."""
    x = torch.round(uv[..., 0])
    y = torch.round(uv[..., 1])
    return (x >= 0) & (x < W) & (y >= 0) & (y < H) & (z > 0)


def brick_tile_bboxes(uv, valid, tile_h: int, tile_w: int, H: int, W: int):
    """Per (brick, frame) tile origin covering the valid voxels.

    uv [NB, F, V, 2] f32 pixel (x, y); valid [NB, F, V] bool. Returns (bbox
    [NB, F, 2] int32 (y0, x0): the valid voxels' smallest nearest pixel,
    aligned down to (8, 128) and clamped to an aligned origin whose tile
    lies in the image; fits [NB, F] bool: every valid voxel's pixel is in
    the tile)."""
    if tile_h > H or tile_w > W:
        raise ValueError(f"tile ({tile_h}, {tile_w}) exceeds the image "
                         f"({H}, {W})")
    big = torch.tensor(1e9, dtype=torch.float32, device=uv.device)
    x = torch.round(uv[..., 0])
    y = torch.round(uv[..., 1])
    x_min = torch.where(valid, x, big).amin(dim=-1)
    y_min = torch.where(valid, y, big).amin(dim=-1)
    none_valid = ~valid.any(dim=-1)
    x_min = torch.where(none_valid, torch.zeros_like(x_min), x_min)
    y_min = torch.where(none_valid, torch.zeros_like(y_min), y_min)
    x0 = (x_min.to(torch.int32) // _LANE) * _LANE
    y0 = (y_min.to(torch.int32) // _SUB) * _SUB
    x0 = x0.clamp(0, (max(W - tile_w, 0) // _LANE) * _LANE)
    y0 = y0.clamp(0, (max(H - tile_h, 0) // _SUB) * _SUB)
    in_tile = ((x >= x0[..., None]) & (x < x0[..., None] + tile_w)
               & (y >= y0[..., None]) & (y < y0[..., None] + tile_h))
    fits = (in_tile | ~valid).all(dim=-1)
    return torch.stack([y0, x0], dim=-1), fits


def tile_sample_nearest_plain(img, uv, bbox, tile_h: int, tile_w: int):
    """The plain PyTorch version (see tile_sample_nearest)."""
    F, C, H, W = img.shape
    NB, _, _, V = uv.shape
    rx = torch.round(uv[:, :, 0])                       # [NB, F, V]
    ry = torch.round(uv[:, :, 1])
    finite = (rx.abs() <= _MAX_COORD) & (ry.abs() <= _MAX_COORD)
    zero = torch.zeros((), dtype=uv.dtype, device=uv.device)
    px = torch.where(finite, rx, zero).to(torch.int64)
    py = torch.where(finite, ry, zero).to(torch.int64)
    y0 = bbox[..., 0:1].to(torch.int64)
    x0 = bbox[..., 1:2].to(torch.int64)
    inb = (finite & (px >= x0) & (px < x0 + tile_w) & (py >= y0)
           & (py < y0 + tile_h) & (px >= 0) & (px < W) & (py >= 0)
           & (py < H))
    pix = torch.where(inb, py * W + px, torch.zeros_like(px))
    f = torch.arange(F, device=uv.device)[None, :, None]
    flat = img.reshape(F, C, H * W)
    vals = flat[f, :, pix]                              # [NB, F, V, C]
    samples = torch.where(inb[..., None], vals, zero)
    return samples.permute(0, 1, 3, 2).contiguous(), inb


def tile_sample_nearest(img, uv, bbox, tile_h: int = 256,
                        tile_w: int = 256):
    """Nearest-sample C image channels at brick voxels' pixels, inside each
    (brick, frame)'s tile only.

    img [F, C, H, W] f32; uv [NB, F, 2, V] f32 pixel (x; y) per voxel; bbox
    [NB, F, 2] int32 tile origins (y0, x0) from brick_tile_bboxes. Returns
    (samples [NB, F, C, V] f32, 0 out of the tile; in_tile [NB, F, V]
    bool)."""
    if img.dim() != 4 or uv.dim() != 4 or uv.shape[2] != 2:
        raise ValueError(f"img must be [F, C, H, W] and uv [NB, F, 2, V], "
                         f"got {tuple(img.shape)}, {tuple(uv.shape)}")
    F, C, H, W = img.shape
    NB, F2, _, V = uv.shape
    if F2 != F or tuple(bbox.shape) != (NB, F, 2):
        raise ValueError(f"uv [NB, F, 2, V] and bbox [NB, F, 2] must match "
                         f"img's F={F}, got {tuple(uv.shape)}, "
                         f"{tuple(bbox.shape)}")
    if tile_h <= 0 or tile_w <= 0:
        raise ValueError(f"tile ({tile_h}, {tile_w}) must be positive")
    devices = {img.device, uv.device, bbox.device}
    if len(devices) != 1:
        raise ValueError(f"tile_sample_nearest tensors on several devices: "
                         f"{devices}")
    dev = devices.pop()
    if dev.type == "cpu":
        return tile_sample_nearest_plain(img, uv, bbox, tile_h, tile_w)
    if dev.type != "cuda":
        raise ValueError(f"tile_sample_nearest runs on cpu or cuda, not "
                         f"{dev}")
    if img.dtype != torch.float32 or uv.dtype != torch.float32 \
            or bbox.dtype != torch.int32:
        raise TypeError("tile_sample_nearest takes f32 img and uv and int32 "
                        "bbox")
    if not (img.is_contiguous() and uv.is_contiguous()
            and bbox.is_contiguous()):
        raise ValueError("img, uv and bbox must be contiguous")
    if F > 65535 or H * W >= 2 ** 31:
        raise ValueError(f"tile_sample kernel takes at most 65535 frames "
                         f"(its grid's rows) and 2^31 pixels per plane, got "
                         f"F={F}, {H}x{W}")
    samples = torch.empty((NB, F, C, V), dtype=torch.float32, device=dev)
    in_tile = torch.empty((NB, F, V), dtype=torch.bool, device=dev)
    return _launch(img, uv, bbox, samples, in_tile, tile_h, tile_w)


def _launch(img, uv, bbox, samples, in_tile, tile_h, tile_w):
    global launches
    from ..native_cuda import check, load

    fn = load("tile_sample", _SIGNATURES).sai_tile_sample
    F, C, H, W = img.shape
    NB, V = uv.shape[0], uv.shape[3]
    err = fn(img.data_ptr(), uv.data_ptr(), bbox.data_ptr(),
             samples.data_ptr(), in_tile.data_ptr(), NB, F, C, H, W, V,
             tile_h, tile_w, torch.cuda.current_stream().cuda_stream)
    launches += 1
    check(err, "tile_sample")
    return samples, in_tile
