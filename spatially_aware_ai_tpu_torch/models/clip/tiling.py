"""Tiled CLIP feature extraction: overlapping patches -> per-patch
embeddings folded into a low-res [ny, nx, C] feature image.

Mirrors spatially_aware_ai_tpu/models/clip/tiling.py
(`tiled_image_features_batch`, the single-frame `tiled_image_features`,
the unfolds `get_patches` / `get_patches_cf`): normalize with the CLIP
channel stats, unfold patch_size / patch_stride tiles, resize each to the
tower's input size (bilinear, align_corners=False, no antialias), encode
all F * ny * nx tiles in one batch. When the geometry divides evenly and
tiles are downscaled (patch_size >= 224, e.g. 256/128 at 1024x768), the
whole frame is resized once and 224-tiles are unfolded at the scaled
stride — the JAX package's fast prep, equivalent to resizing each tile.
Images are channels-first inside; the public layout is the JAX one
([F, H, W, 3]).

On that path `ClipEngine.img_inference_tiled_batch` takes the fused conv
stem: the 224-tiles are unfolded straight into the [tiles * g * g,
3 * p * p] token matrix of the tower's p x p patches, conv1 is one product
with it, and the tower starts from its tokens (`CLIP.encode_image_tokens`);
the [tiles, 3, 224, 224] tile tensor is never written. The tokens are the
unfused path's: the same values against the same weight in the same
product.

`F.interpolate(bilinear, align_corners=False, antialias=False)` equals
`jax.image.resize(bilinear, antialias=False)` on these paths (ROADMAP trap
C5; pinned by tests/test_torch_clip.py).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ...core.device import full_f32

OPENAI_CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
OPENAI_CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def num_patches(size: int, patch_size: int, patch_stride: int) -> int:
    if (size - patch_size) % patch_stride != 0:
        raise ValueError(
            f"(size - patch_size) must be divisible by stride: "
            f"{size=} {patch_size=} {patch_stride=}"
        )
    return (size - patch_size) // patch_stride + 1


def get_patches(img, patch_size: int, patch_stride: int):
    """img [H, W, C] -> [ny, nx, patch_size, patch_size, C] overlapping
    tiles."""
    num_patches(img.shape[0], patch_size, patch_stride)
    num_patches(img.shape[1], patch_size, patch_stride)
    t = img.unfold(0, patch_size, patch_stride).unfold(
        1, patch_size, patch_stride)                  # [ny, nx, C, ps, ps]
    return t.permute(0, 1, 3, 4, 2)


def get_patches_cf(img, patch_size: int, patch_stride: int):
    """Channels-first unfold: [..., H, W] -> [ny, nx, ..., ps, ps].
    Requires patch_size % patch_stride == 0, as the JAX package's does."""
    num_patches(img.shape[-2], patch_size, patch_stride)
    num_patches(img.shape[-1], patch_size, patch_stride)
    if patch_size % patch_stride != 0:
        raise ValueError("get_patches_cf requires patch_size % stride == 0")
    t = img.unfold(-2, patch_size, patch_stride).unfold(
        -2, patch_size, patch_stride)                 # [..., ny, nx, ps, ps]
    lead = img.dim() - 2
    return t.permute(lead, lead + 1, *range(lead), lead + 2, lead + 3)


def _unfold(x, size: int, stride: int):
    """[F, 3, H, W] -> [F * ny * nx, 3, size, size] tiles, frame-major then
    row-major over the tile grid."""
    Fn, C = x.shape[0], x.shape[1]
    t = x.unfold(2, size, stride).unfold(3, size, stride)  # F,3,ny,nx,s,s
    ny, nx = t.shape[2], t.shape[3]
    return t.permute(0, 2, 3, 1, 4, 5).reshape(Fn * ny * nx, C, size, size)


def resize_bilinear(x, size):
    """[B, C, h, w] -> [B, C, *size], bilinear, half-pixel centers, no
    antialias (jax.image.resize(method="bilinear", antialias=False))."""
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False,
                         antialias=False)


def _stem_tokens(small, kernel, vit_size: int, stride: int, conv_patch: int):
    """The fused conv stem: [F, 3, H2, W2] resized frames and conv1's
    weight [D, 3, cp, cp] -> patch tokens [F * ny * nx, g * g, D] of every
    vit_size tile at `stride`, row-major over each tile's g x g token grid.
    One copy makes the [F * ny * nx * g * g, 3 * cp * cp] matrix, rows in
    (frame, tile row, tile column, token row, token column) order and
    (channel, ky, kx) inside a row, the order of the weight's reshape; the
    product runs in the frames' dtype with TF32 off."""
    cp = conv_patch
    g = vit_size // cp
    p = get_patches_cf(small, vit_size, stride)    # [ny, nx, F, 3, vs, vs]
    ny, nx, Fn, C = p.shape[:4]
    p = p.reshape(ny, nx, Fn, C, g, cp, g, cp).permute(2, 0, 1, 4, 6, 3, 5, 7)
    flat = p.reshape(Fn * ny * nx * g * g, C * cp * cp)
    kmat = kernel.reshape(kernel.shape[0], -1).to(flat.dtype)
    with full_f32():
        tokens = F.linear(flat, kmat)
    return tokens.reshape(Fn * ny * nx, g * g, -1)


def tiled_image_features_batch(imgs, *, patch_size: int, patch_stride: int,
                               encode_fn, prep_dtype=None,
                               conv_kernel_fn=None, encode_tokens_fn=None,
                               conv_patch=None, vit_size: int = 224):
    """imgs [F, H, W, 3] in [0, 1] -> [F, ny, nx, C] tiled CLIP features.

    encode_fn: [B, 3, vit, vit] channel-normalized -> [B, C].
    conv_kernel_fn / encode_tokens_fn / conv_patch: with all three (conv1's
    weight accessor, [B, g * g, width] tokens -> [B, C], the tower's patch
    size), the resize-once path takes the fused conv stem when vit_size is
    a multiple of conv_patch and of the scaled stride; the per-tile path
    ignores them, as the JAX package's does."""
    if prep_dtype is not None:
        imgs = imgs.to(prep_dtype)
    mean = torch.as_tensor(OPENAI_CLIP_MEAN, device=imgs.device,
                           dtype=imgs.dtype)
    std = torch.as_tensor(OPENAI_CLIP_STD, device=imgs.device,
                          dtype=imgs.dtype)
    imgs = (imgs - mean) / std
    Fn, H, W = imgs.shape[0], imgs.shape[1], imgs.shape[2]
    ny = num_patches(H, patch_size, patch_stride)
    nx = num_patches(W, patch_size, patch_stride)
    x = imgs.permute(0, 3, 1, 2)
    vs = vit_size
    if (
        patch_size >= vs
        and (H * vs) % patch_size == 0
        and (W * vs) % patch_size == 0
        and (patch_stride * vs) % patch_size == 0
    ):
        H2, W2 = H * vs // patch_size, W * vs // patch_size
        stride2 = patch_stride * vs // patch_size
        small = resize_bilinear(x, (H2, W2))
        if (
            conv_kernel_fn is not None
            and encode_tokens_fn is not None
            and conv_patch is not None
            and vs % conv_patch == 0
            and vs % stride2 == 0
        ):
            feats = encode_tokens_fn(_stem_tokens(
                small, conv_kernel_fn(), vs, stride2, conv_patch))
            return feats.reshape(Fn, ny, nx, -1)
        flat = _unfold(small, vs, stride2)
    else:
        flat = resize_bilinear(_unfold(x, patch_size, patch_stride), (vs, vs))
    feats = encode_fn(flat.contiguous())
    return feats.reshape(Fn, ny, nx, -1)


def tiled_image_features(img, *, patch_size: int, patch_stride: int,
                         encode_fn, prep_dtype=None, vit_size: int = 224):
    """One frame [H, W, 3] in [0, 1] -> [ny, nx, C] tiled CLIP features:
    `tiled_image_features_batch` on a batch of one."""
    return tiled_image_features_batch(
        img[None], patch_size=patch_size, patch_stride=patch_stride,
        encode_fn=encode_fn, prep_dtype=prep_dtype, vit_size=vit_size)[0]


def _depthscaled_crops(imgs, depth, K, patch_stride: int, footprint_m: float,
                       vit_size: int):
    """Per stride-grid centre of every frame, the crop whose pixel size
    covers footprint_m at the centre's depth, resampled to vit_size.
    Returns (crops [F * n, vit, vit, 3] channel-normalized, centres [n, 2]
    (x, y), half sizes [F, n, 2] in pixels, valid [F, n], (ny, nx))."""
    from ...core.sampling import sample_image_at_uv

    Fn, H, W = imgs.shape[0], imgs.shape[1], imgs.shape[2]
    dev = imgs.device
    ycs = torch.arange(patch_stride, H, patch_stride, device=dev)
    xcs = torch.arange(patch_stride, W, patch_stride, device=dev)
    ny, nx = ycs.shape[0], xcs.shape[0]
    cy, cx = torch.meshgrid(ycs, xcs, indexing="ij")
    centres = torch.stack([cx.reshape(-1), cy.reshape(-1)], -1).to(
        torch.float32)                                         # [n, 2]
    n = centres.shape[0]

    d = depth[:, cy.reshape(-1), cx.reshape(-1)]               # [F, n]
    valid = d > 0
    safe_d = torch.where(valid, d, torch.ones_like(d))
    fx, fy = K[:, 0, 0, None], K[:, 1, 1, None]
    half = torch.stack([fx * footprint_m / safe_d / 2.0,
                        fy * footprint_m / safe_d / 2.0], -1)  # [F, n, 2]

    # per-crop [vit, vit] sampling grids (align_corners=False convention)
    t = (torch.arange(vit_size, dtype=torch.float32, device=dev) + 0.5) \
        / vit_size
    lo = centres - half
    size = 2.0 * half
    us = lo[..., None, 0:1] + t[:, None] * size[..., None, 0:1]  # [F,n,v,1]
    vs = lo[..., None, 1:2] + t[:, None] * size[..., None, 1:2]
    shape = (Fn, n, vit_size, vit_size, 1)
    uv = torch.cat([us[:, :, None].expand(shape),
                    vs[:, :, :, None].expand(shape)], dim=-1) - 0.5

    mean = torch.as_tensor(OPENAI_CLIP_MEAN, device=dev)
    std = torch.as_tensor(OPENAI_CLIP_STD, device=dev)
    normed = (imgs - mean) / std
    crops = torch.stack([
        sample_image_at_uv(normed[f], uv[f].reshape(-1, 2))
        for f in range(Fn)]).reshape(Fn * n, vit_size, vit_size, 3)
    return crops, centres, half, valid, (ny, nx)


def tiled_image_features_depthscaled(imgs, depth, K, *, patch_stride: int,
                                     encode_fn, footprint_m: float = 0.5,
                                     vit_size: int = 224):
    """Depth-scaled tiled CLIP features (the JAX package's
    `tiled_image_features_depthscaled`; reference clipfusion.py:841-890):
    each stride-grid centre gets a crop whose pixel size covers
    `footprint_m` at that centre's depth, so CLIP sees about the same
    world size everywhere.

    imgs [F, H, W, 3] in [0, 1], depth [F, H, W] meters, K [F, 3, 3], on
    one device. All crops of all frames are sampled bilinearly and encoded
    in ONE forward (the JAX package jits one frame at a time: the same
    function). The overlap splat onto the [ny, nx] cells that the fusion
    sampler assigns to a feature image (cell p's centre (p + 0.5) * W / nx
    - 0.5) is a small [n, n] product per frame; centres with no depth get
    weight 0 and cells no crop covers stay zero. Returns [F, ny, nx, C].

    encode_fn: [B, 3, vit, vit] channel-normalized -> [B, C]."""
    Fn, H, W = imgs.shape[0], imgs.shape[1], imgs.shape[2]
    crops, centres, half, valid, (ny, nx) = _depthscaled_crops(
        imgs, depth, K, patch_stride, footprint_m, vit_size)
    n = centres.shape[0]
    feats = encode_fn(crops.permute(0, 3, 1, 2).contiguous())
    feats = feats.reshape(Fn, n, -1)

    dev = imgs.device
    dst_x = (torch.arange(nx, dtype=torch.float32, device=dev) + 0.5) \
        * (W / nx) - 0.5
    dst_y = (torch.arange(ny, dtype=torch.float32, device=dev) + 0.5) \
        * (H / ny) - 0.5
    dgy, dgx = torch.meshgrid(dst_y, dst_x, indexing="ij")
    centres_dst = torch.stack([dgx.reshape(-1), dgy.reshape(-1)], -1)

    delta = (centres_dst[None, :, :] - centres[:, None, :]).abs()  # [s, d, 2]
    covers = ((delta[None, ..., 0] <= half[:, :, None, 0])
              & (delta[None, ..., 1] <= half[:, :, None, 1])
              & valid[:, :, None]).to(torch.float32)            # [F, s, d]
    wsum = covers.sum(dim=1)                                    # [F, d]
    fsum = torch.einsum("fsd,fsc->fdc", covers, feats)
    out = fsum / wsum.clamp_min(1.0)[..., None]
    return out.reshape(Fn, ny, nx, -1)
