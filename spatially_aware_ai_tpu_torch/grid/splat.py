"""Kernel B1: the chunk-batched bilinear CLIP-feature splat.

Counterpart of spatially_aware_ai_tpu/grid/pallas_fusion.py
(`fused_feature_splat`) and of `einsum_feature_splat` in
spatially_aware_ai_tpu/grid/fusion.py, which compute the same function:

    feat_sum[N, C] += sum_f sum_{4 corners} w * valid * feat_imgs[f, cy*Px+cx, :]

The CUDA kernel is csrc/feature_splat.cu, two launches per call: a
compaction of the live rows, then the splat, whose CTAs keep a channel
slice of the chunk's feature images in shared memory (the kernel's
`sai_feature_splat_slice` chooses its width) and read the corner rows from
there; where no 32-channel slice fits, they read them from global memory
(the L2 route). On a CUDA tensor the wrappers launch it (or raise); on a
CPU tensor they run the plain PyTorch version below, which repeats the
kernel's arithmetic. Two entry points:

- `splat(feat_sum, uvw, feat_imgs)`: row k of uvw updates grid row k
  (the hybrid integrator);
- `splat_scatter(feat_sum, active, uvw_active, feat_imgs)`:
  feat_sum[active[k]] += contribution of uvw_active row k, in one pass
  (the sparse and brick integrators' phase 2); indices outside [0, N) are
  dead slots and are dropped (JAX's `mode="drop"` scatter, ROADMAP trap
  C2). Active indices must be unique.

`launches` counts kernel launches (CUDA tensors only).
"""
from __future__ import annotations

import ctypes

import torch

# launches of the CUDA kernel, for runs that check the path went through it
launches = 0

_SIGNATURES = {"sai_feature_splat": (ctypes.c_int, [
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]),
    "sai_feature_splat_slice": (ctypes.c_int, [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong])}


def _corner_terms(uvw, Py: int, Px: int):
    """Per (row, frame, corner): flat patch index (clamped) and weight
    (0 for corners outside the grid), the JAX expression term by term."""
    px, py, val = uvw[..., 0], uvw[..., 1], uvw[..., 2]
    x0 = torch.floor(px)
    y0 = torch.floor(py)
    fx = px - x0
    fy = py - y0
    ix = x0.clamp(-2.0, Px + 1.0).to(torch.int64)
    iy = y0.clamp(-2.0, Py + 1.0).to(torch.int64)
    for dy in (0, 1):
        for dx in (0, 1):
            cx = ix + dx
            cy = iy + dy
            wx = fx if dx else (1.0 - fx)
            wy = fy if dy else (1.0 - fy)
            w = wx * wy * val
            inb = (cx >= 0) & (cx < Px) & (cy >= 0) & (cy < Py)
            idx = (cy.clamp(0, Py - 1) * Px + cx.clamp(0, Px - 1))
            yield idx, torch.where(inb, w, torch.zeros_like(w))


def splat_contrib_plain(uvw, feat_imgs):
    """[K, C] contributions of uvw rows [K, F, 3] (plain PyTorch)."""
    K, F = uvw.shape[0], uvw.shape[1]
    _, Py, Px, C = feat_imgs.shape
    flat = feat_imgs.reshape(F, Py * Px, C)
    acc = torch.zeros((K, C), dtype=torch.float32, device=uvw.device)
    for f in range(F):
        for idx, w in _corner_terms(uvw[:, f], Py, Px):
            acc += w[:, None] * flat[f].index_select(0, idx)
    return acc


def splat_plain(feat_sum, uvw, feat_imgs):
    feat_sum += splat_contrib_plain(uvw, feat_imgs)
    return feat_sum


def splat_scatter_plain(feat_sum, active, uvw_active, feat_imgs):
    contrib = splat_contrib_plain(uvw_active, feat_imgs)
    keep = (active >= 0) & (active < feat_sum.shape[0])
    feat_sum.index_add_(0, active[keep], contrib[keep])
    return feat_sum


def splat_work(uvw, Py: int, Px: int, C: int, rows_valid=None):
    """What the splat of uvw [K, F, 3] over F x Py x Px x C images needs,
    counted on these inputs (plain PyTorch, any device). rows_valid [K]
    bool, for the scatter entry: the row's index lies in [0, N); None for
    the dense entry, where every row has its destination and there is no
    index array. A row is touched when it is valid and some frame's
    validity is nonzero; a corner counts when its frame is valid and it
    lies inside the patch grid. Returns a dict:
      touched_rows, corners  (weighted corners of touched rows)
      bytes        each touched feat_sum row read and written once, the
                   uvw rows of valid rows read once (the dense entry must
                   read every row to learn which are live), the row
                   indices read once where there are any, the images read
                   once
      flops        2 per channel per corner
      corner_bytes the corner rows' reads, C floats per corner: the traffic
                   a kernel that reads them from L2 makes"""
    K, F = uvw.shape[0], uvw.shape[1]
    px, py, val = uvw[..., 0], uvw[..., 1], uvw[..., 2]
    touched = (val != 0).any(dim=1)
    if rows_valid is not None:
        touched &= rows_valid
    x0, y0 = torch.floor(px), torch.floor(py)
    inside = torch.zeros_like(val)
    for dy in (0, 1):
        for dx in (0, 1):
            cx, cy = x0 + dx, y0 + dy
            inside += ((cx >= 0) & (cx < Px) & (cy >= 0) & (cy < Py)).float()
    corners = int((inside * ((val != 0) & touched[:, None])).sum())
    n_touched = int(touched.sum())
    uvw_rows, index_bytes = K, 0
    if rows_valid is not None:
        uvw_rows, index_bytes = int(rows_valid.sum()), K * 8
    return {"touched_rows": n_touched, "corners": corners,
            "bytes": (2 * n_touched * C * 4 + uvw_rows * F * 3 * 4
                      + index_bytes + F * Py * Px * C * 4),
            "flops": 2.0 * corners * C,
            "corner_bytes": corners * C * 4}


def _check(feat_sum, uvw, feat_imgs, rows):
    if feat_sum.dtype != torch.float32 or uvw.dtype != torch.float32 \
            or feat_imgs.dtype != torch.float32:
        raise TypeError("feature splat takes float32 feat_sum, uvw and "
                        "feat_imgs")
    if feat_sum.dim() != 2 or uvw.dim() != 3 or uvw.shape[2] != 3 \
            or feat_imgs.dim() != 4:
        raise ValueError(
            f"shapes: feat_sum [N, C], uvw [K, F, 3], feat_imgs "
            f"[F, Py, Px, C]; got {tuple(feat_sum.shape)}, "
            f"{tuple(uvw.shape)}, {tuple(feat_imgs.shape)}")
    C = feat_sum.shape[1]
    if feat_imgs.shape[3] != C or feat_imgs.shape[0] != uvw.shape[1]:
        raise ValueError("feat_imgs [F, Py, Px, C] must match uvw's F and "
                         "feat_sum's C")
    if rows is not None:
        if rows.dtype != torch.int64 or rows.dim() != 1 \
                or rows.shape[0] != uvw.shape[0]:
            raise ValueError("active must be int64 [K] matching uvw's K")
    tensors = [feat_sum, uvw, feat_imgs] + ([rows] if rows is not None
                                            else [])
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"feature splat tensors on several devices: "
                         f"{devices}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("feature splat tensors must be contiguous")
    return devices.pop()


def _launch(feat_sum, rows, uvw, feat_imgs):
    global launches
    from ..native_cuda import check, load

    C = feat_sum.shape[1]
    if C % 4 != 0:
        raise ValueError(f"feature dim {C} must be a multiple of 4")
    if feat_sum.data_ptr() % 16 or feat_imgs.data_ptr() % 16:
        raise ValueError("feat_sum and feat_imgs must be 16-byte aligned")
    if uvw.shape[0] >= 2 ** 30 or feat_sum.shape[0] >= 2 ** 31:
        raise ValueError("too many rows for one launch")
    if uvw.shape[0] == 0:
        return feat_sum
    fn = load("feature_splat", _SIGNATURES).sai_feature_splat
    F, Py, Px = feat_imgs.shape[0], feat_imgs.shape[1], feat_imgs.shape[2]
    # the live rows' count and list, (uvw row, destination) pairs
    scratch = torch.empty(2 * uvw.shape[0] + 2, dtype=torch.int32,
                          device=feat_sum.device)
    err = fn(feat_sum.data_ptr(), feat_sum.shape[0],
             rows.data_ptr() if rows is not None else None,
             uvw.shape[0], uvw.data_ptr(), feat_imgs.data_ptr(),
             F, Py, Px, C, scratch.data_ptr(),
             torch.cuda.current_stream().cuda_stream)
    launches += 1
    check(err, "feature_splat")
    return feat_sum


def splat(feat_sum, uvw, feat_imgs):
    """In place: feat_sum [N, C] += splat of uvw [N, F, 3] (patch-space x,
    y, validity) over feat_imgs [F, Py, Px, C]. Returns feat_sum."""
    if uvw.shape[0] != feat_sum.shape[0]:
        raise ValueError("dense splat needs one uvw row per grid row")
    dev = _check(feat_sum, uvw, feat_imgs, None)
    if dev.type == "cpu":
        return splat_plain(feat_sum, uvw, feat_imgs)
    if dev.type != "cuda":
        raise ValueError(f"feature splat runs on cpu or cuda, not {dev}")
    return _launch(feat_sum, None, uvw, feat_imgs)


def splat_scatter(feat_sum, active, uvw_active, feat_imgs):
    """In place: feat_sum[active[k]] += splat of uvw_active row k, for
    active [K] int64 (unique; indices outside [0, N) dropped). Returns
    feat_sum."""
    dev = _check(feat_sum, uvw_active, feat_imgs, active)
    if dev.type == "cpu":
        return splat_scatter_plain(feat_sum, active, uvw_active, feat_imgs)
    if dev.type != "cuda":
        raise ValueError(f"feature splat runs on cpu or cuda, not {dev}")
    return _launch(feat_sum, active, uvw_active, feat_imgs)
