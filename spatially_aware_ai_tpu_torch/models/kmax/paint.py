"""Kernel B3: sequential panoptic mask paint (claim resolution).

Counterpart of spatially_aware_ai_tpu/models/kmax/pallas_paint.py
(`paint_masks`). Per frame, the N query masks are walked in paint order
j = 0..N-1 (query order[f, j]); m = prob > pixel_threshold, new = m on
unclaimed pixels; the query is accepted iff keep[f, j], |m| > 0 and
|new| / max(|m|, 1) >= overlap_threshold, and then stamps j on its new
pixels. The result is claim [F, h, w] int32, -1 where unclaimed, and
accepted [F, N] bool in paint order (with overlap_threshold <= 0 a query
can be accepted and paint nothing, so the claims do not say it).

The CUDA kernel is csrc/paint_masks.cu: three launches (pack the kept
planes into bits on every SM, resolve each frame's accept chain over the
bits, stamp the claims on every SM), counted as one launch per call in
`launches`. On CUDA tensors `paint_masks` launches it (or raises); on CPU
tensors it runs `paint_masks_plain`, the claim-carrying loop of the JAX
package's panoptic_inference_batch (model.py, the fori path), vectorised
over frames.
"""
from __future__ import annotations

import ctypes

import torch

# launches of the CUDA kernel, for runs that check the path went through it
launches = 0

_INT3 = [ctypes.c_int] * 3
_SIGNATURES = {
    "sai_paint_pack": (ctypes.c_int, [*[ctypes.c_void_p] * 5, *_INT3,
                                      ctypes.c_float, ctypes.c_void_p]),
    "sai_paint_resolve": (ctypes.c_int, [*[ctypes.c_void_p] * 5, *_INT3,
                                         ctypes.c_float, ctypes.c_void_p]),
    "sai_paint_stamp": (ctypes.c_int, [*[ctypes.c_void_p] * 3, *_INT3,
                                       ctypes.c_void_p]),
}

# the JAX contract's query count; the kernel builds its step lists with
# four warps. Mirrors kMaxQueries in csrc/paint_masks.cu
MAX_QUERIES = 128
# h * w whose bits the resolve step's 256 threads hold in registers (7
# chunks of 4 words each); mirrors kMaxPixels in csrc/paint_masks.cu
MAX_PIXELS = 7 * 256 * 4 * 32
# frames are the stamp step's grid rows
MAX_FRAMES = 65535


def _f32(value: float, device) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=device)


def paint_masks_plain(mask_probs, order, keep, *, overlap_threshold: float,
                      pixel_threshold: float):
    """The plain PyTorch version: one vectorised step per paint index."""
    F, N, h, w = mask_probs.shape
    dev = mask_probs.device
    binary = mask_probs > _f32(pixel_threshold, dev)     # [F, N, h, w]
    area = binary.sum(dim=(2, 3))                        # [F, N]
    order = order.long()
    frames = torch.arange(F, device=dev)
    thr = _f32(overlap_threshold, dev)
    claim = torch.full((F, h, w), -1, dtype=torch.int32, device=dev)
    accepted = torch.zeros((F, N), dtype=torch.bool, device=dev)
    for j in range(N):
        q = order[:, j]
        m = binary[frames, q]                            # [F, h, w]
        new = m & (claim < 0)
        a = area[frames, q]
        ratio = new.sum(dim=(1, 2)).float() / a.clamp_min(1).float()
        ok = (keep[:, j] > 0) & (a > 0) & (ratio >= thr)
        claim = torch.where(new & ok[:, None, None], j, claim)
        accepted[:, j] = ok
    return claim, accepted


def paint_masks(mask_probs, order, keep, *, overlap_threshold: float,
                pixel_threshold: float):
    """mask_probs [F, N, h, w] f32, query-softmaxed and NOT sorted; order
    [F, N] int (paint order, most confident first); keep [F, N] int or
    bool, in PAINT order (keep[f, j] gates query order[f, j]). Returns
    (claim [F, h, w] int32: the paint index of the accepted query that
    claimed each pixel, -1 where unclaimed; accepted [F, N] bool in paint
    order)."""
    if mask_probs.dim() != 4:
        raise ValueError(f"mask_probs must be [F, N, h, w], got "
                         f"{tuple(mask_probs.shape)}")
    F, N, h, w = mask_probs.shape
    for name, t in (("order", order), ("keep", keep)):
        if tuple(t.shape) != (F, N):
            raise ValueError(f"{name} must be [{F}, {N}], got "
                             f"{tuple(t.shape)}")
    devices = {mask_probs.device, order.device, keep.device}
    if len(devices) != 1:
        raise ValueError(f"paint_masks tensors on several devices: {devices}")
    dev = devices.pop()
    if dev.type == "cpu":
        return paint_masks_plain(mask_probs, order, keep,
                                 overlap_threshold=overlap_threshold,
                                 pixel_threshold=pixel_threshold)
    if dev.type != "cuda":
        raise ValueError(f"paint_masks runs on cpu or cuda, not {dev}")
    if mask_probs.dtype != torch.float32 or not mask_probs.is_contiguous():
        raise ValueError("mask_probs must be contiguous float32")
    if N > MAX_QUERIES:
        raise ValueError(f"paint_masks kernel takes at most {MAX_QUERIES} "
                         f"queries, got {N}")
    if h * w > MAX_PIXELS:
        raise ValueError(f"paint_masks kernel takes at most {MAX_PIXELS} "
                         f"pixels per map, got {h}x{w}")
    if F > MAX_FRAMES:
        raise ValueError(f"paint_masks kernel takes at most {MAX_FRAMES} "
                         f"frames, got {F}")
    order = order.to(torch.int32).contiguous()
    keep = keep.to(torch.int32).contiguous()
    claim = torch.empty((F, h, w), dtype=torch.int32, device=dev)
    accepted = torch.empty((F, N), dtype=torch.bool, device=dev)
    return _launch(mask_probs, order, keep, claim, accepted,
                   overlap_threshold, pixel_threshold)


def _launch(probs, order, keep, claim, accepted, overlap_threshold,
            pixel_threshold, marks=None):
    """Pack, resolve and stamp on the current stream, with the workspace
    (bits [F, N, 4 * ceil(hw / 128)], areas [F, N], accepted lists
    [F, N + 1]) from torch.empty. marks: four CUDA events, recorded before
    each step and after the last, for timing the steps apart."""
    global launches
    from ...native_cuda import check, load

    lib = load("paint_masks", _SIGNATURES)
    F, N, h, w = probs.shape
    hw = h * w
    dev = probs.device
    # rows of ceil(hw / 32) words rounded up to 16 bytes
    bits = torch.empty((F, N, 4 * -(-hw // 128)), dtype=torch.int32,
                       device=dev)
    area = torch.empty((F, N), dtype=torch.int32, device=dev)
    acc_list = torch.empty((F, N + 1), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    steps = (
        ("pack", lambda: lib.sai_paint_pack(
            probs.data_ptr(), order.data_ptr(), keep.data_ptr(),
            bits.data_ptr(), area.data_ptr(), F, N, hw,
            float(pixel_threshold), stream)),
        ("resolve", lambda: lib.sai_paint_resolve(
            bits.data_ptr(), area.data_ptr(), keep.data_ptr(),
            accepted.data_ptr(), acc_list.data_ptr(), F, N, hw,
            float(overlap_threshold), stream)),
        ("stamp", lambda: lib.sai_paint_stamp(
            bits.data_ptr(), acc_list.data_ptr(), claim.data_ptr(), F, N, hw,
            stream)),
    )
    launches += 1
    for i, (name, step) in enumerate(steps):
        if marks is not None:
            marks[i].record()
        check(step(), f"paint_masks {name}")
    if marks is not None:
        marks[-1].record()
    return claim, accepted
