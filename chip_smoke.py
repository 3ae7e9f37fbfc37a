#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (spatially_aware_ai_tpu_torch) on one
NVIDIA card.

    python3 chip_smoke.py                    # every phase
    python3 chip_smoke.py --phases build,kernels,crosscheck_kmax,path_kmax
    python3 chip_smoke.py --phases build,kernels,probe_tiledma,path_brick

Phases, each printing one JSON line:

1. build      nvcc builds the CUDA kernels (feature splat B1, fused LN->MLP
              B2, panoptic paint B3, tile sample B4) from csrc/ for sm_90a,
              in parallel; seconds and ptxas register / spill lines.
2. kernels    each kernel against its plain PyTorch version on the card at
              the main paths' shapes: max abs error against the stated
              tolerance (B3, B4: equal), kernel ms (median of CUDA-event
              timings after a warm-up, the calls queued behind a device
              sleep so that each reads device time, not launch cost), plain
              ms, a library call's ms where one exists, and the bound (least
              time the card could take). B3 also gives its three steps'
              times (pack, resolve, stamp) and the longest chain of kept
              steps in a frame; B4 its achieved bytes/s.
3. crosscheck the small synthetic path (96x72, 8 frames, 0.06 m voxels, tiny
              CLIP) on the CPU (plain versions) and on the card (kernels):
              integer accumulators must agree exactly, tsdf / rgb within
              1e-5, features by cosine >= 0.9999.
4. crosscheck_kmax
              a small kMaX (ConvNeXt widths 64-256, which B2 takes) on the
              CPU and on the card with one state dict: mask logits within
              1e-3, class logits within 1e-4 of their scale, device-fused
              labels equal on >= 99.9% of the pixels, and the CPU's logits
              through the card's panoptic inference (B3) give the CPU's
              category / segment maps exactly, also at overlap threshold 0.
5. probe_tiledma
              benchmarks/probe_tiledma.py's A/B at its operating point:
              1024x768 depth + label, a 57x56x55 grid at 0.04 m in 8^3
              bricks (392), F=8, 256x256 tiles. The plain gather
              (sample_image_at_uv nearest over the flat voxel set, per
              frame) and B4, ms per chunk each, and the tiles' coverage.
              B4 must agree with the gather on in-image, in-tile voxels,
              flag no voxel outside the image, and launch.
6. path       the first slice's path at full width: 32 frames of 1024x768
              at 0.02 m, CLIP ViT-B/32 quick-gelu (random weights from seed
              0, f32), ColorSegmenter labels, the sparse integrator; then
              extract_mesh, flood_fill_3d and a 3-prompt text query. Kernel
              launch counts are zeroed just before and read just after; a
              kernel with no launch fails the run.
7. path_brick the `path` configuration with integrator="brick"; then the
              sparse integrator on the same inputs in the same process:
              tsdf_w, w and label_hist equal, tsdf_sum and rgb_sum within
              1e-5 of their largest magnitude, features by cosine >=
              0.9999; then mesh, objects and query as `path`. Both
              integrate_s, the active / total bricks per chunk, launches
              (B1 and B2 must launch).
8. path_kmax  the same scan and CLIP with kMaX-DeepLab ConvNeXt-L labels at
              full width (test long edge 1281, f32, random weights from
              seed 0, class head and mask-logit scale raised so that frames
              are painted), fused on the device; then the same mesh,
              objects and query. Counts as in `path`; B3 must launch once
              per chunk.
9. profile    the kMaX path's fuse_scan (the first path's without
              path_kmax) once more under torch.profiler: device time by
              kernel, each port kernel's (B1-B4) device time and launches,
              and the device's busy time, as a share of the profiled wall
              and of the unprofiled fuse_scan.

Then a JSON line {"kernels": [...]} with each kernel's numbers, the card's
name and power limit from nvidia-smi, and, last, the device line. Any
failed phase exits non-zero. Without a CUDA card, or without the package
beside this script, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (dense): HBM bytes/s, f32 CUDA-core FLOP/s,
# TF32 and bf16 tensor-core FLOP/s
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_TF32 = 495e12
PEAK_BF16 = 989e12

SPLAT_REPLACES = "spatially_aware_ai_tpu/grid/pallas_fusion.py:105"
MLP_REPLACES = "spatially_aware_ai_tpu/models/pallas_mlp.py:222"
PAINT_REPLACES = "spatially_aware_ai_tpu/models/kmax/pallas_paint.py:137"
TILE_REPLACES = "spatially_aware_ai_tpu/grid/pallas_tiledma.py:196"

# a device sleep (in clock cycles, about 5 ms) ahead of the timed calls: the
# host queues them all while the card sleeps, so the events read the card's
# time per call and not the host's time to launch it
SLEEP_CYCLES = 10_000_000

# kernel names of each port kernel in a profiler trace
PORT_KERNELS = {"feature_splat": ("splat_kernel",),
                "ln_mlp": ("ln_mlp_fused", "ln_mlp_phase", "ln_stats",
                           "split_kernel"),
                "paint_masks": ("paint_",),
                "tile_sample": ("tile_sample_kernel",)}

# random kMaX weights paint nothing (class scores stay under 0.5, cosine
# mask logits in [-1, 1] under the 0.4 pixel threshold): the kMaX phases
# scale the class head and the mask-logit BN by these factors
KMAX_CLASS_SCALE = 20.0
KMAX_MASK_SCALE = 100.0


def emit(obj):
    print(json.dumps(obj), flush=True)


def time_ms(fn, warmup: int = 3, iters: int = 15) -> float:
    """Median CUDA-event time of fn() in ms, after a warm-up, with the calls
    queued behind a device sleep (SLEEP_CYCLES)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    pairs = []
    for _ in range(iters):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


# ---------------------------------------------------------------- phases


def phase_build():
    from spatially_aware_ai_tpu_torch import native_cuda

    t0 = time.perf_counter()
    out = native_cuda.build(["feature_splat", "ln_mlp", "paint_masks",
                             "tile_sample"], verbose=True)
    ptxas = {
        name: [ln.strip() for ln in info["log"].splitlines()
               if "registers" in ln or "spill" in ln]
        for name, info in out.items()
    }
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_kernel_s": {k: v["seconds"] for k, v in out.items()},
          "ptxas": ptxas})


def _splat_inputs(gen, N_buf, K, F, Py, Px, C, dev):
    import torch

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    feat_sum = torch.randn((N_buf, C), generator=gen, device=dev)
    feat_imgs = torch.randn((F, Py, Px, C), generator=gen, device=dev)
    # coordinates reach past every edge (out-of-grid corners add 0); a third
    # of the rows are invalid in every frame
    uvw = torch.stack([rand(K, F) * (Px + 2.0) - 1.5,
                       rand(K, F) * (Py + 2.0) - 1.5,
                       (rand(K, F) < 0.6).float()], dim=-1)
    uvw[rand(K) < 0.33] *= torch.tensor([1.0, 1.0, 0.0], device=dev)
    return feat_sum, feat_imgs, uvw.contiguous()


def _splat_work(uvw, rows_valid, Py, Px, C):
    """(bytes, flops) the splat needs on these inputs: each touched
    feat_sum row read and written once, uvw / indices / feature images read
    once; 2 flops per channel per in-grid weighted corner."""
    import torch

    F = uvw.shape[1]
    px, py, val = uvw[..., 0], uvw[..., 1], uvw[..., 2]
    x0, y0 = torch.floor(px), torch.floor(py)
    corners = torch.zeros_like(val)
    for dy in (0, 1):
        for dx in (0, 1):
            cx, cy = x0 + dx, y0 + dy
            corners += ((cx >= 0) & (cx < Px) & (cy >= 0) & (cy < Py)
                        & (val != 0)).float()
    touched = int(((val != 0).any(dim=1) & rows_valid).sum())
    nbytes = (2 * touched * C * 4 + uvw.numel() * 4
              + uvw.shape[0] * 8 + F * Py * Px * C * 4)
    flops = 2.0 * float(corners.sum()) * C
    return nbytes, flops


def _bound(nbytes, flops, peak_flops):
    tb, tf = nbytes / PEAK_BYTES, flops / peak_flops
    return 1e3 * max(tb, tf), ("bytes" if tb >= tf else "operations")


def phase_kernels(report):
    import torch

    from spatially_aware_ai_tpu_torch.grid import splat as S
    from spatially_aware_ai_tpu_torch.models import ln_mlp as L

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    checks = []
    ok = True

    # ---- B1 at the path's shapes: K = 65,536 slots, F = 8, 5x7 patches,
    # C = 512, over the 0.02 m grid's 101*35*99 (+1) rows
    N_buf, K, F, Py, Px, C = 101 * 35 * 99 + 1, 65536, 8, 5, 7, 512
    feat_sum, feat_imgs, uvw = _splat_inputs(gen, N_buf, K, F, Py, Px, C, dev)
    count = 50000
    perm = torch.randperm(N_buf - 1, generator=gen, device=dev)[:count]
    active = torch.full((K,), N_buf, dtype=torch.int64, device=dev)
    active[:count] = perm.sort().values
    uvw[count:, :, 2] = 0.0  # fill slots carry zero weight
    tol = 1e-4
    got = S.splat_scatter(feat_sum.clone(), active, uvw, feat_imgs)
    want = S.splat_scatter_plain(feat_sum.clone(), active, uvw, feat_imgs)
    err = float((got - want).abs().max())
    # rows outside the live set (dead slots point past the end) untouched
    untouched = torch.ones(N_buf, dtype=torch.bool, device=dev)
    untouched[active[:count]] = False
    dead_ok = torch.equal(got[untouched], feat_sum[untouched])
    del got, want
    ms = time_ms(lambda: S.splat_scatter(feat_sum, active, uvw, feat_imgs))
    plain_ms = time_ms(
        lambda: S.splat_scatter_plain(feat_sum, active, uvw, feat_imgs),
        warmup=1, iters=5)
    # library yardstick: the contraction as one sparse product,
    # W [K, F*P] (CSR, built outside the timing) @ feat_imgs [F*P, C]
    W = torch.zeros((K, F * Py * Px), device=dev)
    for f in range(F):
        for idx, w in S._corner_terms(uvw[:, f], Py, Px):
            W[torch.arange(K, device=dev), f * Py * Px + idx] += w
    W = W.to_sparse_csr()
    flat = feat_imgs.reshape(F * Py * Px, C)
    lib_ms = time_ms(lambda: torch.sparse.mm(W, flat))
    del W
    nbytes, flops = _splat_work(uvw, active < N_buf, Py, Px, C)
    bound_ms, bound_by = _bound(nbytes, flops, PEAK_F32)
    good = err <= tol and dead_ok
    ok &= good
    checks.append({"kernel": "feature_splat", "entry": "splat_scatter",
                   "shape": {"K": K, "N_buf": N_buf, "F": F, "P": Py * Px,
                             "C": C, "live": count},
                   "max_abs_err": err, "tol": tol, "untouched_rows_ok": dead_ok,
                   "ok": good, "ms": ms,
                   "plain_ms": plain_ms, "library_ms": lib_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by})
    report["feature_splat"] = {
        "name": "feature_splat", "route": "cuda",
        "source": "spatially_aware_ai_tpu_torch/csrc/feature_splat.cu",
        "replaces": SPLAT_REPLACES, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": lib_ms}

    # dense entry over every grid row (the hybrid integrator's shape)
    feat_sum_d, _, uvw_d = _splat_inputs(gen, N_buf, N_buf, F, Py, Px, C,
                                         dev)
    uvw_d[torch.rand(N_buf, generator=gen, device=dev) < 0.8] *= \
        torch.tensor([1.0, 1.0, 0.0], device=dev)  # ~15% near-surface rows
    got = S.splat(feat_sum_d.clone(), uvw_d, feat_imgs)
    want = S.splat_plain(feat_sum_d.clone(), uvw_d, feat_imgs)
    err = float((got - want).abs().max())
    del got, want
    ms = time_ms(lambda: S.splat(feat_sum_d, uvw_d, feat_imgs))
    plain_ms = time_ms(lambda: S.splat_plain(feat_sum_d, uvw_d, feat_imgs),
                       warmup=1, iters=3)
    nbytes, flops = _splat_work(
        uvw_d, torch.ones(N_buf, dtype=torch.bool, device=dev), Py, Px, C)
    bound_ms, bound_by = _bound(nbytes, flops, PEAK_F32)
    good = err <= tol
    ok &= good
    checks.append({"kernel": "feature_splat", "entry": "splat",
                   "shape": {"N": N_buf, "F": F, "P": Py * Px, "C": C},
                   "max_abs_err": err, "tol": tol, "ok": good, "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": bound_ms,
                   "bound_by": bound_by})
    del feat_sum_d, uvw_d, feat_sum, uvw

    # ---- B2: CLIP shapes (quick_gelu, eps 1e-5, no gamma) and ConvNeXt-L
    # widths (exact gelu, eps 1e-6, gamma), f32 and bf16, M not a multiple
    # of any row tile. Tolerance: f32 3e-4 abs, no rel term: the 3xTF32
    # products read about 1e-4 at these shapes and a single TF32 pass about
    # 1.7e-3, so the limit tells the two apart; bf16 3e-2 abs + 2e-2 rel (a
    # sum-order difference can move a bf16 rounding of the hidden
    # activation or of the output by one ulp).
    cases = [("quick_gelu", 768, 14000, 1e-5, False),
             ("quick_gelu", 512, 231, 1e-5, False)]
    cases += [("gelu", d, 1003, 1e-6, True) for d in (192, 384, 768, 1536)]
    for act, D, M, eps, with_gamma in cases:
        for dt in (torch.float32, torch.bfloat16):
            args = _mlp_args(gen, dev, M, D, with_gamma, dt)
            # the ConvNeXt widths are timed at their path shapes below
            timed = act == "quick_gelu"
            entry = _b2_entry(args, act, eps, timed)
            ok &= entry["ok"]
            checks.append(entry)
            if act == "quick_gelu" and D == 768 and dt == torch.float32:
                report["ln_mlp"] = {
                    "name": "ln_mlp", "route": "cuda",
                    "source": "spatially_aware_ai_tpu_torch/csrc/ln_mlp.cu",
                    "replaces": MLP_REPLACES,
                    **{k: entry[k] for k in (
                        "max_abs_err", "ms", "plain_ms", "bound_ms",
                        "bound_by", "library_ms")}}
            del args
    ok &= _convnext_mlp_checks(gen, dev, checks, report)
    ok &= _paint_check(gen, dev, checks, report)
    ok &= _tile_check(dev, checks, report)
    emit({"phase": "kernels", "ok": ok, "checks": checks})
    if not ok:
        raise SystemExit("kernels phase: a kernel disagrees with its plain "
                         "version")


def _mlp_args(gen, dev, M, D, with_gamma, dt):
    """B2's inputs: x, residual [M, D] in dt; f32 LN, bias and gamma
    vectors; w1 [D, 4D] and w2 [4D, D] as the callers pass them, nn.Linear
    weights transposed (`fc.weight.t()`)."""
    import torch

    H = 4 * D

    def rn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    return (rn(M, D).to(dt), rn(M, D).to(dt), 1.0 + rn(D, scale=0.1),
            rn(D, scale=0.1), rn(H, D, scale=D ** -0.5).t(),
            rn(H, scale=0.1), rn(D, H, scale=H ** -0.5).t(),
            rn(D, scale=0.1), 0.5 + rn(D, scale=0.1) if with_gamma else None)


def _b2_weight_stream(M, D, H, esize):
    """Bytes of weights B2 reads from L2 in one launch: the earlier
    mma.sync design, blocks of TM = 64 / 32 / 16 rows (D <= 384 / 768 / 1536), each
    reading both matrices in the activation type; this design, tiles of 128
    rows, each reading both matrices' planes once (f32: big and small TF32
    planes, twice the bytes; bf16: one plane)."""
    tm = 64 if D <= 384 else 32 if D <= 768 else 16
    planes = 2 if esize == 4 else 1
    return {"old_mma_sync": -(-M // tm) * 2 * D * H * esize,
            "new_wgmma": -(-M // 128) * 2 * D * H * esize * planes}


def _b2_entry(args, act, eps, timed):
    """B2 against its plain version on args; with `timed`, its ms, the
    plain version's and the library's: the two products alone as cuBLAS
    f32 GEMMs (torch.addmm twice, TF32 off, on the LN'd input and the
    activation the plain version makes), the same work B2's tensor cores
    do. The bound is the 3xTF32 tensor-core floor for f32 (three TF32
    products per f32 product), the bf16 peak for bf16; the f32 CUDA-core
    figure stands beside it."""
    import torch

    from spatially_aware_ai_tpu_torch.models import ln_mlp as L

    x, res, lns, lnb, w1, b1, w2, b2, gamma = args
    M, D = x.shape
    H = w1.shape[1]
    dt = x.dtype
    got = L.fused_ln_mlp(*args, act=act, eps=eps).float()
    want = L.ln_mlp_plain(*args, act=act, eps=eps).float()
    atol, rtol = (3e-4, 0.0) if dt == torch.float32 else (3e-2, 2e-2)
    diff = (got - want).abs()
    good = bool((diff <= atol + rtol * want.abs()).all())
    err = float(diff.max())
    del got, diff
    flops = 4.0 * M * D * H
    nbytes = (3 * M * D + 2 * D * H) * x.element_size() + (3 * D + H) * 4
    if dt == torch.float32:
        bound_ms, bound_by = _bound(nbytes, 3 * flops, PEAK_TF32)
    else:
        bound_ms, bound_by = _bound(nbytes, flops, PEAK_BF16)
    entry = {"kernel": "ln_mlp", "act": act, "dtype": str(dt)[6:], "M": M,
             "D": D, "H": H, "route": L.route(D, H),
             "max_abs_err": err, "atol": atol, "rtol": rtol, "ok": good,
             "bound_ms": bound_ms, "bound_by": bound_by,
             "bound_ms_f32_cuda_core": _bound(nbytes, flops, PEAK_F32)[0],
             "l2_weight_bytes": _b2_weight_stream(M, D, H, x.element_size())}
    if dt == torch.float32:
        # what one TF32 pass reads on the same inputs (cuBLAS with TF32
        # on), beside the limit it must not pass
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            tf32 = L.ln_mlp_plain(*args, act=act, eps=eps)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        entry["tf32_plain_max_abs_err"] = float(
            (tf32.float() - want).abs().max())
        del tf32
    del want
    entry["library_ms"] = None
    if timed:
        kw = dict(act=act, eps=eps)
        entry["ms"] = time_ms(lambda: L.fused_ln_mlp(*args, **kw))
        entry["plain_ms"] = time_ms(lambda: L.ln_mlp_plain(*args, **kw))
        if dt == torch.float32:
            xf = x.float()
            mu = xf.mean(-1, keepdim=True)
            lnx = (xf - mu) * torch.rsqrt(
                (xf - mu).square().mean(-1, keepdim=True) + eps) * lns + lnb
            hid = L.activation(lnx @ w1 + b1, act)
            entry["library_ms"] = time_ms(lambda: (
                torch.addmm(b1, lnx, w1), torch.addmm(b2, hid, w2)))
            del xf, mu, lnx, hid
    return entry


def _convnext_mlp_checks(gen, dev, checks, report):
    """B2 in f32 at the four ConvNeXt-L stage shapes of the kMaX path: 8
    frames padded to 992x1312 give M = 8 * 248 * 328 rows at os4 and a
    quarter of that per later stage; exact gelu, eps 1e-6, gamma. The f32
    tolerance as above (3e-4 abs)."""
    import torch

    ok = True
    by_shape = {}
    for D, M in ((192, 650752), (384, 162688), (768, 40672), (1536, 10168)):
        args = _mlp_args(gen, dev, M, D, True, torch.float32)
        entry = _b2_entry(args, "gelu", 1e-6, timed=True)
        entry["path"] = "kmax ConvNeXt-L"
        ok &= entry["ok"]
        checks.append(entry)
        by_shape[f"D{D}_M{M}"] = {k: entry[k] for k in (
            "ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err")}
        del args
    report.setdefault("ln_mlp", {"name": "ln_mlp"})["convnext_f32"] = \
        by_shape
    return ok


def _paint_inputs(gen, dev, F=8, N=128, h=241, w=321):
    """B3's inputs at the kMaX path's shape, made as panoptic_inference_batch
    makes them: F-2 frames of random logits (class x4, masks x3, as
    tests/test_kmax_paint.py), a hand-built frame (a dominant thing, a
    mostly covered weaker thing of its class that the overlap threshold
    drops, two disjoint stuff strips of one class) and an all-void frame.
    Returns (probs [F, N, h, w], order, keep in paint order) int32."""
    import torch

    from spatially_aware_ai_tpu_torch.models.kmax import model as KM

    cfg = KM.KMAX_CONVNEXT_LARGE
    cls = torch.randn((F, N, cfg.num_classes + 1), generator=gen,
                      device=dev) * 4.0
    masks = torch.randn((F, h, w, N), generator=gen, device=dev) * 3.0
    cls[-2], masks[-2] = -6.0, -8.0
    cls[-2, 0, 3], masks[-2, :, :200, 0] = 8.0, 6.0
    cls[-2, 1, 3], masks[-2, :, 120:220, 1] = 7.0, 5.9
    cls[-2, 2, 100], masks[-2, :50, 220:, 2] = 8.0, 6.0
    cls[-2, 3, 100], masks[-2, 100:150, 220:, 3] = 7.5, 6.0
    cls[-1], masks[-1] = 0.0, 0.0
    cls[-1, :, -1] = 10.0
    _, _, keep, mask_probs, _, _, order = KM.query_stats(cls, masks, cfg)
    return (mask_probs.permute(0, 3, 1, 2).contiguous(), order.int(),
            keep.gather(1, order).int())


def _paint_step_ms(probs, order, keep, kw, warmup: int = 3,
                   iters: int = 15):
    """Median device times of B3's three launches (pack, resolve, stamp),
    from CUDA events recorded between them, queued as in time_ms."""
    import torch

    from spatially_aware_ai_tpu_torch.models.kmax import paint as P

    F, N, h, w = probs.shape
    claim = torch.empty((F, h, w), dtype=torch.int32, device=probs.device)
    accepted = torch.empty((F, N), dtype=torch.bool, device=probs.device)
    args = (probs, order, keep, claim, accepted, kw["overlap_threshold"],
            kw["pixel_threshold"])
    for _ in range(warmup):
        P._launch(*args)
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    marks = [[torch.cuda.Event(enable_timing=True) for _ in range(4)]
             for _ in range(iters)]
    for m in marks:
        P._launch(*args, marks=m)
    torch.cuda.synchronize()
    return {f"{step}_ms": statistics.median(m[i].elapsed_time(m[i + 1])
                                            for m in marks)
            for i, step in enumerate(("pack", "resolve", "stamp"))}


def _paint_check(gen, dev, checks, report):
    """B3 at the kMaX path's shape (F=8, N=128, 241x321): the claims and
    the accepted flags must equal the plain version's. The bound counts the
    planes this data needs (keep == 0 steps are skipped), the claim map,
    the accepted flags and order / keep. The longest chain of kept steps
    in a frame sets the resolve step's latency floor."""
    import torch

    from spatially_aware_ai_tpu_torch.models.kmax import paint as P

    probs, order, keep = _paint_inputs(gen, dev)
    F, N, h, w = probs.shape
    kw = dict(overlap_threshold=0.8, pixel_threshold=0.4)
    got, got_acc = P.paint_masks(probs, order, keep, **kw)
    want, want_acc = P.paint_masks_plain(probs, order, keep, **kw)
    equal = torch.equal(got, want) and torch.equal(got_acc, want_acc)
    err = float((got - want).abs().max())
    hand = got[-2]
    semantics = bool((hand[:, 200:220] < 0).all() and (got[-1] < 0).all()
                     and (hand[:, :120] >= 0).all())
    kept = int(keep.sum())
    nbytes = kept * h * w * 4 + F * h * w * 4 + 2 * F * N * 4 + F * N
    bound_ms, bound_by = _bound(nbytes, 0.0, PEAK_F32)
    ms = time_ms(lambda: P.paint_masks(probs, order, keep, **kw))
    steps = _paint_step_ms(probs, order, keep, kw)
    plain_ms = time_ms(lambda: P.paint_masks_plain(probs, order, keep, **kw))
    # the same planes at thresholds where masks overlap and most kept steps
    # are rejected between accepted ones (the resolve step restarts at each
    # change of outcome)
    kw_rej = dict(overlap_threshold=0.95, pixel_threshold=0.1)
    got_rej = P.paint_masks(probs, order, keep, **kw_rej)
    want_rej = P.paint_masks_plain(probs, order, keep, **kw_rej)
    equal &= all(torch.equal(a, b) for a, b in zip(got_rej, want_rej))
    rejecting = {"thresholds": kw_rej,
                 "accepted": int(want_rej[1].sum()),
                 **_paint_step_ms(probs, order, keep, kw_rej)}
    good = equal and semantics
    checks.append({
        "kernel": "paint_masks", "F": F, "N": N, "h": h, "w": w,
        "kept_queries": kept,
        "longest_kept_chain": int((keep != 0).sum(1).max()),
        "accepted": int(got_acc.sum()), "rejecting": rejecting,
        "claimed_share": float((got >= 0).float().mean()),
        "equal": equal, "max_abs_err": err, "hand_frame_ok": semantics,
        "ok": good, "ms": ms, **steps, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "bound_ms_every_plane": (F * N * h * w * 4 + F * h * w * 4)
        / PEAK_BYTES * 1e3})
    report["paint_masks"] = {
        "name": "paint_masks", "route": "cuda",
        "source": "spatially_aware_ai_tpu_torch/csrc/paint_masks.cu",
        "replaces": PAINT_REPLACES, "max_abs_err": err, "ms": ms, **steps,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None}
    return good


# benchmarks/probe_tiledma.py's operating point: the synthetic scene's
# camera orbit at 1024x768, a 57x56x55 grid at 0.04 m in 8^3 bricks, F=8,
# depth + label (C=2), 256x256 tiles
PROBE = dict(F=8, W=1024, H=768, brick=8, nvox=(57, 56, 55), voxel=0.04,
             origin=(-1.2, -0.7, -1.2), tile=(256, 256))


def _probe_inputs(dev):
    """The probe's inputs on the card: frames rendered at a quarter size
    and upsampled 4x (K scaled to match), as the probe makes them; the
    brick voxels' uv and z, the in-image mask, the [F, 2, H, W] image,
    the tile bboxes and their coverage, uv channel-first for B4."""
    import numpy as np
    import torch

    from spatially_aware_ai_tpu_torch.data import SyntheticSceneDataset
    from spatially_aware_ai_tpu_torch.grid import tiledma as T

    F, W, H = PROBE["F"], PROBE["W"], PROBE["H"]
    ds = SyntheticSceneDataset(num_frames=F, width=W // 4, height=H // 4)
    up = np.ones((4, 4), np.float32)
    depths = np.stack([np.kron(ds[i].depth, up) for i in range(F)])
    labels = np.stack([np.kron(ds.render_labels(i), up) for i in range(F)])
    poses = np.stack([ds[i].pose for i in range(F)])
    Ks = np.stack([ds[i].K for i in range(F)]).astype(np.float32)
    Ks[:, :2] *= 4
    uv, z = T.brick_voxel_uv(PROBE["nvox"], np.asarray(PROBE["origin"]),
                             PROBE["voxel"], poses, Ks,
                             brick=PROBE["brick"], device=dev)
    in_img = T.in_image_mask(uv, z, H, W)
    img = torch.from_numpy(np.stack([depths, labels], 1)
                           .astype(np.float32)).to(dev)
    bbox, fits = T.brick_tile_bboxes(uv, in_img, *PROBE["tile"], H, W)
    return dict(uv=uv, in_img=in_img, img=img, bbox=bbox, fits=fits,
                uv_cf=uv.permute(0, 1, 3, 2).contiguous())


def _tile_check(dev, checks, report):
    """B4 at the probe's shape (392 bricks of 512 voxels, F=8, C=2,
    768x1024, 256x256 tiles): samples and in_tile equal to the plain
    version's. The bound counts uv, bbox, the outputs and each distinct
    in-tile pixel's C channels once; beside it, the same with each distinct
    32-byte image sector the pixels lie in. The library yardstick is one
    torch.gather of the same pixels (no tile mask)."""
    import torch

    from spatially_aware_ai_tpu_torch.grid import tiledma as T

    inp = _probe_inputs(dev)
    img, uv, bbox = inp["img"], inp["uv_cf"], inp["bbox"]
    tile = PROBE["tile"]
    F, C, H, W = img.shape
    NB, V = uv.shape[0], uv.shape[3]
    got = T.tile_sample_nearest(img, uv, bbox, *tile)
    want = T.tile_sample_nearest_plain(img, uv, bbox, *tile)
    equal = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    err = float((got[0] - want[0]).abs().max())
    in_tile = want[1]
    ms = time_ms(lambda: T.tile_sample_nearest(img, uv, bbox, *tile))
    plain_ms = time_ms(lambda: T.tile_sample_nearest_plain(img, uv, bbox,
                                                           *tile))
    # the same pixels through one library gather, indices made beforehand
    px = torch.round(uv[:, :, 0]).clamp(0, W - 1).long()
    py = torch.round(uv[:, :, 1]).clamp(0, H - 1).long()
    pix = (py * W + px).permute(1, 0, 2).reshape(F, 1, NB * V)
    src = img.reshape(F, C, H * W)
    index = pix.expand(F, C, NB * V)
    lib_ms = time_ms(lambda: torch.gather(src, 2, index))
    frame = torch.arange(F, device=dev)[None, :, None]
    needed = torch.unique((frame * H * W + py * W + px)[in_tile]).numel()
    nbytes = (uv.numel() * 4 + bbox.numel() * 4 + got[0].numel() * 4
              + got[1].numel() + needed * C * 4)
    bound_ms, bound_by = _bound(nbytes, 0.0, PEAK_F32)
    # what the gathers move from memory: a distinct 32-byte sector of the
    # image per read pixel, nearly one per in-tile voxel and channel
    base = ((frame * C * H + py) * W + px)[in_tile]
    sectors = torch.unique(torch.cat([(base + c * H * W) // 8
                                      for c in range(C)])).numel()
    sector_bytes = nbytes - needed * C * 4 + sectors * 32
    checks.append({
        "kernel": "tile_sample", "NB": NB, "F": F, "C": C, "H": H, "W": W,
        "V": V, "tile": list(tile), "in_tile_share": float(
            in_tile.float().mean()), "distinct_pixels": needed,
        "equal": equal, "max_abs_err": err, "ok": equal, "ms": ms,
        "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "bytes": nbytes,
        "achieved_bytes_per_s": nbytes / (ms * 1e-3),
        "image_sectors": sectors, "sector_bytes": sector_bytes,
        "sector_bound_ms": sector_bytes / PEAK_BYTES * 1e3,
        "library_ms_over_ms": lib_ms / ms})
    report["tile_sample"] = {
        "name": "tile_sample", "route": "cuda",
        "source": "spatially_aware_ai_tpu_torch/csrc/tile_sample.cu",
        "replaces": TILE_REPLACES, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": lib_ms}
    return equal


def phase_probe_tiledma(report, dev="cuda"):
    """benchmarks/probe_tiledma.py on the card: A, the plain gather of
    depth + label per frame over the flat voxel set (the integrators'
    depth pass); B, kernel B4 over the bricks' tiles. Counts are zeroed
    just before B's run and read just after."""
    import torch

    from spatially_aware_ai_tpu_torch.core.sampling import sample_image_at_uv
    from spatially_aware_ai_tpu_torch.grid import tiledma as T

    inp = _probe_inputs(dev)
    img, uv_cf, bbox, in_img = (inp[k] for k in ("img", "uv_cf", "bbox",
                                                 "in_img"))
    tile = PROBE["tile"]
    F = img.shape[0]
    NB, V = uv_cf.shape[0], uv_cf.shape[3]
    torch.cuda.synchronize()

    T.launches = 0
    samples, in_tile = T.tile_sample_nearest(img, uv_cf, bbox, *tile)
    torch.cuda.synchronize()
    launches = {"tile_sample": T.launches}

    packed = img.permute(0, 2, 3, 1).contiguous()            # [F, H, W, 2]
    uv_flat = inp["uv"].transpose(0, 1).reshape(F, NB * V, 2)

    def gather_all():
        return [sample_image_at_uv(packed[f], uv_flat[f], mode="nearest")
                for f in range(F)]

    ref = torch.stack(gather_all()).reshape(F, NB, V, 2).permute(1, 0, 2, 3)
    ok = in_img & in_tile
    agree = torch.equal(samples.permute(0, 1, 3, 2)[ok], ref[ok])
    outside = int((in_tile & ~in_img).sum())
    gather_ms = time_ms(gather_all)
    b4_ms = time_ms(lambda: T.tile_sample_nearest(img, uv_cf, bbox, *tile))
    checks = {"agrees_with_gather": agree, "in_tile_implies_in_image":
              outside == 0, "launched": launches["tile_sample"] == 1}
    out = {"phase": "probe_tiledma", "bricks": NB, "voxels": NB * V,
           "frames": F, "tile": list(tile),
           "gather_ms_per_chunk": gather_ms, "tile_sample_ms_per_chunk":
           b4_ms, "speedup_vs_gather": gather_ms / b4_ms,
           "brick_tile_coverage": float(inp["fits"].float().mean()),
           "in_image_share": float(in_img.float().mean()),
           "in_tile_share_of_in_image": float(ok.sum() / in_img.sum()),
           "launches": launches, "checks": checks,
           "ok": all(checks.values())}
    emit(out)
    _record_launches(report, "probe_tiledma", launches)
    if not out["ok"]:
        raise SystemExit(f"probe_tiledma phase failed: {checks}")


def _small_path(device):
    from spatially_aware_ai_tpu_torch.data import (
        ColorSegmenter, SyntheticScene, SyntheticSceneDataset)
    from spatially_aware_ai_tpu_torch.models.clip.engine import ClipEngine
    from spatially_aware_ai_tpu_torch.pipeline import FusionConfig, fuse_scan

    ds = SyntheticSceneDataset(num_frames=8, width=96, height=72)
    cfg = FusionConfig(voxel_size=0.06, trunc_vox=2.0, clip_patch_size=48,
                       clip_patch_stride=24, frame_chunk=4, with_labels=True,
                       integrator="sparse")
    seg = ColorSegmenter(SyntheticScene.demo_room())
    return fuse_scan(ds, ClipEngine.tiny(seed=0, device=device), cfg,
                     segmenter=seg.run_on_image, device=device)


def phase_crosscheck():
    import numpy as np
    import torch

    cpu = _small_path("cpu")
    gpu = _small_path("cuda")
    out = {"phase": "crosscheck", "nvox": cpu.nvox}
    ok = True
    for name in ("tsdf_w", "w", "label_hist"):
        a = getattr(cpu.grid, name).cpu()
        b = getattr(gpu.grid, name).cpu()
        if a.dtype == torch.uint16:
            a, b = a.view(torch.int16), b.view(torch.int16)
        mism = int((a != b).sum())
        out[f"{name}_mismatches"] = mism
        ok &= mism == 0
    for name in ("tsdf", "rgb"):
        d = float(np.abs(cpu.values[name] - gpu.values[name]).max())
        out[f"{name}_max_abs"] = d
        ok &= d <= 1e-5
    fa = cpu.feat_grid.reshape(-1, cpu.feat_grid.shape[-1]).double()
    fb = gpu.feat_grid.reshape(-1, fa.shape[-1]).cpu().double()
    m = fa.norm(dim=1) > 0
    cos = (fa[m] * fb[m]).sum(1) / fa[m].norm(dim=1) / fb[m].norm(dim=1)
    out["feat_cos_min"] = float(cos.min())
    out["observed_voxels"] = int(m.sum())
    ok &= float(cos.min()) >= 0.9999 and int(m.sum()) > 0
    out["ok"] = ok
    emit(out)
    if not ok:
        raise SystemExit("crosscheck phase: CPU and CUDA runs disagree")


def _scale_for_painting(model):
    """Raise the class head and the mask-logit BN scale of a random kMaX so
    that frames are painted (see KMAX_CLASS_SCALE)."""
    import torch

    pred = model.sem_seg_head.predictor
    with torch.no_grad():
        pred._transformer_class_head.weight.mul_(KMAX_CLASS_SCALE)
        pred._transformer_class_head.bias.mul_(KMAX_CLASS_SCALE)
        pred._pixel_space_mask_batch_norm.weight.mul_(KMAX_MASK_SCALE)


def phase_crosscheck_kmax():
    """A small kMaX (ConvNeXt depths 1,1,2,1 at widths 64-256, which B2
    takes, and KMAX_TINY_TEST's decoder) on the CPU and on the card with one
    state dict, on 4 synthetic frames of 128x96. Mask logits of the
    unscaled model within 1e-3 abs; class logits within 1e-4 of their
    largest magnitude (f32 rounding reads about 3e-5 of it; the same run
    with TF32 allowed is printed beside it); device-fused labels of the
    painting model equal on >= 99.9% of the pixels; the CPU's logits
    through the card's panoptic_inference_batch (B3) give the CPU's maps
    exactly, at the config's thresholds and at overlap_threshold 0 (where
    accepted queries may paint nothing)."""
    import dataclasses

    import numpy as np
    import torch

    from spatially_aware_ai_tpu_torch.data import SyntheticSceneDataset
    from spatially_aware_ai_tpu_torch.models.kmax import model as KM
    from spatially_aware_ai_tpu_torch.models.kmax.convnext import (
        ConvNeXtConfig)

    cfg = dataclasses.replace(
        KM.KMAX_TINY_TEST,
        backbone=ConvNeXtConfig(depths=(1, 1, 2, 1), dims=(64, 128, 192, 256)))
    ds = SyntheticSceneDataset(num_frames=4, width=128, height=96)
    rgbs = torch.from_numpy(np.stack([ds[i].rgb for i in range(4)])
                            .astype(np.float32))
    model = KM.KMaxDeepLab(cfg).init_random_(torch.Generator().manual_seed(0))
    out = {"phase": "crosscheck_kmax", "frames": list(rgbs.shape)}
    segs = {d: KM.KmaxSegmenter(cfg, model.state_dict(), device=d)
            for d in ("cpu", "cuda")}
    H, W = rgbs.shape[1:3]
    new_h, new_w, pad_h, pad_w = segs["cpu"]._test_shape(H, W)
    logits = {}
    with torch.inference_mode():
        for d, seg in segs.items():
            imgs = KM.prep_batch(rgbs.to(d), new_h, new_w, pad_h, pad_w)
            logits[d] = [t.cpu() for t in seg.model(imgs)]
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        try:
            logits["tf32"] = [t.cpu() for t in segs["cuda"].model(
                KM.prep_batch(rgbs.cuda(), new_h, new_w, pad_h, pad_w))]
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
    scale = float(logits["cpu"][0].abs().max())
    out["class_logits_max"] = scale
    out["class_logits_atol"] = 1e-4 * scale
    for d in ("cuda", "tf32"):
        key = "" if d == "cuda" else "tf32_"
        cerr = float((logits["cpu"][0] - logits[d][0]).abs().max())
        out[f"{key}class_logits_max_abs"] = cerr
        out[f"{key}class_logits_rel"] = cerr / scale
        out[f"{key}mask_logits_max_abs"] = float(
            (logits["cpu"][1] - logits[d][1]).abs().max())
    ok = (out["mask_logits_max_abs"] <= 1e-3
          and out["class_logits_max_abs"] <= out["class_logits_atol"])

    for seg in segs.values():
        _scale_for_painting(seg.model)
    labels = {d: seg.run_on_batch_fused_labels(rgbs, as_numpy=False).cpu()
              for d, seg in segs.items()}
    agree = float((labels["cpu"] == labels["cuda"]).float().mean())
    out["fused_label_agreement"] = agree
    out["painted_share"] = float((labels["cpu"] != KM.NULL_ID).float().mean())
    ok &= agree >= 0.999 and out["painted_share"] > 0

    with torch.inference_mode():
        imgs = KM.prep_batch(rgbs, new_h, new_w, pad_h, pad_w)
        cls, masks = segs["cpu"].model(imgs)
        masks = masks[:, :-(-new_h // 4), :-(-new_w // 4)]
        for key, c in (("", cfg),
                       ("overlap0_", dataclasses.replace(
                           cfg, overlap_threshold=0.0))):
            cpu_maps = KM.panoptic_inference_batch(cls, masks, c)
            card_maps = KM.panoptic_inference_batch(cls.cuda(), masks.cuda(),
                                                    c)
            same = all(torch.equal(a, b.cpu())
                       for a, b in zip(cpu_maps, card_maps))
            out[f"{key}panoptic_maps_equal"] = same
            out[f"{key}segments"] = int(cpu_maps[1].max())
            ok &= same
    out["ok"] = ok
    emit(out)
    if not ok:
        raise SystemExit("crosscheck_kmax phase: CPU and CUDA runs disagree")


def phase_path(report, integrator="sparse"):
    """The `path` phase; with integrator="brick" the `path_brick` phase,
    which also runs the sparse integrator on the same inputs after the
    counts are read and holds the two grids together."""
    import dataclasses

    import numpy as np
    import torch

    from spatially_aware_ai_tpu_torch.data import (
        ColorSegmenter, SyntheticScene, SyntheticSceneDataset)
    from spatially_aware_ai_tpu_torch.grid import splat as S
    from spatially_aware_ai_tpu_torch.models import ln_mlp as L
    from spatially_aware_ai_tpu_torch.models.clip.engine import ClipEngine
    from spatially_aware_ai_tpu_torch.models.clip.model import (
        VIT_B_32_QUICKGELU)
    from spatially_aware_ai_tpu_torch.pipeline import FusionConfig, fuse_scan
    from spatially_aware_ai_tpu_torch.scene import flood_fill_3d

    dev = torch.device("cuda")
    secs = {}
    t0 = time.perf_counter()
    ds = SyntheticSceneDataset(num_frames=32, width=1024, height=768)
    for i in range(len(ds)):  # render up front: set-up, not the path
        ds[i]
    engine = ClipEngine.random(VIT_B_32_QUICKGELU, seed=0, device=dev)
    seg = ColorSegmenter(SyntheticScene.demo_room())
    name = "path" if integrator == "sparse" else f"path_{integrator}"
    cfg = FusionConfig(voxel_size=0.02, clip_patch_size=256,
                       clip_patch_stride=128, frame_chunk=8,
                       with_labels=True, integrator=integrator)
    torch.cuda.synchronize()
    secs["setup_s"] = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()

    messages = []
    S.launches = 0
    L.launches = 0
    t0 = time.perf_counter()
    result = fuse_scan(ds, engine, cfg, segmenter=seg.run_on_image,
                       device=dev, progress=messages.append)
    secs["fuse_scan_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    mesh = result.extract_mesh(feats_on_device=True)
    torch.cuda.synchronize()
    secs["extract_mesh_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    nvox = result.nvox
    sk, obj_ids = flood_fill_3d(result.values["class_id"].reshape(nvox),
                                None, result.feat_grid,
                                result.values["rgb"].reshape(*nvox, 3))
    secs["flood_fill_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    feats = mesh["clip_feats"]
    feats = feats / feats.norm(dim=-1, keepdim=True).clamp_min(1e-8)
    prompts = ["a red box", "a chair", "the floor"]
    rel = engine.run_query(feats, prompts)
    secs["query_s"] = time.perf_counter() - t0
    launches = {"feature_splat": S.launches, "ln_mlp": L.launches}

    feat_grid = result.feat_grid
    labels = sorted({o["class_label"]
                     for o in sk["unique_objects"].values()})
    checks = {
        "feat_finite": bool(torch.isfinite(feat_grid).all()),
        "feat_shape": list(feat_grid.shape) == [*nvox, 512],
        "observed": int((result.values["weight"] > 0).sum()) > 0,
        "mesh": len(mesh["verts_world"]) > 0 and len(mesh["faces"]) > 0,
        "relevance": rel.shape == (len(mesh["verts_world"]), 3)
        and bool(np.isfinite(rel).all())
        and bool(np.allclose(rel.sum(-1), 1.0, atol=1e-4)),
        "objects": {"floor-wood", "table", "chair", "suitcase"}
        <= set(labels),
        "launches": all(v > 0 for v in launches.values()),
    }
    out = {"phase": name, "seconds": secs, "timings": result.timings,
           "nvox": list(nvox), "voxels": int(np.prod(nvox)),
           "vertices": int(len(mesh["verts_world"])),
           "faces": int(len(mesh["faces"])),
           "objects": len(sk["unique_objects"]), "object_labels": labels,
           "peak_cuda_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": launches, "checks": checks}
    if integrator == "brick":
        out["active_bricks_per_chunk"] = [
            m.split()[-1] for m in messages if m.startswith("active bricks")]
        del mesh, feat_grid, feats
        t0 = time.perf_counter()
        sparse = fuse_scan(ds, engine, dataclasses.replace(
            cfg, integrator="sparse"), segmenter=seg.run_on_image, device=dev)
        out["vs_sparse"] = _grids_against(result, sparse)
        out["vs_sparse"]["fuse_scan_s_sparse"] = time.perf_counter() - t0
        checks["equal_to_sparse"] = out["vs_sparse"].pop("ok")
    out["ok"] = all(checks.values())
    emit(out)
    _record_launches(report, name, launches)
    if not out["ok"]:
        raise SystemExit(f"{name} phase failed: {checks}")
    return (lambda: fuse_scan(ds, engine, cfg, segmenter=seg.run_on_image,
                              device=dev)), secs["fuse_scan_s"]


def _grids_against(a, b):
    """Hold fuse_scan result a's grid against b's: tsdf_w, w and label_hist
    equal; tsdf_sum and rgb_sum within 1e-5 of b's largest magnitude;
    features of every observed voxel by cosine >= 0.9999, unobserved rows
    zero in both."""
    import torch

    out = {"integrate_s": a.timings["integrate_s"],
           "integrate_s_sparse": b.timings["integrate_s"]}
    ok = True
    for name in ("tsdf_w", "w", "label_hist"):
        x, y = getattr(a.grid, name), getattr(b.grid, name)
        if x.dtype == torch.uint16:
            x, y = x.view(torch.int16), y.view(torch.int16)
        out[f"{name}_mismatches"] = int((x != y).sum())
        ok &= out[f"{name}_mismatches"] == 0
    for name in ("tsdf_sum", "rgb_sum"):
        x, y = getattr(a.grid, name), getattr(b.grid, name)
        scale = float(y.abs().max())
        out[f"{name}_max_abs"] = float((x - y).abs().max())
        out[f"{name}_limit"] = 1e-5 * scale
        ok &= out[f"{name}_max_abs"] <= out[f"{name}_limit"]
    seen = b.grid.w > 0
    fa = a.grid.feat_sum[seen].double()
    fb = b.grid.feat_sum[seen].double()
    cos = (fa * fb).sum(1) / (fa.norm(dim=1) * fb.norm(dim=1))
    out["observed_voxels"] = int(seen.sum())
    out["feat_cos_min"] = float(cos.min())
    unseen_zero = bool((a.grid.feat_sum[~seen] == 0).all()
                       and (b.grid.feat_sum[~seen] == 0).all())
    out["unobserved_rows_zero"] = unseen_zero
    out["ok"] = bool(ok and out["feat_cos_min"] >= 0.9999 and unseen_zero
                     and out["observed_voxels"] > 0)
    return out


def _record_launches(report, path, launches):
    """Each kernel's launches by path; `launches` is the last path's."""
    for name, n in launches.items():
        entry = report.setdefault(name, {"name": name})
        entry["launches"] = n
        entry.setdefault("launches_by_path", {})[path] = n


def phase_path_kmax(report):
    import numpy as np
    import torch

    from spatially_aware_ai_tpu_torch.data import SyntheticSceneDataset
    from spatially_aware_ai_tpu_torch.grid import splat as S
    from spatially_aware_ai_tpu_torch.models import ln_mlp as L
    from spatially_aware_ai_tpu_torch.models.clip.engine import ClipEngine
    from spatially_aware_ai_tpu_torch.models.clip.model import (
        VIT_B_32_QUICKGELU)
    from spatially_aware_ai_tpu_torch.models.kmax import model as KM
    from spatially_aware_ai_tpu_torch.models.kmax import paint as P
    from spatially_aware_ai_tpu_torch.pipeline import FusionConfig, fuse_scan
    from spatially_aware_ai_tpu_torch.scene import flood_fill_3d

    dev = torch.device("cuda")
    secs = {}
    t0 = time.perf_counter()
    n_frames, chunk = 32, 8
    ds = SyntheticSceneDataset(num_frames=n_frames, width=1024, height=768)
    for i in range(len(ds)):  # render up front: set-up, not the path
        ds[i]
    engine = ClipEngine.random(VIT_B_32_QUICKGELU, seed=0, device=dev)
    seg = KM.KmaxSegmenter.random(KM.KMAX_CONVNEXT_LARGE, seed=0, device=dev)
    _scale_for_painting(seg.model)
    cfg = FusionConfig(voxel_size=0.02, clip_patch_size=256,
                       clip_patch_stride=128, frame_chunk=chunk,
                       with_labels=True)
    torch.cuda.synchronize()
    secs["setup_s"] = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()

    S.launches = L.launches = P.launches = 0
    t0 = time.perf_counter()
    result = fuse_scan(ds, engine, cfg, segmenter=seg.run_on_image,
                       device=dev)
    secs["fuse_scan_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    mesh = result.extract_mesh(feats_on_device=True)
    torch.cuda.synchronize()
    secs["extract_mesh_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    nvox = result.nvox
    sk, _ = flood_fill_3d(result.values["class_id"].reshape(nvox), None,
                          result.feat_grid,
                          result.values["rgb"].reshape(*nvox, 3))
    secs["flood_fill_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    feats = mesh["clip_feats"]
    feats = feats / feats.norm(dim=-1, keepdim=True).clamp_min(1e-8)
    rel = engine.run_query(feats, ["a red box", "a chair", "the floor"])
    secs["query_s"] = time.perf_counter() - t0
    launches = {"feature_splat": S.launches, "ln_mlp": L.launches,
                "paint_masks": P.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # what the segmenter painted on the first chunk (after the counts)
    rgbs = np.stack([ds[i].rgb for i in range(chunk)]).astype(np.float32)
    cat, segid = seg.run_on_batch_panoptic(rgbs)
    paint_chunk0 = _paint_on_path(seg, rgbs)
    segments = [len(np.unique(s[s > 0])) for s in segid]
    n_chunks = -(-n_frames // chunk)
    blocks = sum(KM.KMAX_CONVNEXT_LARGE.backbone.depths)
    expected_b2 = n_chunks * (VIT_B_32_QUICKGELU.vision_layers + blocks) \
        + VIT_B_32_QUICKGELU.text_layers
    feat_grid = result.feat_grid
    checks = {
        "feat_finite": bool(torch.isfinite(feat_grid).all()),
        "feat_shape": list(feat_grid.shape) == [*nvox, 512],
        "observed": int((result.values["weight"] > 0).sum()) > 0,
        "mesh": len(mesh["verts_world"]) > 0 and len(mesh["faces"]) > 0,
        "relevance": rel.shape == (len(mesh["verts_world"]), 3)
        and bool(np.isfinite(rel).all())
        and bool(np.allclose(rel.sum(-1), 1.0, atol=1e-4)),
        "painted": float((cat != KM.NULL_ID).mean()) > 0,
        "segments_per_frame": float(np.mean(segments)) >= 2,
        "launches": all(v > 0 for v in launches.values()),
        "paint_once_per_chunk": launches["paint_masks"] == n_chunks,
        "paint_chunk0_equal": paint_chunk0["equal"],
        "ln_mlp_launches": launches["ln_mlp"] == expected_b2,
    }
    t = result.timings
    out = {"phase": "path_kmax", "seconds": secs, "timings": t,
           "kmax_s_per_frame": t["labels_s"] / n_frames,
           "clip_and_wait_s": t["inference_s"] - t["labels_s"],
           "class_scale": KMAX_CLASS_SCALE, "mask_scale": KMAX_MASK_SCALE,
           "painted_share_chunk0": float((cat != KM.NULL_ID).mean()),
           "segments_per_frame_chunk0": segments,
           "paint_chunk0": paint_chunk0,
           "labelled_voxels": int((result.values["class_id"] >= 0).sum()),
           "nvox": list(nvox), "vertices": int(len(mesh["verts_world"])),
           "objects": len(sk["unique_objects"]),
           "object_labels": sorted({o["class_label"] for o in
                                    sk["unique_objects"].values()})[:20],
           "peak_cuda_mem_gb": peak_gb, "launches": launches,
           "expected_ln_mlp_launches": expected_b2, "checks": checks,
           "ok": all(checks.values())}
    emit(out)
    _record_launches(report, "path_kmax", launches)
    if not out["ok"]:
        raise SystemExit(f"path_kmax phase failed: {checks}")
    return (lambda: fuse_scan(ds, engine, cfg, segmenter=seg.run_on_image,
                              device=dev)), secs["fuse_scan_s"]


def _paint_on_path(seg, rgbs):
    """B3 on the inputs the path's segmenter gives it for one chunk (after
    the launch counts are read): kept and accepted steps, the longest kept
    chain, equality to the plain version, and its times."""
    import torch

    from spatially_aware_ai_tpu_torch.models.kmax import model as KM
    from spatially_aware_ai_tpu_torch.models.kmax import paint as P

    with torch.inference_mode():
        imgs = torch.as_tensor(rgbs, device=seg.device)
        new_h, new_w, pad_h, pad_w = seg._test_shape(*imgs.shape[1:3])
        cls, masks = seg.model(KM.prep_batch(imgs, new_h, new_w, pad_h,
                                             pad_w))
        masks = masks[:, :-(-new_h // 4), :-(-new_w // 4)]
        _, _, keep, mask_probs, _, _, order = KM.query_stats(cls, masks,
                                                             seg.cfg)
        probs = mask_probs.permute(0, 3, 1, 2).contiguous()
        keep = keep.gather(1, order).int()
        order = order.int()
        kw = dict(overlap_threshold=float(seg.cfg.overlap_threshold),
                  pixel_threshold=float(seg.cfg.pixel_confidence_threshold))
        got = P.paint_masks(probs, order, keep, **kw)
        want = P.paint_masks_plain(probs, order, keep, **kw)
        return {"shape": list(probs.shape), "kept_queries": int(keep.sum()),
                "longest_kept_chain": int((keep != 0).sum(1).max()),
                "accepted": int(want[1].sum()),
                "equal": all(torch.equal(a, b) for a, b in zip(got, want)),
                "ms": time_ms(lambda: P.paint_masks(probs, order, keep,
                                                    **kw)),
                **_paint_step_ms(probs, order, keep, kw)}


def phase_profile(name, run_path, unprofiled_s):
    """A path's fuse_scan once more under torch.profiler: device time by
    kernel (top 12) and the device's busy time, as a share of the profiled
    wall time and of the path phase's unprofiled fuse_scan time (the
    profiler slows the host side)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_path()
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    by_name = {}
    spans = []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        tot, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + (end - start) / 1e3, n + 1)
    busy_us, last = 0.0, float("-inf")
    for start, end in sorted(spans):  # union of the device intervals
        if end > last:
            busy_us += end - max(start, last)
            last = end
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    port = {}
    for kernel, names in PORT_KERNELS.items():
        hits = [v for k, v in by_name.items() if any(n in k for n in names)]
        port[kernel] = {"ms": sum(v[0] for v in hits),
                        "count": sum(v[1] for v in hits)}
    emit({"phase": "profile", "path": name, "wall_s": wall_s,
          "device_events": len(spans),
          "device_busy_s": busy_us / 1e6,
          "device_busy_share": busy_us / 1e6 / wall_s,
          "unprofiled_wall_s": unprofiled_s,
          "device_busy_share_unprofiled": busy_us / 1e6 / unprofiled_s,
          "port_kernels": port,
          "top_kernels": [{"name": k[:100], "ms": v[0], "count": v[1]}
                          for k, v in top]})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases",
                    default="build,kernels,crosscheck,crosscheck_kmax,"
                    "probe_tiledma,path,path_brick,path_kmax,profile")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import spatially_aware_ai_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port's package is not beside this script "
              f"({e})", file=sys.stderr)
        return 2
    # full f32 in every comparison (ROADMAP trap C6)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    report = {}
    if "build" in phases:
        phase_build()
    if "kernels" in phases:
        phase_kernels(report)
    if "crosscheck" in phases:
        phase_crosscheck()
    if "crosscheck_kmax" in phases:
        phase_crosscheck_kmax()
    if "probe_tiledma" in phases:
        phase_probe_tiledma(report)
    profiled = None
    if "path" in phases:
        profiled = ("path",) + phase_path(report)
    if "path_brick" in phases:
        phase_path(report, integrator="brick")
    if "path_kmax" in phases:
        profiled = ("path_kmax",) + phase_path_kmax(report)
    if "profile" in phases and profiled is not None:
        phase_profile(*profiled)
    emit({"kernels": list(report.values())})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
