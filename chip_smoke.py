#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (spatially_aware_ai_tpu_torch) on one
NVIDIA card.

    python3 chip_smoke.py                    # every phase
    python3 chip_smoke.py --phases build,kernels,crosscheck_kmax,path_kmax
    python3 chip_smoke.py --phases build,crosscheck_kmax,path_kmax,path_kmax_bf16
    python3 chip_smoke.py --phases build,kernels,probe_tiledma,path_brick
    python3 chip_smoke.py --phases build,kernels,insitu
    python3 chip_smoke.py --phases build,serve
    python3 chip_smoke.py --phases build,live
    python3 chip_smoke.py --phases build,shard,multihost,depth
    python3 chip_smoke.py --phases build,convert,evals
    python3 chip_smoke.py --phases build,path,path_kmax,clis

Every phase runs under torch's default TF32 flags: the port pins full f32
in its own forwards (core/device.py `full_f32`). Phases, each printing one
JSON line:

1. build      nvcc builds the CUDA kernels (feature splat B1, fused LN->MLP
              B2, panoptic paint B3, tile sample B4, attention B5) from
              csrc/ for sm_90a, in parallel; seconds and ptxas register /
              spill lines.
2. kernels    each kernel against its plain PyTorch version on the card at
              the main paths' shapes: max abs error against the stated
              tolerance (B3, B4: equal), kernel ms (median of CUDA-event
              timings after a warm-up, the calls queued behind a device
              sleep so that each reads device time, not launch cost), plain
              ms, a library call's ms where one exists, and the bound (least
              time the card could take). B3 also gives its three steps'
              times (pack, resolve, stamp) and the longest chain of kept
              steps in a frame; B4 and B5 their achieved bytes/s. B1 at
              both entries gives its live rows, weighted corners, the
              corner-row bytes a kernel reading them from L2 moves
              (grid/splat.py `splat_work`) and its achieved bytes/s. B5 at
              the vision tower's shape over one chunk ([280, 12, 50, 64])
              and the text tower's ([3, 8, 77, 64], causal), each in f32
              and bf16, with scaled_dot_product_attention as the library
              call.
3. crosscheck the small synthetic path (96x72, 8 frames, 0.06 m voxels, a
              small CLIP with 64-wide heads) on the CPU (plain versions) and
              on the card (kernels):
              integer accumulators must agree exactly, tsdf / rgb within
              1e-5, features by cosine >= 0.9999.
4. crosscheck_kmax
              a small kMaX (ConvNeXt widths 64-256, which B2 takes) on the
              CPU and on the card with one state dict: mask logits within
              1e-3, class logits within 1e-4 of their scale, the card's
              logits unmoved when the caller allows TF32 (the port's pin),
              device-fused labels equal on >= 99.9% of the pixels, and the
              CPU's logits
              through the card's panoptic inference (B3) give the CPU's
              category / segment maps exactly, also at overlap threshold 0.
              Then the same in bf16 (compute_dtype), unit by unit: every
              call of the CPU's forward to a ConvBN, BN, ConvNeXt block,
              stem / downsampling conv, axial attention, k-means layer or
              predictor head run again on the card on the CPU's inputs,
              within 2 bf16 ulps of the output's largest magnitude or
              twice the unit's own bf16 rounding there where that is more
              (models/kmax/diagnostics.py), a ConvBN whose BN scale is 5%
              off failing it (the control); the whole forward's logits
              printed; fused labels equal on >= KMAX_BF16_LABEL_FLOOR of
              the pixels; the CPU's bf16 logits through the card's B3 give
              the CPU's maps exactly.
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
              kernel with no launch fails the run, and B2 and B5 must launch
              once per CLIP layer of every encode (12 per chunk, 12 for the
              query's text). Then B1 on the inputs the path gave it for its
              first chunk (kept aside during the run), timed into a zero
              grid of the path's size: live rows, ms, bound, bytes/s
              (`splat_chunk0`). The tiler takes the fused conv stem: its
              tokens must reach the tower once a chunk, [280, 49, 768];
              after the counts are read, one frame on the card against a
              plain CPU engine on the same weights (tokens within 1e-5 of
              their scale, features within 1e-4 and by cosine >= 0.9999),
              and the first chunk's features under the caller's TF32
              flags within 1e-6 of their scale of those with the flags
              off (`stem`).
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
              kernel, each port kernel's (B1-B5) device time and launches,
              and the device's busy time, as a share of the profiled wall
              and of the unprofiled fuse_scan.
9a. path_kmax_bf16
              path_kmax with both models in bf16 (compute_dtype
              torch.bfloat16, the JAX package's bf16): counts zeroed just
              before the fuse / mesh / objects / query run and read just
              after, B1, B2, B3 and B5 as often as in path_kmax and B2 / B5
              in bf16 every time; the bf16 logits of 2-frame slices
              bit-equal to the 8-frame batch (C14); the bf16 model's
              categories and fused labels against the f32 model's on the
              first chunk (ROADMAP A5's figure, gated only at
              KMAX_BF16_AGREEMENT_FLOOR) and the patch features' cosine;
              fuse_scan of the f32 and bf16 models in turns (f32, bf16,
              bf16, f32): seconds, labels_s, inference_s, peak memory.
10. insitu    the in-situ learning path on the `path` configuration: fuse
              v00 of the scene and flood fill it; give the chair and the
              table user names, and the red box a third; prepare the
              training set from the voxel CLIP features and colours and
              fine-tune the full-width DGCNN (k 20, emb 1024, batch 128, 200
              epochs, cool-down 10) on the card; fuse v01 with the red box
              removed and flood fill it through the model. The chair and
              the table must come back under their names, the red box be
              listed missing, and nothing else be named. train_s,
              epochs_run, the final accuracy and loss, predict_ms and B5's
              launches on each fuse are printed.
11. serve     the Unity HTTP API of the port (create_app over an
              InSituManager, a threading WSGI server on 127.0.0.1) at
              path_kmax's operating point: synthetic scan versions v00 and
              v01 (the red box removed) of 32 frames of 1024x768 written to
              a temporary directory, 0.02 m, CLIP ViT-B/32 and kMaX-DeepLab
              ConvNeXt-L at full width (random weights from seed 0, kMaX
              scaled for painting), the manager's own full-width DGCNN.
              Requests over real HTTP, one JSON line each (status, wall ms,
              response bytes, each kernel's launches, the counts zeroed
              just before and read just after): /reprocess_scan v00,
              /text_query with a bank label and with a new phrase,
              /object_query, /requset_scene_mesh (scene, all_objects),
              /requset_scene_knowledge, /memorize_objects (two objects),
              /insitu_learn, /reprocess_scan_async v01 polled through
              /scan_status with /text_query requests while it runs,
              /scan_preview, and /requset_scene_mesh missing. Every status
              must be 200; B1, B2, B3 and B5 must launch in /reprocess_scan
              and B2 and B5 in a /text_query whose label bank changed; the
              HTTP answers must equal the manager's direct ones; the
              rebuild must install v01, and a query answered while it runs
              must give v00's mesh; each version's config.yml must read
              through json. Then the small scene (96x72, 8 frames, 0.06 m,
              a small CLIP from one state dict, ColorSegmenter) served from
              the CPU and from the card: the same objects and labels, voxel
              counts within 1%, the same top object of /object_query.
12. live      live streaming (manager/live.py, the /live_* routes) at what
              a user gets from cli.serve and /live_begin with no options,
              streaming from an iPhone: 0.04 m voxels, trunc_vox 3, 256/128
              patches, frame_chunk 8, margin 1.0 m, CLIP ViT-B/32 and
              kMaX-DeepLab ConvNeXt-L at full width as in serve. The
              synthetic scan's 32 frames at 1024x768 (rgb, pose, K), depth
              rendered by the same cameras at the sensor's native 256x192
              (uint16 mm, enlarged 4x on the card), rendered once for both
              streams; pushes of 4 frames as npz bodies over HTTP on
              127.0.0.1, one JSON line per request. Stream A: /live_begin,
              8 /live_push, /live_preview and /live_objects after the
              second chunk, /live_status, /live_end, then /text_query and
              /requset_scene_mesh on the installed version and
              /reprocess_scan of the persisted live version (fuse_scan over
              the archive with the device upsample). Checks: 32 frames
              integrated, clipped_fraction < 0.05, B1 launched once per
              chunk (the hybrid's dense entry), B2 / B5 / B3 48 / 12 / 1 a
              chunk, live_end done with objects, every status 200; the
              grid's size and bytes, peak memory, push and live_end ms, the
              time from the last push's return to live_end's return, and
              B1 on the stream's first chunk against its plain version,
              timed with its bound and torch.sparse.mm (`splat_chunk0`).
              Stream B, the crash drill: a rgb_transfer="yuv420" manager
              fed packed i420 planes; 20 frames with /live_snapshot after
              16, a copy of the live grid, the manager dropped without
              /live_end, a fresh one on the same scan dir: /live_resume
              must report snapshot_frames 16 and resumed_frames 20 and its
              grid equal the copy (integers exact, float sums within 1e-6
              relative); the last 12 frames and /live_end. Then the small
              scene (96x72, 8 frames, 0.06 m) streamed by the port's
              cli/client.py `live --i420 --snapshot-every 1
              --objects-every 1` to a CPU and a card manager: the same
              objects and labels, voxel counts within 1%, the same
              clipped_fraction.
13. shard     voxel-sharded fusion (parallel/) at path_kmax's operating
              point on a mesh of 4 x cuda:0 (four shards, each integrated
              on its own stream; the port's form of the JAX package's
              virtual devices): (c) fuse_scan sharded against unsharded,
              weight and tsdf_weight equal, class_id on >= 99.9% of the
              voxels, features by cosine >= 0.9999, both seconds and peak
              memories, the sharded run's launches (B1 at most one per
              shard and chunk; B3, B5 and B2 once per frame slice, per
              CLIP layer, per CLIP layer and ConvNeXt block); (a) the
              path's first two chunks (its feature images and kMaX
              labels) through the sharded and unsharded sparse, brick and
              hybrid integrators into grids of the path's size: integer
              accumulators equal, float sums within 1e-5, both seconds;
              (b) kMaX on 2-frame slices against the 8-frame batch: the
              small kMaX of crosscheck_kmax, its logits within 2e-4 of
              their largest magnitude; the full-width painting model, its
              pixel decoder's outputs, every k-means layer's mask logits
              and its final logits within 2e-4, its fused labels equal on
              >= 99.9% of the pixels, each k-means layer's difference and
              flipped argmax share printed; (d) make_mesh()'s count of
              cards, and a sharded live session (16 frames pushed 4 at a
              time, cli.serve's defaults) equal to an unsharded one.
14. multihost parallel/multihost.py: 2 processes x 2 shards of one
              4-shard mesh, both on cuda:0 with the gloo backend (NCCL
              refuses two ranks on one card); the all_reduced checksums
              equal on both and within 1e-6 relative of the
              single-process oracle on the card.
15. depth     depth-scaled CLIP patches (scale_patches_by_depth, 0.5 m
              footprint): one 1024x768 frame's feature image on the card
              against the CPU with one state dict (abs 1e-4, cosine >=
              0.9999); the tiler's card seconds per chunk beside the fixed
              tiles'; then path_kmax's fuse_scan with it: seconds, launches
              (B5 once per CLIP layer a chunk: every crop of the chunk in
              one forward), and the same geometry as the fixed tiles.
16. convert   weights in the official formats through the port's
              converters on the card: the full-width random CLIP ViT-B/32
              (seed 0) saved as an open_clip-named .bin and the full-width
              painting kMaX as a detectron2 {"model": ...} .pth in a
              temporary directory with a miniature BPE merges .gz;
              cli.convert_clip and cli.convert_kmax --config large write
              the pickles, `from_checkpoint` loads them (file bytes,
              convert and load seconds). Checks: (a) the converted CLIP's
              image features of one chunk (280 crops) and text features of
              a label bank, with the source's tokens, bitwise equal to the
              source engine's; (b) the converted kMaX's logits and fused
              labels on path_kmax's first 8 frames bitwise equal; (c) with
              SAI_CLIP_CHECKPOINT, SAI_KMAX_CHECKPOINT and SAI_BPE_VOCAB
              set, create_app with no injected engines: /reprocess_scan of
              an 8-frame 1024x768 v00 and a /text_query whose heatmap
              equals the one served with the source engines injected; (d)
              B1, B2, B3 and B5 launched through the converted engines
              (counts zeroed after the sources' runs).
17. evals     eval_synthetic_labels on the card at its CLI's defaults (16
              frames, 128x96, 0.05 m) with the full-width random CLIP, for
              the gt, heuristic and geometric segmenters: mIoU, accuracy,
              observed voxels, mesh vertices and objects detected equal to
              the JAX package's (EVAL_PINS), the surface RMS within 1e-5 m,
              4 of 4 objects for gt; cli.fuse over the ScanNet miniature
              archive and the Hypersim one (a synthetic scan under its
              scene name where h5py is missing), then evals.scannet.main
              over ground truth made from the fused mesh and
              evals.hypersim.main: the files written and the stats finite;
              and the crosscheck's small CLIP from one converted pickle,
              the ScanNet archive fused and scored on the card and on the
              CPU: top-1 labels equal on >= 99.9% of the ground-truth
              vertices. Launches counted over the phase (B1, B2, B5).
18. clis      the offline CLIs from a temporary directory, one JSON line per
              step with wall seconds and launches (counts zeroed before
              each step): (a) cli.fuse of an 8-frame 1024x768 synthetic
              scan, 0.02 m, the full-width random CLIP ViT-B/32 (seed 0),
              256/128 (B1; B2 and B5 once per vision layer); (b) cli.query
              with its five default targets on that output, on the card and
              with --device cpu: the softmax and CLIP-Surgery relevances
              within 1e-4, the PLYs' vertices and faces equal, B2 and B5
              once per text layer of each of the 68 text encodes; (c)
              cli.extract_obj with a vertex_obj_idx.npy of alternating ids:
              each object's PLY equal to extract_meshes_by_object's split;
              (d) cli.test2d on two frames at 256/128, on the card and on
              the CPU: the per-patch relevance within 1e-4, two sheets
              each, B2 and B5 once per vision layer a frame and per text
              layer; (e) cli.viz cameras (`viz voxels` needs matplotlib,
              which the card's machine lacks, so it is not run); (f)
              cli.doctor --json: rc 0, the device ok at capability 9.0,
              the toolchain with the five kernels loaded, the native
              helpers ok; rc 1 with SAI_CLIP_CHECKPOINT=/nonexistent; (g)
              cli.fetch_assets --check on an empty directory: rc 0, all
              three missing; (h) the native helpers built with g++ on this
              machine (a failed build fails the phase): native marching
              cubes against numpy on the path phase's finalized tsdf (the
              same vertex and face counts, sorted vertices within 1e-6)
              and native connected components against scipy on
              path_kmax's class grid (the same components in the same
              order), seconds of each. Needs path and path_kmax before it.

Then a JSON line {"kernels": [...]} with each kernel's numbers, the card's
name and power limit from nvidia-smi, and, last, the device line. Any
failed phase exits non-zero. Without a CUDA card, or without the package
beside this script, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import subprocess
import sys
import time
from unittest import mock

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
ATTN_REPLACES = "benchmarks/probe_mosaic_attn.py:68"

# a device sleep (in clock cycles, about 5 ms) ahead of the timed calls: the
# host queues them all while the card sleeps, so the events read the card's
# time per call and not the host's time to launch it
SLEEP_CYCLES = 10_000_000

# kernel names of each port kernel in a profiler trace
PORT_KERNELS = {"feature_splat": ("splat_kernel", "compact_kernel"),
                "ln_mlp": ("ln_mlp_", "ln_stats", "split_kernel"),
                "paint_masks": ("paint_",),
                "tile_sample": ("tile_sample_kernel",),
                "attention": ("attention_kernel",)}

# random kMaX weights paint nothing (class scores stay under 0.5, cosine
# mask logits in [-1, 1] under the 0.4 pixel threshold): the kMaX phases
# scale the class head and the mask-logit BN by these factors
KMAX_CLASS_SCALE = 20.0
KMAX_MASK_SCALE = 100.0

# the JAX package's eval_synthetic_labels at its CLI's defaults (16 frames,
# 128x96, 0.05 m) for each segmenter; tests/test_torch_evals.py
# `test_chip_smoke_eval_pins_are_the_jax_values` computes them from JAX on
# the CPU (the label votes read no CLIP weight)
EVAL_PINS = {
    "gt": {"miou": 0.9370705619816396, "accuracy": 0.9805403666773882,
           "observed_voxels": 6218, "mesh_vertices": 2300,
           "objects_detected": 4, "surface_rms_m": 0.005798326805233955},
    "heuristic": {"miou": 0.35904136875644976,
                  "accuracy": 0.7044065615953683, "observed_voxels": 6218,
                  "mesh_vertices": 2300, "objects_detected": 3,
                  "surface_rms_m": 0.005798326805233955},
    "geometric": {"miou": 0.6257445255634781,
                  "accuracy": 0.9047925377935028, "observed_voxels": 6218,
                  "mesh_vertices": 2300, "objects_detected": 3,
                  "surface_rms_m": 0.005798326805233955},
}


# volumes the path phases keep for the clis phase's native checks
_KEPT = {}


def emit(obj):
    print(json.dumps(obj), flush=True)


def _to_numpy(a):
    return a.cpu().numpy() if hasattr(a, "cpu") else a


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
                             "tile_sample", "attention"], verbose=True)
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


def splat_cases(gen, dev):
    """B1's inputs at the paths' shapes, 5x7 patches of F = 8 frames, C =
    512, over the 0.02 m grid's 101*35*99 (+1) rows: {"splat_scatter":
    (feat_sum, active, uvw, feat_imgs)} with K = 65,536 slots, 50,000 of
    them live (sorted rows; the rest dead slots past the end, with zero
    weight), and {"splat": (feat_sum, uvw, feat_imgs)} over every row,
    about 15% near the surface."""
    import torch

    N_buf, K, F, Py, Px, C = 101 * 35 * 99 + 1, 65536, 8, 5, 7, 512
    feat_sum, feat_imgs, uvw = _splat_inputs(gen, N_buf, K, F, Py, Px, C, dev)
    count = 50000
    perm = torch.randperm(N_buf - 1, generator=gen, device=dev)[:count]
    active = torch.full((K,), N_buf, dtype=torch.int64, device=dev)
    active[:count] = perm.sort().values
    uvw[count:, :, 2] = 0.0  # fill slots carry zero weight
    feat_sum_d, _, uvw_d = _splat_inputs(gen, N_buf, N_buf, F, Py, Px, C,
                                         dev)
    uvw_d[torch.rand(N_buf, generator=gen, device=dev) < 0.8] *= \
        torch.tensor([1.0, 1.0, 0.0], device=dev)  # ~15% near-surface rows
    return {"splat_scatter": (feat_sum, active, uvw, feat_imgs),
            "splat": (feat_sum_d, uvw_d, feat_imgs)}


def splat_numbers(args, ms):
    """B1's work on these inputs (grid/splat.py `splat_work`), its bound,
    and the achieved rates at ms: the bound's bytes and the corner-row
    bytes a kernel reading them from L2 would move."""
    from spatially_aware_ai_tpu_torch.grid import splat as S

    from spatially_aware_ai_tpu_torch.native_cuda import load

    feat_sum, uvw, feat_imgs = args[0], args[-2], args[-1]
    N_buf = feat_sum.shape[0]
    F, Py, Px, C = feat_imgs.shape
    valid = (args[1] >= 0) & (args[1] < N_buf) if len(args) == 4 else None
    work = S.splat_work(uvw, Py, Px, C, rows_valid=valid)
    bound_ms, bound_by = _bound(work["bytes"], work["flops"], PEAK_F32)
    slice_of = load("feature_splat", S._SIGNATURES).sai_feature_splat_slice
    return {**work, "bound_ms": bound_ms, "bound_by": bound_by,
            "achieved_bytes_per_s": work["bytes"] / (ms * 1e-3),
            "corner_bytes_per_s": work["corner_bytes"] / (ms * 1e-3),
            "slice_channels": slice_of(F, Py * Px, C, _smem_optin())}


def _smem_optin():
    import torch

    return torch.cuda.get_device_properties(0).shared_memory_per_block_optin


def _splat_checks(gen, dev, report):
    """B1 against its plain version at both entries (1e-4; the scatter's
    rows outside the live set untouched), timed, with the sparse product
    as the scatter's library yardstick."""
    import torch

    from spatially_aware_ai_tpu_torch.grid import splat as S

    cases = splat_cases(gen, dev)
    tol = 1e-4
    out = []
    feat_sum, active, uvw, feat_imgs = cases["splat_scatter"]
    N_buf, K = feat_sum.shape[0], active.shape[0]
    F, Py, Px, C = feat_imgs.shape
    got = S.splat_scatter(feat_sum.clone(), active, uvw, feat_imgs)
    want = S.splat_scatter_plain(feat_sum.clone(), active, uvw, feat_imgs)
    err = float((got - want).abs().max())
    # rows outside the live set (dead slots point past the end) untouched
    untouched = torch.ones(N_buf, dtype=torch.bool, device=dev)
    untouched[active[active < N_buf]] = False
    dead_ok = torch.equal(got[untouched], feat_sum[untouched])
    del got, want
    ms = time_ms(lambda: S.splat_scatter(feat_sum, active, uvw, feat_imgs))
    plain_ms = time_ms(
        lambda: S.splat_scatter_plain(feat_sum, active, uvw, feat_imgs),
        warmup=1, iters=5)
    lib_ms = _sparse_mm_ms(uvw, feat_imgs)
    good = err <= tol and dead_ok
    entry = {"kernel": "feature_splat", "entry": "splat_scatter",
             "shape": {"K": K, "N_buf": N_buf, "F": F, "P": Py * Px, "C": C,
                       "live": int((active < N_buf).sum())},
             "max_abs_err": err, "tol": tol, "untouched_rows_ok": dead_ok,
             "ok": good, "ms": ms, "plain_ms": plain_ms,
             "library_ms": lib_ms,
             **splat_numbers(cases["splat_scatter"], ms)}
    out.append(entry)
    report["feature_splat"] = {
        "name": "feature_splat", "route": "cuda",
        "source": "spatially_aware_ai_tpu_torch/csrc/feature_splat.cu",
        "replaces": SPLAT_REPLACES,
        **{k: entry[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                 "bound_by", "library_ms")}}

    # dense entry over every grid row (the hybrid integrator's shape)
    feat_sum_d, uvw_d, _ = cases["splat"]
    got = S.splat(feat_sum_d.clone(), uvw_d, feat_imgs)
    want = S.splat_plain(feat_sum_d.clone(), uvw_d, feat_imgs)
    err = float((got - want).abs().max())
    del got, want
    ms = time_ms(lambda: S.splat(feat_sum_d, uvw_d, feat_imgs))
    plain_ms = time_ms(lambda: S.splat_plain(feat_sum_d, uvw_d, feat_imgs),
                       warmup=1, iters=3)
    out.append({"kernel": "feature_splat", "entry": "splat",
                "shape": {"N": N_buf, "F": F, "P": Py * Px, "C": C},
                "max_abs_err": err, "tol": tol, "ok": err <= tol, "ms": ms,
                "plain_ms": plain_ms, **splat_numbers(cases["splat"], ms)})
    report["feature_splat"]["dense"] = {
        k: out[-1][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                "bound_by")}
    return out


def _sparse_mm_ms(uvw, feat_imgs):
    """The library yardstick of B1: the contraction as one sparse product,
    W [K, F*P] (CSR, built outside the timing) @ feat_imgs [F*P, C]."""
    import torch

    from spatially_aware_ai_tpu_torch.grid import splat as S

    K, dev = uvw.shape[0], uvw.device
    F, Py, Px, C = feat_imgs.shape
    W = torch.zeros((K, F * Py * Px), device=dev)
    for f in range(F):
        for idx, w in S._corner_terms(uvw[:, f], Py, Px):
            W[torch.arange(K, device=dev), f * Py * Px + idx] += w
    W = W.to_sparse_csr()
    flat = feat_imgs.reshape(F * Py * Px, C)
    return time_ms(lambda: torch.sparse.mm(W, flat))


def _bound(nbytes, flops, peak_flops):
    tb, tf = nbytes / PEAK_BYTES, flops / peak_flops
    return 1e3 * max(tb, tf), ("bytes" if tb >= tf else "operations")


def phase_kernels(report):
    import torch

    from spatially_aware_ai_tpu_torch.models import ln_mlp as L

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    checks = []
    ok = True

    for entry in _splat_checks(gen, dev, report):
        ok &= entry["ok"]
        checks.append(entry)

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
    ok &= _attention_check(gen, dev, checks, report)
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


# CTAs of a cluster in B2's bf16 kernels (kCluster in csrc/ln_mlp.cu):
# each weight box is read from L2 once per cluster and multicast
B2_CLUSTER = 2


def _b2_tile(M, N, sms):
    """Route 2's bf16 tile (wide, WN) for an [M, N] product on a card of
    `sms` SMs, as the kernel's tile_for picks it (sai_ln_mlp_tile)."""
    from spatially_aware_ai_tpu_torch.models import ln_mlp as L
    from spatially_aware_ai_tpu_torch.native_cuda import load

    code = load("ln_mlp", L._SIGNATURES).sai_ln_mlp_tile(M, N, sms)
    return code // 65536, code % 65536


def _b2_weight_stream(M, D, H, esize, sms=132):
    """Bytes of weights B2 reads from L2 in one launch: the earlier
    mma.sync design, blocks of TM = 64 / 32 / 16 rows (D <= 384 / 768 /
    1536), each reading both matrices in the activation type; the wgmma
    design with 128-row tiles (the f32 route's, and the earlier bf16
    route's), each reading both matrices' planes once (f32: big and small
    TF32 planes, twice the bytes; bf16: one plane); and the bf16 route's
    clusters (`bf16_cluster`), each cluster of B2_CLUSTER row tiles
    reading every weight box once (multicast), route 2's row tiles of 128
    or 64 rows as the kernel picks them for this M (`_b2_tile`). A model
    of the bytes, not a measurement."""
    from spatially_aware_ai_tpu_torch.models import ln_mlp as L

    tm = 64 if D <= 384 else 32 if D <= 768 else 16
    planes = 2 if esize == 4 else 1
    out = {"old_mma_sync": -(-M // tm) * 2 * D * H * esize,
           "new_wgmma": -(-M // 128) * 2 * D * H * esize * planes}
    if esize == 2:
        def steps(rows):  # a cluster's steps over the row tiles
            return -(-(-(-M // rows)) // B2_CLUSTER)

        if L.route(D, H) == 1:
            out["bf16_cluster"] = steps(128) * 2 * D * H * 2
        else:
            out["bf16_cluster"] = sum(
                steps(64 if _b2_tile(M, n, sms)[0] else 128) * D * H * 2
                for n in (H, D))
    return out


def _b2_bound(M, D, H, dt):
    """B2's bound (ms, by): each input read once and the output written
    once; operations as 3xTF32 (three TF32 products per f32 product) for
    f32, at the bf16 peak for bf16."""
    import torch

    esize = 4 if dt == torch.float32 else 2
    flops = 4.0 * M * D * H
    nbytes = (3 * M * D + 2 * D * H) * esize + (3 * D + H) * 4
    if dt == torch.float32:
        return _bound(nbytes, 3 * flops, PEAK_TF32)
    return _bound(nbytes, flops, PEAK_BF16)


def _b2_entry(args, act, eps, timed):
    """B2 against its plain version on args; with `timed`, its ms, its
    weight pass's alone (`_b2_planes_fn`), the plain version's and the
    library's (`_b2_library_fn`: the same work B2's tensor cores do). The
    bound is the 3xTF32 tensor-core floor for f32 (three TF32 products per
    f32 product), the bf16 peak for bf16; the f32 CUDA-core figure stands
    beside it."""
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
    bound_ms, bound_by = _b2_bound(M, D, H, dt)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    entry = {"kernel": "ln_mlp", "act": act, "dtype": str(dt)[6:], "M": M,
             "D": D, "H": H, "route": L.route(D, H),
             "max_abs_err": err, "atol": atol, "rtol": rtol, "ok": good,
             "bound_ms": bound_ms, "bound_by": bound_by,
             "bound_ms_f32_cuda_core": _bound(nbytes, flops, PEAK_F32)[0],
             "l2_weight_bytes": _b2_weight_stream(M, D, H, x.element_size(),
                                                  sms)}
    if dt == torch.bfloat16 and L.route(D, H) == 2:
        entry["tiles"] = [_b2_tile(M, n, sms) for n in (H, D)]
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
        entry["split_ms"] = time_ms(_b2_planes_fn(w1, w2, dt))
        entry["plain_ms"] = time_ms(lambda: L.ln_mlp_plain(*args, **kw))
        entry["library_ms"] = time_ms(_b2_library_fn(args, act, eps))
    return entry


def _b2_library_fn(args, act, eps):
    """B2's library yardstick on args: the two products alone as cuBLAS
    GEMMs in the activation dtype (torch.addmm twice, TF32 off for f32), on
    the LN'd input and the activation the plain version makes, each rounded
    to that dtype as B2 rounds them."""
    import torch

    from spatially_aware_ai_tpu_torch.models import ln_mlp as L

    x, res, lns, lnb, w1, b1, w2, b2, gamma = args
    dt = x.dtype
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    lnx = ((xf - mu) * torch.rsqrt(
        (xf - mu).square().mean(-1, keepdim=True) + eps) * lns + lnb).to(dt)
    del xf, mu
    w1d, w2d, b1d, b2d = (t.to(dt) for t in (w1, w2, b1, b2))
    hid = L.activation(torch.addmm(b1d, lnx, w1d).float(), act).to(dt)
    return lambda: (torch.addmm(b1d, lnx, w1d), torch.addmm(b2d, hid, w2d))


def _b2_planes_fn(w1, w2, dt):
    """B2's weight pass alone, as fused_ln_mlp makes it: the bf16 cast of
    both weights (one launch), or the f32 split of each in its route's K
    order."""
    import torch

    from spatially_aware_ai_tpu_torch.models import ln_mlp as L

    if dt == torch.bfloat16:
        return lambda: L.bf16_planes(w1.t(), w2.t())
    m1, m2 = L.PLANE_MODES[L.route(*w1.shape)]
    return lambda: (L.weight_planes(w1.t(), m1), L.weight_planes(w2.t(), m2))


# B2's launches per run of path_kmax (4 chunks of 8 frames) at each
# ConvNeXt-L stage: one per block and chunk (depths 3, 3, 27, 3)
CONVNEXT_PATH_SHAPES = ((192, 650752, 12), (384, 162688, 12),
                        (768, 40672, 108), (1536, 10168, 12))


def _convnext_mlp_checks(gen, dev, checks, report):
    """B2 in f32 and in bf16 at the four ConvNeXt-L stage shapes of the
    kMaX path: 8 frames padded to 992x1312 give M = 8 * 248 * 328 rows at
    os4 and a quarter of that per later stage; exact gelu, eps 1e-6,
    gamma. The tolerances as above (f32 3e-4 abs; bf16 3e-2 abs + 2e-2
    rel); the library call is two cuBLAS GEMMs in the same dtype."""
    import torch

    ok = True
    for dt, key in ((torch.float32, "convnext_f32"),
                    (torch.bfloat16, "convnext_bf16")):
        by_shape = {}
        for D, M, launches in CONVNEXT_PATH_SHAPES:
            args = _mlp_args(gen, dev, M, D, True, dt)
            entry = _b2_entry(args, "gelu", 1e-6, timed=True)
            entry["path"] = "kmax ConvNeXt-L"
            ok &= entry["ok"]
            checks.append(entry)
            by_shape[f"D{D}_M{M}"] = {
                **{k: entry[k] for k in ("ms", "split_ms", "plain_ms",
                                         "library_ms", "bound_ms",
                                         "bound_by", "max_abs_err")},
                "launches_per_path_run": launches}
            del args
        report.setdefault("ln_mlp", {"name": "ln_mlp"})[key] = by_shape
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


# B5's shapes: the vision tower over one chunk's 280 tiles and the text
# tower's 3 prompts (causal), each in f32 (the f32 paths') and bf16
# (path_kmax_bf16's)
def attention_cases():
    import torch

    return ((280, 12, 50, False, torch.float32),
            (280, 12, 50, False, torch.bfloat16),
            (3, 8, 77, True, torch.float32),
            (3, 8, 77, True, torch.bfloat16))


def attention_inputs(gen, dev, B, H, T, dt):
    """A fused qkv tensor [B, T, 3 H 64] and its head views q, k, v [B, H,
    T, 64], as CLIP passes them."""
    import torch

    qkv = torch.randn((B, T, 3 * H * 64), generator=gen, device=dev).to(dt)
    q, k, v = qkv.view(B, T, 3, H, 64).permute(2, 0, 3, 1, 4)
    return qkv, q, k, v


def _attention_check(gen, dev, checks, report):
    """B5 against its plain version at the CLIP towers' shapes: the vision
    tower over one chunk's 280 tiles ([280, 12, 50, 64]) and the text
    tower's 3 prompts ([3, 8, 77, 64], causal), each in f32 (the f32
    paths'; 1e-5 abs) and bf16 (path_kmax_bf16's; 2 bf16 ulps of each
    row's largest output), all on the head views of a fused qkv tensor as
    CLIP passes them.
    The bound counts q, k, v read once and o written once, and the
    products' operations (2 * hd per score and per output term, over the
    pairs the causal mask keeps) at the peak for their type (f32 CUDA
    cores; bf16 tensor cores); the library call is
    F.scaled_dot_product_attention on the same views."""
    import torch
    import torch.nn.functional as F

    from spatially_aware_ai_tpu_torch.models import attention as A

    ok = True
    for B, H, T, causal, dt in attention_cases():
        qkv, q, k, v = attention_inputs(gen, dev, B, H, T, dt)
        got = A.attention(q, k, v, causal)
        want = A.attention_plain(q, k, v, causal)
        err = float((got.float() - want.float()).abs().max())
        entry = {"kernel": "attention", "B": B, "H": H, "T": T, "hd": 64,
                 "causal": causal, "dtype": str(dt)[6:], "max_abs_err": err}
        if dt == torch.float32:
            entry.update(tol=1e-5, ok=err <= 1e-5)
        else:
            ulps = float(A.bf16_ulps(got.view(B, T, H, 64),
                                     want.view(B, T, H, 64)).max())
            entry.update(tol="2 bf16 ulps", max_bf16_ulps=ulps, ok=ulps <= 2)
        lib = F.scaled_dot_product_attention(q, k, v, is_causal=causal)
        entry["library_max_abs_err"] = float(
            (lib.transpose(1, 2).reshape(B, T, H * 64).float()
             - want.float()).abs().max())
        entry["ms"] = time_ms(lambda: A.attention(q, k, v, causal))
        entry["plain_ms"] = time_ms(
            lambda: A.attention_plain(q, k, v, causal))
        entry["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal))
        pairs = T * (T + 1) // 2 if causal else T * T
        nbytes = 4 * B * H * T * 64 * qkv.element_size()
        flops = 4.0 * B * H * pairs * 64
        entry["bound_ms"], entry["bound_by"] = _bound(
            nbytes, flops, PEAK_F32 if dt == torch.float32 else PEAK_BF16)
        entry["bytes"] = nbytes
        entry["achieved_bytes_per_s"] = nbytes / (entry["ms"] * 1e-3)
        entry["achieved_flops_per_s"] = flops / (entry["ms"] * 1e-3)
        checks.append(entry)
        ok &= entry["ok"]
        keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")
        if dt == torch.float32 and not causal:
            report.setdefault("attention", {}).update({
                "name": "attention", "route": "cuda",
                "source": "spatially_aware_ai_tpu_torch/csrc/attention.cu",
                "replaces": ATTN_REPLACES, **{k: entry[k] for k in keys}})
        else:
            name = f"{str(dt)[6:]}_T{T}{'_causal' if causal else ''}"
            report.setdefault("attention", {})[name] = {
                k: entry[k] for k in keys}
        del qkv, q, k, v, got, want, lib
    return ok


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
    from spatially_aware_ai_tpu_torch.models.clip.engine import (
        SMALL_CARD_CONFIG, ClipEngine)
    from spatially_aware_ai_tpu_torch.pipeline import FusionConfig, fuse_scan

    ds = SyntheticSceneDataset(num_frames=8, width=96, height=72)
    cfg = FusionConfig(voxel_size=0.06, trunc_vox=2.0, clip_patch_size=48,
                       clip_patch_stride=24, frame_chunk=4, with_labels=True,
                       integrator="sparse")
    seg = ColorSegmenter(SyntheticScene.demo_room())
    engine = ClipEngine.random(SMALL_CARD_CONFIG, seed=0, device=device)
    return fuse_scan(ds, engine, cfg, segmenter=seg.run_on_image,
                     device=device)


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
        # a caller that allows TF32 everywhere: the port's pin holds
        flags = (torch.get_float32_matmul_precision(),
                 torch.backends.cudnn.allow_tf32)
        torch.set_float32_matmul_precision("high")
        torch.backends.cudnn.allow_tf32 = True
        try:
            logits["tf32_flags"] = [t.cpu() for t in segs["cuda"].model(
                KM.prep_batch(rgbs.cuda(), new_h, new_w, pad_h, pad_w))]
        finally:
            torch.set_float32_matmul_precision(flags[0])
            torch.backends.cudnn.allow_tf32 = flags[1]
    scale = float(logits["cpu"][0].abs().max())
    out["class_logits_max"] = scale
    out["class_logits_atol"] = 1e-4 * scale
    for d in ("cuda", "tf32_flags"):
        key = "" if d == "cuda" else "tf32_flags_"
        cerr = float((logits["cpu"][0] - logits[d][0]).abs().max())
        out[f"{key}class_logits_max_abs"] = cerr
        out[f"{key}class_logits_rel"] = cerr / scale
        out[f"{key}mask_logits_max_abs"] = float(
            (logits["cpu"][1] - logits[d][1]).abs().max())
    out["tf32_flags_unmoved"] = all(
        torch.equal(a, b) for a, b in zip(logits["cuda"],
                                          logits["tf32_flags"]))
    ok = (out["mask_logits_max_abs"] <= 1e-3
          and out["class_logits_max_abs"] <= out["class_logits_atol"]
          and out["tf32_flags_unmoved"])

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
    ok &= _crosscheck_kmax_bf16(cfg, model.state_dict(), rgbs, out)
    out["ok"] = ok
    emit(out)
    if not ok:
        raise SystemExit("crosscheck_kmax phase: CPU and CUDA runs disagree")


# the ConvNeXt layer scale of the bf16 unit checks' model: the random
# weights' 1e-6 leaves a block's output its input, where a block's check
# would not see B2
KMAX_BF16_LAYER_SCALE = 0.1
# the share of pixels whose fused label the card's bf16 run must give as
# the CPU's bf16 run does: random weights leave near-tied bf16 logits
# whose argmax one rounding flips, and a flipped k-means assignment can
# repaint a frame, so the floor only says that the two runs still segment
# the frames alike; the unit checks hold the arithmetic
KMAX_BF16_LABEL_FLOOR = 0.5
# the control of the unit checks: one ConvBN's BN scale raised by this
# factor on the card must fail its limit
KMAX_BF16_CONTROL_SCALE = 1.05


def _kmax_bf16_units(cfg, state_dict, imgs, res, dev="cuda"):
    """crosscheck_kmax's unit checks (models/kmax/diagnostics.py) on the
    small kMaX in bf16 with its ConvNeXt layer scales raised to
    KMAX_BF16_LAYER_SCALE: every unit call of the CPU's forward run again
    on the card on the CPU's inputs, and each k-means layer once more on
    unit-scale inputs of the first frame's shapes (where its own rounding
    is small); the control. Fills `res`; returns whether every call kept
    its limit and the control failed its own."""
    import copy

    import torch

    from spatially_aware_ai_tpu_torch.models.attention import max_bf16_ulps
    from spatially_aware_ai_tpu_torch.models.kmax import diagnostics as D
    from spatially_aware_ai_tpu_torch.models.kmax import model as KM

    bf = torch.bfloat16
    state_dict = {k: (torch.full_like(v, KMAX_BF16_LAYER_SCALE)
                      if k.endswith(".gamma") else v)
                  for k, v in state_dict.items()}
    cpu, card = (KM.KmaxSegmenter(cfg, state_dict, device=d,
                                  compute_dtype=bf).model
                 for d in ("cpu", dev))
    with torch.inference_mode():
        with D.unit_calls(cpu) as calls:
            cpu(imgs)
        dists = D.unit_distances(card, cpu, calls)
        gen = torch.Generator().manual_seed(0)
        layers = [c for c in calls if c[0] == "KMaxTransformerLayer"]
        unit_scale = []
        for kind, name, meth, args, _ in layers[:len(cfg.dec_blocks)]:
            a = tuple(torch.randn(t.shape, generator=gen).to(bf)
                      for t in args)
            unit_scale.append((f"{kind} (unit-scale inputs)", name, meth, a,
                               cpu.get_submodule(name)(*a)))
        dists += D.unit_distances(card, cpu, unit_scale)
        _, unit, _, args, want = next(
            c for c in calls if c[1].endswith("_pixel_space_head_last_convbn"))
        broken = copy.deepcopy(card.get_submodule(unit))
        broken.norm.weight.mul_(KMAX_BF16_CONTROL_SCALE)
        control = max_bf16_ulps(broken(args[0].to(dev)), want)
        control_limit = next(d[5] for d in dists if d[1] == unit)
    units = {}
    for kind, _, _, ulps, rounding, limit in dists:
        u = units.setdefault(kind, {"calls": 0, "max_ulps": 0.0,
                                    "max_rounding_ulps": 0.0,
                                    "max_limit": 0.0, "over": 0})
        u["calls"] += 1
        u["max_ulps"] = max(u["max_ulps"], ulps)
        u["max_rounding_ulps"] = max(u["max_rounding_ulps"], rounding)
        u["max_limit"] = max(u["max_limit"], limit)
        u["over"] += ulps > limit
    res.update(layer_scale=KMAX_BF16_LAYER_SCALE, unit_ulps=D.UNIT_ULPS,
               rounding_factor=D.ROUNDING_FACTOR, units=units,
               units_over=sum(u["over"] for u in units.values()),
               control={"unit": unit, "scale": KMAX_BF16_CONTROL_SCALE,
                        "ulps": control, "limit": control_limit})
    return (res["units_over"] == 0 and set(D.UNIT_KINDS) < set(units)
            and control > control_limit)


def _crosscheck_kmax_bf16(cfg, state_dict, rgbs, out, dev="cuda"):
    """crosscheck_kmax's bf16 pass: the small kMaX with compute_dtype bf16
    on the CPU (plain kernels) and on the card from one state dict. Unit
    by unit (`_kmax_bf16_units`: FrozenBatchNorm, ConvBN, ConvNeXt blocks
    with B2, the stem and downsampling convolutions, axial attentions,
    k-means layers, the predictor's heads), every call of the CPU's
    forward run again on the card on the CPU's inputs: within
    diagnostics.UNIT_ULPS bf16 ulps of the output's largest magnitude, or
    ROUNDING_FACTOR times the unit's own bf16 rounding on those inputs
    where that is more; a ConvBN with its BN scale raised by
    KMAX_BF16_CONTROL_SCALE must fail its limit (the control). Whole
    forward, printed: the card's class and mask logits with each k-means
    assignment taken from the CPU run, and the CPU's f32 forward with the
    same assignments, in ulps from the CPU's bf16 logits, and free running.
    The painting model's fused labels equal on >= KMAX_BF16_LABEL_FLOOR
    of the pixels; the CPU's bf16 logits, cast to f32, through the card's
    panoptic_inference_batch (B3) give the CPU's maps exactly."""
    import torch

    from spatially_aware_ai_tpu_torch.models.attention import max_bf16_ulps
    from spatially_aware_ai_tpu_torch.models.kmax import diagnostics as D
    from spatially_aware_ai_tpu_torch.models.kmax import model as KM

    bf = torch.bfloat16
    segs = {d: KM.KmaxSegmenter(cfg, state_dict, device=d, compute_dtype=bf)
            for d in ("cpu", dev)}
    card = segs[dev]
    H, W = rgbs.shape[1:3]
    new_h, new_w, pad_h, pad_w = segs["cpu"]._test_shape(H, W)
    f32 = KM.KmaxSegmenter(cfg, state_dict, device="cpu")
    res = {"label_floor": KMAX_BF16_LABEL_FLOOR}
    imgs = KM.prep_batch(rgbs, new_h, new_w, pad_h, pad_w)
    ok = _kmax_bf16_units(cfg, state_dict, imgs, res, dev)
    with torch.inference_mode():
        with D.kmeans_logits(segs["cpu"].model) as recorded:
            cpu = segs["cpu"].model(imgs)
        free = card.model(imgs.to(card.device))
        runs = {}
        for name, model, x in (("card", card.model, imgs.to(card.device)),
                               ("f32", f32.model, imgs)):
            with D.kmeans_logits(model, recorded):
                runs[name] = model(x)
        forced = runs["card"]
    res["dtypes"] = sorted({str(t.dtype) for t in (*cpu, *free, *forced)})
    ok &= res["dtypes"] == ["torch.bfloat16"]
    for i, name in enumerate(("class", "mask")):
        res[f"{name}_logits_forced_ulps"] = max_bf16_ulps(forced[i], cpu[i])
        res[f"{name}_logits_f32_forced_ulps"] = max_bf16_ulps(
            runs["f32"][i], cpu[i])
        res[f"{name}_logits_free_ulps"] = max_bf16_ulps(free[i], cpu[i])

    for seg in segs.values():
        _scale_for_painting(seg.model)
    labels = [seg.run_on_batch_fused_labels(rgbs, as_numpy=False).cpu()
              for seg in (segs["cpu"], card)]
    res["fused_label_agreement"] = float(
        (labels[0] == labels[1]).float().mean())
    res["painted_share"] = float((labels[0] != KM.NULL_ID).float().mean())
    ok &= (res["fused_label_agreement"] >= KMAX_BF16_LABEL_FLOOR
           and res["painted_share"] > 0)
    with torch.inference_mode():
        cls, masks = segs["cpu"].model(imgs)
        cls = cls.float()
        masks = masks[:, :-(-new_h // 4), :-(-new_w // 4)].float()
        cpu_maps = KM.panoptic_inference_batch(cls, masks, cfg)
        card_maps = KM.panoptic_inference_batch(cls.to(card.device),
                                                masks.to(card.device), cfg)
    res["panoptic_maps_equal"] = all(torch.equal(a, b.cpu())
                                     for a, b in zip(cpu_maps, card_maps))
    res["segments"] = int(cpu_maps[1].max())
    ok &= res["panoptic_maps_equal"]
    res["ok"] = bool(ok)
    out["bf16"] = res
    return ok


def _path_scan():
    """The path point's synthetic scan, 32 frames of 1024x768, rendered
    once for every phase that fuses it (path, path_brick, path_kmax,
    shard, depth): rendering is set-up and takes most of a second a
    frame on the host. fuse_scan only reads the frames."""
    if "path_scan" not in _KEPT:
        from spatially_aware_ai_tpu_torch.data import SyntheticSceneDataset

        ds = SyntheticSceneDataset(num_frames=32, width=1024, height=768)
        for i in range(len(ds)):  # render up front: set-up, not the path
            ds[i]
        _KEPT["path_scan"] = ds
    return _KEPT["path_scan"]


def phase_path(report, integrator="sparse"):
    """The `path` phase; with integrator="brick" the `path_brick` phase,
    which also runs the sparse integrator on the same inputs after the
    counts are read and holds the two grids together."""
    import dataclasses

    import numpy as np
    import torch

    from spatially_aware_ai_tpu_torch.data import (
        ColorSegmenter, SyntheticScene)
    from spatially_aware_ai_tpu_torch.grid import splat as S
    from spatially_aware_ai_tpu_torch.models import attention as A
    from spatially_aware_ai_tpu_torch.models import ln_mlp as L
    from spatially_aware_ai_tpu_torch.models.clip.engine import ClipEngine
    from spatially_aware_ai_tpu_torch.models.clip.model import (
        VIT_B_32_QUICKGELU)
    from spatially_aware_ai_tpu_torch.pipeline import FusionConfig, fuse_scan
    from spatially_aware_ai_tpu_torch.scene import flood_fill_3d

    dev = torch.device("cuda")
    secs = {}
    t0 = time.perf_counter()
    ds = _path_scan()
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
    kept, restore = _keep_first_scatter(integrator == "sparse")
    spy, tokens_seen = _tokens_seen(engine, keep=False)
    S.launches = L.launches = A.launches = 0
    t0 = time.perf_counter()
    try:
        with spy:
            result = fuse_scan(ds, engine, cfg, segmenter=seg.run_on_image,
                               device=dev, progress=messages.append)
    finally:
        restore()
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
    if integrator == "sparse":  # clis (h) meshes this volume natively
        weight = _to_numpy(result.values["weight"])[:int(np.prod(nvox))]
        tsdf = _to_numpy(result.values["tsdf"])[:int(np.prod(nvox))]
        _KEPT["path_tsdf"] = np.where(weight == 0, np.float32(np.nan),
                                      tsdf).astype(np.float32).reshape(nvox)
    t0 = time.perf_counter()
    feats = mesh["clip_feats"]
    feats = feats / feats.norm(dim=-1, keepdim=True).clamp_min(1e-8)
    prompts = ["a red box", "a chair", "the floor"]
    rel = engine.run_query(feats, prompts)
    secs["query_s"] = time.perf_counter() - t0
    launches = {"feature_splat": S.launches, "ln_mlp": L.launches,
                "attention": A.launches}
    # one B2 and one B5 launch per CLIP layer of each chunk's encode and of
    # the query's text encode
    per_clip_layer = (-(-len(ds) // cfg.frame_chunk)
                      * VIT_B_32_QUICKGELU.vision_layers
                      + VIT_B_32_QUICKGELU.text_layers)

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
        "clip_launches": launches["ln_mlp"] == per_clip_layer
        and launches["attention"] == per_clip_layer,
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
    if integrator == "sparse":
        out["stem"], stem_checks = _stem_on_path(engine, ds, cfg,
                                                 tokens_seen)
        checks.update(stem_checks)
        out["splat_chunk0"] = _splat_on_path(kept)
        report.setdefault("feature_splat", {"name": "feature_splat"})[
            "path_chunk0_ms"] = out["splat_chunk0"]["ms"]
    out["ok"] = all(checks.values())
    emit(out)
    _record_launches(report, name, launches)
    if not out["ok"]:
        raise SystemExit(f"{name} phase failed: {checks}")
    return (lambda: fuse_scan(ds, engine, cfg, segmenter=seg.run_on_image,
                              device=dev)), secs["fuse_scan_s"]


def _tokens_seen(engine, keep=True):
    """A patch of engine.model.encode_image_tokens that keeps each token
    tensor the fused conv stem hands the tower (only its shape unless
    `keep`), and the list it keeps them in."""
    seen = []
    fn = engine.model.encode_image_tokens

    def spy(tokens):
        seen.append(tokens if keep else tuple(tokens.shape))
        return fn(tokens)

    return mock.patch.object(engine.model, "encode_image_tokens", spy), seen


def _stem_on_path(engine, ds, cfg, shapes):
    """The fused conv stem, which the path's tiler takes: the token
    shapes it handed the tower in the path's run (`shapes`, once a chunk,
    [tiles, 49, 768]); one frame on the card against a plain CPU engine
    on the same weights (tokens within 1e-5 of their scale, features
    within 1e-4 and by cosine >= 0.9999 per tile); and the first chunk's
    features under a caller's TF32 flags within 1e-6 of their scale of
    those with the flags off (the stem's product pins f32 itself)."""
    import torch

    from spatially_aware_ai_tpu_torch.models.clip.engine import ClipEngine

    chunk = cfg.frame_chunk
    rgb = torch.as_tensor(ds.stacked(list(range(chunk)))["rgb"],
                          device=engine.device)

    def tile(e, x):
        return e.img_inference_tiled_batch(x, cfg.clip_patch_size,
                                           cfg.clip_patch_stride)

    cpu = ClipEngine(engine.cfg, engine.model.state_dict(), device="cpu")
    spy_card, tok_card = _tokens_seen(engine)
    spy_cpu, tok_cpu = _tokens_seen(cpu)
    with spy_card, spy_cpu:
        got = tile(engine, rgb[:1]).cpu()
        want = tile(cpu, rgb[:1].cpu())
    tg, tw = tok_card[0].cpu(), tok_cpu[0]
    a, b = (t.reshape(-1, t.shape[-1]).double() for t in (got, want))
    frame = {"tokens_max_abs": float((tg - tw).abs().max()),
             "tokens_scale": float(tw.abs().max()),
             "max_abs": float((got - want).abs().max()),
             "cos_min": float(((a * b).sum(1)
                               / (a.norm(dim=1) * b.norm(dim=1))).min())}
    del cpu, tok_card, tok_cpu, tg, tw
    g = engine.cfg.image_size // engine.cfg.patch_size
    tiles = got.shape[1] * got.shape[2]
    # fuse_scan pads a short last chunk to frame_chunk frames
    want_shapes = [(chunk * tiles, g * g, engine.cfg.vision_width)
                   ] * -(-len(ds) // chunk)

    saved = (torch.get_float32_matmul_precision(),
             torch.backends.cudnn.allow_tf32)
    try:
        torch.set_float32_matmul_precision("highest")
        torch.backends.cudnn.allow_tf32 = False
        off = tile(engine, rgb)
        torch.set_float32_matmul_precision("high")
        torch.backends.cudnn.allow_tf32 = True
        on = tile(engine, rgb)
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cudnn.allow_tf32 = saved[1]
    tf32 = {"max_abs": float((on - off).abs().max()),
            "scale": float(off.abs().max())}
    out = {"token_shapes": [list(t) for t in shapes],
           "frame_card_vs_cpu": frame, "callers_tf32": tf32}
    checks = {
        "stem_once_a_chunk": list(shapes) == want_shapes,
        "stem_frame_vs_cpu": frame["tokens_max_abs"]
        <= 1e-5 * frame["tokens_scale"] and frame["max_abs"] <= 1e-4
        and frame["cos_min"] >= 0.9999,
        "stem_tf32_unmoved": tf32["max_abs"] <= 1e-6 * tf32["scale"],
    }
    return out, checks


def _keep_first_scatter(on: bool):
    """Spy on the sparse integrator's B1 call (grid.fusion's splat_scatter)
    when on: the first call's feat_sum shape, rows, uvw and images (the
    path's first chunk) are kept by reference (each chunk makes them anew,
    so they stay as they were; no device work is added to the timed run).
    Returns (kept, restore)."""
    from spatially_aware_ai_tpu_torch.grid import fusion

    real = fusion.splat_scatter
    kept = {}
    if not on:
        return kept, lambda: None

    def spy(feat_sum, active, uvw, feat_imgs):
        if not kept:
            kept.update(shape=tuple(feat_sum.shape), active=active, uvw=uvw,
                        feat_imgs=feat_imgs)
        return real(feat_sum, active, uvw, feat_imgs)

    fusion.splat_scatter = spy
    return kept, lambda: setattr(fusion, "splat_scatter", real)


def _splat_on_path(kept):
    """B1's scatter on the inputs the path gave it for its first chunk
    (after the launch counts are read), into a zero grid of the path's
    size: live rows, ms, work and bound."""
    import torch

    from spatially_aware_ai_tpu_torch.grid import splat as S

    args = (torch.zeros(kept["shape"], device=kept["uvw"].device),
            kept["active"], kept["uvw"], kept["feat_imgs"])
    ms = time_ms(lambda: S.splat_scatter(*args))
    return {"live_rows": int(kept["active"].shape[0]), "ms": ms,
            **splat_numbers(args, ms)}


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

    from spatially_aware_ai_tpu_torch.grid import splat as S
    from spatially_aware_ai_tpu_torch.models import attention as A
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
    ds = _path_scan()
    engine = ClipEngine.random(VIT_B_32_QUICKGELU, seed=0, device=dev)
    seg = KM.KmaxSegmenter.random(KM.KMAX_CONVNEXT_LARGE, seed=0, device=dev)
    _scale_for_painting(seg.model)
    cfg = FusionConfig(voxel_size=0.02, clip_patch_size=256,
                       clip_patch_stride=128, frame_chunk=chunk,
                       with_labels=True)
    torch.cuda.synchronize()
    secs["setup_s"] = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()

    S.launches = L.launches = P.launches = A.launches = 0
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
    # clis (h) labels this grid's components natively
    _KEPT["path_kmax_class"] = _to_numpy(
        result.values["class_id"]).reshape(nvox)
    t0 = time.perf_counter()
    feats = mesh["clip_feats"]
    feats = feats / feats.norm(dim=-1, keepdim=True).clamp_min(1e-8)
    rel = engine.run_query(feats, ["a red box", "a chair", "the floor"])
    secs["query_s"] = time.perf_counter() - t0
    launches = {"feature_splat": S.launches, "ln_mlp": L.launches,
                "paint_masks": P.launches, "attention": A.launches}
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
        "attention_launches": launches["attention"] == n_chunks
        * VIT_B_32_QUICKGELU.vision_layers + VIT_B_32_QUICKGELU.text_layers,
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


def _dtype_tally(module):
    """Count the activation dtype of each launch of a kernel wrapper
    module's `_launch` (its first argument), without touching its launch
    count. Returns (tally, restore)."""
    import collections

    real = module._launch
    tally = collections.Counter()

    def spy(*args, **kwargs):
        tally[str(args[0].dtype)[6:]] += 1
        return real(*args, **kwargs)

    module._launch = spy
    return tally, lambda: setattr(module, "_launch", real)


# the share of pixels whose category the bf16 model must give as the f32
# model does in path_kmax_bf16: random weights leave near-tied logits (the
# painting scale sharpens their softmax, not their margins), whose argmax
# bf16 rounding flips, so the figure is a lower bound for a trained model;
# the floor says only that bf16 still segments the frames as f32 does
KMAX_BF16_AGREEMENT_FLOOR = 0.5


# path_kmax_bf16's scan: path_kmax's
KMAX_BF16_SCAN = {"num_frames": 32, "width": 1024, "height": 768}


def _peak_gb(dev, reset=False):
    """The card's peak allocated GB since the last reset (None on the
    CPU); with `reset`, start a new window instead."""
    import torch

    if torch.device(dev).type != "cuda":
        return None
    if reset:
        torch.cuda.reset_peak_memory_stats(dev)
        return None
    return torch.cuda.max_memory_allocated(dev) / 1e9


def phase_path_kmax_bf16(report, dev="cuda"):
    """path_kmax with both models in bf16 (compute_dtype): the CLIP towers
    and kMaX-DeepLab ConvNeXt-L at full width from the same seeds, the
    kMaX scaled for painting. The main run (counts zeroed just before,
    read just after) fuses, meshes, finds objects and answers a query; B1,
    B2, B3 and B5 must launch as often as in path_kmax, B2 and B5 in bf16
    every time. Then on the first chunk's frames: the bf16 logits of
    2-frame slices bit-equal to the 8-frame batch's (C14); the bf16
    model's categories and fused labels against the f32 model's (ROADMAP
    A5's agreement, gated at KMAX_BF16_AGREEMENT_FLOOR), and the patch
    features' cosine against f32. Last, fuse_scan of the f32 and the bf16
    models in turns (f32, bf16, bf16, f32): seconds, labels_s, inference_s
    and peak memory of each."""
    import numpy as np
    import torch

    from spatially_aware_ai_tpu_torch.data import SyntheticSceneDataset
    from spatially_aware_ai_tpu_torch.grid import splat as S
    from spatially_aware_ai_tpu_torch.models import attention as A
    from spatially_aware_ai_tpu_torch.models import ln_mlp as L
    from spatially_aware_ai_tpu_torch.models.clip.engine import ClipEngine
    from spatially_aware_ai_tpu_torch.models.clip.model import (
        VIT_B_32_QUICKGELU)
    from spatially_aware_ai_tpu_torch.models.kmax import model as KM
    from spatially_aware_ai_tpu_torch.models.kmax import paint as P
    from spatially_aware_ai_tpu_torch.pipeline import FusionConfig, fuse_scan
    from spatially_aware_ai_tpu_torch.scene import flood_fill_3d

    dev = torch.device(dev)
    bf = torch.bfloat16
    secs = {}
    t0 = time.perf_counter()
    n_frames, chunk = KMAX_BF16_SCAN["num_frames"], 8
    ds = SyntheticSceneDataset(**KMAX_BF16_SCAN)
    for i in range(len(ds)):  # render up front: set-up, not the path
        ds[i]
    models = {}
    for key, dt in (("f32", None), ("bf16", bf)):
        engine = ClipEngine.random(VIT_B_32_QUICKGELU, seed=0,
                                   compute_dtype=dt, device=dev)
        seg = KM.KmaxSegmenter.random(KM.KMAX_CONVNEXT_LARGE, seed=0,
                                      device=dev, compute_dtype=dt)
        _scale_for_painting(seg.model)
        models[key] = (engine, seg)
    engine, seg = models["bf16"]
    cfg = FusionConfig(voxel_size=0.02, clip_patch_size=256,
                       clip_patch_stride=128, frame_chunk=chunk,
                       with_labels=True)
    _sync(dev)
    secs["setup_s"] = time.perf_counter() - t0
    _peak_gb(dev, reset=True)

    tallies = [_dtype_tally(L), _dtype_tally(A)]
    S.launches = L.launches = P.launches = A.launches = 0
    try:
        t0 = time.perf_counter()
        result = fuse_scan(ds, engine, cfg, segmenter=seg.run_on_image,
                           device=dev)
        secs["fuse_scan_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        mesh = result.extract_mesh(feats_on_device=True)
        _sync(dev)
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
    finally:
        for _, restore in tallies:
            restore()
    launches = {"feature_splat": S.launches, "ln_mlp": L.launches,
                "paint_masks": P.launches, "attention": A.launches}
    dtypes = {"ln_mlp": dict(tallies[0][0]),
              "attention": dict(tallies[1][0])}
    peak_gb = _peak_gb(dev)
    n_chunks = -(-n_frames // chunk)
    blocks = sum(KM.KMAX_CONVNEXT_LARGE.backbone.depths)
    expected = {
        "feature_splat": n_chunks,
        "ln_mlp": n_chunks * (VIT_B_32_QUICKGELU.vision_layers + blocks)
        + VIT_B_32_QUICKGELU.text_layers,
        "paint_masks": n_chunks,
        "attention": n_chunks * VIT_B_32_QUICKGELU.vision_layers
        + VIT_B_32_QUICKGELU.text_layers}

    # the first chunk's frames, after the counts
    rgbs = np.stack([ds[i].rgb for i in range(chunk)]).astype(np.float32)
    with torch.inference_mode():
        imgs = torch.as_tensor(rgbs, device=dev)
        new_h, new_w, pad_h, pad_w = seg._test_shape(*imgs.shape[1:3])
        x = KM.prep_batch(imgs, new_h, new_w, pad_h, pad_w)
        whole = seg.model(x)
        parts = [seg.model(x[i:i + 2]) for i in range(0, chunk, 2)]
        split_equal = all(torch.equal(whole[j],
                                      torch.cat([p[j] for p in parts]))
                          for j in range(2))
        logits_dtypes = sorted({str(t.dtype) for t in whole})
        del whole, parts, x
        feats_by = {k: m[0].img_inference_tiled_batch(imgs, 256, 128)
                    for k, m in models.items()}
    a, b = (feats_by[k].reshape(-1, feats_by[k].shape[-1]).double()
            for k in ("f32", "bf16"))
    cos = (a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1))
    del feats_by, a, b
    cats = {k: m[1].run_on_batch_panoptic(rgbs)[0]
            for k, m in models.items()}
    labels = {k: m[1].run_on_batch_fused_labels(rgbs)
              for k, m in models.items()}
    agreement = {
        "categories": float((cats["f32"] == cats["bf16"]).mean()),
        "fused_labels": float((labels["f32"] == labels["bf16"]).mean()),
        "painted_share_f32": float((cats["f32"] != KM.NULL_ID).mean()),
        "painted_share_bf16": float((cats["bf16"] != KM.NULL_ID).mean()),
        "per_frame_categories": [float((x == y).mean()) for x, y in
                                 zip(cats["f32"], cats["bf16"])],
        "floor": KMAX_BF16_AGREEMENT_FLOOR}

    # fuse_scan of each model in turns, f32 / bf16 / bf16 / f32
    turns = []
    for key in ("f32", "bf16", "bf16", "f32"):
        e, sg = models[key]
        _sync(dev)
        _peak_gb(dev, reset=True)
        t0 = time.perf_counter()
        r = fuse_scan(ds, e, cfg, segmenter=sg.run_on_image, device=dev)
        _sync(dev)
        turns.append({"dtype": key,
                      "fuse_scan_s": time.perf_counter() - t0,
                      "labels_s": r.timings["labels_s"],
                      "inference_s": r.timings["inference_s"],
                      "peak_cuda_mem_gb": _peak_gb(dev)})
        del r

    feat_grid = result.feat_grid
    checks = {
        "feat_finite": bool(torch.isfinite(feat_grid).all()),
        "feat_shape": list(feat_grid.shape) == [*nvox, engine.feature_dim],
        "observed": int((result.values["weight"] > 0).sum()) > 0,
        "mesh": len(mesh["verts_world"]) > 0 and len(mesh["faces"]) > 0,
        "relevance": rel.shape == (len(mesh["verts_world"]), 3)
        and bool(np.isfinite(rel).all())
        and bool(np.allclose(rel.sum(-1), 1.0, atol=1e-4)),
        "painted": agreement["painted_share_bf16"] > 0,
        "launches": launches == expected,
        "launches_as_path_kmax": all(
            launches[k] == report.get(k, {}).get("launches_by_path", {})
            .get("path_kmax", launches[k]) for k in launches),
        "b2_all_bf16": dtypes["ln_mlp"] == {"bfloat16": expected["ln_mlp"]},
        "b5_all_bf16": dtypes["attention"]
        == {"bfloat16": expected["attention"]},
        "logits_bf16": logits_dtypes == ["torch.bfloat16"],
        "batch_split_bit_equal": split_equal,
        "agreement_floor": agreement["categories"]
        >= KMAX_BF16_AGREEMENT_FLOOR,
    }
    t = result.timings
    out = {"phase": "path_kmax_bf16", "seconds": secs, "timings": t,
           "kmax_s_per_frame": t["labels_s"] / n_frames,
           "clip_and_wait_s": t["inference_s"] - t["labels_s"],
           "labelled_voxels": int((result.values["class_id"] >= 0).sum()),
           "nvox": list(nvox), "vertices": int(len(mesh["verts_world"])),
           "objects": len(sk["unique_objects"]),
           "peak_cuda_mem_gb": peak_gb, "launches": launches,
           "expected_launches": expected, "launch_dtypes": dtypes,
           "bf16_vs_f32": {**agreement,
                           "patch_feature_cos_min": float(cos.min()),
                           "patch_feature_cos_mean": float(cos.mean())},
           "turns": turns, "checks": checks, "ok": all(checks.values())}
    emit(out)
    _record_launches(report, "path_kmax_bf16", launches)
    if not out["ok"]:
        raise SystemExit(f"path_kmax_bf16 phase failed: {checks}")
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
    kernel (top 12), each port kernel's device time and count (B2's also by
    its kernels' names), and the device's busy time, as a share of the
    profiled wall time and of the path phase's unprofiled fuse_scan time
    (the profiler slows the host side)."""
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
        hits = {k: v for k, v in by_name.items()
                if any(n in k for n in names)}
        port[kernel] = {"ms": sum(v[0] for v in hits.values()),
                        "count": sum(v[1] for v in hits.values())}
        if kernel == "ln_mlp":
            split = {}
            for k, (ms, n) in hits.items():
                short = k.replace("(anonymous namespace)::", "")
                short = short.split("(")[0].replace("void ", "")[:80]
                tot = split.setdefault(short, {"ms": 0.0, "count": 0})
                tot["ms"] += ms
                tot["count"] += n
            port[kernel]["by_kernel"] = split
    emit({"phase": "profile", "path": name, "wall_s": wall_s,
          "device_events": len(spans),
          "device_busy_s": busy_us / 1e6,
          "device_busy_share": busy_us / 1e6 / wall_s,
          "unprofiled_wall_s": unprofiled_s,
          "device_busy_share_unprofiled": busy_us / 1e6 / unprofiled_s,
          "port_kernels": port,
          "top_kernels": [{"name": k[:100], "ms": v[0], "count": v[1]}
                          for k, v in top]})


def insitu_flow(dev, engine, cfg, learner, num_frames, width, height):
    """Learn -> reprocess on the synthetic scene: fuse v00 and flood fill
    it; name the largest chair, table and suitcase (the red box) objects
    (merge_objects, the rename of the serving flow); prepare the training
    set from the voxel CLIP features and colours and train `learner`; fuse
    v01 without the red box and flood fill it through the learner with v00's
    scene knowledge. Returns (numbers, checks)."""
    import numpy as np
    import torch

    from spatially_aware_ai_tpu_torch.data import (
        ColorSegmenter, SyntheticScene, SyntheticSceneDataset)
    from spatially_aware_ai_tpu_torch.grid import splat as S
    from spatially_aware_ai_tpu_torch.models import attention as A
    from spatially_aware_ai_tpu_torch.models import ln_mlp as L
    from spatially_aware_ai_tpu_torch.pipeline import fuse_scan
    from spatially_aware_ai_tpu_torch.scene import (
        flood_fill_3d, merge_objects)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    room = SyntheticScene.demo_room()
    scans = [SyntheticSceneDataset(scene=scene, num_frames=num_frames,
                                   width=width, height=height)
             for scene in (room, room.without("red_box"))]
    for ds in scans:  # render up front: set-up, not the path
        for i in range(len(ds)):
            ds[i]
    seg = ColorSegmenter(room)
    out, grids = {}, []
    S.launches = L.launches = 0
    for version, ds in enumerate(scans):
        A.launches = 0
        sync()
        t0 = time.perf_counter()
        res = fuse_scan(ds, engine, cfg, segmenter=seg.run_on_image,
                        device=dev)
        sync()
        out[f"fuse_v0{version}_s"] = time.perf_counter() - t0
        out[f"attention_launches_v0{version}"] = A.launches
        nvox = res.nvox
        grids.append((res.values["class_id"].reshape(nvox), res.feat_grid,
                      res.values["rgb"].reshape(*nvox, 3)))
        if version == 0:
            sk0, _ = flood_fill_3d(grids[0][0], None, *grids[0][1:])
            names = {}
            for cls_label, name in (("chair", "my_chair"),
                                    ("table", "my_table"),
                                    ("suitcase", "my_box")):
                objs = [(len(o["voxels"]), k) for k, o in
                        sk0["unique_objects"].items()
                        if o["class_label"] == cls_label]
                names[name], sk0 = merge_objects(sk0, None, learner,
                                                 [max(objs)[1]], name)
            out["objects_v00"] = len(sk0["unique_objects"])
            out["examples"] = learner.prepare_data(sk0, *grids[0][1:])
            sync()
            t0 = time.perf_counter()
            out["train"] = learner.train_model()
            sync()
            out["train_s"] = time.perf_counter() - t0
    class1, feat1, rgb1 = grids[1]
    t0 = time.perf_counter()
    sk1, _ = flood_fill_3d(class1, None, feat1, rgb1, learner, sk0)
    out["reidentify_s"] = time.perf_counter() - t0
    items = []
    for o in sk1["unique_objects"].values():
        vi = tuple(np.asarray(o["voxels"]).T)
        items.append((feat1[vi], rgb1[vi], np.asarray(o["voxels"])))
    learner.predict_objects(items)
    sync()
    t0 = time.perf_counter()
    learner.predict_objects(items)
    sync()
    out["predict_ms"] = (time.perf_counter() - t0) * 1e3
    out["predicted_objects"] = len(items)
    uo = sk1["unique_objects"]
    named = sorted(k for k, o in uo.items() if o["user_modified"])
    out.update(names=names, objects_v01=len(uo), named_v01=named,
               missing_v01=sorted(sk1["missing_objects"]),
               launches={"feature_splat": S.launches, "ln_mlp": L.launches,
                         "attention": out["attention_launches_v00"]
                         + out["attention_launches_v01"]})
    kept = (names["my_chair"], names["my_table"])
    n_chunks = -(-num_frames // cfg.frame_chunk)
    layers = engine.cfg.vision_layers
    checks = {
        "trained": bool(out["train"]["trained"]),
        "named_come_back": all(k in uo and uo[k]["user_modified"]
                               for k in kept),
        "removed_listed_missing": names["my_box"] in sk1["missing_objects"]
        and not any(k.startswith("my_box") for k in uo),
        "nothing_else_named": all(k.split(":")[0] in ("my_chair", "my_table")
                                  for k in named),
        "attention_launches": out["attention_launches_v00"]
        == out["attention_launches_v01"] == n_chunks * layers,
    }
    return out, checks


def phase_insitu(report):
    """The in-situ learning path at full width on the `path` configuration
    (see insitu_flow); the learner's model is saved, loaded back into a new
    learner and must predict the same."""
    import tempfile

    import torch

    from spatially_aware_ai_tpu_torch.models.clip.engine import ClipEngine
    from spatially_aware_ai_tpu_torch.models.clip.model import (
        VIT_B_32_QUICKGELU)
    from spatially_aware_ai_tpu_torch.models.dgcnn import InSituLearning
    from spatially_aware_ai_tpu_torch.pipeline import FusionConfig

    dev = torch.device("cuda")
    engine = ClipEngine.random(VIT_B_32_QUICKGELU, seed=0, device=dev)
    cfg = FusionConfig(voxel_size=0.02, clip_patch_size=256,
                       clip_patch_stride=128, frame_chunk=8, with_labels=True)
    with tempfile.TemporaryDirectory() as d:
        paths = dict(model_path=os.path.join(d, "insitu_model.pkl"),
                     label_path=os.path.join(d, "insitu_labels.json"))
        learner = InSituLearning(device=dev, **paths)
        out, checks = insitu_flow(dev, engine, cfg, learner, 32, 1024, 768)
        reloaded = InSituLearning(device=dev, **paths)
        checks["reloaded_same_labels"] = reloaded.labels == learner.labels
        probe = torch.randn((16, 30, 518), generator=torch.Generator(
            device=dev).manual_seed(0), device=dev)
        with torch.no_grad():
            checks["reloaded_same_logits"] = torch.equal(
                learner.net(probe), reloaded.net(probe))
    out = {"phase": "insitu", **out, "checks": checks,
           "ok": all(checks.values())}
    emit(out)
    _record_launches(report, "insitu", out["launches"])
    if not out["ok"]:
        raise SystemExit(f"insitu phase failed: {checks}")


# ------------------------------------------------------------ serve phase

# /text_query requests sent while the background rebuild runs
QUERIES_DURING = 3


class _Http:
    """The port's app over a threading WSGI server on 127.0.0.1 (any free
    port) in a daemon thread, and a client for it that counts the kernels'
    launches per request and in all (`total`)."""

    def __init__(self, app):
        import socketserver
        import threading
        from wsgiref.simple_server import (WSGIRequestHandler, WSGIServer,
                                           make_server)

        class Server(socketserver.ThreadingMixIn, WSGIServer):
            daemon_threads = True

        class Quiet(WSGIRequestHandler):
            def log_message(self, *args):
                pass

        self.httpd = make_server("127.0.0.1", 0, app, server_class=Server,
                                 handler_class=Quiet)
        # every launch while the server runs, the background rebuild's
        # between requests included
        self.total = dict.fromkeys(("feature_splat", "ln_mlp",
                                    "paint_masks", "attention"), 0)
        self.flush()
        self.total = dict.fromkeys(self.total, 0)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.flush()

    def flush(self, keep=True):
        """Add the counts since the last flush to `total` (unless not
        `keep`); zero them."""
        from spatially_aware_ai_tpu_torch.grid import splat as S
        from spatially_aware_ai_tpu_torch.models import attention as A
        from spatially_aware_ai_tpu_torch.models import ln_mlp as L
        from spatially_aware_ai_tpu_torch.models.kmax import paint as P

        for name, mod in (("feature_splat", S), ("ln_mlp", L),
                          ("paint_masks", P), ("attention", A)):
            self.total[name] += mod.launches if keep else 0
            mod.launches = 0

    def call(self, method, path, data=None, log=None, counted=True,
             npz=None, tag="serve_request"):
        """(status, JSON or text payload); with `log`, one JSON line per
        request: status, wall ms, response bytes and the kernels' launches
        (counts zeroed just before the request and read just after). `npz`
        posts bytes (an npz body) instead of the form `data`."""
        import urllib.error
        import urllib.parse
        import urllib.request

        from spatially_aware_ai_tpu_torch.grid import splat as S
        from spatially_aware_ai_tpu_torch.models import attention as A
        from spatially_aware_ai_tpu_torch.models import ln_mlp as L
        from spatially_aware_ai_tpu_torch.models.kmax import paint as P

        def counts():
            return {"feature_splat": S.launches, "ln_mlp": L.launches,
                    "paint_masks": P.launches, "attention": A.launches}

        headers = {}
        if npz is not None:
            body = npz
            headers["Content-Type"] = "application/octet-stream"
        else:
            body = (urllib.parse.urlencode(data or {}).encode()
                    if method == "POST" else None)
        req = urllib.request.Request(self.url + path, data=body,
                                     method=method, headers=headers)
        if counted:
            self.flush()
        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(req, timeout=600) as resp:
                status, raw = resp.status, resp.read()
        except urllib.error.HTTPError as e:
            status, raw = e.code, e.read()
        ms = (time.perf_counter() - t0) * 1e3
        launches = counts()
        if counted:
            self.flush()
        try:
            payload = json.loads(raw)
        except ValueError:
            payload = raw.decode()
        if log is not None:
            line = {"phase": tag, "method": method, "route": path,
                    "status": status, "ms": ms, "bytes": len(raw)}
            if counted:
                line["launches"] = launches
            emit(line)
            log.append(line)
        return status, payload


def _heatmap_diff(a, b) -> dict:
    """Two /text_query answers of one scene: the largest difference of the
    vertices and of the relevance alpha (0.5 x relevance), the rows whose
    turbo colour differs, and of those the rows whose relevance does not
    lie within 1e-5 of a colour-table boundary ((k + 0.5) / 255, where a
    rounding-level difference picks the neighbouring colour)."""
    import numpy as np

    if sorted(a) != sorted(b) or a["faces"] != b["faces"] \
            or len(a["vertices"]) != len(b["vertices"]):
        return {"max_abs": float("inf"), "turbo_steps": 0,
                "off_boundary": 0}
    ca, cb = np.asarray(a["colors"]), np.asarray(b["colors"])
    diff = max(float(np.abs(np.asarray(a["vertices"])
                            - np.asarray(b["vertices"])).max()),
               float(np.abs(ca[:, 3] - cb[:, 3]).max()))
    steps = np.abs(ca[:, :3] - cb[:, :3]).max(axis=1) > 1e-6
    x = 2.0 * ca[steps, 3] * 255.0
    off = np.abs(x - np.floor(x) - 0.5) > 255.0 * 1e-5
    return {"max_abs": diff, "turbo_steps": int(steps.sum()),
            "off_boundary": int(off.sum())}


def _json_diff(a, b) -> float:
    """The largest difference between the floats of two JSON trees of the
    same structure (the same keys, lengths, strings and integers), or inf
    where the structures differ."""
    if isinstance(a, dict):
        if not isinstance(b, dict) or sorted(a) != sorted(b):
            return float("inf")
        return max((_json_diff(a[k], b[k]) for k in a), default=0.0)
    if isinstance(a, list):
        if not isinstance(b, list) or len(a) != len(b):
            return float("inf")
        return max((_json_diff(x, y) for x, y in zip(a, b)), default=0.0)
    if isinstance(a, float) or isinstance(b, float):
        return abs(float(a) - float(b))
    return 0.0 if a == b else float("inf")


def _write_scan_versions(root, spec, removed_in_v01=("red_box",)):
    for ver, remove in ((0, []), (1, list(removed_in_v01))):
        d = os.path.join(root, "scans", "demo", f"v{ver:02d}")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "synthetic_scene.json"), "w") as f:
            json.dump({**spec, "remove": remove}, f)


def _serve_small(dev, root):
    """The small scene (96x72, 8 frames, 0.06 m, SMALL_CARD_CONFIG CLIP from
    one state dict, ColorSegmenter) served from `dev`: the knowledge and the
    object ranking of v00."""
    import torch

    from spatially_aware_ai_tpu_torch.data import (ColorSegmenter,
                                                   SyntheticScene)
    from spatially_aware_ai_tpu_torch.manager import InSituManager
    from spatially_aware_ai_tpu_torch.models.clip.engine import (
        SMALL_CARD_CONFIG, ClipEngine)
    from spatially_aware_ai_tpu_torch.server import create_app

    manager = InSituManager(
        scan_dir=os.path.join(root, "scans"), scan_name="demo",
        dataset="synthetic", output_dir=os.path.join(root, f"out_{dev}"),
        device=dev, voxel_size=0.06, trunc_vox=2, clip_patch_size=48,
        clip_patch_stride=24, frame_chunk=4,
        clip_engine=ClipEngine.random(SMALL_CARD_CONFIG, seed=0, device=dev),
        seg_model=ColorSegmenter(SyntheticScene.demo_room()),
        auto_reconstruct=False)
    http = _Http(create_app(manager))
    try:
        statuses = [http.call("POST", "/reprocess_scan", {"version": 0},
                              counted=False)[0]]
        status, sk = http.call("POST", "/requset_scene_knowledge",
                               {"scan_version": 0}, counted=False)
        statuses.append(status)
        status, ranked = http.call("POST", "/object_query",
                                   {"text_query": "show me a chair"},
                                   counted=False)
        statuses.append(status)
    finally:
        http.close()
        manager._wait_for_save()
    del manager
    if dev == "cuda":
        torch.cuda.synchronize()
    return statuses, sk, ranked


def serve_crosscheck(root):
    """The small scene served through a CPU manager and a card manager:
    the same object keys and class labels, voxel counts within 1%, and the
    same top object."""
    _write_scan_versions(root, {"num_frames": 8, "width": 96, "height": 72})
    runs = {d: _serve_small(d, root) for d in ("cpu", "cuda")}
    (s_cpu, sk_cpu, r_cpu), (s_gpu, sk_gpu, r_gpu) = (runs["cpu"],
                                                      runs["cuda"])
    uo_cpu, uo_gpu = sk_cpu["unique_objects"], sk_gpu["unique_objects"]
    counts = {k: (len(uo_cpu[k]["voxels"]), len(uo_gpu[k]["voxels"]))
              for k in uo_cpu if k in uo_gpu}
    out = {
        "statuses": {"cpu": s_cpu, "cuda": s_gpu},
        "objects": sorted(uo_gpu),
        "voxels_cpu_cuda": counts,
        "top_object": {"cpu": r_cpu["objects"][0]["object_id"],
                       "cuda": r_gpu["objects"][0]["object_id"]},
    }
    checks = {
        "crosscheck_status_200": all(s == 200 for s in s_cpu + s_gpu),
        "crosscheck_same_objects": sorted(uo_cpu) == sorted(uo_gpu)
        and len(uo_gpu) > 0,
        "crosscheck_same_labels": all(
            uo_cpu[k]["class_label"] == uo_gpu[k]["class_label"]
            for k in counts),
        "crosscheck_voxels_1pct": all(abs(a - b) <= 0.01 * max(a, 1)
                                      for a, b in counts.values()),
        "crosscheck_same_top_object": out["top_object"]["cpu"]
        == out["top_object"]["cuda"],
    }
    return out, checks


def serve_flow(dev, engine, seg, root, spec, **manager_kw):
    """The request sequence of the serve phase (module docstring, phase 11)
    against the port's app over HTTP, for a manager on `dev` with the given
    engines, over the synthetic scan versions v00 and v01 (red box removed)
    of `spec`. Returns (numbers, checks, launches over the whole run)."""
    import torch

    from spatially_aware_ai_tpu_torch.manager import InSituManager
    from spatially_aware_ai_tpu_torch.server import create_app

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    secs, log, checks, timings = {}, [], {}, {}
    t0 = time.perf_counter()
    _write_scan_versions(root, spec)
    manager = InSituManager(
        scan_dir=os.path.join(root, "scans"), scan_name="demo",
        dataset="synthetic", output_dir=os.path.join(root, "out"),
        device=dev, clip_engine=engine, seg_model=seg,
        auto_reconstruct=False, **manager_kw)
    http = _Http(create_app(manager))
    sync()
    secs["setup_s"] = time.perf_counter() - t0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    try:
        http.call("POST", "/reprocess_scan", {"version": 0}, log)
        reprocess = log[-1]["launches"]
        timings["v00"] = dict(manager.last_fusion_timings,
                              build_s=manager.last_fusion_seconds)
        uo = manager.scene_knowledge["unique_objects"]
        bank = sorted({o["class_label"] for o in uo.values()})
        label, phrase = bank[0], "a small red suitcase"
        # each HTTP answer against the manager's direct answer to the same
        # call, made right after it (same label bank, no encode)
        direct = {}
        _, q_label = http.call("POST", "/text_query",
                               {"text_query": f"show me {label}"}, log)
        bank_changed = log[-1]["launches"]
        direct["text_query_label"] = _heatmap_diff(
            q_label, manager.clip_text_query(label))
        _, q_phrase = http.call("POST", "/text_query",
                                {"text_query": phrase}, log)
        phrase_launches = log[-1]["launches"]
        direct["text_query_phrase"] = _heatmap_diff(
            q_phrase, manager.clip_text_query(phrase))
        _, ranked = http.call("POST", "/object_query",
                              {"text_query": phrase}, log)
        direct["object_query"] = _json_diff(
            ranked["objects"], manager.object_text_query(phrase))
        _, mesh_scene = http.call("POST", "/requset_scene_mesh", {
            "scan_version": 0, "obj_key": "scene", "color": "rgb"}, log)
        _, mesh_all = http.call("POST", "/requset_scene_mesh", {
            "scan_version": 0, "obj_key": "all_objects", "color": "rgb"},
            log)
        http.call("POST", "/requset_scene_knowledge", {"scan_version": 0},
                  log)
        largest = sorted(uo, key=lambda k: -len(uo[k]["voxels"]))[:2]
        http.call("POST", "/memorize_objects", {
            "object_list": json.dumps({"items": largest})}, log)
        _, learned = http.call("GET", "/insitu_learn", None, log)
        direct["mesh_scene"] = _json_diff(mesh_scene,
                                          manager.request_mesh(0, "scene"))
        direct["mesh_all_objects"] = _json_diff(
            mesh_all, manager.request_mesh(0, "all_objects"))
        checks["http_equals_direct"] = all(
            (d["max_abs"] <= 1e-5 and d["off_boundary"] == 0)
            if isinstance(d, dict) else d <= 1e-5 for d in direct.values())

        # the background rebuild of v01: the first QUERIES_DURING polls
        # each send a /text_query too, then polls every 0.25 s. A query
        # answered before the job reached "installing" must give v00's mesh
        v0_faces, v0_verts = len(q_label["faces"]), q_label["vertices"]
        http.call("POST", "/reprocess_scan_async", {"version": 1}, log)
        during, polls = [], 0
        while True:
            _, st = http.call("GET", "/scan_status", None, log,
                              counted=False)
            polls += 1
            if st["state"] != "running":
                break
            if len(during) >= QUERIES_DURING:
                time.sleep(0.25)
                continue
            _, q = http.call("POST", "/text_query", {"text_query": label},
                             log)
            _, after = http.call("GET", "/scan_status", None, counted=False)
            during.append({
                "answered_while_running": after["state"] == "running"
                and after["phase"] != "installing",
                "v00_mesh": q["vertices"] == v0_verts
                and len(q["faces"]) == v0_faces,
                "phase_after": after.get("phase")})
        http.call("GET", "/scan_preview", None, log)
        preview_bytes = log[-1]["bytes"]
        timings["v01"] = dict(manager.last_fusion_timings,
                              build_s=manager.last_fusion_seconds)
        _, missing = http.call("POST", "/requset_scene_mesh", {
            "scan_version": 1, "obj_key": "missing", "color": "rgb"}, log)
        peak_gb = (torch.cuda.max_memory_allocated() / 1e9
                   if dev.type == "cuda" else None)
        manager._wait_for_save()
        configs = []
        for ver in ("v00", "v01"):
            with open(os.path.join(root, "out", "demo", ver,
                                   "config.yml")) as f:
                configs.append(json.loads(f.read()))
    finally:
        http.close()
    checks.update({
        "status_200": all(ln["status"] == 200 for ln in log),
        "reprocess_launches": all(v > 0 for v in reprocess.values()),
        "bank_change_launches": bank_changed["attention"] > 0
        and bank_changed["ln_mlp"] > 0 and phrase_launches["attention"] > 0,
        "insitu_trained": bool(learned.get("trained")),
        "async_done": st["state"] == "done" and manager.curr_ver == 1
        and manager.scene_knowledge["scan_version"] == 1,
        "queried_during_rebuild": any(d["answered_while_running"]
                                      for d in during),
        "served_v00_during_rebuild": all(
            d["v00_mesh"] for d in during if d["answered_while_running"]),
        "configs_json": [c["curr_ver"] for c in configs] == [0, 1]
        and all(c["device"] == str(manager.device) for c in configs),
    })
    out = {"seconds": secs, "fusion_timings": timings,
           "requests": len(log), "polls": polls,
           "queries_during_rebuild": during,
           "scan_preview_bytes": preview_bytes,
           "missing_objects": sorted(missing), "objects_v00": len(uo),
           "objects_v01": len(manager.scene_knowledge["unique_objects"]),
           "bank": bank, "vertices_v00": len(v0_verts),
           "peak_cuda_mem_gb": peak_gb, "launches_reprocess": reprocess,
           "http_minus_direct": direct}
    return out, checks, http.total


_ENGINES = {}


def _full_engines(dev):
    """CLIP ViT-B/32 quick-gelu and kMaX-DeepLab ConvNeXt-L at full width on
    `dev` (random weights from seed 0, kMaX scaled for painting), built
    once for the serve and live phases."""
    if dev not in _ENGINES:
        from spatially_aware_ai_tpu_torch.models.clip.engine import (
            ClipEngine)
        from spatially_aware_ai_tpu_torch.models.clip.model import (
            VIT_B_32_QUICKGELU)
        from spatially_aware_ai_tpu_torch.models.kmax import model as KM

        engine = ClipEngine.random(VIT_B_32_QUICKGELU, seed=0, device=dev)
        seg = KM.KmaxSegmenter.random(KM.KMAX_CONVNEXT_LARGE, seed=0,
                                      device=dev)
        _scale_for_painting(seg.model)
        _ENGINES[dev] = engine, seg
    return _ENGINES[dev]


def phase_serve(report):
    """The Unity API of the port over real HTTP at path_kmax's operating
    point (module docstring, phase 11), then the small scene served from
    the CPU and from the card (serve_crosscheck)."""
    import tempfile

    import torch

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    engine, seg = _full_engines(dev)
    engines_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as root:
        out, checks, totals = serve_flow(
            dev, engine, seg, os.path.join(root, "full"),
            {"num_frames": 32, "width": 1024, "height": 768},
            voxel_size=0.02, trunc_vox=3, clip_patch_size=256,
            clip_patch_stride=128, frame_chunk=8)
        crosscheck, cross_checks = serve_crosscheck(
            os.path.join(root, "small"))
    checks.update(cross_checks)
    out = {"phase": "serve", "engines_s": engines_s, **out,
           "launches": totals, "crosscheck": crosscheck, "checks": checks,
           "ok": all(checks.values())}
    emit(out)
    _record_launches(report, "serve", totals)
    if not out["ok"]:
        raise SystemExit(f"serve phase failed: {checks}")


# ------------------------------------------------------------- live phase

# frames per /live_push, and stream B's snapshot and crash points
LIVE_PUSH = 4
LIVE_SNAPSHOT_AT = 16
LIVE_CRASH_AT = 20


def live_frames(num_frames, width, height, depth_scale=1):
    """The synthetic scan as a client streams it: u8 rgb, pose and K (for
    the rgb size) at width x height, and uint16-mm depth rendered by the
    same cameras at the sensor's native width/s x height/s."""
    import numpy as np

    from spatially_aware_ai_tpu_torch.data import SyntheticSceneDataset

    full = SyntheticSceneDataset(num_frames=num_frames, width=width,
                                 height=height).stacked_u8()
    native = full if depth_scale == 1 else SyntheticSceneDataset(
        num_frames=num_frames, width=width // depth_scale,
        height=height // depth_scale).stacked()
    depth = np.clip(np.rint(np.nan_to_num(native["depth"]) * 1000.0), 0,
                    65535).astype(np.uint16)
    return {"rgb": full["rgb"], "depth": depth, "pose": full["pose"],
            "K": full["K"]}


def _push_body(frames, lo, hi, i420=False):
    """An npz /live_push body of frames[lo:hi]; with i420 the rgb goes as
    packed 4:2:0 planes (`rgb_i420`, the client's encode)."""
    import io

    import numpy as np

    from spatially_aware_ai_tpu_torch.core.yuv import rgb_u8_to_i420

    part = {k: v[lo:hi] for k, v in frames.items()}
    if i420:
        part["rgb_i420"] = rgb_u8_to_i420(part.pop("rgb"))
    buf = io.BytesIO()
    np.savez(buf, **part)
    return buf.getvalue()


def _keep_first_dense_splat():
    """Spy on the hybrid integrator's B1 call (grid.fusion's splat): the
    first call's feat_sum shape, uvw and images (the stream's first chunk),
    kept by reference. Returns (kept, restore)."""
    from spatially_aware_ai_tpu_torch.grid import fusion

    real = fusion.splat
    kept = {}

    def spy(feat_sum, uvw, feat_imgs):
        if not kept:
            kept.update(shape=tuple(feat_sum.shape), uvw=uvw,
                        feat_imgs=feat_imgs)
        return real(feat_sum, uvw, feat_imgs)

    fusion.splat = spy
    return kept, lambda: setattr(fusion, "splat", real)


def _dense_splat_on_live(kept):
    """B1's dense entry on the inputs the live stream gave it for its first
    chunk (after the launch counts are read), into a zero grid of the live
    grid's size: against its plain version (max abs error), ms, plain ms,
    torch.sparse.mm ms, work and bound."""
    import torch

    from spatially_aware_ai_tpu_torch.grid import splat as S

    uvw, feats = kept["uvw"], kept["feat_imgs"]
    zero = torch.zeros(kept["shape"], device=uvw.device)
    got = S.splat(zero.clone(), uvw, feats)
    want = S.splat_plain(zero.clone(), uvw, feats)
    err = float((got - want).abs().max())
    del got, want
    args = (zero, uvw, feats)
    ms = time_ms(lambda: S.splat(*args))
    plain_ms = time_ms(lambda: S.splat_plain(zero, uvw, feats), warmup=1,
                       iters=5)
    library_ms = _sparse_mm_ms(uvw, feats)
    return {"rows": int(uvw.shape[0]), "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            **splat_numbers(args, ms)}


def _live_manager(dev, engine, seg, root, **manager_kw):
    from spatially_aware_ai_tpu_torch.manager import InSituManager

    return InSituManager(
        scan_dir=os.path.join(root, "scans"), scan_name="demo",
        dataset="synthetic", output_dir=os.path.join(root, "out"),
        device=dev, clip_engine=engine, seg_model=seg,
        auto_reconstruct=False, **manager_kw)


def _grid_bytes(grid):
    return sum(t.numel() * t.element_size() for t in (
        grid.tsdf_sum, grid.tsdf_w, grid.rgb_sum, grid.feat_sum, grid.w,
        grid.label_hist) if t is not None)


def live_stream_a(dev, engine, seg, root, frames, **manager_kw):
    """Stream A of the live phase (module docstring, phase 12) over HTTP:
    begin, the pushes (preview and objects after the second chunk),
    status, end, a text query and the scene mesh of the installed version,
    and /reprocess_scan of the persisted live version. Returns (numbers,
    checks, launches over the stream)."""
    import torch

    from spatially_aware_ai_tpu_torch.server import create_app

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    tag = "live_request"
    log, checks = [], {}
    manager = _live_manager(dev, engine, seg, root, **manager_kw)
    http = _Http(create_app(manager))
    kept, restore = _keep_first_dense_splat()
    chunk = manager.frame_chunk
    n = len(frames["rgb"])
    sync()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    try:
        http.call("POST", "/live_begin", {}, log, tag=tag)
        pushes = []
        for lo in range(0, n, LIVE_PUSH):
            _, st = http.call("POST", "/live_push",
                              npz=_push_body(frames, lo, lo + LIVE_PUSH),
                              log=log, tag=tag)
            t_last_push = time.perf_counter()
            pushes.append(log[-1])
            if lo + LIVE_PUSH == 2 * chunk:
                _, preview = http.call("GET", "/live_preview", None, log,
                                       tag=tag)
                _, objects = http.call("GET", "/live_objects", None, log,
                                       tag=tag)
        grid = manager._live.grid
        grid_bytes, grid_rows = _grid_bytes(grid), int(grid.tsdf_sum.shape[0])
        del grid
        _, status = http.call("GET", "/live_status", None, log, tag=tag)
        _, end = http.call("POST", "/live_end", {}, log, tag=tag)
        scan_to_queryable_s = time.perf_counter() - t_last_push
        end_launches = log[-1]["launches"]
        peak_gb = (torch.cuda.max_memory_allocated() / 1e9
                   if dev.type == "cuda" else None)
        version = end.get("version")
        uo = manager.scene_knowledge["unique_objects"]
        label = sorted({o["class_label"] for o in uo.values()})[0]
        _, query = http.call("POST", "/text_query",
                             {"text_query": f"show me {label}"}, log, tag=tag)
        http.call("POST", "/requset_scene_mesh", {
            "scan_version": version, "obj_key": "scene", "color": "rgb"},
            log, tag=tag)
        http.call("POST", "/reprocess_scan", {"version": version}, log,
                  tag=tag)
        reprocess = log[-1]
        reprocess_timings = dict(manager.last_fusion_timings,
                                 build_s=manager.last_fusion_seconds)
        objects_reprocessed = len(manager.scene_knowledge["unique_objects"])
    finally:
        restore()
        http.close()
        manager._wait_for_save()
    chunks = -(-n // chunk)
    pushed = {k: sum(p["launches"][k] for p in pushes) + end_launches[k]
              for k in end_launches}
    checks.update({
        "status_200": all(ln["status"] == 200 for ln in log),
        "frames_integrated": end.get("frames_integrated") == n,
        "clipped_under_5pct": end.get("clipped_fraction", 1.0) < 0.05,
        "b1_once_per_chunk": pushed["feature_splat"] == chunks,
        "clip_kmax_launches": pushed["ln_mlp"] == 48 * chunks
        and pushed["attention"] == 12 * chunks
        and pushed["paint_masks"] == chunks,
        "end_done": end.get("state") == "done"
        and end.get("n_objects", 0) > 0,
        "preview_mesh": bool(preview.get("mesh"))
        and len(preview["mesh"]["vertices"]) > 0,
        "objects_mid_stream": bool(objects.get("objects")),
        "query_mesh": len(query.get("vertices", [])) > 0,
        "reprocess_launches": reprocess["launches"]["feature_splat"] > 0
        and objects_reprocessed > 0,
    })
    out = {"requests": len(log), "frames": n, "chunks": chunks,
           "nvox": end.get("nvox"), "grid_rows": grid_rows,
           "grid_bytes": grid_bytes,
           "clipped_fraction": end.get("clipped_fraction"),
           "warm": status.get("warm"),
           "push_ms": [p["ms"] for p in pushes],
           "live_end_ms": log[[ln["route"] for ln in log].index(
               "/live_end")]["ms"],
           "scan_to_queryable_s": scan_to_queryable_s,
           "reprocess_ms": reprocess["ms"],
           "reprocess_timings": reprocess_timings,
           "objects_live_end": end.get("n_objects"),
           "objects_reprocessed": objects_reprocessed,
           "vertices_live_end": end.get("n_vertices"),
           "preview_bytes": log[[ln["route"] for ln in log].index(
               "/live_preview")]["bytes"],
           "objects_mid_stream": len(objects.get("objects") or []),
           "peak_cuda_mem_gb": peak_gb, "launches_pushed": pushed}
    if dev.type == "cuda" and kept:
        out["splat_chunk0"] = _dense_splat_on_live(kept)
        checks["splat_chunk0_agrees"] = (
            out["splat_chunk0"]["max_abs_err"] <= 1e-4)
    return out, checks, http.total


def _grids_equal(a, b):
    """Resume check of stream B: integer accumulators and label_hist equal,
    float sums within 1e-6 of their largest magnitude."""
    import torch

    out = {}
    for k in ("tsdf_w", "w", "label_hist"):
        x, y = getattr(a, k), getattr(b, k)
        out[f"{k}_equal"] = bool(x.shape == y.shape and torch.equal(x, y))
    for k in ("tsdf_sum", "rgb_sum", "feat_sum"):
        x, y = getattr(a, k), getattr(b, k)
        scale = float(y.abs().max().clamp_min(1e-30))
        out[f"{k}_rel"] = (float((x - y).abs().max()) / scale
                           if x.shape == y.shape else float("inf"))
    out["ok"] = all(v for k, v in out.items() if k.endswith("_equal")) \
        and all(v <= 1e-6 for k, v in out.items() if k.endswith("_rel"))
    return out


def live_stream_b(dev, engine, seg, root, frames, **manager_kw):
    """Stream B of the live phase: a yuv420-transfer session fed packed
    i420 planes, snapshotted, dropped without /live_end, resumed by a fresh
    manager on the same scan dir, finished. Returns (numbers, checks)."""
    from spatially_aware_ai_tpu_torch.server import create_app

    tag = "live_crash_request"
    log, n = [], len(frames["rgb"])
    saved = os.environ.get("SAI_RGB_TRANSFER")
    os.environ["SAI_RGB_TRANSFER"] = "yuv420"
    try:
        manager = _live_manager(dev, engine, seg, root, **manager_kw)
        fresh = None
        http = _Http(create_app(manager))
        try:
            http.call("POST", "/live_begin", {}, log, tag=tag)
            for lo in range(0, LIVE_CRASH_AT, LIVE_PUSH):
                http.call("POST", "/live_push",
                          npz=_push_body(frames, lo, lo + LIVE_PUSH, True),
                          log=log, tag=tag)
                if lo + LIVE_PUSH == LIVE_SNAPSHOT_AT:
                    _, snap = http.call("POST", "/live_snapshot", {}, log,
                                        tag=tag)
                    snap_ms = log[-1]["ms"]
            crashed = manager._live.preview_grid()
            transfer = manager._live.cfg.rgb_transfer
        finally:
            http.close()
        staging = manager._live_staging_dir()
        snap_bytes = os.path.getsize(os.path.join(staging,
                                                  "grid_snapshot.npz"))
        manager._wait_for_save()
        del manager  # dropped without /live_end: the staging dir stays
        fresh = _live_manager(dev, engine, seg, root, **manager_kw)
        http = _Http(create_app(fresh))
        try:
            _, resumed = http.call("POST", "/live_resume", {}, log, tag=tag)
            resume_ms = log[-1]["ms"]
            held = _grids_equal(fresh._live.preview_grid(), crashed)
            del crashed
            for lo in range(LIVE_CRASH_AT, n, LIVE_PUSH):
                http.call("POST", "/live_push",
                          npz=_push_body(frames, lo, lo + LIVE_PUSH, True),
                          log=log, tag=tag)
            _, end = http.call("POST", "/live_end", {}, log, tag=tag)
        finally:
            http.close()
            fresh._wait_for_save()
    finally:
        if saved is None:
            os.environ.pop("SAI_RGB_TRANSFER", None)
        else:
            os.environ["SAI_RGB_TRANSFER"] = saved
    checks = {
        "crash_status_200": all(ln["status"] == 200 for ln in log),
        "crash_yuv420_session": transfer == "yuv420",
        "crash_snapshot": bool(snap.get("snapshotted"))
        and snap.get("frames_in_snapshot") == LIVE_SNAPSHOT_AT,
        "resume_frames": resumed.get("snapshot_frames") == LIVE_SNAPSHOT_AT
        and resumed.get("resumed_frames") == LIVE_CRASH_AT,
        "resume_exact": held["ok"],
        "crash_end_done": end.get("state") == "done"
        and end.get("frames_integrated") == n,
    }
    out = {"snapshot_ms": snap_ms, "snapshot_bytes": snap_bytes,
           "resume_ms": resume_ms, "resumed": resumed, "resume_vs_crashed":
           held, "end_ms": log[-1]["ms"],
           "objects": end.get("n_objects")}
    return out, checks


def _live_small(dev, root):
    """The small scene (96x72, 8 frames, 0.06 m, SMALL_CARD_CONFIG CLIP
    from one state dict, ColorSegmenter) streamed by the port's
    cli/client.py `live --i420 --snapshot-every 1 --objects-every 1` to a
    manager on `dev`: the knowledge of the installed version and the
    live_end status."""
    import ast
    import contextlib
    import io

    import torch

    from spatially_aware_ai_tpu_torch.cli import client
    from spatially_aware_ai_tpu_torch.data import (ColorSegmenter,
                                                   SyntheticScene)
    from spatially_aware_ai_tpu_torch.models.clip.engine import (
        SMALL_CARD_CONFIG, ClipEngine)
    from spatially_aware_ai_tpu_torch.server import create_app

    manager = _live_manager(
        dev, ClipEngine.random(SMALL_CARD_CONFIG, seed=0, device=dev),
        ColorSegmenter(SyntheticScene.demo_room()),
        os.path.join(root, str(dev)), voxel_size=0.06, trunc_vox=2,
        clip_patch_size=48, clip_patch_stride=24, frame_chunk=4)
    http = _Http(create_app(manager))
    printed = io.StringIO()
    try:
        with contextlib.redirect_stdout(printed):
            client.main(["--server", http.url, "live",
                         os.path.join(root, "scan"), "--dataset",
                         "synthetic", "--chunk", "2", "--i420",
                         "--snapshot-every", "1", "--objects-every", "1"])
        status, sk = http.call("POST", "/requset_scene_knowledge",
                               {"scan_version": manager.curr_ver},
                               counted=False)
    finally:
        http.close()
        manager._wait_for_save()
    del manager
    if dev == "cuda":
        torch.cuda.synchronize()
    end = ast.literal_eval(
        [ln for ln in printed.getvalue().splitlines()
         if ln.startswith("end: ")][-1][len("end: "):])
    return status, sk, end


def live_crosscheck(root):
    """The small scene streamed to a CPU manager and to a card manager:
    the same object keys and class labels, voxel counts within 1%, the
    same clipped_fraction."""
    os.makedirs(os.path.join(root, "scan"), exist_ok=True)
    with open(os.path.join(root, "scan", "synthetic_scene.json"), "w") as f:
        json.dump({"num_frames": 8, "width": 96, "height": 72}, f)
    runs = {d: _live_small(d, root) for d in ("cpu", "cuda")}
    (s_cpu, sk_cpu, e_cpu), (s_gpu, sk_gpu, e_gpu) = (runs["cpu"],
                                                      runs["cuda"])
    uo_cpu, uo_gpu = sk_cpu["unique_objects"], sk_gpu["unique_objects"]
    counts = {k: (len(uo_cpu[k]["voxels"]), len(uo_gpu[k]["voxels"]))
              for k in uo_cpu if k in uo_gpu}
    out = {"objects": sorted(uo_gpu), "voxels_cpu_cuda": counts,
           "clipped_fraction": {"cpu": e_cpu.get("clipped_fraction"),
                                "cuda": e_gpu.get("clipped_fraction")}}
    checks = {
        "crosscheck_done": s_cpu == s_gpu == 200
        and e_cpu.get("state") == e_gpu.get("state") == "done",
        "crosscheck_same_objects": sorted(uo_cpu) == sorted(uo_gpu)
        and len(uo_gpu) > 0,
        "crosscheck_same_labels": all(
            uo_cpu[k]["class_label"] == uo_gpu[k]["class_label"]
            for k in counts),
        "crosscheck_voxels_1pct": all(abs(a - b) <= 0.01 * max(a, 1)
                                      for a, b in counts.values()),
        "crosscheck_same_clipped": e_cpu.get("clipped_fraction")
        == e_gpu.get("clipped_fraction"),
    }
    return out, checks


def phase_live(report):
    """Live streaming on the card (module docstring, phase 12): stream A,
    the crash drill (stream B), then the small scene streamed from the
    CPU and from the card (live_crosscheck)."""
    import tempfile

    import torch

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    engine, seg = _full_engines(dev)
    frames = live_frames(32, 1024, 768, depth_scale=4)
    setup_s = time.perf_counter() - t0
    kw = dict(voxel_size=0.04, trunc_vox=3, clip_patch_size=256,
              clip_patch_stride=128, frame_chunk=8)
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        a, checks, totals = live_stream_a(dev, engine, seg,
                                          os.path.join(root, "a"), frames,
                                          **kw)
        a_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        b, b_checks = live_stream_b(dev, engine, seg,
                                    os.path.join(root, "b"), frames, **kw)
        b_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        crosscheck, cross_checks = live_crosscheck(
            os.path.join(root, "small"))
        cross_s = time.perf_counter() - t0
    checks.update(b_checks)
    checks.update(cross_checks)
    out = {"phase": "live", "seconds": {"setup_s": setup_s,
                                        "stream_a_s": a_s,
                                        "stream_b_s": b_s,
                                        "crosscheck_s": cross_s},
           "depth_pushed": list(frames["depth"].shape[1:]),
           **a, "crash": b, "launches": totals, "crosscheck": crosscheck,
           "checks": checks, "ok": all(checks.values())}
    emit(out)
    _record_launches(report, "live", totals)
    if "splat_chunk0" in a:
        report.setdefault("feature_splat", {"name": "feature_splat"})[
            "live_chunk0_ms"] = a["splat_chunk0"]["ms"]
    if not out["ok"]:
        raise SystemExit(f"live phase failed: {checks}")


# ------------------------------------------------------------ shard phase


SHARDS = 4


def _kept_chunk(ds, engine, seg, cfg, lo, hi, dev):
    """One chunk of the path as fuse_scan builds it (quantized upload,
    CLIP's fixed tiles, device-fused kMaX labels), kept for the
    integrator comparisons."""
    import numpy as np
    import torch

    from spatially_aware_ai_tpu_torch.grid.voxel_grid import FrameBatch
    from spatially_aware_ai_tpu_torch.pipeline import (
        quantized_chunk_to_device)

    st = ds.stacked_u8(list(range(lo, hi)))
    rgb, depth = quantized_chunk_to_device(st["rgb"], st["depth"], dev)
    with torch.inference_mode():
        feats = engine.img_inference_tiled_batch(
            rgb, patch_size=cfg.clip_patch_size,
            patch_stride=cfg.clip_patch_stride)
        labels = seg.run_on_batch_fused_labels(rgb, as_numpy=False)
    return FrameBatch(
        depth=depth, rgb=rgb,
        pose=torch.as_tensor(np.asarray(st["pose"], np.float32), device=dev),
        K=torch.as_tensor(np.asarray(st["K"], np.float32), device=dev),
        feat_img=feats.contiguous(), labels=labels.to(torch.int32),
        frame_valid=torch.ones(hi - lo, dtype=torch.bool, device=dev))


def _integrators_sharded_vs_one(mesh, result, batches, dev):
    """(a) of the shard phase: the kept chunks through the sharded and the
    unsharded sparse, brick and hybrid integrators into grids of the
    path's size: integer accumulators equal, float sums within 1e-5 of
    each other; the card's seconds for both."""
    import torch

    from spatially_aware_ai_tpu_torch.grid.voxel_grid import create_grid
    from spatially_aware_ai_tpu_torch.parallel import (
        gather_grid, make_sharded_integrate, shard_grid)

    g0 = result.grid
    kw = dict(origin=g0.origin.cpu().numpy(), voxel_size=g0.voxel_size,
              nvox=g0.nvox, trunc=g0.trunc, feature_dim=g0.feat_sum.shape[1],
              with_labels=True, num_classes=g0.label_hist.shape[1],
              pad_to=SHARDS, min_padding=1, device=dev)
    out = {}
    for integ in ("sparse", "brick", "einsum"):
        one = create_grid(**kw)
        sg = shard_grid(mesh, create_grid(**kw))
        step = make_sharded_integrate(mesh, sg, batches[0], integrator=integ)
        row = {}
        for name, fn in (("one", lambda b: _integrate_one(one, b, integ)),
                         ("sharded", lambda b: step(sg, b))):
            _sync(dev)
            t0 = time.perf_counter()
            with torch.inference_mode():
                for b in batches:
                    fn(b)
            _sync(dev)
            row[f"{name}_s"] = time.perf_counter() - t0
        got = gather_grid(sg)
        ok = True
        for k in ("tsdf_w", "w", "label_hist"):
            x, y = getattr(got, k), getattr(one, k)
            if x.dtype == torch.uint16:
                x, y = x.view(torch.int16), y.view(torch.int16)
            row[f"{k}_mismatches"] = int((x != y).sum())
            ok &= row[f"{k}_mismatches"] == 0
        for k in ("tsdf_sum", "rgb_sum", "feat_sum"):
            row[f"{k}_max_abs"] = float((getattr(got, k)
                                         - getattr(one, k)).abs().max())
            ok &= row[f"{k}_max_abs"] <= 1e-5
        row["observed"] = int((one.w > 0).sum())
        row["ok"] = bool(ok and row["observed"] > 0)
        out[integ] = row
        del one, sg, got
    return out


def _sync(dev):
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def _integrate_one(grid, batch, integ):
    from spatially_aware_ai_tpu_torch.grid.brick import (
        integrate_frames_brick)
    from spatially_aware_ai_tpu_torch.grid.fusion import (
        integrate_frames_pallas, integrate_frames_sparse)

    if integ == "sparse":
        integrate_frames_sparse(grid, batch)
    elif integ == "brick":
        integrate_frames_brick(grid, batch)
    else:
        integrate_frames_pallas(grid, batch)


def _kmax_stages(model, rgb, step):
    """kMaX on rgb in one batch and in slices of `step` frames through the
    model's own forward: the largest difference (and magnitude) of the
    pixel decoder's outputs, of each k-means layer's mask logits (the
    tensor its hard argmax reads, recorded by hooks) with the share of
    pixels whose argmax differs, and of the final class and mask logits."""
    import torch

    from spatially_aware_ai_tpu_torch.models.kmax import model as KM

    seg = KM.KmaxSegmenter.__new__(KM.KmaxSegmenter)
    seg.cfg = model.cfg
    new_h, new_w, pad_h, pad_w = seg._test_shape(*rgb.shape[1:3])
    head = model.sem_seg_head
    layers = head.transformer_decoder._kmax_transformer_layers
    seen = {"decoder": [], "kmeans": [[] for _ in layers]}
    hooks = [head.pixel_decoder.register_forward_hook(
        lambda mod, args, out: seen["decoder"].append(out))]
    for i, layer in enumerate(layers):
        hooks.append(layer.register_forward_pre_hook(
            lambda mod, args, i=i: seen["kmeans"][i].append(args[2])))

    def run(x):
        seen["decoder"].clear()
        for rec in seen["kmeans"]:
            rec.clear()
        cls, masks = model(KM.prep_batch(x, new_h, new_w, pad_h, pad_w))
        dec = [torch.cat([d[k] for d in seen["decoder"]])
               for k in KM._LEVELS]
        return dec, [torch.cat(rec) for rec in seen["kmeans"]], [cls, masks]

    try:
        with torch.inference_mode():
            whole = run(rgb)
            parts = [run(rgb[i:i + step])
                     for i in range(0, rgb.shape[0], step)]
    finally:
        for h in hooks:
            h.remove()

    def diff(g, j):
        split = torch.cat([p[g][j] for p in parts])
        return split, {"max_abs": float((split - whole[g][j]).abs().max()),
                       "scale": float(whole[g][j].abs().max())}

    out = {f"decoder_{k}": diff(0, j)[1] for j, k in enumerate(KM._LEVELS)}
    out["kmeans_layers"] = []
    for j in range(len(whole[1])):
        split, d = diff(1, j)
        d["flipped_share"] = float((split.argmax(-1)
                                    != whole[1][j].argmax(-1))
                                   .float().mean())
        out["kmeans_layers"].append(d)
    out["class_logits"], out["mask_logits"] = diff(2, 0)[1], diff(2, 1)[1]
    return out


def _within(stage, tol):
    return stage["max_abs"] <= tol * stage["scale"]


def _kmax_frame_split(seg, rgb):
    """(b) of the shard phase: kMaX on a chunk's 8 frames in one batch and
    in SHARDS slices, as a sharded fuse_scan runs it.

    - The small kMaX of crosscheck_kmax (widths 64-256, which B2 takes),
      as initialised: class and mask logits within 2e-4 of their largest
      magnitude (the JAX package's multi-device criterion).
    - The full-width painting model: device-fused labels equal on >= 99.9%
      of the pixels, and the pixel decoder's outputs, every k-means
      layer's mask logits and the final class and mask logits within 2e-4
      of their magnitude. Before the head ran one frame at a time (ROADMAP
      C14) only the decoder and the first k-means layer held: each layer's
      hard argmax over 128 random clusters has near-ties that the batch
      size's rounding flipped (flipped_share per layer), and a flipped
      pixel moves its cluster's query by O(1)."""
    import dataclasses

    import torch

    from spatially_aware_ai_tpu_torch.models.kmax import model as KM
    from spatially_aware_ai_tpu_torch.models.kmax.convnext import (
        ConvNeXtConfig)

    step = rgb.shape[0] // SHARDS
    cfg = dataclasses.replace(
        KM.KMAX_TINY_TEST,
        backbone=ConvNeXtConfig(depths=(1, 1, 2, 1), dims=(64, 128, 192, 256)))
    small = KM.KMaxDeepLab(cfg).init_random_(torch.Generator().manual_seed(0))
    small = small.to(rgb.device).eval().requires_grad_(False)
    small_rgb = torch.nn.functional.interpolate(
        rgb.permute(0, 3, 1, 2), size=(96, 128), mode="bilinear",
        align_corners=False).permute(0, 2, 3, 1).contiguous()
    out = {"small": _kmax_stages(small, small_rgb, step),
           "full": _kmax_stages(seg.model, rgb, step)}
    ok = all(_within(out["small"][k], 2e-4)
             for k in ("class_logits", "mask_logits"))
    ok &= all(_within(out["full"][k], 2e-4) for k in out["full"]
              if k.startswith("decoder_") or k.endswith("_logits"))
    ok &= all(_within(layer, 2e-4)
              for layer in out["full"]["kmeans_layers"])
    with torch.inference_mode():
        labels = seg.run_on_batch_fused_labels(rgb, as_numpy=False)
        labels_split = torch.cat([
            seg.run_on_batch_fused_labels(rgb[i:i + step], as_numpy=False)
            for i in range(0, rgb.shape[0], step)])
    out["label_agreement"] = float((labels == labels_split).float().mean())
    out["painted_share"] = float((labels != KM.NULL_ID).float().mean())
    out["ok"] = bool(ok and out["label_agreement"] >= 0.999
                     and out["painted_share"] > 0)
    return out


def _fuse_scans_against(a, b):
    """(c) of the shard phase: sharded fuse_scan result a against the
    unsharded b: weight and tsdf_weight equal, class_id on >= 99.9% of the
    voxels, features of observed voxels by cosine >= 0.9999."""
    import numpy as np
    import torch

    out = {}
    for k in ("weight", "tsdf_weight"):
        out[f"{k}_mismatches"] = int((a.values[k] != b.values[k]).sum())
    out["class_id_agreement"] = float(np.mean(a.values["class_id"]
                                              == b.values["class_id"]))
    n = int(np.prod(b.nvox))
    seen = np.flatnonzero(b.values["weight"] > 0)
    rows = torch.as_tensor(seen, device=b.values["feat"].device)
    fa = a.values["feat"][:n][rows].double()
    fb = b.values["feat"][:n][rows].double()
    cos = (fa * fb).sum(1) / (fa.norm(dim=1) * fb.norm(dim=1))
    out["observed_voxels"] = int(len(seen))
    out["feat_cos_min"] = float(cos.min())
    out["tsdf_max_abs"] = float(np.abs(a.values["tsdf"]
                                       - b.values["tsdf"]).max())
    out["ok"] = bool(out["weight_mismatches"] == 0
                     and out["tsdf_weight_mismatches"] == 0
                     and out["class_id_agreement"] >= 0.999
                     and out["feat_cos_min"] >= 0.9999
                     and out["observed_voxels"] > 0)
    return out


def _live_sharded_vs_one(engine, seg, frames, mesh, dev):
    """(d) of the shard phase: a sharded LiveScanSession of a few pushes
    against an unsharded one (cli.serve's defaults, the hybrid): the same
    grid (integers equal, float sums within 1e-6 of their largest
    magnitude), and each session's seconds."""
    import dataclasses

    import numpy as np

    from spatially_aware_ai_tpu_torch.manager.live import LiveScanSession
    from spatially_aware_ai_tpu_torch.pipeline import FusionConfig

    out = {}
    results = {}
    for name, shard in (("one", False), ("sharded", True)):
        cfg = FusionConfig(voxel_size=0.04, trunc_vox=3.0,
                           clip_patch_size=256, clip_patch_stride=128,
                           frame_chunk=8, with_labels=True,
                           shard_voxels=shard)
        sess = LiveScanSession(engine, seg, cfg, margin_m=1.0, device=dev,
                               mesh=mesh)
        t0 = time.perf_counter()
        for lo in range(0, len(frames["rgb"]), 4):
            sess.push(*(frames[k][lo:lo + 4]
                        for k in ("rgb", "depth", "pose", "K")))
        result, _ = sess.end()
        _sync(dev)
        out[f"{name}_s"] = time.perf_counter() - t0
        results[name] = result
    # the sharded buffer is padded to a multiple of the mesh: compare the
    # grid's own rows
    n = int(np.prod(results["one"].nvox))
    a, b = (dataclasses.replace(results[k].grid, **{
        f: getattr(results[k].grid, f)[:n]
        for f in ("tsdf_sum", "tsdf_w", "rgb_sum", "feat_sum", "w",
                  "label_hist")}) for k in ("sharded", "one"))
    out["grid"] = _grids_equal(a, b)
    out["voxels"] = n
    # the frame split moves kMaX's labels and CLIP's features by rounding
    # (phase 13 (b)): the criteria of (c)
    out["values"] = _fuse_scans_against(results["sharded"], results["one"])
    out["ok"] = (out["grid"]["tsdf_w_equal"] and out["grid"]["w_equal"]
                 and out["values"].pop("ok"))
    return out


def phase_shard(report):
    """Voxel-sharded fusion on the card (module docstring, phase 13)."""
    import dataclasses

    import torch

    from spatially_aware_ai_tpu_torch.grid import splat as S
    from spatially_aware_ai_tpu_torch.models import attention as A
    from spatially_aware_ai_tpu_torch.models import ln_mlp as L
    from spatially_aware_ai_tpu_torch.models.kmax import model as KM
    from spatially_aware_ai_tpu_torch.models.kmax import paint as P
    from spatially_aware_ai_tpu_torch.parallel import make_mesh
    from spatially_aware_ai_tpu_torch.pipeline import FusionConfig, fuse_scan

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    n_frames, chunk = 32, 8
    ds = _path_scan()
    engine, seg = _full_engines(dev)
    mesh = make_mesh(devices=["cuda:0"] * SHARDS)
    cfg = FusionConfig(voxel_size=0.02, clip_patch_size=256,
                       clip_patch_stride=128, frame_chunk=chunk,
                       with_labels=True)
    torch.cuda.synchronize()
    secs = {"setup_s": time.perf_counter() - t0}
    checks = {"default_mesh_count":
              len(make_mesh()) == torch.cuda.device_count()}

    # in turns (unsharded, sharded, sharded, unsharded): the first
    # fuse_scan of a process is slower (ROADMAP A6); the second sharded
    # run is the counted one
    shard_cfg = dataclasses.replace(cfg, shard_voxels=True)
    secs["fuse_scan_s_unsharded"], secs["fuse_scan_s_sharded"] = [], []
    peak = {}
    messages = []
    for turn, sharded_turn in enumerate((False, True, True, False)):
        torch.cuda.reset_peak_memory_stats()
        if turn == 2:
            S.launches = L.launches = P.launches = A.launches = 0
        t0 = time.perf_counter()
        r = fuse_scan(ds, engine, shard_cfg if sharded_turn else cfg,
                      segmenter=seg.run_on_image, device=dev,
                      mesh=mesh if sharded_turn else None,
                      progress=messages.append)
        name = "sharded" if sharded_turn else "unsharded"
        secs[f"fuse_scan_s_{name}"].append(time.perf_counter() - t0)
        if turn == 2:
            launches = {"feature_splat": S.launches, "ln_mlp": L.launches,
                        "paint_masks": P.launches, "attention": A.launches}
        if turn < 2:  # with no other result held
            peak[f"{name}_gb"] = torch.cuda.max_memory_allocated() / 1e9
        else:
            if sharded_turn:
                sharded = r
            else:
                one = r
        del r
    n_chunks = -(-n_frames // chunk)
    checks["sharded_message"] = any(f"over {SHARDS} mesh entries" in m
                                    for m in messages)
    checks["launches"] = all(v > 0 for v in launches.values())
    # B1: one scatter per shard and chunk (none where a shard has no
    # near-surface row); the models once per frame slice: B3 once, B5 per
    # CLIP layer, B2 per CLIP layer and ConvNeXt block
    slices = n_chunks * SHARDS
    blocks = sum(KM.KMAX_CONVNEXT_LARGE.backbone.depths)
    layers = engine.cfg.vision_layers
    expected = {"feature_splat": slices, "paint_masks": slices,
                "attention": slices * layers,
                "ln_mlp": slices * (layers + blocks)}
    checks["splat_per_shard"] = 0 < launches["feature_splat"] <= slices
    for k in ("paint_masks", "attention", "ln_mlp"):
        checks[f"{k}_per_slice"] = launches[k] == expected[k]
    vs = _fuse_scans_against(sharded, one)
    checks["fuse_scan_equal"] = vs.pop("ok")

    batches = [_kept_chunk(ds, engine, seg, cfg, lo, lo + chunk, dev)
               for lo in (0, chunk)]
    integ = _integrators_sharded_vs_one(mesh, one, batches, dev)
    checks["integrators_equal"] = all(r.pop("ok") for r in integ.values())
    kmax = _kmax_frame_split(seg, batches[0].rgb)
    checks["kmax_frame_split"] = kmax.pop("ok")
    del batches, one, sharded

    frames = ds.stacked_u8(list(range(16)))
    live = _live_sharded_vs_one(engine, seg, frames, mesh, dev)
    checks["live_equal"] = live.pop("ok")

    out = {"phase": "shard", "mesh": [str(d) for d in mesh.devices],
           "seconds": secs, "peak_cuda_mem": peak, "launches": launches,
           "expected": expected,
           "fuse_scan": vs, "integrators": integ, "kmax": kmax,
           "live": live, "checks": checks, "ok": all(checks.values())}
    emit(out)
    _record_launches(report, "shard", launches)
    if not out["ok"]:
        raise SystemExit(f"shard phase failed: {checks}")


# --------------------------------------------------------- multihost phase


def _run_harness(out_dir):
    """Two harness processes (2 shards each) on cuda:0 with gloo; returns
    (seconds, exit codes, their stderr tails, their JSON outputs or
    None)."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    outs = [os.path.join(out_dir, f"mh{i}.json") for i in range(2)]
    env = dict(os.environ, PYTHONPATH=ROOT)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m",
         "spatially_aware_ai_tpu_torch.parallel.multihost",
         "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
         "--process-id", str(i), "--out", outs[i], "--device", "cuda",
         "--backend", "gloo", "--local-shards", "2"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for i in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    secs = time.perf_counter() - t0
    rcs = [p.returncode for p in procs]
    sums = None
    if not any(rcs):
        sums = []
        for o in outs:
            with open(o) as f:
                sums.append(json.load(f))
    return secs, rcs, [err[-1500:] for _, err in logs], sums


def phase_multihost():
    """The multi-process harness on the card (module docstring, phase 14):
    2 processes x 2 shards of one 4-shard mesh, both on cuda:0, gloo; the
    all_reduced checksums against the single-process oracle on the card."""
    import tempfile

    from spatially_aware_ai_tpu_torch.parallel.multihost import (
        oracle_checksums)

    with tempfile.TemporaryDirectory() as d:
        secs, rcs, errs, sums = _run_harness(d)
    out = {"phase": "multihost", "seconds": secs, "rcs": rcs}
    checks = {"exit_0": sums is not None}
    if sums is not None:
        oracle = oracle_checksums(device="cuda")
        rel = {k: abs(sums[0][k] - v) / max(abs(v), 1e-30)
               for k, v in oracle.items()}
        out.update(devices=[s["device"] for s in sums],
                   n_shards=sums[0]["n_shards"], max_rel_err=max(
                       rel.values()), oracle=oracle)
        checks["same_on_both"] = all(sums[0][k] == sums[1][k]
                                     for k in oracle)
        checks["oracle_1e-6"] = out["max_rel_err"] <= 1e-6
        checks["on_the_card"] = all(s["device"].startswith("cuda")
                                    for s in sums)
        checks["observed"] = oracle["w"] > 0
    else:
        out["stderr"] = errs
    out["checks"] = checks
    out["ok"] = all(checks.values())
    emit(out)
    if not out["ok"]:
        raise SystemExit(f"multihost phase failed: {checks}")


# ------------------------------------------------------------- depth phase


def phase_depth(report):
    """Depth-scaled CLIP patches on the card (module docstring, phase 15)."""
    import dataclasses

    import numpy as np
    import torch

    from spatially_aware_ai_tpu_torch.grid import splat as S
    from spatially_aware_ai_tpu_torch.models import attention as A
    from spatially_aware_ai_tpu_torch.models import ln_mlp as L
    from spatially_aware_ai_tpu_torch.models.clip.engine import ClipEngine
    from spatially_aware_ai_tpu_torch.models.kmax import paint as P
    from spatially_aware_ai_tpu_torch.pipeline import FusionConfig, fuse_scan

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    n_frames, chunk = 32, 8
    ds = _path_scan()
    engine, seg = _full_engines(dev)
    cpu = ClipEngine(engine.cfg, engine.model.state_dict(), device="cpu")
    st = ds.stacked(list(range(chunk)))
    rgb = torch.as_tensor(st["rgb"], device=dev)
    depth = torch.as_tensor(st["depth"], device=dev)
    K = torch.as_tensor(st["K"], device=dev)
    secs = {"setup_s": time.perf_counter() - t0}

    # one frame on the card against the CPU plain version
    got = engine.img_inference_tiled_depthscaled(rgb[0], depth[0], K[0],
                                                 128).cpu()
    want = cpu.img_inference_tiled_depthscaled(rgb[0].cpu(), depth[0].cpu(),
                                               K[0].cpu(), 128)
    a, b = got.reshape(-1, got.shape[-1]), want.reshape(-1, got.shape[-1])
    live = b.norm(dim=1) > 0
    cos = (a[live] * b[live]).sum(1) / (a[live].norm(dim=1)
                                        * b[live].norm(dim=1))
    frame = {"shape": list(got.shape), "cells": int(live.numel()),
             "covered_cells": int(live.sum()),
             "max_abs": float((a - b).abs().max()),
             "cos_min": float(cos.min())}
    checks = {"frame_vs_cpu": frame["max_abs"] <= 1e-4
              and frame["cos_min"] >= 0.9999 and frame["covered_cells"] > 0}

    # the tiler's card time per chunk, and the fixed tiles' beside it
    def tiler(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / 3

    fn_depth = lambda: engine.img_inference_tiled_depthscaled(  # noqa
        rgb, depth, K, 128)
    fn_fixed = lambda: engine.img_inference_tiled_batch(  # noqa
        rgb, patch_size=256, patch_stride=128)
    fn_depth(), fn_fixed()
    per_chunk = {"depthscaled_s": tiler(fn_depth),
                 "fixed_s": tiler(fn_fixed)}

    cfg = FusionConfig(voxel_size=0.02, clip_patch_size=256,
                       clip_patch_stride=128, frame_chunk=chunk,
                       with_labels=True, scale_patches_by_depth=True)
    torch.cuda.reset_peak_memory_stats()
    S.launches = L.launches = P.launches = A.launches = 0
    t0 = time.perf_counter()
    result = fuse_scan(ds, engine, cfg, segmenter=seg.run_on_image,
                       device=dev)
    secs["fuse_scan_s"] = time.perf_counter() - t0
    launches = {"feature_splat": S.launches, "ln_mlp": L.launches,
                "paint_masks": P.launches, "attention": A.launches}
    n_chunks = -(-n_frames // chunk)
    feat = result.feat_grid
    checks.update({
        "launches": all(v > 0 for v in launches.values()),
        # one CLIP forward a chunk, every crop of its 8 frames in it
        "attention_per_chunk": launches["attention"]
        == n_chunks * engine.cfg.vision_layers,
        "feat_finite": bool(torch.isfinite(feat).all()),
        "observed": int((result.values["weight"] > 0).sum()) > 0,
    })
    fixed = fuse_scan(ds, engine, dataclasses.replace(
        cfg, scale_patches_by_depth=False), segmenter=seg.run_on_image,
        device=dev)
    checks["same_geometry"] = bool(np.array_equal(
        result.values["weight"], fixed.values["weight"]))
    out = {"phase": "depth", "seconds": secs, "frame": frame,
           "tiler_per_chunk": per_chunk, "timings": result.timings,
           "peak_cuda_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": launches, "checks": checks,
           "ok": all(checks.values())}
    emit(out)
    _record_launches(report, "depth", launches)
    if not out["ok"]:
        raise SystemExit(f"depth phase failed: {checks}")


# ---------------------------------------------------------- convert phase

# the label bank of the convert phase's text check
CONVERT_LABELS = ["a red box", "the floor", "a chair", "a wooden table",
                  "the wall", "a small red suitcase"]


def _kernel_counts():
    """Each port kernel's launch count since the last zeroing."""
    from spatially_aware_ai_tpu_torch.grid import splat as S
    from spatially_aware_ai_tpu_torch.models import attention as A
    from spatially_aware_ai_tpu_torch.models import ln_mlp as L
    from spatially_aware_ai_tpu_torch.models.kmax import paint as P

    return {"feature_splat": S.launches, "ln_mlp": L.launches,
            "paint_masks": P.launches, "attention": A.launches}


def _zero_kernel_counts():
    from spatially_aware_ai_tpu_torch.grid import splat as S
    from spatially_aware_ai_tpu_torch.models import attention as A
    from spatially_aware_ai_tpu_torch.models import ln_mlp as L
    from spatially_aware_ai_tpu_torch.models.kmax import paint as P

    S.launches = L.launches = P.launches = A.launches = 0


def write_merges_gz(path):
    """A miniature merges table in the format of open_clip's
    bpe_simple_vocab_16e6.txt.gz: gzip, a version line, merge pairs."""
    import gzip

    lines = ["#version: 0.2 (miniature)", "t h", "th e</w>", "h e",
             "r e", "re d</w>", "b o", "bo x</w>", "c h", "ch a", "cha i",
             "chai r</w>", "f l", "fl o", "flo o", "floo r</w>"]
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    return path


def _served_heatmap(dev, root, **engines):
    """/reprocess_scan of an 8-frame 1024x768 v00 at path_kmax's point,
    then /text_query, over HTTP from a manager with `engines` (none: the
    manager's defaults, from the environment). Returns (statuses,
    heatmap, launches counted over the requests)."""
    from spatially_aware_ai_tpu_torch.manager import InSituManager
    from spatially_aware_ai_tpu_torch.server import create_app

    _write_scan_versions(root, {"num_frames": 8, "width": 1024,
                                "height": 768})
    manager = InSituManager(
        scan_dir=os.path.join(root, "scans"), scan_name="demo",
        dataset="synthetic", output_dir=os.path.join(root, "out"),
        device=dev, voxel_size=0.02, trunc_vox=3, clip_patch_size=256,
        clip_patch_stride=128, frame_chunk=8, auto_reconstruct=False,
        **engines)
    http = _Http(create_app(manager))
    try:
        statuses = [http.call("POST", "/reprocess_scan", {"version": 0})[0]]
        status, heat = http.call("POST", "/text_query",
                                 {"text_query": "show me a chair"})
        statuses.append(status)
    finally:
        http.close()
        manager._wait_for_save()
    return statuses, heat, http.total


def phase_convert(report, dev="cuda"):
    """Official-format checkpoints through the port's converters and
    `from_checkpoint` on the card (module docstring, phase 16)."""
    import tempfile

    import numpy as np
    import torch

    from spatially_aware_ai_tpu_torch.cli import convert_clip, convert_kmax
    from spatially_aware_ai_tpu_torch.core.device import full_f32
    from spatially_aware_ai_tpu_torch.data import SyntheticSceneDataset
    from spatially_aware_ai_tpu_torch.models.clip.engine import ClipEngine
    from spatially_aware_ai_tpu_torch.models.clip.model import (
        VIT_B_32_QUICKGELU)
    from spatially_aware_ai_tpu_torch.models.kmax import model as KM

    dev = torch.device(dev)
    secs, checks = {}, {}
    ds = SyntheticSceneDataset(num_frames=8, width=1024, height=768)
    rgbs = np.stack([ds[i].rgb for i in range(8)]).astype(np.float32)
    rgb_dev = torch.as_tensor(rgbs, device=dev)
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        merges = write_merges_gz(os.path.join(root, "merges.txt.gz"))
        src_clip = ClipEngine.random(VIT_B_32_QUICKGELU, seed=0,
                                     bpe_path=merges, device=dev)
        _, src_kmax = _full_engines(dev)
        files = {name: os.path.join(root, name) for name in (
            "open_clip_pytorch_model.bin", "kmax_convnext_large.pth",
            "clip.pkl", "kmax.pkl")}
        torch.save({k: v.cpu() for k, v in
                    src_clip.model.state_dict().items()},
                   files["open_clip_pytorch_model.bin"])
        torch.save({"model": {k: v.cpu() for k, v in
                              src_kmax.model.state_dict().items()}},
                   files["kmax_convnext_large.pth"])
        secs["setup_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        convert_clip.main([files["open_clip_pytorch_model.bin"],
                           files["clip.pkl"]])
        secs["convert_clip_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        convert_kmax.main([files["kmax_convnext_large.pth"],
                           files["kmax.pkl"], "--config", "large"])
        secs["convert_kmax_s"] = time.perf_counter() - t0
        sizes = {name: os.path.getsize(p) for name, p in files.items()}

        tokens = src_clip.tokenizer(CONVERT_LABELS)
        new_h, new_w, pad_h, pad_w = src_kmax._test_shape(768, 1024)

        def outputs(clip, seg):
            with torch.inference_mode():
                out = {"image": clip.img_inference_tiled_batch(
                           rgb_dev, 256, 128),
                       "text": clip._encode_text(tokens)}
                with full_f32():
                    out["class_logits"], out["mask_logits"] = seg.model(
                        KM.prep_batch(rgb_dev, new_h, new_w, pad_h, pad_w))
            out["labels"] = seg.run_on_batch_fused_labels(rgbs,
                                                          as_numpy=False)
            return out

        # the sources' answers, before the counts
        want = outputs(src_clip, src_kmax)
        want_served = _served_heatmap(dev, os.path.join(root, "injected"),
                                      clip_engine=src_clip,
                                      seg_model=src_kmax)
        _sync(dev)

        _zero_kernel_counts()
        t0 = time.perf_counter()
        conv_clip = ClipEngine.from_checkpoint(files["clip.pkl"],
                                               bpe_path=merges, device=dev)
        conv_kmax = KM.KmaxSegmenter.from_checkpoint(files["kmax.pkl"],
                                                     device=dev)
        _sync(dev)
        secs["load_s"] = time.perf_counter() - t0
        got = outputs(conv_clip, conv_kmax)
        launches = _kernel_counts()
        with mock.patch.dict(os.environ, {
                "SAI_CLIP_CHECKPOINT": files["clip.pkl"],
                "SAI_KMAX_CHECKPOINT": files["kmax.pkl"],
                "SAI_BPE_VOCAB": merges}):
            t0 = time.perf_counter()
            served = _served_heatmap(dev, os.path.join(root, "from_env"))
            secs["served_from_env_s"] = time.perf_counter() - t0
        launches = {k: v + served[2][k] for k, v in launches.items()}
    equal = {k: bool(torch.equal(got[k], want[k])) for k in want}
    checks["clip_bitwise"] = equal["image"] and equal["text"]
    checks["kmax_bitwise"] = (equal["class_logits"] and equal["mask_logits"]
                              and equal["labels"])
    checks["converted_config"] = (conv_clip.cfg == VIT_B_32_QUICKGELU
                                  and conv_kmax.cfg == KM.KMAX_CONVNEXT_LARGE)
    checks["served_status_200"] = all(s == 200 for s in served[0]
                                      + want_served[0])
    checks["served_heatmap_equal"] = served[1] == want_served[1]
    checks["painted"] = bool((got["labels"] != KM.NULL_ID).any())
    checks["launches"] = all(v > 0 for v in launches.values())
    out = {"phase": "convert", "seconds": secs, "file_bytes": sizes,
           "image_features": list(got["image"].shape),
           "text_features": list(got["text"].shape), "equal": equal,
           "heatmap": {"vertices": len(served[1].get("vertices", [])),
                       **_heatmap_diff(served[1], want_served[1])},
           "launches": launches, "checks": checks,
           "ok": all(checks.values())}
    emit(out)
    _record_launches(report, "convert", launches)
    if not out["ok"]:
        raise SystemExit(f"convert phase failed: {checks}")


# ------------------------------------------------------------ evals phase

ARCHIVES = os.path.join(ROOT, "tests", "fixtures", "archives")
SCANNET_SCENE = "scene0706_00"
HYPERSIM_SCENE = "ai_001_001"


def _scannet_gt(gt_root, mesh_path):
    """ScanNet-format ground truth over a fused mesh's vertices: each
    vertex its own segment, labelled by its height band (floor, table,
    chair, wall)."""
    import numpy as np

    from spatially_aware_ai_tpu_torch.meshing.ply import read_ply, write_ply

    verts, faces, _ = read_ply(mesh_path)
    gt_dir = os.path.join(gt_root, SCANNET_SCENE)
    os.makedirs(gt_dir)
    write_ply(os.path.join(gt_dir, f"{SCANNET_SCENE}_vh_clean_2.ply"),
              verts, faces)
    names = np.array(["floor", "table", "chair", "wall"])
    label = names[np.searchsorted(np.quantile(verts[:, 1], [0.25, 0.5,
                                                            0.75]),
                                  verts[:, 1])]
    groups = {}
    for i, n in enumerate(label):
        groups.setdefault(str(n), []).append(i)
    with open(os.path.join(gt_dir, f"{SCANNET_SCENE}_vh_clean_2.0.010000"
                           ".segs.json"), "w") as f:
        json.dump({"segIndices": list(range(len(verts)))}, f)
    with open(os.path.join(gt_dir, f"{SCANNET_SCENE}.aggregation.json"),
              "w") as f:
        json.dump({"segGroups": [{"label": k, "segments": v}
                                 for k, v in groups.items()]}, f)
    return gt_dir


def _hypersim_scans(root):
    """The Hypersim miniature archive where h5py imports; else (h5py is
    not on every host) a synthetic scan under the archive's scene name,
    which evals.hypersim reads the same way. Returns (scan dir, cli.fuse
    flags, what was fused)."""
    import importlib.util

    flags = ["--voxel-size", "0.1", "--clip-patch-size", "40",
             "--clip-patch-stride", "20", "--frame-chunk", "2"]
    if importlib.util.find_spec("h5py") is not None:
        return (os.path.join(ARCHIVES, "hypersim_mini"),
                ["--dataset", "hypersim"] + flags, "hypersim_mini")
    d = os.path.join(root, "hypersim_standin", HYPERSIM_SCENE)
    os.makedirs(d)
    with open(os.path.join(d, "synthetic_scene.json"), "w") as f:
        json.dump({"num_frames": 4, "width": 160, "height": 120}, f)
    return (os.path.dirname(d), ["--dataset", "synthetic"] + flags,
            "synthetic stand-in (no h5py)")


def phase_evals(report, dev="cuda"):
    """The evals and cli/fuse on the card (module docstring, phase 17)."""
    import dataclasses
    import pickle
    import tempfile

    import numpy as np
    import torch

    from spatially_aware_ai_tpu_torch.cli import fuse
    from spatially_aware_ai_tpu_torch.evals import hypersim, scannet
    from spatially_aware_ai_tpu_torch.evals.synthetic import (
        eval_synthetic_labels)
    from spatially_aware_ai_tpu_torch.models.clip.convert import (
        convert_open_clip_state_dict, count_layers, infer_clip_config)
    from spatially_aware_ai_tpu_torch.models.clip.engine import (
        SMALL_CARD_CONFIG, ClipEngine)

    dev = torch.device(dev)
    engine, _ = _full_engines(dev)
    checks, secs = {}, {}
    _zero_kernel_counts()
    synthetic = {}
    for name, pin in EVAL_PINS.items():
        t0 = time.perf_counter()
        st = eval_synthetic_labels(segmenter=name, clip_engine=engine,
                                   device=dev)
        secs[f"synthetic_{name}_s"] = time.perf_counter() - t0
        synthetic[name] = {k: st[k] for k in (
            "miou", "accuracy", "observed_voxels", "mesh_vertices",
            "surface_rms_m")}
        synthetic[name]["objects_detected"] = st["objects"][
            "objects_detected"]
        checks[f"synthetic_{name}_equals_jax"] = all(
            synthetic[name][k] == pin[k] for k in (
                "miou", "accuracy", "observed_voxels", "mesh_vertices",
                "objects_detected"))
        checks[f"synthetic_{name}_rms_1e-5"] = abs(
            st["surface_rms_m"] - pin["surface_rms_m"]) <= 1e-5
    checks["synthetic_gt_4_of_4"] = (synthetic["gt"]["objects_detected"]
                                     == 4)

    out = {}
    with tempfile.TemporaryDirectory() as root:
        # cli/fuse with the full-width random CLIP, then the two evals
        hyp_dir, hyp_flags, out["hypersim_input"] = _hypersim_scans(root)
        t0 = time.perf_counter()
        fuse.main([os.path.join(ARCHIVES, "scannet_mini"),
                   os.path.join(root, "scannet"), "--dataset", "scannet",
                   "--device", str(dev)])
        secs["fuse_scannet_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        fuse.main([hyp_dir, os.path.join(root, "hypersim"), "--device",
                   str(dev)] + hyp_flags)
        secs["fuse_hypersim_s"] = time.perf_counter() - t0
        pred = os.path.join(root, "scannet", SCANNET_SCENE)
        _scannet_gt(os.path.join(root, "gt"),
                    os.path.join(pred, "mesh_rgb.ply"))
        t0 = time.perf_counter()
        sn = scannet.main([os.path.join(root, "scannet"),
                           os.path.join(root, "gt")], clip_engine=engine)
        hy = hypersim.main([os.path.join(root, "hypersim")],
                           clip_engine=engine)
        secs["evals_s"] = time.perf_counter() - t0
        made = [os.path.join(pred, f) for f in (
            "mesh_rgb.ply", "vertex_clip_feats.npy", "config.yml",
            "transferred.ply", "transferred_vertex_labels.npy")] + [
            os.path.join(root, "scannet", "global_cmat.npy"),
            os.path.join(root, "hypersim", HYPERSIM_SCENE,
                         "vertex_clip_feats.npy"),
            os.path.join(root, "hypersim", "hypersim_eval.json")]
        checks["files"] = all(os.path.exists(p) for p in made)
        tp, fp = np.asarray(hy["tp"]), np.asarray(hy["fp"])
        checks["stats_finite"] = bool(
            np.isfinite([sn["miou"], sn["macc_top1"], sn["macc_top5"]]).all()
            and all(np.isfinite(hy[k]).all() for k in ("tp", "fp", "fn",
                                                       "recall"))
            and np.isfinite(np.asarray(hy["precision"])[tp + fp > 0]).all()
            and hy["scenes_evaluated"] == 1)
        out["scannet"] = {k: sn[k] for k in ("miou", "macc_top1",
                                             "macc_top5")}
        out["hypersim"] = {"recall_at_0.5": hy["recall"][50],
                           "precision_at_0": hy["precision"][0]}

        # the crosscheck's small CLIP on the card and on the CPU, from one
        # converted pickle: the top-1 labels on the ground-truth vertices
        small = ClipEngine.random(SMALL_CARD_CONFIG, seed=0, device="cpu")
        sd = small.model.state_dict()
        params = convert_open_clip_state_dict(
            sd, count_layers(sd, "visual.transformer.resblocks."),
            count_layers(sd, "transformer.resblocks."))
        ckpt = os.path.join(root, "small_clip.pkl")
        with open(ckpt, "wb") as f:
            pickle.dump({"format": "sai_clip_params", "params": params,
                         "config": dataclasses.asdict(
                             infer_clip_config(params))}, f)
        merges = write_merges_gz(os.path.join(root, "merges.txt.gz"))
        top1 = {}
        with mock.patch.dict(os.environ, {"SAI_BPE_VOCAB": merges}):
            for tag, d in (("card", str(dev)), ("cpu", "cpu")):
                pred = os.path.join(root, f"small_{tag}")
                fuse.main([os.path.join(ARCHIVES, "scannet_mini"), pred,
                           "--dataset", "scannet", "--clip-checkpoint", ckpt,
                           "--device", d])
                if tag == "card":
                    gt = _scannet_gt(os.path.join(root, "small_gt"),
                                     os.path.join(pred, SCANNET_SCENE,
                                                  "mesh_rgb.ply"))
                scannet.eval_scene(
                    os.path.join(pred, SCANNET_SCENE), gt, "20",
                    ClipEngine.from_checkpoint(ckpt, device=d),
                    write_debug_meshes=False)
                top1[tag] = np.load(os.path.join(
                    pred, SCANNET_SCENE,
                    "transferred_vertex_labels.npy"))[:, 0]
        agreement = float((top1["card"] == top1["cpu"]).mean())
        checks["small_clip_top1_99.9"] = agreement >= 0.999
        out["small_clip_top1_agreement"] = agreement
        out["gt_vertices"] = int(len(top1["card"]))
    # the evals' paths run no kMaX: B1, B2 and B5 are theirs
    launches = {k: v for k, v in _kernel_counts().items()
                if k != "paint_masks"}
    checks["launches"] = all(v > 0 for v in launches.values())
    out = {"phase": "evals", "seconds": secs, "synthetic": synthetic,
           **out, "launches": launches, "checks": checks,
           "ok": all(checks.values())}
    emit(out)
    _record_launches(report, "evals", launches)
    if not out["ok"]:
        raise SystemExit(f"evals phase failed: {checks}")


CLIS_SCAN = {"num_frames": 8, "width": 1024, "height": 768}
CLIS_QUERY = "a red box"


def _capture(module, name):
    """A patch of module.name that records each of its return values."""
    seen = []
    real = getattr(module, name)

    def wrapper(*args, **kwargs):
        out = real(*args, **kwargs)
        seen.append(out)
        return out

    return mock.patch.object(module, name, wrapper), seen


def _step(name, fn, counted=True):
    """Run fn() with the kernel counts zeroed before and read after: (its
    result, the step's JSON fields: wall seconds, launches)."""
    import torch

    _zero_kernel_counts()
    t0 = time.perf_counter()
    out = fn()
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    fields = {"step": name, "seconds": time.perf_counter() - t0}
    if counted:
        fields["launches"] = _kernel_counts()
    return out, fields


def _max_diff(a, b) -> float:
    import numpy as np

    return max(float(np.abs(np.asarray(a[k]) - np.asarray(b[k])).max())
               for k in a) if a else 0.0


def phase_clis(report, dev="cuda"):
    """The offline CLIs on the card from a temporary directory, each step
    one JSON line: (a) cli.fuse, (b) cli.query on the card and on the CPU,
    (c) cli.extract_obj, (d) cli.test2d on the card and on the CPU, (e)
    cli.viz cameras (viz voxels needs matplotlib, which the card's machine
    lacks), (f) cli.doctor, (g) cli.fetch_assets --check, (h) the native
    helpers against numpy and scipy on the path phases' grids."""
    import contextlib
    import io
    import shutil
    import tempfile

    import numpy as np

    from spatially_aware_ai_tpu_torch import native
    from spatially_aware_ai_tpu_torch.cli import (
        doctor, extract_obj, fetch_assets, fuse, query, test2d, viz)
    from spatially_aware_ai_tpu_torch.meshing.extract import (
        extract_meshes_by_object)
    from spatially_aware_ai_tpu_torch.meshing.marching import marching_cubes
    from spatially_aware_ai_tpu_torch.meshing.ply import read_ply
    from spatially_aware_ai_tpu_torch.models.clip.model import (
        VIT_B_32_QUICKGELU)
    from spatially_aware_ai_tpu_torch.query import CONTROL_OBJECTS
    from spatially_aware_ai_tpu_torch.scene import objects

    if "path_tsdf" not in _KEPT or "path_kmax_class" not in _KEPT:
        raise SystemExit("clis phase: (h) needs the path and path_kmax "
                         "phases before it")
    vision = VIT_B_32_QUICKGELU.vision_layers
    text = VIT_B_32_QUICKGELU.text_layers
    checks, steps, phase_launches = {}, [], {}
    t_phase = time.perf_counter()

    def record(fields, **extra):
        fields.update(extra)
        steps.append(fields)
        emit({"phase": "clis", **fields})
        for k, v in fields.get("launches", {}).items():
            phase_launches[k] = phase_launches.get(k, 0) + v

    with tempfile.TemporaryDirectory() as root:
        scans = os.path.join(root, "scans")
        scan_dir = os.path.join(scans, "roomA")
        os.makedirs(scan_dir)
        with open(os.path.join(scan_dir, "synthetic_scene.json"), "w") as f:
            json.dump(CLIS_SCAN, f)

        # (a) the scan fused by the CLI: full-width random CLIP, 256/128
        _, fields = _step("fuse", lambda: fuse.main([
            scans, os.path.join(root, "out3d"), "--dataset", "synthetic",
            "--voxel-size", "0.02", "--clip-patch-size", "256",
            "--clip-patch-stride", "128", "--device", dev]))
        pred = os.path.join(root, "out3d", "roomA")
        verts, faces, colors = read_ply(os.path.join(pred, "mesh_rgb.ply"))
        n_feats = len(np.load(os.path.join(pred, "vertex_clip_feats.npy")))
        la = fields["launches"]
        checks["fuse"] = (len(faces) > 0 and n_feats == len(verts)
                          and la["feature_splat"] >= 1
                          and la["ln_mlp"] == la["attention"] == vision)
        record(fields, vertices=int(len(verts)), faces=int(len(faces)))

        # (b) cli.query, default targets, on the card and on the CPU
        cpu_pred = os.path.join(root, "cpu_pred")
        shutil.copytree(pred, cpu_pred)
        rel = {}
        for tag, d, device in (("card", pred, dev), ("cpu", cpu_pred,
                                                     "cpu")):
            patch, seen = _capture(query, "relevance_maps")
            with patch:
                _, fields = _step(f"query_{tag}", lambda: query.main(
                    [d, "--device", device]), counted=tag == "card")
            rel[tag] = seen[0]
            record(fields)
        encodes = len(query.DEFAULT_TARGETS) + len(CONTROL_OBJECTS)
        lb = steps[-2]["launches"]
        diffs = [_max_diff(rel["card"][i], rel["cpu"][i]) for i in (0, 1)]
        names = sorted(n for n in os.listdir(pred) if n.startswith("clip"))
        same_ply = names == sorted(n for n in os.listdir(cpu_pred)
                                   if n.startswith("clip"))
        for n in names:
            (v1, f1, _), (v2, f2, _) = (read_ply(os.path.join(d, n))
                                        for d in (pred, cpu_pred))
            same_ply = same_ply and np.array_equal(v1, v2) \
                and np.array_equal(f1, f2)
        checks["query_relevance_1e-4"] = max(diffs) <= 1e-4
        checks["query_plys"] = same_ply and len(names) == len(
            query.DEFAULT_TARGETS) + sum(
            t in CONTROL_OBJECTS for t in query.DEFAULT_TARGETS)
        checks["query_launches"] = (lb["ln_mlp"] == lb["attention"]
                                    == text * encodes)
        emit({"phase": "clis", "step": "query_compare",
              "max_abs_diff_softmax": diffs[0],
              "max_abs_diff_surgery": diffs[1], "files": len(names),
              "text_encodes": encodes,
              "expected_launches_each": text * encodes})

        # (c) cli.extract_obj: one PLY per object, as the direct split
        obj_idx = (np.arange(len(verts)) % 2).astype(np.int32) - 3
        np.save(os.path.join(pred, "vertex_obj_idx.npy"), obj_idx)
        objs_dir = os.path.join(root, "objects")
        _, fields = _step("extract_obj", lambda: extract_obj.main(
            [pred, "--out-dir", objs_dir]))
        direct = extract_meshes_by_object(verts, faces, colors[:, :3],
                                          obj_idx, [-3, -2])
        same = sorted(os.listdir(objs_dir)) == [
            "object_-2_mesh.ply", "object_-3_mesh.ply"]
        for oid in (-3, -2):
            v, f, c = read_ply(os.path.join(objs_dir,
                                            f"object_{oid}_mesh.ply"))
            dv, df, dc = direct[oid]
            same = same and np.array_equal(v, dv) and np.array_equal(f, df) \
                and np.abs(c[:, :3] - dc).max() <= 1.0 / 255 + 1e-6
        checks["extract_obj"] = same
        record(fields, objects=2)

        # (d) cli.test2d on two frames, on the card and on the CPU
        grids = {}
        for tag, device in (("card", dev), ("cpu", "cpu")):
            patch, seen = _capture(test2d, "frame_relevance")
            out_dir = os.path.join(root, f"sheets_{tag}")
            with patch:
                _, fields = _step(f"test2d_{tag}", lambda: test2d.main([
                    scan_dir, CLIS_QUERY, "--dataset", "synthetic",
                    "--patch-size", "256", "--patch-stride", "128",
                    "--max-frames", "2", "--out-dir", out_dir,
                    "--device", device]), counted=tag == "card")
            grids[tag] = seen
            record(fields, sheets=len(os.listdir(out_dir)))
        ld = steps[-2]["launches"]
        diff = max(float(np.abs(a - b).max())
                   for a, b in zip(grids["card"], grids["cpu"]))
        checks["test2d_relevance_1e-4"] = (
            len(grids["card"]) == len(grids["cpu"]) == 2 and diff <= 1e-4
            and grids["card"][0].shape == (5, 7))
        checks["test2d_sheets"] = steps[-2]["sheets"] == steps[-1][
            "sheets"] == 2
        checks["test2d_launches"] = (ld["ln_mlp"] == ld["attention"]
                                     == vision * 2 + text)
        emit({"phase": "clis", "step": "test2d_compare",
              "max_abs_diff": diff,
              "expected_launches_each": vision * 2 + text})

        # (e) cli.viz cameras
        cams = os.path.join(root, "cams.ply")
        _, fields = _step("viz_cameras", lambda: viz.main([
            "cameras", scan_dir, "--dataset", "synthetic", "--out", cams]))
        checks["viz_cameras"] = len(read_ply(cams)[0]) == \
            CLIS_SCAN["num_frames"] * 3 * 10
        record(fields)

        # (f) cli.doctor with the card probe and the kernel loads
        def run_doctor(env):
            buf = io.StringIO()
            with mock.patch.dict(os.environ, env), \
                    contextlib.redirect_stdout(buf):
                rc = doctor.main(["--json"])
            return rc, json.loads(buf.getvalue())

        assets = os.path.join(root, "assets")
        (rc, rep), fields = _step("doctor", lambda: run_doctor(
            {"SAI_ASSET_DIR": assets}))
        c = rep["checks"]
        checks["doctor"] = (
            rc == 0 and c["device"]["status"] == "ok"
            and c["device"]["capability"] == [9, 0]
            and c["toolchain"]["status"] == "ok"
            and sorted(c["toolchain"]["kernels_s"]) == sorted(
                doctor.KERNELS)
            and c["native"]["status"] == "ok")
        (rc_bad, rep_bad), _ = _step("doctor_missing_weights",
                                     lambda: run_doctor({
                                         "SAI_ASSET_DIR": assets,
                                         "SAI_CLIP_CHECKPOINT":
                                             "/nonexistent"}))
        checks["doctor_missing_weights_rc1"] = (
            rc_bad == 1 and rep_bad["checks"]["weights"]["status"] == "fail")
        record(fields, rc=rc, rc_missing_weights=rc_bad,
               checks_status={k: v["status"] for k, v in c.items()},
               device=c["device"], toolchain=c["toolchain"])

        # (g) cli.fetch_assets --check on an empty directory
        empty = os.path.join(root, "empty_assets")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc, fields = _step("fetch_assets_check", lambda: fetch_assets.main(
                ["--check", "--dest", empty]))
        lines = buf.getvalue().splitlines()
        checks["fetch_assets_check"] = rc == 0 and len(lines) == 3 and all(
            ln.startswith("[MISS]") for ln in lines)
        record(fields, rc=rc)

    # (h) the native helpers on this machine against numpy and scipy
    t0 = time.perf_counter()
    lib = native.get_lib()
    build_s = time.perf_counter() - t0
    checks["native_built"] = lib is not None
    if lib is None:
        raise SystemExit("clis phase: the native library did not build")
    vol = _KEPT["path_tsdf"]
    (nv, nf), s_native = _step("mc_native", lambda: native
                               .marching_cubes_native(vol), counted=False)
    (pv, pf), s_numpy = _step("mc_numpy", lambda: marching_cubes(vol),
                              counted=False)
    mc_diff = float(np.abs(np.sort(nv, axis=0) - np.sort(pv, axis=0)).max())
    checks["native_mc"] = (len(nv) == len(pv) and len(nf) == len(pf) > 0
                           and mc_diff <= 1e-6)
    grid = _KEPT["path_kmax_class"]
    comps, c_native = _step("cc_native", lambda: objects
                            .connected_components_3d(grid), counted=False)
    with mock.patch.object(native, "connected_components_native",
                           lambda g, null_id=133: None):
        plain, c_scipy = _step("cc_scipy", lambda: objects
                               .connected_components_3d(grid), counted=False)
    checks["native_cc"] = len(comps) == len(plain) > 0 and all(
        a[0] == b[0] and all(np.array_equal(x, y) for x, y in zip(a[1], b[1]))
        for a, b in zip(comps, plain))
    emit({"phase": "clis", "step": "native", "build_s": build_s,
          "lib": os.path.basename(native.lib_path()),
          "mc_voxels": int(vol.size), "mc_vertices": int(len(nv)),
          "mc_faces": int(len(nf)), "mc_native_s": s_native["seconds"],
          "mc_numpy_s": s_numpy["seconds"], "mc_sorted_vertex_diff": mc_diff,
          "cc_voxels": int(grid.size), "cc_components": len(comps),
          "cc_native_s": c_native["seconds"],
          "cc_scipy_s": c_scipy["seconds"]})

    launches = {k: v for k, v in phase_launches.items()
                if k != "paint_masks"}
    checks["launches"] = all(v > 0 for v in launches.values())
    checks = {k: bool(v) for k, v in checks.items()}
    out = {"phase": "clis", "seconds": time.perf_counter() - t_phase,
           "launches": launches, "checks": checks,
           "ok": all(checks.values())}
    emit(out)
    _record_launches(report, "clis", launches)
    if not out["ok"]:
        raise SystemExit(f"clis phase failed: {checks}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases",
                    default="build,kernels,crosscheck,crosscheck_kmax,"
                    "probe_tiledma,path,path_brick,path_kmax,profile,"
                    "path_kmax_bf16,insitu,"
                    "serve,live,shard,multihost,depth,convert,evals,clis")
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
    # a path's models go with its closure, so that no later phase's peak
    # memory holds them
    del profiled
    gc.collect()
    if "path_kmax_bf16" in phases:
        bf16_path = phase_path_kmax_bf16(report)
        if "profile" in phases:
            phase_profile("path_kmax_bf16", *bf16_path)
        del bf16_path
        gc.collect()
    if "insitu" in phases:
        phase_insitu(report)
    if "serve" in phases:
        phase_serve(report)
    if "live" in phases:
        phase_live(report)
    if "shard" in phases:
        phase_shard(report)
    if "multihost" in phases:
        phase_multihost()
    if "depth" in phases:
        phase_depth(report)
    if "convert" in phases:
        phase_convert(report)
    if "evals" in phases:
        phase_evals(report)
    if "clis" in phases:
        phase_clis(report)
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
