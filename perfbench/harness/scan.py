"""The "scan" runner: closed-loop scans to queryable, one at a time.

Set-up: the port's models from the seed, the room rendered on the device,
and one warm-up scan of `warmup_frames` frames spread over the loop (so
that its bounds, and with them its grid, are the whole room's) through
every stage: fuse_scan, extract_mesh, flood_fill_3d (with labels) and a
query.

Window: scans back to back, each fuse_scan + extract_mesh + flood_fill_3d
(with labels) + the first run_query of the traffic's prompts, each stage
ended by a synchronisation. It runs from the first scan's start to the
end of the last scan that started before `seconds`; scan_to_query_s is its
length over the number of scans.

Correctness: the last scan's outputs (with --trace 1, the traced scan's)
against the reference, after the program's state is freed. With labels,
every scan keeps what kMaX produced on the timed path: the labels of every
frame (uint8 on the device) and, for `compared_kmax_frames` frames (one a
chunk, the slot moving from chunk to chunk), each stage's output: the
backbone's features at `compared_backbone_rows` positions a level, the
pixel decoder's outputs, each k-means layer's input query, assignment and
output, and the logits. The reference checks kMaX a stage at a time on
those frames, each stage from the program's own state, and works the
scene out again from the program's labels (harness/compare.py,
reference/scan.py).
"""
from __future__ import annotations

import collections
import functools
import gc
import os
import random
import sys
import time

import numpy as np
import torch

from ..reference import scan as ref_scan
from ..scenes.room import RoomScan
from . import compare, models
from . import trace as tracing


class _Subset:
    """Frames `idx` of a scan, in the same loader form."""

    def __init__(self, scan, idx):
        self.scan, self.idx = scan, np.asarray(idx)
        self.imwidth, self.imheight = scan.imwidth, scan.imheight
        self.native_depth_scale = scan.native_depth_scale

    def __len__(self):
        return len(self.idx)

    def stacked_u8(self, indices=None, native_depth=False):
        sel = self.idx if indices is None else self.idx[list(indices)]
        return self.scan.stacked_u8(sel, native_depth=native_depth)

    def bounds_samples(self, uv_size: int = 7):
        d, uu, vv, pose, K = self.scan.bounds_samples(uv_size)
        return d[self.idx], uu, vv, pose[self.idx], K[self.idx]


class _B2Spans:
    """A benchmark range around every call of the port's fused LayerNorm
    -> MLP (kernel B2), recording each call's shape (M, D, H), element
    size and whether x is the residual. Installed on the modules that call
    it, for the traced scan only."""

    def __init__(self):
        self.calls = []
        self._saved = []

    def __enter__(self):
        from spatially_aware_ai_tpu_torch.models.clip import model as cm
        from spatially_aware_ai_tpu_torch.models.kmax import convnext as cn

        for mod in (cm, cn):
            fn = mod.fused_ln_mlp
            self._saved.append((mod, fn))
            mod.fused_ln_mlp = self._wrap(fn)
        return self

    def _wrap(self, fn):
        def wrapped(x, residual, ln_scale, ln_bias, w1, b1, w2, b2,
                    gamma=None, **kw):
            self.calls.append({"M": x.shape[0], "D": x.shape[1],
                               "H": w1.shape[1],
                               "esize": x.element_size(),
                               "dtype": str(x.dtype).split(".")[-1],
                               "same_residual":
                               x.data_ptr() == residual.data_ptr(),
                               "gamma": gamma is not None})
            with tracing.span("b2"):
                return fn(x, residual, ln_scale, ln_bias, w1, b1, w2, b2,
                          gamma, **kw)
        return wrapped

    def __exit__(self, *exc):
        for mod, fn in self._saved:
            mod.fused_ln_mlp = fn


def kmax_sample(seed: int, frames: int, chunk: int, count: int):
    """`count` frames whose kMaX outputs are compared: one in each of
    `count` chunks spread over the scan, at a slot of the chunk that moves
    by one from chunk to chunk from a start drawn from the seed, so that
    the sample meets every chunk and every slot of a chunk once there are
    that many."""
    chunks = -(-frames // chunk)
    picked = sorted({int(c) for c in np.linspace(0, chunks - 1, count)
                     .round()})
    start = random.Random(int(seed)).randrange(chunk)
    out = [c * chunk + (start + k) % chunk for k, c in enumerate(picked)]
    return [f for f in out if f < frames]


class KmaxCapture:
    """What a kMaX model produces for the frames in `sample`, a stage at a
    time, by hooks on its modules (the port's and the reference's have the
    same layout): the backbone's features at `rows` positions of each
    level drawn from the seed, the pixel decoder's outputs, each k-means
    layer's input query, its pixel assignment (the argmax of its mask
    logits, which the layer reads only through it) and its output, and the
    class and mask logits. Frames are counted in the order the model sees
    them: the backbone takes a chunk at a time, the head a frame at a
    time."""

    def __init__(self, model, sample, rows: int, seed: int):
        self.model, self.sample = model, set(sample)
        self.rows, self.seed = int(rows), int(seed)
        self.kept, self.row_index = {}, {}
        self.count = collections.Counter()
        head = model.sem_seg_head
        layers = head.transformer_decoder._kmax_transformer_layers
        self.hooks = [
            model.backbone.register_forward_hook(self._backbone),
            head.pixel_decoder.register_forward_hook(self._decoder)]
        self.hooks += [layer.register_forward_hook(
            functools.partial(self._layer, i))
            for i, layer in enumerate(layers)]
        self.n_layers = len(layers)
        run_head = model._head

        def logits(feats):
            out = run_head(feats)
            f = self._next("head")
            if f in self.sample:
                self._frame(f).update(cls=out[0][0].clone(),
                                      masks=out[1][0].clone())
            return out

        model._head = logits

    def _next(self, kind, n=1):
        f = self.count[kind]
        self.count[kind] += n
        return f

    def _frame(self, f):
        return self.kept.setdefault(f, {"q_in": [None] * self.n_layers,
                                        "assign": [None] * self.n_layers,
                                        "q_out": [None] * self.n_layers})

    def positions(self, level, n, device):
        """The rows of a level's [h * w, C] features that are kept."""
        if level not in self.row_index:
            gen = torch.Generator().manual_seed(
                (self.seed * 7919 + len(self.row_index)) % (2 ** 63))
            self.row_index[level] = torch.randperm(n, generator=gen)[
                :self.rows].to(device)
        return self.row_index[level]

    def _backbone(self, module, inputs, feats):
        n = next(iter(feats.values())).shape[0]
        base = self._next("backbone", n)
        for j in range(n):
            if base + j in self.sample:
                kept = {}
                for k, v in feats.items():
                    flat = v[j].reshape(-1, v.shape[-1])
                    kept[k] = flat[self.positions(k, flat.shape[0],
                                                  flat.device)].clone()
                self._frame(base + j)["backbone"] = kept

    def _decoder(self, module, inputs, dec):
        f = self._next("decoder")
        if f in self.sample:
            self._frame(f)["dec"] = {k: v.clone() for k, v in dec.items()}

    def _layer(self, i, module, inputs, out):
        f = self._next(f"layer{i}")
        if f in self.sample:
            query, _, mlog = inputs
            kept = self._frame(f)
            kept["q_in"][i] = query.clone()
            kept["assign"][i] = mlog.reshape(-1, mlog.shape[-1]).argmax(
                dim=-1).to(torch.int32)
            kept["q_out"][i] = out.clone()

    def close(self):
        del self.model._head
        for h in self.hooks:
            h.remove()
        return {"frames": self.kept, "rows": self.row_index}


class LabelCapture:
    """Each chunk's fused labels that the port's segmenter hands fuse_scan,
    cast to uint8 on the device."""

    def __init__(self, seg):
        self.seg, self.labels = seg, []
        fn = seg.run_on_batch_fused_labels

        def fused_labels(rgbs, dilate=2, as_numpy=True):
            out = fn(rgbs, dilate=dilate, as_numpy=as_numpy)
            self.labels.append(torch.as_tensor(out).to(torch.uint8))
            return out

        seg.run_on_batch_fused_labels = fused_labels

    def close(self, n):
        del self.seg.run_on_batch_fused_labels
        if not self.labels:  # the scan failed before its first chunk
            return None
        return torch.cat(self.labels)[:n]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def one_scan(dataset, engine, seg, fusion, prompts, device, sample=(),
             keep=False, rows=0, seed=0):
    """One scan to queryable through the port; returns the stage times
    and, with keep, the outputs the comparison reads (kMaX's stages for
    the frames in `sample`, `rows` backbone positions a level)."""
    from spatially_aware_ai_tpu_torch.pipeline import fuse_scan
    from spatially_aware_ai_tpu_torch.scene import flood_fill_3d

    labels = kept = None
    if seg is not None:
        label_capture = LabelCapture(seg)
        capture = KmaxCapture(seg.model, sample, rows, seed)
    t0 = time.perf_counter()
    try:
        with tracing.span("fuse_scan"):
            res = fuse_scan(dataset, engine, fusion,
                            segmenter=None if seg is None
                            else seg.run_on_image, device=device)
    finally:
        if seg is not None:
            labels = label_capture.close(len(dataset))
            kept = capture.close()
    t1 = time.perf_counter()
    with tracing.span("extract_mesh"):
        mesh = res.extract_mesh(feats_on_device=True)
        _sync(device)
    t2 = time.perf_counter()
    objects = None
    if seg is not None:
        with tracing.span("flood_fill"):
            nvox = res.nvox
            sk, obj = flood_fill_3d(res.values["class_id"].reshape(nvox),
                                    None, res.feat_grid,
                                    res.values["rgb"].reshape(*nvox, 3))
            objects = {"count": len(sk["unique_objects"]), "voxel_obj": obj}
    t3 = time.perf_counter()
    with tracing.span("run_query"):
        feats = mesh["clip_feats"]
        feats = feats / feats.norm(dim=-1, keepdim=True).clamp_min(1e-8)
        rel = engine.run_query(feats, list(prompts))
    t4 = time.perf_counter()
    times = dict(res.timings, extract_mesh_s=t2 - t1, flood_fill_s=t3 - t2,
                 query_s=t4 - t3, wall_s=t4 - t0)
    if not keep:
        return times, None
    out = {"values": res.values, "nvox": res.nvox, "relevance": rel,
           "mesh": {"verts_voxel": mesh["verts_voxel"]},
           "label_hist": res.grid.label_hist, "objects": objects,
           "labels": labels, "kmax": kept}
    return times, out


class Precision:
    """TF32 on or off for the block (the reference runs with it off, its
    control with it on); the caller's flags come back after."""

    def __init__(self, tf32: bool):
        self.tf32 = tf32

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        torch.backends.cudnn.allow_tf32 = self.tf32

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved


def control_outputs(config, traffic, seed, scan, sample, device):
    """The control in the program's place: the reference computed with
    TF32, what its kMaX produced kept as the program's is."""
    with Precision(tf32=True):
        clip, seg = models.reference_models(config, seed, device)
        labels = kept = None
        if seg is not None:
            capture = KmaxCapture(seg.model, sample,
                                  traffic["compared_backbone_rows"], seed)
            try:
                labels = ref_scan.segment(seg, scan, device)
            finally:
                kept = capture.close()
        out = ref_scan.run_scan(scan, clip, labels,
                                prompts=traffic["prompts"], device=device,
                                **models.fusion_params(config))
    out["labels"], out["kmax"] = labels, kept
    out["mesh"] = {"verts_voxel": out["mesh"]["verts_voxel"]}
    return out


def kmax_check(seg, scan, kept, labels, device, block: int = 4):
    """The reference kMaX `seg` against what the program's kMaX produced on
    the sampled frames, a stage at a time (compare.KmaxGaps): the backbone
    from the frames; the pixel decoder on the reference's backbone
    features; each k-means layer's assignment from its input query and its
    output from its inputs, the logits from the last layer's output, and
    the labels from the logits, each from the program's own state."""
    frames = sorted(kept["frames"])
    gaps = compare.KmaxGaps()
    with torch.inference_mode():
        for lo in range(0, len(frames), block):
            part = frames[lo:lo + block]
            host = scan.stacked_u8(part, native_depth=True)
            rgb = torch.from_numpy(host["rgb"]).to(device).float() / 255
            H, W = rgb.shape[1:3]
            r_feats = ref_scan.backbone(seg, rgb)
            for j, f in enumerate(part):
                k = kept["frames"][f]
                for lv, v in r_feats.items():
                    rows = kept["rows"][lv].to(device)
                    gaps.add("backbone", lv, k["backbone"][lv].to(device),
                             v[j].reshape(-1, v.shape[-1])[rows])
                dec = seg.model.sem_seg_head.pixel_decoder(
                    {lv: v[j:j + 1] for lv, v in r_feats.items()})
                for lv, v in dec.items():
                    gaps.add("decoder", lv, k["dec"][lv].to(device), v)
                p_dec = {lv: v.to(device) for lv, v in k["dec"].items()}
                mine, outs, (cls, masks) = ref_scan.head_from_state(
                    seg, p_dec, [q.to(device) for q in k["q_in"]],
                    [a.to(device) for a in k["assign"]],
                    k["q_out"][-1].to(device))
                for i, (a, o) in enumerate(zip(mine, outs)):
                    gaps.assign(k["assign"][i].to(device), a)
                    gaps.add("layer", i, k["q_out"][i].to(device), o)
                p_cls = k["cls"].to(device)[None]
                p_masks = k["masks"].to(device)[None]
                gaps.add("logits", "class", p_cls, cls)
                gaps.add("logits", "mask", p_masks, masks)
                gaps.paint(labels[f:f + 1].to(device),
                           ref_scan.paint(seg, p_cls, p_masks, H, W))
            del r_feats
    return gaps.numbers()


def check(prog, config, traffic, seed, scan, device):
    """The reference, TF32 off, against the program's outputs: kMaX stage
    by stage on the sampled frames, then the scene worked out from the
    program's labels. Returns the compared numbers."""
    with Precision(tf32=False):
        clip, seg = models.reference_models(config, seed, device)
        numbers = {}
        if seg is not None:
            numbers.update(kmax_check(seg, scan, prog["kmax"],
                                      prog["labels"], device))
            del seg
        ref = ref_scan.run_scan(scan, clip, prog["labels"],
                                prompts=traffic["prompts"], device=device,
                                **models.fusion_params(config))
        numbers.update(compare.scan_numbers(prog, ref))
    return numbers


def say(msg):
    print(f"perfbench: {msg}", file=sys.stderr, flush=True)


def run(*, cell, config, traffic, limits, metrics, seed, seconds, trace,
        device, root, setup_clock, side="program"):
    """One run of a scan cell. side="control" puts the reference in TF32
    in the program's place (no window; the control's readings)."""
    from . import readers

    if device.type == "cuda":
        torch.cuda.init()
        torch.empty(1, device=device)
    say(f"device ready at {setup_clock():.2f} s")
    scan = RoomScan(seed, traffic["scene"], device=device)
    say(f"scan rendered at {setup_clock():.2f} s")
    chunk = int(config["fusion"]["frame_chunk"])
    sample = kmax_sample(seed, len(scan), chunk,
                         int(traffic["compared_kmax_frames"]))
    rows = int(traffic.get("compared_backbone_rows", 0))
    ctx = None
    if side == "control":
        prog = control_outputs(config, traffic, seed, scan, sample, device)
        attempted = 1
    else:
        import spatially_aware_ai_tpu_torch.pipeline  # noqa: F401

        say(f"port imported at {setup_clock():.2f} s")
        engine, seg, fusion = models.port_models(
            config, seed, device,
            say=lambda m: say(f"{m} at {setup_clock():.2f} s"))
        _sync(device)
        say(f"models built at {setup_clock():.2f} s")
        n = len(scan)
        warm = _Subset(scan, np.linspace(0, n - 1, int(
            traffic["warmup_frames"])).round().astype(int))
        one_scan(warm, engine, seg, fusion, traffic["prompts"], device)
        _sync(device)
        setup_peak = (torch.cuda.max_memory_allocated(device)
                      if device.type == "cuda" else 0)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        setup_s = setup_clock()
        say(f"warmed up at {setup_s:.2f} s")

        times = []
        t_start = time.perf_counter()
        while True:
            t, prog = one_scan(scan, engine, seg, fusion, traffic["prompts"],
                               device, sample, keep=not trace, rows=rows,
                               seed=seed)
            times.append(t)
            if time.perf_counter() - t_start >= seconds:
                break
            del prog
        window_s = time.perf_counter() - t_start
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
        summary, b2_calls = None, []
        if trace:
            # one scan after the window, profiled with the host's
            # operations: B2's ranges, the device's busy time, the top
            # device operations and the names of the idle gaps
            tr = tracing.Traced(os.path.join(root, "build", "perfbench",
                                             "trace.json"))
            with _B2Spans() as spans, tr.run():
                _, prog = one_scan(scan, engine, seg, fusion,
                                   traffic["prompts"], device, sample,
                                   keep=True, rows=rows, seed=seed)
            summary = tr.summary
            b2_calls = spans.calls
        # the program's state goes before the reference runs
        del engine, seg, fusion
        gc.collect()
        attempted = len(times)
        ctx = {"scans": times, "frames": n, "config": config,
               "traffic": traffic, "window_s": window_s, "setup_s": setup_s,
               "peak_bytes": peak, "device_peak": max(peak, setup_peak),
               "trace": summary, "b2_calls": b2_calls,
               "scan_to_query_s": window_s / len(times)}
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    numbers = check(prog, config, traffic, seed, scan, device)
    reference_s = time.perf_counter() - t0
    del prog
    checks = compare.judge(numbers, limits.get("checks", {}))
    result = {"correct": all(c["passes"] for c in checks.values()),
              "attempted": attempted, "failed": 0, "checks": checks,
              "reference_s": reference_s}
    say(f"reference and comparison took {reference_s:.2f} s")
    if side == "control":
        result["metrics"] = {}
        return result
    result["metrics"] = readers.read_all(root, metrics, ctx, trace)
    result["device"] = {"memory_peak_bytes": int(ctx["device_peak"])}
    if trace and ctx["trace"] is not None:
        s = ctx["trace"]
        result["device"].update(busy_s=s["busy_s"], window_s=s["window_s"])
        result["breakdown"] = {"device_ops": s["device_ops"],
                               "idle_gaps": s["idle_gaps"]}
    return result
