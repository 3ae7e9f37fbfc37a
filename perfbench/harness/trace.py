"""The traced part of a run: torch.profiler over a short steady window,
read back from its Chrome trace.

What is read: every device activity (kernels, copies, fills) for the busy
time and the top operations; the gaps between them, named by what the
host's main thread was doing; and the device time of the kernels launched
inside each benchmark range (`record_function` names starting with
"perfbench."), matched to their launches by the profiler's correlation
ids, whatever the kernels are called.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import json
import os
import time

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


@contextlib.contextmanager
def span(name: str):
    """A benchmark range around a call into a layer."""
    with torch.profiler.record_function(f"perfbench.{name}"):
        yield


class Traced:
    """Profile a block; afterwards `summary` holds what the metrics read.
    The profiler slows a host-bound block (it records every host operation
    and launch), so its wall time is no denominator for an idle share; its
    device times are the device's own."""

    def __init__(self, path: str):
        self.path = path
        self.summary = None

    @contextlib.contextmanager
    def run(self):
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            yield
            torch.cuda.synchronize()
            window = time.perf_counter() - t0
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        prof.export_chrome_trace(self.path)
        try:
            with open(self.path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(self.path)
        self.summary = summarise(events, window)


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarise(events, window_s: float) -> dict:
    """busy_s, window_s, device time per benchmark range name, the top
    device operations and the longest idle gaps."""
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in DEVICE_CATS]
    busy = _union([(e["ts"], e["ts"] + e["dur"]) for e in dev])
    busy_s = sum(e - s for s, e in busy) / 1e6

    by_name = collections.Counter()
    for e in dev:
        by_name[e["name"]] += e["dur"] / 1e6
    device_ops = [[n, s] for n, s in by_name.most_common(10)]

    ranges = [e for e in events if e.get("ph") == "X"
              and e.get("cat") in ("user_annotation", "cpu_op")
              and str(e.get("name", "")).startswith("perfbench.")]
    launches = [e for e in events if e.get("ph") == "X"
                and e.get("cat") in LAUNCH_CATS]
    kernels_by_corr = collections.defaultdict(list)
    for e in dev:
        corr = e.get("args", {}).get("correlation")
        if corr is not None:
            kernels_by_corr[corr].append(e["dur"] / 1e6)
    by_tid = collections.defaultdict(list)
    for ln in launches:
        by_tid[ln.get("tid")].append((ln["ts"],
                                      ln.get("args", {}).get("correlation")))
    for v in by_tid.values():
        v.sort(key=lambda x: x[0])
    starts = {t: [x[0] for x in v] for t, v in by_tid.items()}
    range_device_s = collections.defaultdict(float)
    range_calls = collections.Counter()
    for r in ranges:
        lo, hi, tid = r["ts"], r["ts"] + r["dur"], r.get("tid")
        range_calls[r["name"]] += 1
        seq = by_tid.get(tid, [])
        i = bisect.bisect_left(starts.get(tid, []), lo)
        while i < len(seq) and seq[i][0] <= hi:
            range_device_s[r["name"]] += sum(kernels_by_corr.get(seq[i][1],
                                                                 ()))
            i += 1

    # the longest idle gaps inside the traced window, named by the range
    # and the innermost host operation of the main thread (the thread of
    # the longest range) at the gap's middle
    gaps = sorted(((s1 - e0, e0, s1) for (_, e0), (s1, _) in
                   zip(busy, busy[1:])), reverse=True)[:10]
    named = []
    if gaps and ranges:
        main_tid = max(ranges, key=lambda r: r["dur"]).get("tid")
        host = [e for e in events if e.get("ph") == "X"
                and e.get("tid") == main_tid
                and e.get("cat") in ("cpu_op", "user_annotation")]
        for length, e0, s1 in gaps:
            mid = (e0 + s1) / 2
            over = [h for h in host if h["ts"] <= mid <= h["ts"] + h["dur"]]
            top = [h for h in over if h["name"].startswith("perfbench.")]
            name = (max(top, key=lambda h: h["dur"])["name"][10:]
                    if top else "host")
            rest = [h for h in over if not h["name"].startswith("perfbench.")]
            if rest:
                name += ":" + min(rest, key=lambda h: h["dur"])["name"]
            named.append([name, length / 1e6])
    return {"busy_s": busy_s, "window_s": window_s,
            "range_device_s": dict(range_device_s),
            "range_calls": dict(range_calls),
            "device_ops": device_ops, "idle_gaps": named}
