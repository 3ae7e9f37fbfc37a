#!/usr/bin/env python3
"""The ConvNeXt stem and downsampling convolutions in bf16, batched against
one frame at a time (`convnext._dense_conv`), on the card, in one process.

    python3 tools/kmax_dense_conv_ab.py [--frames 8] [--iters 10]

Two backbones with random weights (seed 0): ConvNeXt-L at path_kmax's
operating point (a chunk of `--frames` frames padded to 992x1312) and the
small one of chip_smoke's crosscheck_kmax (widths 64-256, 4 frames padded
to 128x160). For each of the four convolutions (stem 4x4 / 4, then 2x2 / 2
three times) on bf16 channels-last inputs of its shape: the milliseconds
of the whole batch through one `conv2d_nhwc` and of one call a frame
(median CUDA-event time of `--iters` calls, in turns batched, per-frame,
per-frame, batched, twice), and whether the batched output is the same
bits as the per-frame one, under cuDNN's default flags and with its
deterministic flag on and its benchmark flag off. Prints one JSON line per
backbone, then one with the card's name and power limit and the sums.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ms(fn, iters):
    import torch

    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(iters):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def _convs(dims, frames, hw, gen):
    """(name, Conv2d on the card, bf16 input [frames, h, w, cin]) of the
    stem and the three downsampling convolutions."""
    import torch

    out, (h, w), cin = [], hw, 3
    for stage, cout in enumerate(dims):
        k = 4 if stage == 0 else 2
        conv = torch.nn.Conv2d(cin, cout, k, stride=k).cuda()
        with torch.no_grad():
            conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen)
                              / (cin * k * k) ** 0.5)
            conv.bias.zero_()
        x = torch.randn((frames, h, w, cin), generator=gen).to(
            "cuda", torch.bfloat16)
        out.append((f"{'stem' if stage == 0 else f'down{stage}'}", conv, x))
        h, w, cin = h // k, w // k, cout
    return out


def measure(dims, frames, hw, iters):
    import torch

    from spatially_aware_ai_tpu_torch.models.kmax.convnext import conv2d_nhwc

    gen = torch.Generator().manual_seed(0)
    res = {"dims": list(dims), "frames": frames, "hw": list(hw), "convs": {}}
    for name, conv, x in _convs(dims, frames, hw, gen):
        def batched():
            return conv2d_nhwc(x, conv)

        def per_frame():
            return torch.cat([conv2d_nhwc(x[i:i + 1], conv)
                              for i in range(x.shape[0])])

        with torch.inference_mode():
            times = {"batched": [], "per_frame": []}
            for _ in range(2):
                for which in ("batched", "per_frame", "per_frame",
                              "batched"):
                    fn = batched if which == "batched" else per_frame
                    times[which].append(_ms(fn, iters))
            same = {"default": bool(torch.equal(batched(), per_frame()))}
            flags = (torch.backends.cudnn.deterministic,
                     torch.backends.cudnn.benchmark)
            torch.backends.cudnn.deterministic = True
            torch.backends.cudnn.benchmark = False
            try:
                same["cudnn_pinned"] = bool(torch.equal(batched(),
                                                        per_frame()))
            finally:
                (torch.backends.cudnn.deterministic,
                 torch.backends.cudnn.benchmark) = flags
        res["convs"][name] = {
            "in": list(x.shape), "out_channels": conv.out_channels,
            "batched_ms": times["batched"],
            "per_frame_ms": times["per_frame"],
            "batched_ms_median": statistics.median(times["batched"]),
            "per_frame_ms_median": statistics.median(times["per_frame"]),
            "batch_invariant": same}
    res["batched_ms_sum"] = sum(c["batched_ms_median"]
                                for c in res["convs"].values())
    res["per_frame_ms_sum"] = sum(c["per_frame_ms_median"]
                                  for c in res["convs"].values())
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kmax_dense_conv_ab: no CUDA card")
    full = measure((192, 384, 768, 1536), args.frames, (992, 1312),
                   args.iters)
    print(json.dumps({"backbone": "convnext_large", **full}), flush=True)
    small = measure((64, 128, 192, 256), 4, (128, 160), args.iters)
    print(json.dumps({"backbone": "crosscheck_small", **small}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"card": smi, "torch": torch.__version__,
                      "full_batched_ms": full["batched_ms_sum"],
                      "full_per_frame_ms": full["per_frame_ms_sum"],
                      "full_per_frame_cost_ms": full["per_frame_ms_sum"]
                      - full["batched_ms_sum"]}))


if __name__ == "__main__":
    main()
