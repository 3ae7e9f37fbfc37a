#!/usr/bin/env python3
"""Fresh-process probe of the CPU drift of the port's ConvNeXt block
(ROADMAP C9).

    python3 tools/c9_erf_probe.py [--runs 400] [--threads 2] [--workers 6]

Each run is a new Python process that sets torch's thread count, then runs
the block's ops once, in the block's order, on a D=64 block of random
weights (seeded by the run): the depthwise conv (`conv2d_nhwc`), the
LayerNorm, fc1, then torch.erf of fc1's output over sqrt 2 (the op an exact
gelu written out by hand calls there), the gelu through the port's
`activation`, fc2 with the layer scale. Each op's f32 output is held
against float64 computed from its f32 input, so a drift names its op and
its rows. Prints one JSON line per drifting run and a summary line: runs,
drifting runs, and per op the runs where it drifted (> 1e-5 against
float64).
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def child(seed: int, threads: int) -> dict:
    import numpy as np
    import torch
    from scipy.special import erf

    torch.set_num_threads(threads)
    sys.path.insert(0, ROOT)
    from spatially_aware_ai_tpu_torch.models.kmax import convnext as TC
    from spatially_aware_ai_tpu_torch.models.ln_mlp import activation

    rng = np.random.default_rng(seed)
    D, B, H, W = 64, 2, 9, 11

    def n(*shape, scale=1.0, loc=0.0):
        return (loc + scale * rng.normal(size=shape)).astype(np.float32)

    x = n(B, H, W, D)
    kern, cb = n(7, 7, 1, D, scale=1 / 7), n(D, scale=0.1)
    ls, lb = n(D, scale=0.1, loc=1.0), n(D, scale=0.1)
    w1, b1 = n(D, 4 * D, scale=1 / 8), n(4 * D, scale=0.1)
    w2, b2, gamma = n(4 * D, D, scale=1 / 16), n(D, scale=0.1), n(D)
    conv = torch.nn.Conv2d(D, D, 7, padding=3, groups=D)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(kern.transpose(3, 2, 0, 1).copy()))
        conv.bias.copy_(torch.from_numpy(cb))
        h = TC.conv2d_nhwc(torch.from_numpy(x), conv).reshape(-1, D)
        mu = h.mean(dim=-1, keepdim=True)
        var = (h - mu).square().mean(dim=-1, keepdim=True)
        ln = (h - mu) * torch.rsqrt(var + 1e-6) * torch.from_numpy(ls) \
            + torch.from_numpy(lb)
        h1 = ln @ torch.from_numpy(w1) + torch.from_numpy(b1)
        e = torch.erf(h1 * 0.7071067811865476)
        g = activation(h1, "gelu")
        out = (g @ torch.from_numpy(w2) + torch.from_numpy(b2)) \
            * torch.from_numpy(gamma)
    f64 = np.float64
    xp = np.pad(x.astype(f64), ((0, 0), (3, 3), (3, 3), (0, 0)))
    conv64 = (sum(xp[:, dy:dy + H, dx:dx + W] * kern[dy, dx, 0].astype(f64)
                  for dy in range(7) for dx in range(7)) + cb).reshape(-1, D)
    hn = h.numpy().astype(f64)
    m64 = hn.mean(-1, keepdims=True)
    v64 = ((hn - m64) ** 2).mean(-1, keepdims=True)
    h1n = h1.numpy().astype(f64)
    refs = {
        "conv": (h, conv64),
        "layernorm": (ln, (hn - m64) / np.sqrt(v64 + 1e-6) * ls + lb),
        "fc1": (h1, ln.numpy().astype(f64) @ w1.astype(f64) + b1),
        "erf": (e, erf(h1n / np.sqrt(2.0))),
        "gelu": (g, 0.5 * h1n * (1 + erf(h1n / np.sqrt(2.0)))),
        "fc2": (out, (g.numpy().astype(f64) @ w2.astype(f64) + b2) * gamma),
    }
    res = {"seed": seed}
    for name, (got, want) in refs.items():
        err = np.abs(got.numpy().astype(f64) - want).max(axis=1)
        rows = np.flatnonzero(err > 1e-5)
        res[name] = {"max": float(err.max()), "rows": len(rows),
                     "first_row": int(rows[0]) if len(rows) else None,
                     "last_row": int(rows[-1]) if len(rows) else None}
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=400)
    ap.add_argument("--threads", type=int, default=2)
    ap.add_argument("--workers", type=int, default=6)
    ap.add_argument("--child", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child is not None:
        print(json.dumps(child(args.child, args.threads)))
        return 0

    def run(seed):
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", str(seed),
             "--threads", str(args.threads)],
            capture_output=True, text=True, check=True).stdout
        return json.loads(out.strip().splitlines()[-1])

    ops = ("conv", "layernorm", "fc1", "erf", "gelu", "fc2")
    drifting = 0
    by_op = dict.fromkeys(ops, 0)
    with concurrent.futures.ThreadPoolExecutor(args.workers) as pool:
        for res in pool.map(run, range(args.runs)):
            bad = [op for op in ops if res[op]["rows"]]
            if bad:
                drifting += 1
                for op in bad:
                    by_op[op] += 1
                print(json.dumps(res), flush=True)
    print(json.dumps({"runs": args.runs, "threads": args.threads,
                      "drifting_runs": drifting,
                      "runs_by_op": by_op}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
