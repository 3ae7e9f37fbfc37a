"""The readings a cell's limits are set from, several seeds in one
process (the kernels are built once):

    python3 perfbench/readings.py --workload scan.kmax_f32 \
        --seeds 11,12,13 --side program
    python3 perfbench/readings.py --workload scan.kmax_f32 \
        --seeds 11,12,13 --side control

--side program runs the cell's runner for one pass per seed (a window of
0 seconds: one scan) and prints every compared number; --side control puts the reference computed with
TF32 in the program's place. One JSON line per seed. Not run by the
benchmark's own runs.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    from perfbench.run import _environment

    _environment()
    import torch

    from perfbench.harness import cli

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--side", choices=("program", "control"),
                    default="program")
    ap.add_argument("--seconds", type=float, default=0.0)
    args = ap.parse_args()
    cell, config, traffic, limits, metrics = cli.cell_inputs(ROOT,
                                                             args.workload)
    if not torch.cuda.is_available():
        sys.exit("readings are taken on the card")
    run = cli.runner(traffic)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        r = run(cell=cell, config=config, traffic=traffic, limits=limits,
                metrics=metrics, seed=seed, seconds=args.seconds,
                trace=False, device=torch.device("cuda"), root=ROOT,
                setup_clock=lambda: time.perf_counter() - t0,
                side=args.side)
        print(json.dumps({
            "workload": args.workload, "side": args.side, "seed": seed,
            "correct": r["correct"], "attempted": r["attempted"],
            "numbers": {k: v["value"] for k, v in r["checks"].items()},
            "metrics": r.get("metrics"), "reference_s": r.get("reference_s"),
            "seconds": time.perf_counter() - t0,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}),
            flush=True)
