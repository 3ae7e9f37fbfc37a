"""Argument handling, the checks every run makes, and the result line."""
from __future__ import annotations

import argparse
import json
import os
import sys

# the JAX stack and the JAX package, by whole top-level module name (the
# port's own name begins with the JAX package's)
BANNED_TOP_LEVEL = ("jax", "jaxlib", "flax", "spatially_aware_ai_tpu")


def process_age_s() -> float:
    """Seconds since this process started (Linux /proc; the interpreter's
    start-up counts as set-up too)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def banned_modules(modules=None):
    """Top-level names in sys.modules that belong to JAX or the JAX
    package."""
    names = {m.split(".", 1)[0] for m in (modules or sys.modules)}
    return sorted(names & set(BANNED_TOP_LEVEL))


def load_json(root: str, *parts) -> dict:
    with open(os.path.join(root, *parts)) as f:
        return json.load(f)


def cell_inputs(root: str, workload: str):
    """(cell, configuration, traffic, limits, metrics) of a workload,
    found by the names in BENCHMARK.json."""
    bench = load_json(root, "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json "
                         f"has {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root, configs[cell["config"]]["file"])
    traffic = load_json(root, "perfbench", "traffic",
                        f"{cell['traffic']}.json")
    limits = load_json(root, "perfbench", "limits", f"{workload}.json")
    metrics = {"end_to_end": [m for m in bench["end_to_end"]
                              if workload in m.get("workloads", [workload])],
               "per_layer": [m for m in bench["per_layer"]
                             if workload in m.get("workloads", [workload])]}
    return cell, config, traffic, limits, metrics


def runner(traffic: dict):
    """The run function of the traffic's runner: the module
    perfbench/harness/<runner>.py, found by name."""
    import importlib

    return importlib.import_module(
        f"perfbench.harness.{traffic['runner']}").run


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def device_info(chips: int) -> dict:
    """The device block; the runner adds memory_peak_bytes, read before
    its reference ran, and with a trace busy_s and window_s."""
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips}


def print_result(result: dict):
    """The compared numbers, each beside its limit, as the last lines on
    standard error; the result as the last line on standard output."""
    for name, entry in result["checks"].items():
        print(f"check {name}: {entry['value']!r} limit {entry['limit']!r}"
              f" ({entry['passes']})", file=sys.stderr)
    line = {k: result[k] for k in ("correct", "attempted", "failed",
                                   "metrics", "device")}
    if "breakdown" in result:
        line["breakdown"] = result["breakdown"]
    line["checks"] = {k: [v["value"], v["limit"]]
                      for k, v in result["checks"].items()}
    sys.stderr.flush()
    print(json.dumps(line), flush=True)


def main(argv, root: str) -> int:
    args = parse(argv)
    cell, config, traffic, limits, metrics = cell_inputs(root,
                                                         args.workload)
    import torch

    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell needs {chips} CUDA device(s); this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = runner(traffic)(
        cell=cell, config=config, traffic=traffic, limits=limits,
        metrics=metrics, seed=args.seed, seconds=args.seconds,
        trace=bool(args.trace), device=torch.device("cuda"), root=root,
        setup_clock=process_age_s)
    found = banned_modules()
    if found:
        print(f"perfbench: the run loaded {found}", file=sys.stderr)
        return 3
    result["device"] = dict(device_info(chips), **result["device"])
    print_result(result)
    return 0
