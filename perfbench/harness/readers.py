"""Find and call the reader of each metric: perfbench/metrics/<name>.py,
whose `read(ctx)` returns the value, or None where the run has nothing to
read, and then the metric is left out of the line."""
from __future__ import annotations

import importlib.util
import os


def load(root: str, name: str):
    path = os.path.join(root, "perfbench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def read_all(root: str, metrics: dict, ctx: dict, traced: bool) -> dict:
    """{name: {"value", "unit"}} of the cell's end-to-end metrics, or of
    its per-layer metrics in a traced run."""
    out = {}
    for m in metrics["per_layer" if traced else "end_to_end"]:
        value = load(root, m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
