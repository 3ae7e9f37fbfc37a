"""Kernel B2's share of its roofline over the traced scan, in %: the sum
of every call's bound (metrics/roofline.py) over the sum of the device
time of the kernels launched inside the benchmark's range around each
fused_ln_mlp call."""
from perfbench.metrics import roofline


def read(ctx):
    t = ctx.get("trace")
    calls = ctx.get("b2_calls")
    if not t or not calls:
        return None
    device_s = t["range_device_s"].get("perfbench.b2", 0.0)
    if device_s <= 0:
        return None
    return 100.0 * sum(roofline.b2_bound_s(c) for c in calls) / device_s
