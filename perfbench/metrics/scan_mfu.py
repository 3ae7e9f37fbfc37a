"""The whole scan's share of the card's peak, in %: the model operations
of one scan (metrics/flops.py) over scan_to_query_s times the peak of the
configuration's dtype (metrics/roofline.py). It stays a share of the whole
step when a later change takes a kernel off the path."""
from perfbench.metrics import flops, roofline


def read(ctx):
    if not ctx.get("scans"):
        return None
    scene = ctx["traffic"]["scene"]
    ops = flops.per_scan(ctx["config"], ctx["frames"], scene["height"],
                         scene["width"])
    return 100.0 * ops / (ctx["scan_to_query_s"]
                          * roofline.PEAK_FLOPS[ctx["config"]["dtype"]])
