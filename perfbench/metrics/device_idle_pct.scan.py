"""The share of a scan's wall time in which no operation ran on the
device, in %: 1 - the traced scan's device busy time (the union of its
device activity) / the mean wall time of the window's scans. The traced
scan's own wall time is not the denominator: the profiler, recording
every host operation, slows this host-bound scan by a sixth to a half."""


def read(ctx):
    t = ctx.get("trace")
    if not t or not ctx.get("scans"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / ctx["scan_to_query_s"])
