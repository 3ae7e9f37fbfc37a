"""Seconds from a scan's first frame to its first answered query: the
window's wall time over the number of whole scans in it."""


def read(ctx):
    return ctx.get("scan_to_query_s")
