"""Grid integration (fuse_scan's `integrate_s`, synchronised), ms a frame,
over the window's scans."""


def read(ctx):
    scans = ctx.get("scans")
    if not scans:
        return None
    return 1e3 * sum(s["integrate_s"] for s in scans) / (len(scans)
                                                         * ctx["frames"])
