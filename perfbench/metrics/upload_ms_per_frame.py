"""Host chunk preparation and upload (fuse_scan's `upload_s`: the wait for
the prefetched chunk and its copies to the device), ms a frame, over the
window's scans."""


def read(ctx):
    scans = ctx.get("scans")
    if not scans:
        return None
    return 1e3 * sum(s["upload_s"] for s in scans) / (len(scans)
                                                      * ctx["frames"])
