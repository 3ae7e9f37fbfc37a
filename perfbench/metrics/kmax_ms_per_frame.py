"""kMaX's fused labels, ms a frame: fuse_scan's `labels_s` (device time
between CUDA events around the segmenter's calls), over the window's
scans. Nothing to read in a scan without labels."""


def read(ctx):
    scans = ctx.get("scans")
    if not scans or not ctx["config"]["fusion"].get("with_labels"):
        return None
    return 1e3 * sum(s["labels_s"] for s in scans) / (len(scans)
                                                      * ctx["frames"])
