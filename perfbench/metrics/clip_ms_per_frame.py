"""CLIP's tiled encode, ms a frame: fuse_scan's `inference_s` less the
labels' device time `labels_s` (0 without labels), over the window's
scans."""


def read(ctx):
    scans = ctx.get("scans")
    if not scans:
        return None
    return 1e3 * sum(s["inference_s"] - s["labels_s"] for s in scans) / (
        len(scans) * ctx["frames"])
