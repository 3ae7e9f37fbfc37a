"""After the last chunk: fuse_scan's `finalize_s` plus the benchmark's
synchronised times of extract_mesh, flood_fill_3d (with labels) and the
first run_query, ms a scan, over the window's scans."""


def read(ctx):
    scans = ctx.get("scans")
    if not scans:
        return None
    return 1e3 * sum(s["finalize_s"] + s["extract_mesh_s"]
                     + s["flood_fill_s"] + s["query_s"]
                     for s in scans) / len(scans)
