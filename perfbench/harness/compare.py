"""The comparison that decides `correct`: the program's outputs of the
compared scan against the reference's, as a few numbers, each held to the
limit the cell's limits file gives it (perfbench/limits/<cell>.json).

Numbers (each 0 for identical outputs, larger when further apart):
  kmax_backbone_gap  the widest gap of kMaX's backbone features at the
               kept positions of the sampled frames, over the reference's
               largest at that level
  kmax_decoder_gap  the widest gap of its pixel decoder's outputs against
               the reference's decoder on the reference's backbone
               features, over the reference's largest at that level
  kmax_assign_gap  the share of pixel assignments of the k-means layers
               that differ from the argmax of the reference's mask logits
               worked out from the program's input query of that layer
  kmax_layer_gap  the widest gap of a k-means layer's output against the
               reference's layer on the program's inputs and assignment,
               over the reference's largest output of that layer
  kmax_logits_gap  the widest gap of the class or mask logits against the
               reference's predictor on the program's last query and
               decoder output, over the reference's largest of that kind
  paint_gap    the share of the sampled frames' pixels whose label differs
               from the reference's panoptic decision of the program's
               logits
  feat_gap     the widest gap of a finalised CLIP feature over voxels that
               both sides observed equally often, over the reference's
               largest feature
  label_gap    the share of label votes in the histograms that differ
  observed_gap the share of voxels whose observation counts differ
  tsdf_gap     the widest tsdf gap over voxels both sides observed
  mesh_gap     the share of vertices, of either mesh, that have no vertex
               of the other within 1e-3 voxel
  query_gap    the widest relevance gap over the vertices both meshes
               share whose corner voxels both sides observed equally often
  objects_gap  the share of voxels in an object that the other side puts
               elsewhere, objects matched by their largest overlap
A limits file names the numbers its cell compares; a number it does not
name is printed with the limit null and decides nothing.
"""
from __future__ import annotations

import numpy as np
import torch


def _host(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _hist(h):
    """A label histogram as int64 (the port keeps uint16 bits)."""
    if h.dtype == torch.uint16:
        h = h.view(torch.int16).to(torch.int32) & 0xFFFF
    return h.to(torch.int64)


def scan_numbers(prog: dict, ref: dict) -> dict:
    """Both sides' outputs -> {number: value}. prog / ref hold "values"
    (finalised grid), "nvox", "mesh" (verts_voxel), "relevance" and, with
    labels, "label_hist" and "objects"."""
    from scipy.spatial import cKDTree

    out = {}
    if tuple(prog["nvox"]) != tuple(ref["nvox"]):
        return {k: float("inf") for k in (
            "feat_gap", "observed_gap", "tsdf_gap", "mesh_gap", "query_gap",
            "label_gap", "objects_gap")}
    n = int(np.prod(ref["nvox"]))
    pv, rv = prog["values"], ref["values"]
    dev = rv["feat"].device
    w_p = torch.as_tensor(_host(pv["weight"])[:n], device=dev)
    w_r = rv["weight"][:n]
    tw_p = torch.as_tensor(_host(pv["tsdf_weight"])[:n], device=dev)
    tw_r = rv["tsdf_weight"][:n]
    both = (w_p > 0) & (w_p == w_r)
    out["observed_gap"] = float(((w_p != w_r) | (tw_p != tw_r)).float()
                                .mean())
    f_r = rv["feat"][:n]
    scale = float(f_r[both].abs().max()) if bool(both.any()) else 1.0
    gap = 0.0
    for lo in range(0, n, 1 << 18):
        sl = slice(lo, min(n, lo + (1 << 18)))
        f_p = pv["feat"][sl].to(dev, torch.float32)
        d = (f_p - f_r[sl]).abs().amax(dim=1)
        d = torch.where(both[sl], d, torch.zeros_like(d))
        gap = max(gap, float(d.max()))
    out["feat_gap"] = gap / max(scale, 1e-30)
    tb = (tw_p > 0) & (tw_r > 0)
    t_p = torch.as_tensor(_host(pv["tsdf"])[:n], device=dev)
    out["tsdf_gap"] = float((t_p - rv["tsdf"][:n]).abs()[tb].max()) \
        if bool(tb.any()) else 0.0

    vp = np.asarray(prog["mesh"]["verts_voxel"], np.float64)
    vr = np.asarray(ref["mesh"]["verts_voxel"], np.float64)
    if len(vp) == 0 or len(vr) == 0:
        out["mesh_gap"] = 1.0
        out["query_gap"] = float("inf")
    else:
        d_pr, i_pr = cKDTree(vr).query(vp)
        d_rp, _ = cKDTree(vp).query(vr)
        out["mesh_gap"] = max(float((d_pr > 1e-3).mean()),
                              float((d_rp > 1e-3).mean()))
        # vertices whose eight corner voxels both sides observed equally
        # often (a voxel observed once more or less moves its vertices'
        # features by a whole frame's; observed_gap counts those voxels)
        corner = np.floor(vp).astype(np.int64)
        same = (w_p == w_r).cpu().numpy().reshape(ref["nvox"])
        ok = np.ones(len(vp), bool)
        for d in np.ndindex(2, 2, 2):
            c = np.minimum(corner + np.asarray(d),
                           np.asarray(ref["nvox"]) - 1)
            ok &= same[c[:, 0], c[:, 1], c[:, 2]]
        match = (d_pr <= 1e-3) & ok
        rel_p = np.asarray(prog["relevance"], np.float64)[match]
        rel_r = np.asarray(ref["relevance"], np.float64)[i_pr[match]]
        out["query_gap"] = float(np.abs(rel_p - rel_r).max()) \
            if match.any() else float("inf")

    if ref.get("label_hist") is not None:
        h_r = _hist(ref["label_hist"][:n])
        moved = 0
        for lo in range(0, n, 1 << 18):
            sl = slice(lo, min(n, lo + (1 << 18)))
            h_p = _hist(prog["label_hist"][sl].to(dev))
            moved += int((h_p - h_r[sl]).abs().sum())
        out["label_gap"] = moved / max(2 * int(h_r.sum()), 1)
        out["objects_gap"] = _partition_gap(
            np.asarray(prog["objects"]["voxel_obj"]).reshape(-1),
            np.asarray(ref["objects"]["voxel_obj"]).reshape(-1))
    return out


def _partition_gap(a, b) -> float:
    """The share of voxels in an object on either side (index != -1) that
    the other side does not put in the object matched to theirs, each
    object matched to the one it overlaps most. Object indices count in
    discovery order, so one component more or less renumbers the rest:
    the match makes the number count only the voxels that moved."""
    inside = (a != -1) | (b != -1)
    if not inside.any():
        return 0.0
    pairs = np.stack([a[inside], b[inside]], 1)
    uniq, counts = np.unique(pairs, axis=0, return_counts=True)
    agree = 0
    for side in (0, 1):
        best = {}
        for (x, y), c in zip(uniq.tolist(), counts.tolist()):
            key = (x, y)[side]
            if key != -1 and c > best.get(key, 0):
                best[key] = c
        agree = min(agree, sum(best.values())) if side else sum(
            best.values())
    return 1.0 - agree / int(inside.sum())


class KmaxGaps:
    """kMaX's numbers, accumulated a frame at a time: for each stage and
    key (a level, a layer, a kind of logits) the widest gap and the
    reference's widest value; the assignments and labels that differ."""

    def __init__(self):
        self.gap, self.scale = {}, {}
        self.moved = self.assigned = 0
        self.flipped = self.painted = 0

    def add(self, stage, key, prog, ref):
        prog, ref = prog.float(), ref.float()
        k = (stage, key)
        self.gap[k] = max(self.gap.get(k, 0.0),
                          float((prog - ref).abs().max()))
        self.scale[k] = max(self.scale.get(k, 0.0), float(ref.abs().max()))

    def assign(self, prog, ref):
        self.moved += int((prog.long() != ref.long()).sum())
        self.assigned += prog.numel()

    def paint(self, prog, ref):
        self.flipped += int((prog.long() != ref.long()).sum())
        self.painted += prog.numel()

    def _widest(self, stage):
        return max(self.gap[k] / max(self.scale[k], 1e-30)
                   for k in self.gap if k[0] == stage)

    def numbers(self) -> dict:
        return {"kmax_backbone_gap": self._widest("backbone"),
                "kmax_decoder_gap": self._widest("decoder"),
                "kmax_assign_gap": self.moved / max(self.assigned, 1),
                "kmax_layer_gap": self._widest("layer"),
                "kmax_logits_gap": self._widest("logits"),
                "paint_gap": self.flipped / max(self.painted, 1)}


def judge(numbers: dict, limits: dict) -> dict:
    """{name: {"value", "limit", "passes"}}; a number without a limit
    passes and is printed beside a null limit."""
    checks = {}
    for name, value in numbers.items():
        limit = limits.get(name)
        ok = True if limit is None else bool(value <= limit)
        checks[name] = {"value": value, "limit": limit, "passes": ok}
    for name in limits:
        if name not in numbers:
            checks[name] = {"value": None, "limit": limits[name],
                            "passes": False}
    return checks
