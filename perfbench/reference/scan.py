"""The benchmark's plain reference of scan to queryable: the same frames
and weights in, the scene worked out again with plain PyTorch and numpy.

    frames -> bounds -> per frame: CLIP tiles, labels, integration of
    every voxel (the scan oracle's arithmetic) -> finalised grid -> marching
    cubes -> objects by flood fill -> a text query's relevance

kMaX is checked apart, a stage at a time, on frames drawn from the seed:
its backbone against the reference's from the frames (`kmax_frames`), its
pixel decoder against the reference's on the reference's backbone
features, then each k-means layer, the predictor and the paint from the
program's own state (`head_from_state`, `paint`): the reference takes the
program's decoder outputs, each layer's input query and pixel assignment,
and the last layer's output. The scene is then worked out from the labels
that the program's kMaX gave the frames. kMaX's hard k-means argmax turns
float32 rounding anywhere before it into other cluster assignments, and
the paint's thresholds turn those into other labels on whole segments, so
a reference that ran kMaX end to end, or its head from the backbone on,
would disagree with any sound program, and with any sound reordering of
the head's arithmetic (PERF.md, PR 17).

It imports nothing of the port. Where the port's semantics are a contract
(the iPhone depth enlarge, the bounds from a 7x7 depth subsample, the
sum-form TSDF with its validity masks, the patch-feature splat, the label
vote, the instance seams), this file states them once more in plain code.
The projection and sampling helpers are copies of the port's plain ones.
"""
from __future__ import annotations

import numpy as np
import torch

from .colors import NUM_CLASSES_WITH_SPARE
from .marching import marching_cubes
from .objects import flood_fill_3d
from .tokenizer import ClipTokenizer

# ---------------------------------------------------------------------------
# depth enlarge and bounds
# ---------------------------------------------------------------------------


def cubic_weights(t, a: float = -0.75):
    """OpenCV's 4-tap cubic convolution weights at offsets (-1, 0, 1, 2)."""
    t = np.asarray(t, np.float64)
    w0 = ((a * (t + 1) - 5 * a) * (t + 1) + 8 * a) * (t + 1) - 4 * a
    w1 = ((a + 2) * t - (a + 3)) * t * t + 1
    tt = 1.0 - t
    w2 = ((a + 2) * tt - (a + 3)) * tt * tt + 1
    return np.stack([w0, w1, w2, 1.0 - w0 - w1 - w2], axis=-1)


def cubic_matrix(n_src: int, scale: int) -> np.ndarray:
    """[n_src * scale, n_src] matrix of cv2.resize(INTER_CUBIC)'s integer
    enlarge along one axis (edge taps folded onto the edge sample)."""
    n_dst = n_src * scale
    M = np.zeros((n_dst, n_src), np.float64)
    dst = np.arange(n_dst)
    src = (dst + 0.5) / scale - 0.5
    base = np.floor(src).astype(np.int64)
    w = cubic_weights(src - base)
    for tap in range(4):
        np.add.at(M, (dst, np.clip(base - 1 + tap, 0, n_src - 1)),
                  w[:, tap])
    return M.astype(np.float32)


def enlarge_depth(depth_u16, scale: int):
    """[F, h, w] uint16 millimetres (a tensor) -> [F, h*s, w*s] metres."""
    d = depth_u16.to(torch.float32)
    a_h = torch.from_numpy(cubic_matrix(d.shape[1], scale)).to(d.device)
    a_w = torch.from_numpy(cubic_matrix(d.shape[2], scale)).to(d.device)
    return (a_h @ d @ a_w.T).clamp(0.0, 65535.0) / 1000.0


def subsample_grid(width: int, height: int, uv_size: int = 7):
    u = np.round(np.linspace(0, width - 1, uv_size)).astype(np.int32)
    v = np.round(np.linspace(0, height - 1, uv_size)).astype(np.int32)
    uu, vv = np.meshgrid(u, v, indexing="xy")
    return uu.reshape(-1), vv.reshape(-1)


def bounds_samples(depth_u16, scale: int, width: int, height: int):
    """Depth in metres of the enlarged frames at the 7x7 subsample, worked
    out from the native frames (host numpy): (depth [F, P], uu, vv)."""
    uu, vv = subsample_grid(width, height)
    h, w = depth_u16.shape[1:]
    Mh = cubic_matrix(h, scale)[vv]
    Mw = cubic_matrix(w, scale)[uu]
    s = np.einsum("ph,fhw,pw->fp", Mh, depth_u16.astype(np.float32), Mw,
                  optimize=True)
    return np.clip(s, 0.0, 65535.0).astype(np.float32) / 1000.0, uu, vv


def scene_bounds(depth, uu, vv, poses, Ks, voxel_size, trunc_m, max_depth):
    """(origin [3], nvox [3]): percentiles 1 / 99 of the back-projected
    samples within max_depth, widened by the truncation."""
    uv1 = np.stack([uu, vv, np.ones_like(uu)], -1).astype(np.float32)
    rays = np.einsum("fij,pj->fpi", np.linalg.inv(Ks.astype(np.float32)),
                     uv1)
    cam = rays * depth[..., None]
    xyz = (np.einsum("fij,fpj->fpi", poses[:, :3, :3].astype(np.float32),
                     cam) + poses[:, None, :3, 3])
    keep = ~np.isnan(depth) & (depth > 0) & (depth < max_depth)
    xyz = xyz[keep].astype(np.float32)
    lo = np.percentile(xyz, 1.0, axis=0).astype(np.float32) - trunc_m
    hi = np.percentile(xyz, 99.0, axis=0).astype(np.float32) + trunc_m
    nvox = np.round((hi - lo) / voxel_size).astype(np.int32)
    return lo, nvox


# ---------------------------------------------------------------------------
# sampling (copies of the port's plain helpers)
# ---------------------------------------------------------------------------


def _index(v):
    return v.clamp(-2.0 ** 30, 2.0 ** 30).to(torch.int64)


def _gather_2d(img, yi, xi):
    H, W = img.shape[0], img.shape[1]
    inb = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
    vals = img[yi.clamp(0, H - 1), xi.clamp(0, W - 1)]
    return torch.where(inb[..., None], vals, torch.zeros((), dtype=img.dtype,
                                                          device=img.device))


def sample_image(img, uv, mode: str):
    """[H, W, C] at pixel uv [..., 2]; out of bounds reads 0."""
    x, y = uv[..., 0], uv[..., 1]
    if mode == "nearest":
        return _gather_2d(img, _index(torch.round(y)), _index(torch.round(x)))
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0)[..., None], (y - y0)[..., None]
    xi, yi = _index(x0), _index(y0)
    return (_gather_2d(img, yi, xi) * (1 - fx) * (1 - fy)
            + _gather_2d(img, yi, xi + 1) * fx * (1 - fy)
            + _gather_2d(img, yi + 1, xi) * (1 - fx) * fy
            + _gather_2d(img, yi + 1, xi + 1) * fx * fy)


def sample_volume(flat, nvox, coords, mode: str):
    """Row-major [d0*d1*d2, C] volume at voxel coordinates coords [V, 3];
    out-of-bounds corners read 0."""
    d0, d1, d2 = (int(v) for v in nvox)

    def gather(i0, i1, i2):
        inb = ((i0 >= 0) & (i0 < d0) & (i1 >= 0) & (i1 < d1)
               & (i2 >= 0) & (i2 < d2))
        idx = ((i0.clamp(0, d0 - 1) * d1 + i1.clamp(0, d1 - 1)) * d2
               + i2.clamp(0, d2 - 1))
        return torch.where(inb[..., None], flat[idx],
                           torch.zeros((), dtype=flat.dtype,
                                       device=flat.device))

    c0, c1, c2 = coords[..., 0], coords[..., 1], coords[..., 2]
    if mode == "nearest":
        return gather(_index(torch.round(c0)), _index(torch.round(c1)),
                      _index(torch.round(c2)))
    f0, f1, f2 = torch.floor(c0), torch.floor(c1), torch.floor(c2)
    t = [(c0 - f0)[..., None], (c1 - f1)[..., None], (c2 - f2)[..., None]]
    i = [_index(f0), _index(f1), _index(f2)]
    out = 0.0
    for a in (0, 1):
        for b in (0, 1):
            for c in (0, 1):
                w = ((t[0] if a else 1 - t[0]) * (t[1] if b else 1 - t[1])
                     * (t[2] if c else 1 - t[2]))
                out = out + w * gather(i[0] + a, i[1] + b, i[2] + c)
    return out


# ---------------------------------------------------------------------------
# integration
# ---------------------------------------------------------------------------


class Grid:
    """Sum-form accumulators over every voxel of the bounds."""

    def __init__(self, origin, nvox, voxel_size, trunc_m, feature_dim,
                 with_labels, device):
        self.origin = torch.as_tensor(origin, device=device)
        self.nvox = tuple(int(v) for v in nvox)
        self.voxel_size = float(voxel_size)
        self.trunc = float(trunc_m)
        n = int(np.prod(self.nvox))

        def z(*shape, dt=torch.float32):
            return torch.zeros(shape, dtype=dt, device=device)

        self.tsdf_sum, self.tsdf_w = z(n), z(n, dt=torch.int32)
        self.rgb_sum, self.feat_sum = z(n, 3), z(n, feature_dim)
        self.w = z(n, dt=torch.int32)
        self.label_hist = (z(n, NUM_CLASSES_WITH_SPARE, dt=torch.int32)
                           if with_labels else None)
        flat = torch.arange(n, device=device)
        i0, rem = flat // (self.nvox[1] * self.nvox[2]), flat % (
            self.nvox[1] * self.nvox[2])
        idx = torch.stack([i0, rem // self.nvox[2], rem % self.nvox[2]], -1)
        self.xyz = idx.to(torch.float32) * self.voxel_size + self.origin

    def integrate(self, depth, rgb, pose, K, feat_img, labels=None):
        """One frame: depth [H, W] m, rgb [H, W, 3], pose / K, feat_img
        [Py, Px, C], labels [H, W] int or None."""
        H, W = depth.shape
        R, d = pose[:3, :3], self.xyz - pose[:3, 3]
        cam = d[:, 0:1] * R[0] + d[:, 1:2] * R[1] + d[:, 2:3] * R[2]
        uvz = (cam[:, 0:1] * K[:, 0] + cam[:, 1:2] * K[:, 1]
               + cam[:, 2:3] * K[:, 2])
        z = uvz[:, 2]
        uv = uvz[:, :2] / z[:, None]
        u, v = uv[:, 0], uv[:, 1]
        frustum = ((u >= -0.5) & (u <= W - 0.5) & (v >= -0.5)
                   & (v <= H - 0.5) & (z > 0))
        uv = torch.where(torch.isfinite(uv), uv, torch.zeros_like(uv))
        d = sample_image(depth[..., None], uv, "nearest")[:, 0]
        sdf = (d - z) / self.trunc
        tsdf_ok = frustum & (sdf > -1.0)
        self.tsdf_sum += sdf.clamp(-1.0, 1.0) * tsdf_ok
        self.tsdf_w += tsdf_ok.to(torch.int32)
        rows = torch.nonzero(frustum & (sdf.abs() <= 1.0))[:, 0]
        uvr = uv[rows]
        self.rgb_sum[rows] += sample_image(rgb, uvr, "bilinear")
        py, px = feat_img.shape[:2]
        scale = torch.tensor([px / W, py / H], device=uv.device)
        self.feat_sum[rows] += sample_image(feat_img, (uvr + 0.5) * scale
                                            - 0.5, "bilinear")
        self.w[rows] += 1
        if self.label_hist is not None:
            lab = sample_image(labels.to(torch.float32)[..., None], uvr,
                               "nearest")[:, 0].to(torch.int64)
            ok = (lab >= 0) & (lab < self.label_hist.shape[1])
            self.label_hist.view(-1).index_add_(
                0, rows[ok] * self.label_hist.shape[1] + lab[ok],
                torch.ones_like(lab[ok], dtype=torch.int32))

    def finalize(self):
        """tsdf, rgb, feat, weight, tsdf_weight and, with labels, class_id
        (argmax of the histogram, -1 where it is empty)."""
        w = self.w.clamp_min(1).to(torch.float32)
        out = {"tsdf": self.tsdf_sum / self.tsdf_w.clamp_min(1),
               "rgb": self.rgb_sum / w[:, None],
               "feat": self.feat_sum / w[:, None],
               "weight": self.w, "tsdf_weight": self.tsdf_w}
        if self.label_hist is not None:
            cid = self.label_hist.argmax(dim=1).to(torch.int32)
            out["class_id"] = torch.where(
                (self.label_hist != 0).any(dim=1), cid,
                torch.full_like(cid, -1))
        return out


# ---------------------------------------------------------------------------
# the whole scan
# ---------------------------------------------------------------------------


def segment(kmax, scan, device, chunk: int = 8):
    """kMaX over every frame of `scan`, as the fused-label path runs it:
    labels [F, H, W] uint8 with same-class instance seams nulled."""
    host = scan.stacked_u8(range(len(scan)), native_depth=True)
    labels = []
    with torch.inference_mode():
        for s in range(0, len(scan), chunk):
            rgb = torch.from_numpy(host["rgb"][s:s + chunk]).to(device)
            _, _, _, lab = kmax_frames(kmax, rgb.float() / 255)
            labels.append(lab.to(torch.uint8))
    return torch.cat(labels)


def kmax_frames(kmax, rgb):
    """rgb [F, H, W, 3] in [0, 1] -> (backbone features {level: [F, h, w,
    C]}, class logits [F, N, C + 1], mask logits [F, h, w, N] before the
    crop, labels [F, H, W])."""
    feats = backbone(kmax, rgb)
    cls, masks = head(kmax, feats)
    H, W = rgb.shape[1:3]
    return feats, cls, masks, paint(kmax, cls, masks, H, W)


def backbone(kmax, rgb):
    """rgb [F, H, W, 3] in [0, 1] -> backbone features {level: [F, h, w,
    C]} at the test shape."""
    from .kmax import prep_batch

    H, W = rgb.shape[1:3]
    new_h, new_w, pad_h, pad_w = kmax._test_shape(H, W)
    return kmax.model.backbone(prep_batch(rgb, new_h, new_w, pad_h, pad_w))


def head(kmax, feats):
    """The pixel decoder, the k-means decoder and the predictor, a frame at
    a time: backbone features {level: [F, h, w, C]} -> (class logits,
    mask logits)."""
    n = next(iter(feats.values())).shape[0]
    outs = [kmax.model._head({k: v[i:i + 1] for k, v in feats.items()})
            for i in range(n)]
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


def head_from_state(kmax, dec, q_ins, assigns, q_last):
    """kMaX's head of one frame a stage at a time, each stage from another
    run's state: its pixel decoder's outputs `dec` {level: [1, h, w, C]},
    each k-means layer's input query q_ins[i] [1, N, D] and pixel
    assignment assigns[i] [h * w], and its last layer's output q_last.
    Returns (each layer's assignment worked out from its input query, each
    layer's output from its inputs and the given assignment, (class
    logits, mask logits) from q_last)."""
    from .kmax import _LEVELS

    m = kmax.model
    td = m.sem_seg_head.transformer_decoder
    pred = m.sem_seg_head.predictor
    n_q = kmax.cfg.num_queries
    mine, outs = [], []
    i = 0
    for li, n_blocks in enumerate(kmax.cfg.dec_blocks):
        pixel_space = td._pixel_space_projections[li](dec[_LEVELS[li]])
        pixel_norm = pred.pixel_features(pixel_space)
        for _ in range(n_blocks):
            q = q_ins[i]
            mlog = pred.mask_logits(td._mask_embedding_projection(q),
                                    pixel_norm)
            mine.append(mlog.reshape(-1, n_q).argmax(dim=-1))
            # the layer reads its logits only through their argmax
            given = torch.nn.functional.one_hot(
                assigns[i].long(), n_q).to(mlog.dtype).reshape(mlog.shape)
            outs.append(td._kmax_transformer_layers[i](q, pixel_space,
                                                       given))
            i += 1
    panoptic = td._panoptic_feature_projection(dec["os4"])
    cls = pred.class_logits(td._class_embedding_projection(q_last))
    masks = pred.mask_logits(td._mask_embedding_projection(q_last),
                             pred.pixel_features(panoptic))
    return mine, outs, (cls, masks)


def paint(kmax, cls, masks, H, W):
    """The panoptic decision of logits: the paint, the nearest resize to
    the frame and the nulled instance seams -> labels [F, H, W]."""
    from .kmax import (null_same_class_instance_seams,
                       panoptic_inference_batch, resize_nearest_int2)

    new_h, new_w, _, _ = kmax._test_shape(H, W)
    masks = masks[:, :-(-new_h // 4), :-(-new_w // 4)].float()
    cat, seg = panoptic_inference_batch(cls.float(), masks, kmax.cfg)
    cat, seg = resize_nearest_int2(cat, seg, (H, W))
    return null_same_class_instance_seams(cat, seg)


def run_scan(scan, clip, labels, *, voxel_size, trunc_vox, max_depth,
             patch_size, patch_stride, prompts, device, chunk: int = 8):
    """The reference scene of `scan` (a perfbench.scenes dataset). clip is
    a reference CLIP; labels [F, H, W] (a device tensor of class ids) are
    the frames' labels to integrate, or None for a scan without labels.
    Returns grid values and histogram, the mesh, the objects and the
    query's relevance (when `prompts` are given)."""
    n = len(scan)
    host = scan.stacked_u8(range(n), native_depth=True)
    scale = int(host["depth_upsample"])
    H, W = host["rgb"].shape[1:3]
    trunc_m = trunc_vox * voxel_size
    samples, uu, vv = bounds_samples(host["depth"], scale, W, H)
    origin, nvox = scene_bounds(samples, uu, vv, host["pose"], host["K"],
                                voxel_size, trunc_m, max_depth)
    grid = Grid(origin, nvox, voxel_size, trunc_m, clip.shape.embed_dim,
                labels is not None, device)
    with torch.inference_mode():
        for s in range(0, n, chunk):
            sl = slice(s, min(n, s + chunk))
            rgb = torch.from_numpy(host["rgb"][sl]).to(device).float() / 255
            depth = enlarge_depth(
                torch.from_numpy(host["depth"][sl].astype(np.int32))
                .to(device), scale)
            pose = torch.from_numpy(host["pose"][sl]).to(device)
            K = torch.from_numpy(host["K"][sl]).to(device)
            feats = clip.tiled_features(rgb, patch_size, patch_stride)
            for f in range(rgb.shape[0]):
                grid.integrate(depth[f], rgb[f], pose[f], K[f], feats[f],
                               None if labels is None
                               else labels[s + f].to(torch.int64))
        values = grid.finalize()
        label_hist = grid.label_hist
        del grid
        mesh = extract_mesh(values, nvox, origin, voxel_size, device)
        objects = None
        if labels is not None:
            objects = object_summary(values, nvox)
        feats = mesh["clip_feats"]
        feats = feats / feats.norm(dim=-1, keepdim=True).clamp_min(1e-8)
        relevance = query(clip, feats, prompts) if prompts else None
    return {"values": values, "nvox": tuple(int(v) for v in nvox),
            "origin": origin, "mesh": mesh, "objects": objects,
            "relevance": relevance, "label_hist": label_hist}


def extract_mesh(values, nvox, origin, voxel_size, device):
    """Marching cubes at 0 of the tsdf (NaN where no feature weight), rgb
    and CLIP features sampled trilinearly at the vertices."""
    n = int(np.prod(nvox))
    tsdf = values["tsdf"][:n].cpu().numpy().reshape(nvox)
    weight = values["weight"][:n].cpu().numpy().reshape(nvox)
    tsdf = np.where(weight == 0, np.float32(np.nan), tsdf)
    verts, faces = marching_cubes(tsdf, 0.0)
    coords = torch.as_tensor(verts, device=device)
    feat = values["feat"]
    return {"verts_voxel": verts, "faces": faces,
            "verts_world": verts * voxel_size + origin,
            "colors": sample_volume(values["rgb"], nvox, coords,
                                    "bilinear").clamp(0, 1).cpu().numpy(),
            "clip_feats": sample_volume(feat, nvox, coords, "bilinear")}


def object_summary(values, nvox):
    """flood_fill_3d over the class grid: the number of objects, the object
    index of every voxel and the objects' class labels."""
    n = int(np.prod(nvox))
    sk, obj = flood_fill_3d(values["class_id"][:n].cpu().numpy()
                            .reshape(nvox), None, None, None)
    return {"count": len(sk["unique_objects"]), "voxel_obj": obj,
            "labels": sorted({o["class_label"]
                              for o in sk["unique_objects"].values()})}


def query(clip, feats, prompts):
    """softmax(100 * feats @ text^T) over the prompts, each encoded with
    the byte-level tokenizer and L2-normalised."""
    tok = torch.as_tensor(np.asarray(ClipTokenizer(None)(list(prompts))),
                          dtype=torch.int64, device=feats.device)
    text = clip.encode_text(tok)
    text = text / text.norm(dim=-1, keepdim=True)
    return torch.softmax(100.0 * feats @ text.T, dim=-1).cpu().numpy()
