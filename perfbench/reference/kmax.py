"""kMaX-DeepLab, the benchmark's plain reference: a frozen copy of the
port's plain path (its model, ConvNeXt backbone and panoptic decision),
with the hand-written kernels replaced by the plain PyTorch ops of
`ops.py`. Parameter names are detectron2's, so one state dict loads into
this model and into the port's `KmaxSegmenter`.

`full_f32` is a no-op here: the caller sets the TF32 flags, off for the
reference and on for its control (perfbench/harness/compare.py).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .ops import full_f32
from .convnext import (CONVNEXT_LARGE, CONVNEXT_TINY_TEST, ConvNeXt,
                       ConvNeXtConfig, conv2d_nhwc, layer_norm)
from .ops import paint_masks


@dataclasses.dataclass(frozen=True)
class KMaxConfig:
    backbone: ConvNeXtConfig = CONVNEXT_LARGE
    num_queries: int = 128
    num_classes: int = 133   # COCO panoptic; void is index 133
    num_things: int = 80     # contiguous ids [0, 80) are "thing" classes
    dec_dim: int = 256
    num_heads: int = 8
    dec_blocks: Tuple[int, ...] = (2, 2, 2)     # kMaX layers at os32/16/8
    mask_dim: int = 128
    pd_dims: Tuple[int, ...] = (512, 256, 128, 64)  # decoder os32/16/8/4
    pd_blocks: Tuple[int, ...] = (1, 1, 1, 1)
    aspp_rates: Tuple[int, ...] = (6, 12, 18)
    axial_span: int = 128    # a 1281 long edge pads to 1312: 82 at os16
    test_long_edge: int = 1281
    class_threshold_thing: float = 0.7
    class_threshold_stuff: float = 0.5
    pixel_confidence_threshold: float = 0.4
    overlap_threshold: float = 0.8
    reorder_class_weight: float = 1.0
    reorder_mask_weight: float = 1.0


KMAX_CONVNEXT_LARGE = KMaxConfig()
KMAX_TINY_TEST = KMaxConfig(
    backbone=CONVNEXT_TINY_TEST, num_queries=16, dec_dim=32, num_heads=4,
    dec_blocks=(1, 1, 1), mask_dim=32, pd_dims=(32, 24, 16, 16),
    pd_blocks=(1, 1, 1, 1), aspp_rates=(1, 2, 3), axial_span=16,
    test_long_edge=129,
)

NULL_ID = 133


def _gelu(x):
    return F.gelu(x)  # exact erf, as flax nn.gelu(approximate=False)


class FrozenBatchNorm(nn.Module):
    """Inference BatchNorm over the last axis, with BatchNorm's state-dict
    names (weight, bias, running_mean, running_var, num_batches_tracked).
    The statistics and affine are rounded to `dtype` (default x.dtype) and
    each op runs in torch's promotion of x and that dtype, as the JAX
    package's FrozenBatchNorm(dtype=...)."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))
        self.register_buffer("num_batches_tracked",
                             torch.tensor(0, dtype=torch.long))

    def forward(self, x, dtype=None):
        dt = dtype or x.dtype
        inv = torch.rsqrt(self.running_var.to(dt) + self.eps)
        return ((x - self.running_mean.to(dt)) * (self.weight.to(dt) * inv)
                + self.bias.to(dt))


class ConvBN(nn.Module):
    """conv (no bias) -> frozen BN -> optional gelu. dims=2 for NHWC maps
    (kernel k x k, SAME padding, dilation, groups), dims=1 for [B, N, C]
    query features (kernel 1, i.e. a matmul). Runs in x.dtype."""

    def __init__(self, cin: int, cout: int, k: int = 1, groups: int = 1,
                 dilation: int = 1, act: Optional[str] = None, dims: int = 2):
        super().__init__()
        if dims == 2:
            self.conv = nn.Conv2d(cin, cout, k, padding=dilation * (k - 1) // 2,
                                  dilation=dilation, groups=groups, bias=False)
        else:
            self.conv = nn.Conv1d(cin, cout, 1, bias=False)
        self.norm = FrozenBatchNorm(cout)
        self.act = act
        self.pointwise = k == 1 and groups == 1  # a matmul over channels

    def forward(self, x):
        if self.pointwise:
            w = self.conv.weight
            x = F.linear(x, w.reshape(w.shape[0], -1).to(x.dtype))
        else:
            x = conv2d_nhwc(x, self.conv)
        x = self.norm(x)
        return _gelu(x) if self.act == "gelu" else x


def _resize_bilinear_nhwc(x, size):
    """[B, h, w, C] -> [B, *size, C]: bilinear, half-pixel centers, no
    antialias (jax.image.resize(bilinear) when upsampling)."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(size),
                      mode="bilinear", align_corners=False, antialias=False)
    return y.permute(0, 2, 3, 1).contiguous()


class ASPP(nn.Module):
    def __init__(self, cin: int, dim: int, rates):
        super().__init__()
        self._conv0 = ConvBN(cin, dim, 1, act="gelu")
        self.n_rates = len(rates)
        for i, r in enumerate(rates):
            setattr(self, f"_conv{i + 1}",
                    ConvBN(cin, dim, 3, dilation=r, act="gelu"))
        self._pool_conv = ConvBN(cin, dim, 1, act="gelu")
        self._proj_conv_bn_act = ConvBN(dim * (2 + len(rates)), dim, 1,
                                        act="gelu")

    def forward(self, x):
        branches = [self._conv0(x)]
        branches += [getattr(self, f"_conv{i + 1}")(x)
                     for i in range(self.n_rates)]
        pooled = self._pool_conv(x.mean(dim=(1, 2), keepdim=True))
        branches.append(pooled.expand(-1, x.shape[1], x.shape[2], -1))
        return self._proj_conv_bn_act(torch.cat(branches, dim=-1))


class AxialAttention(nn.Module):
    """Multi-head self-attention along one spatial axis (1 = over H within
    each column, 2 = over W within each row) with a learned relative-
    position bias covering spans up to `span`."""

    def __init__(self, dim: int, heads: int, axis: int, span: int):
        super().__init__()
        self.dim, self.heads, self.axis, self.span = dim, heads, axis, span
        self._qkv_conv_bn = ConvBN(dim, 3 * dim, 1)
        self.rel_bias = nn.Parameter(torch.zeros(heads, 2 * span - 1))
        self._out_bn = FrozenBatchNorm(dim)

    def forward(self, x):
        B, H, W, _ = x.shape
        L = x.shape[self.axis]
        if L > self.span:
            raise ValueError(f"axial length {L} exceeds rel-pos span "
                             f"{self.span}; raise KMaxConfig.axial_span")
        hd = self.dim // self.heads
        qkv = self._qkv_conv_bn(x).reshape(B, H, W, 3, self.heads, hd)
        q, k, v = qkv.unbind(dim=3)                      # [B, H, W, h, hd]
        pos = torch.arange(L, device=x.device)
        bias = self.rel_bias.to(x.dtype)[
            :, pos[:, None] - pos[None, :] + self.span - 1]
        # the logits in x.dtype, then f32 from the scale on (the JAX
        # package divides by a numpy scalar, which promotes): the softmax,
        # the weighted sum and the output BN are f32, with the BN's
        # parameters rounded to x.dtype
        if self.axis == 1:
            logits = torch.einsum("bqwnc,bkwnc->bwnqk", q, k).float() \
                / math.sqrt(hd)
            attn = torch.softmax(logits + bias, dim=-1)
            out = torch.einsum("bwnqk,bkwnc->bqwnc", attn, v.float())
        else:
            logits = torch.einsum("bhqnc,bhknc->bhnqk", q, k).float() \
                / math.sqrt(hd)
            attn = torch.softmax(logits + bias, dim=-1)
            out = torch.einsum("bhnqk,bhknc->bhqnc", attn, v.float())
        return self._out_bn(out.reshape(B, H, W, self.dim), x.dtype)


class AxialBlock(nn.Module):
    """Inverted bottleneck with axial attention (height, then width)."""

    def __init__(self, dim: int, heads: int, span: int):
        super().__init__()
        mid = dim // 2
        self._conv1_bn_act = ConvBN(dim, mid, 1, act="gelu")
        self._attn_h = AxialAttention(mid, heads, 1, span)
        self._attn_w = AxialAttention(mid, heads, 2, span)
        self._conv3_bn = ConvBN(mid, dim, 1)

    def forward(self, x):
        """x in the model's dtype; the attention's f32 output is rounded
        back to it at the next convolution."""
        h = self._attn_h(self._conv1_bn_act(x))
        h = self._attn_w(h.to(x.dtype))
        return _gelu(x + self._conv3_bn(_gelu(h).to(x.dtype)))


class BottleneckBlock(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        mid = dim // 2
        self._conv1_bn_act = ConvBN(dim, mid, 1, act="gelu")
        self._conv2_bn_act = ConvBN(mid, mid, 3, act="gelu")
        self._conv3_bn = ConvBN(mid, dim, 1)

    def forward(self, x):
        h = self._conv3_bn(self._conv2_bn_act(self._conv1_bn_act(x)))
        return _gelu(x + h)


class ResizedFuse(nn.Module):
    """Project a deeper decoder output and a skip level to `dim`, upsample
    the deeper one bilinearly, add, gelu."""

    def __init__(self, c_low: int, c_high: int, dim: int):
        super().__init__()
        self._lowres_conv_bn = ConvBN(c_low, dim, 1)
        self._highres_conv_bn = ConvBN(c_high, dim, 1)

    def forward(self, lowres, highres):
        hi = self._highres_conv_bn(highres)
        lo = _resize_bilinear_nhwc(self._lowres_conv_bn(lowres),
                                   hi.shape[1:3])
        return _gelu(lo + hi)


_LEVELS = ("os32", "os16", "os8", "os4")


class KMaxPixelDecoder(nn.Module):
    def __init__(self, cfg: KMaxConfig):
        super().__init__()
        bd, pd = cfg.backbone.dims, cfg.pd_dims
        in_dims = (bd[3], bd[2], bd[1], bd[0])           # os32 .. os4
        self._in_norms = nn.ModuleList(nn.LayerNorm(d, eps=1e-6)
                                       for d in in_dims)
        self._aspp = ASPP(in_dims[0], pd[0], cfg.aspp_rates)
        self._stages = nn.ModuleList(
            nn.ModuleList(
                AxialBlock(pd[s], cfg.num_heads, cfg.axial_span) if s < 2
                else BottleneckBlock(pd[s])
                for _ in range(cfg.pd_blocks[s]))
            for s in range(4))
        self._resized_fuses = nn.ModuleList(
            ResizedFuse(pd[i], in_dims[i + 1], pd[i + 1]) for i in range(3))

    def forward(self, feats):
        """feats {os4..os32} channels-last -> {os32..os4} with widths
        cfg.pd_dims."""
        normed = {lv: layer_norm(self._in_norms[i], feats[lv])
                  for i, lv in enumerate(_LEVELS)}
        outs = {}
        x = self._aspp(normed["os32"])
        for s, lv in enumerate(_LEVELS):
            if s > 0:
                x = self._resized_fuses[s - 1](x, normed[lv])
            for blk in self._stages[s]:
                x = blk(x)
            outs[lv] = x
        return outs


class KMaxPredictor(nn.Module):
    """The shared heads: a pixel head (depthwise 5x5 + two 1x1 ConvBNs) with
    L2-normalised output, cosine mask logits against L2-normalised mask
    embeddings with a trailing single-channel BN, and a class head."""

    def __init__(self, cfg: KMaxConfig):
        super().__init__()
        D, M = cfg.dec_dim, cfg.mask_dim
        self._pixel_space_head_conv0bnact = ConvBN(D, D, 5, groups=D,
                                                   act="gelu")
        self._pixel_space_head_conv1bnact = ConvBN(D, D, 1, act="gelu")
        self._pixel_space_head_last_convbn = ConvBN(D, M, 1)
        self._transformer_mask_head = ConvBN(D, M, dims=1)
        self._transformer_class_head = nn.Conv1d(D, cfg.num_classes + 1, 1)
        self._pixel_space_mask_batch_norm = FrozenBatchNorm(1)

    def pixel_features(self, pixel):
        h = self._pixel_space_head_conv0bnact(pixel)
        h = self._pixel_space_head_last_convbn(
            self._pixel_space_head_conv1bnact(h))
        return h / torch.linalg.norm(h, dim=-1, keepdim=True).clamp_min(1e-6)

    def mask_logits(self, mask_emb, pixel_norm):
        """mask_emb [B, N, D], pixel_norm [B, H, W, M] -> [B, H, W, N]."""
        m = self._transformer_mask_head(mask_emb)
        m = m / torch.linalg.norm(m, dim=-1, keepdim=True).clamp_min(1e-6)
        # BatchNorm2d(1) over the logit map: one affine for every logit
        return self._pixel_space_mask_batch_norm(
            torch.einsum("bhwd,bnd->bhwn", pixel_norm, m))

    def class_logits(self, class_emb):
        w = self._transformer_class_head.weight
        dt = class_emb.dtype
        return F.linear(class_emb, w.reshape(w.shape[0], -1).to(dt),
                        self._transformer_class_head.bias.to(dt))


class KMaxTransformerLayer(nn.Module):
    """k-means cross-attention (the clustering logits are the shared
    predictor's mask logits; each pixel goes to its argmax center), then
    query self-attention and an FFN; conv1d + BN, no LayerNorm."""

    def __init__(self, cfg: KMaxConfig):
        super().__init__()
        D = cfg.dec_dim
        self.heads = cfg.num_heads
        self._pixel_v_conv_bn = ConvBN(D, D, 1)
        self._kmeans_query_conv3_bn = ConvBN(D, D, dims=1)
        self._query_qkv_conv_bn = ConvBN(D, 3 * D, dims=1)
        self._query_self_attention_out_conv_bn = ConvBN(D, D, dims=1)
        self._query_ffn_conv1_bn_act = ConvBN(D, 2 * D, act="gelu", dims=1)
        self._query_ffn_conv2_bn = ConvBN(2 * D, D, dims=1)

    def forward(self, query, pixel, mask_logits):
        """query [B, N, D]; pixel [B, H, W, D]; mask_logits [B, H, W, N]."""
        B, N, D = query.shape
        dt = query.dtype
        value = self._pixel_v_conv_bn(pixel).reshape(B, -1, D)
        # the first maximal index on ties (jnp.argmax's rule, which bf16
        # logits meet often); the one-hot in the model's dtype; the pooled
        # sum over the frame's pixels accumulated in f32 and rounded once,
        # as XLA's dot of two bf16 operands
        assign = F.one_hot(mask_logits.reshape(B, -1, N).argmax(dim=-1),
                           N).to(dt)                      # [B, P, N]
        pooled = torch.einsum("bpn,bpd->bnd", assign.float(),
                              value.float()).to(dt)
        query = query + self._kmeans_query_conv3_bn(pooled)

        hd = D // self.heads
        qkv = self._query_qkv_conv_bn(query).reshape(B, N, 3, self.heads, hd)
        q, k, v = qkv.unbind(dim=2)                       # [B, N, h, hd]
        # f32 from the scale on, as in AxialAttention
        att = torch.einsum("bnhd,bmhd->bhnm", q, k).float() / math.sqrt(hd)
        sa = torch.einsum("bhnm,bmhd->bnhd", torch.softmax(att, dim=-1),
                          v.float())
        query = query + self._query_self_attention_out_conv_bn(
            sa.reshape(B, N, D).to(dt))
        h = self._query_ffn_conv2_bn(self._query_ffn_conv1_bn_act(query))
        return _gelu(query + h)


class KMaxTransformerDecoder(nn.Module):
    def __init__(self, cfg: KMaxConfig):
        super().__init__()
        D = cfg.dec_dim
        self._cluster_centers = nn.Embedding(cfg.num_queries, D)
        self._class_embedding_projection = ConvBN(D, D, act="gelu", dims=1)
        self._mask_embedding_projection = ConvBN(D, D, act="gelu", dims=1)
        self._pixel_space_projections = nn.ModuleList(
            ConvBN(cfg.pd_dims[i], D, 1, act="gelu") for i in range(3))
        self._panoptic_feature_projection = ConvBN(cfg.pd_dims[3], D, 1,
                                                   act="gelu")
        self._kmax_transformer_layers = nn.ModuleList(
            KMaxTransformerLayer(cfg) for _ in range(sum(cfg.dec_blocks)))


class _SemSegHead(nn.Module):
    def __init__(self, cfg: KMaxConfig):
        super().__init__()
        self.pixel_decoder = KMaxPixelDecoder(cfg)
        self.predictor = KMaxPredictor(cfg)
        self.transformer_decoder = KMaxTransformerDecoder(cfg)


COMPUTE_DTYPES = (torch.float32, torch.bfloat16)


class KMaxDeepLab(nn.Module):
    def __init__(self, cfg: KMaxConfig = KMAX_CONVNEXT_LARGE,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if dtype not in COMPUTE_DTYPES:
            raise ValueError(f"kMaX-DeepLab runs in float32 or bfloat16, "
                             f"not {dtype}")
        self.cfg = cfg
        self.dtype = dtype
        self.backbone = ConvNeXt(cfg.backbone)
        self.sem_seg_head = _SemSegHead(cfg)

    @full_f32()
    def forward(self, images):
        """images [B, H, W, 3] normalised (any float dtype) ->
        (class_logits [B, N, C + 1], mask_logits [B, H/4, W/4, N]) in the
        model's dtype; f32 without TF32 whatever the caller's flags
        (core/device.py).

        The backbone runs on the whole batch and the head (pixel decoder,
        kMaX decoder, predictor) one frame at a time, so that a frame's
        logits do not depend on the frames batched with it (ROADMAP C14).
        On the card the head's convolutions pick their algorithms by the
        batch size and round differently, and each k-means layer's hard
        argmax turns that rounding into other cluster assignments: the
        final logits of 2-frame slices and of an 8-frame batch were 25% of
        their scale apart. The backbone's kernels (B2 and the depthwise
        convolution) give each frame the same bits in any batch there; in
        bf16 its stem and downsampling convolutions run a frame at a time
        too (convnext._dense_conv)."""
        feats = self.backbone(images.to(self.dtype))
        outs = [self._head({k: v[i:i + 1] for k, v in feats.items()})
                for i in range(images.shape[0])]
        return (torch.cat([o[0] for o in outs]),
                torch.cat([o[1] for o in outs]))

    def _head(self, feats):
        """Backbone features of one frame -> (class_logits, mask_logits)."""
        c = self.cfg
        dec = self.sem_seg_head.pixel_decoder(feats)
        td = self.sem_seg_head.transformer_decoder
        pred = self.sem_seg_head.predictor
        query = td._cluster_centers.weight[None].to(self.dtype)
        i = 0
        for li, n_blocks in enumerate(c.dec_blocks):
            pixel_space = td._pixel_space_projections[li](dec[_LEVELS[li]])
            for _ in range(n_blocks):
                mlog = pred.mask_logits(td._mask_embedding_projection(query),
                                        pred.pixel_features(pixel_space))
                query = td._kmax_transformer_layers[i](query, pixel_space,
                                                       mlog)
                i += 1
        panoptic = td._panoptic_feature_projection(dec["os4"])
        class_logits = pred.class_logits(
            td._class_embedding_projection(query))
        mask_logits = pred.mask_logits(td._mask_embedding_projection(query),
                                       pred.pixel_features(panoptic))
        return class_logits, mask_logits


# ---------------------------------------------------------------------------
# Panoptic post-processing (always f32)
# ---------------------------------------------------------------------------


def _f32(value: float, device) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=device)


def query_stats(class_logits, mask_logits, cfg: KMaxConfig):
    """Per-query class, thing flag, class-keep flag, mask probabilities
    (softmax over queries), binary masks, areas and paint order, for
    class_logits [..., N, C+1] and mask_logits [..., h, w, N]."""
    dev = class_logits.device
    probs = torch.softmax(class_logits.float(), dim=-1)
    scores = probs[..., :-1].amax(dim=-1)
    classes = probs[..., :-1].argmax(dim=-1)
    is_thing = classes < cfg.num_things
    keep = scores > torch.where(is_thing, _f32(cfg.class_threshold_thing, dev),
                                _f32(cfg.class_threshold_stuff, dev))
    mask_probs = torch.softmax(mask_logits.float(), dim=-1)
    binary = mask_probs > _f32(cfg.pixel_confidence_threshold, dev)
    hw = (-3, -2)
    area = binary.sum(dim=hw)
    in_mask_conf = torch.where(
        area > 0, (mask_probs * binary).sum(dim=hw) / area.clamp_min(1),
        _f32(0.0, dev))
    reorder = (scores ** cfg.reorder_class_weight
               * in_mask_conf ** cfg.reorder_mask_weight)
    # stable: zero-area queries all score 0 (ROADMAP trap C4)
    order = torch.argsort(-reorder, dim=-1, stable=True)
    return classes, is_thing, keep, mask_probs, binary, area, order


def panoptic_inference_batch(class_logits, mask_logits, cfg: KMaxConfig,
                             null_id: int = NULL_ID):
    """Batched `panoptic_inference`: [F, N, C+1] + [F, h, w, N] ->
    (cat_map [F, h, w], seg_map [F, h, w]) int32, the same per frame.

    Softmaxes, keep flags, areas and the order are computed for all frames
    at once; the sequential claim paint is kernel B3 (one int32 claim map:
    the paint index of the claiming query, -1 unclaimed, and the accepted
    flags); segment ids, stuff merging and categories are reconstructed from
    those without a loop."""
    classes, is_thing, keep, mask_probs, _, _, order = query_stats(
        class_logits, mask_logits, cfg)
    Fn, N = classes.shape
    dev = classes.device
    claim, accepted = paint_masks(
        mask_probs.permute(0, 3, 1, 2).contiguous(), order,
        keep.gather(1, order),
        overlap_threshold=float(cfg.overlap_threshold),
        pixel_threshold=float(cfg.pixel_confidence_threshold))
    claim_flat = claim.reshape(Fn, -1).long()

    # an accepted query may paint nothing (overlap_threshold <= 0) and still
    # take a segment id, as in the scalar reference
    # things open a fresh segment; stuff merges into the FIRST accepted
    # stuff query of its class; ids count new segments in paint order
    cls_sorted = classes.gather(1, order)
    thing_sorted = is_thing.gather(1, order)
    idxs = torch.arange(N, device=dev).expand(Fn, N)
    stuff_idx = torch.where(accepted & ~thing_sorted, idxs, N)
    firsts = torch.full((Fn, cfg.num_classes), N, dtype=torch.long,
                        device=dev).scatter_reduce(1, cls_sorted, stuff_idx,
                                                   "amin")
    canonical = torch.where(thing_sorted, idxs,
                            firsts.gather(1, cls_sorted)).clamp_max(N - 1)
    is_new = accepted & (canonical == idxs)
    seg_at = torch.cumsum(is_new.int(), dim=1)
    segid_sorted = seg_at.gather(1, canonical)

    claimed = claim >= 0
    safe = claim_flat.clamp_min(0)
    cat_map = torch.where(claimed,
                          cls_sorted.gather(1, safe).reshape(claim.shape),
                          null_id)
    seg_map = torch.where(claimed,
                          segid_sorted.gather(1, safe).reshape(claim.shape), 0)
    return cat_map.int(), seg_map.int()


def nearest_indices(n_in: int, n_out: int, device=None) -> torch.Tensor:
    """Source index of each output pixel of jax.image.resize(nearest):
    floor((arange(n_out) + 0.5) * n_in / n_out) in float32 (ROADMAP trap
    C8: F.interpolate's "nearest" and "nearest-exact" may round
    otherwise)."""
    pos = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5)
    return torch.floor(pos * n_in / n_out).long()


def resize_nearest_int2(a, b, out_hw):
    """Two int maps [..., h, w] resized nearest to [..., *out_hw] with one
    set of indices (cat and seg share them)."""
    rows = nearest_indices(a.shape[-2], out_hw[0], a.device)
    cols = nearest_indices(a.shape[-1], out_hw[1], a.device)
    return a[..., rows[:, None], cols], b[..., rows[:, None], cols]


def null_same_class_instance_seams(cat, seg, null_id: int = NULL_ID,
                                   dilate: int = 2):
    """Null out (dilated) pixels where two different panoptic segments of
    the SAME class touch, so fused 3D labels keep a gap between instances.
    cat / seg [..., H, W] int -> [..., H, W] int32. The dilation is a
    (2 * dilate + 1)^2 max window, as scipy's binary_dilation with a full
    3x3 structure run `dilate` times."""
    def mark(a, b):
        return ((seg[a] != seg[b]) & (seg[a] > 0) & (seg[b] > 0)
                & (cat[a] == cat[b]))

    seam = torch.zeros(seg.shape, dtype=torch.bool, device=seg.device)
    lead = (Ellipsis,)
    right = mark(lead + (slice(None), slice(1, None)),
                 lead + (slice(None), slice(None, -1)))
    seam[..., :, 1:] |= right
    seam[..., :, :-1] |= right
    down = mark(lead + (slice(1, None), slice(None)),
                lead + (slice(None, -1), slice(None)))
    seam[..., 1:, :] |= down
    seam[..., :-1, :] |= down
    if dilate > 0:
        H, W = seam.shape[-2:]
        k = 2 * dilate + 1
        seam = F.max_pool2d(seam.reshape(-1, 1, H, W).float(), k, stride=1,
                            padding=dilate).reshape(seam.shape) > 0
    return torch.where(seam, null_id, cat).int()


# ImageNet statistics of detectron2-style preprocessing
PIXEL_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
PIXEL_STD = np.array([0.229, 0.224, 0.225], np.float32)


def prep_batch(rgbs, new_h: int, new_w: int, pad_h: int, pad_w: int):
    """Test-time preprocessing of a frame chunk [F, H, W, 3] in [0, 1]:
    bilinear resize to (new_h, new_w) without antialias, zero pad to
    (pad_h, pad_w), THEN normalise, so the pad reads -mean / std (ASPP's
    image pooling averages over it, as in the JAX package)."""
    x = F.interpolate(rgbs.permute(0, 3, 1, 2), size=(new_h, new_w),
                      mode="bilinear", align_corners=False, antialias=False)
    x = F.pad(x.permute(0, 2, 3, 1), (0, 0, 0, pad_w - new_w, 0, pad_h - new_h))
    mean = torch.as_tensor(PIXEL_MEAN, device=x.device)
    std = torch.as_tensor(PIXEL_STD, device=x.device)
    return ((x - mean) / std).contiguous()


class KmaxSegmenter:
    """The model on one device with its configuration and test-time
    shape (the port's KmaxSegmenter, cut to what the reference runs:
    reference/scan.py's `kmax_frames`, `head` and `paint` drive it)."""

    def __init__(self, cfg: KMaxConfig, state_dict, device="cuda",
                 compute_dtype=None):
        self.device = torch.device(device)
        self.cfg = cfg
        self.compute_dtype = compute_dtype or torch.float32
        self.model = KMaxDeepLab(cfg, dtype=self.compute_dtype)
        self.model.load_state_dict(state_dict)
        self.model.to(self.device)
        self.model.eval().requires_grad_(False)

    def _test_shape(self, H: int, W: int):
        """(new_h, new_w, padded_h, padded_w): long edge to
        cfg.test_long_edge keeping the aspect, padded to a multiple of 32."""
        long_edge = self.cfg.test_long_edge
        if W >= H:
            new_w, new_h = long_edge, int(round(long_edge * H / W))
        else:
            new_h, new_w = long_edge, int(round(long_edge * W / H))
        return new_h, new_w, new_h + (-new_h) % 32, new_w + (-new_w) % 32
