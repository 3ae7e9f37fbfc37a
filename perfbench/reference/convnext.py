"""ConvNeXt backbone of the reference kMaX: a frozen copy of the port's,
with kernel B2 replaced by the plain LayerNorm -> MLP of `ops.py`."""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .ops import ln_mlp as fused_ln_mlp


@dataclasses.dataclass(frozen=True)
class ConvNeXtConfig:
    depths: Tuple[int, ...] = (3, 3, 27, 3)
    dims: Tuple[int, ...] = (192, 384, 768, 1536)
    layer_scale_init: float = 1e-6


CONVNEXT_LARGE = ConvNeXtConfig()
CONVNEXT_TINY_TEST = ConvNeXtConfig(depths=(1, 1, 2, 1), dims=(16, 32, 48, 64))


def _same_pad(n: int, k: int, s: int, d: int = 1):
    """(lo, hi) padding of one axis for flax's padding="SAME"."""
    out = -(-n // s)
    total = max((out - 1) * s + (k - 1) * d + 1 - n, 0)
    return total // 2, total - total // 2


def layer_norm(ln: nn.LayerNorm, x):
    """LayerNorm in f32 statistics, output in x.dtype (flax's
    LayerNorm(dtype=...); for f32 x the plain `ln(x)`)."""
    y = F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(),
                     ln.bias.float(), ln.eps)
    return y.to(x.dtype)


def conv2d_nhwc(x, conv: nn.Conv2d):
    """flax nn.Conv(padding="SAME") of a channels-last x [B, H, W, C] with a
    torch Conv2d's parameters (OIHW weight), through F.conv2d on the
    channels-last NCHW view. Returns [B, H', W', O] contiguous."""
    (kh, kw), (sh, sw), (dh, dw) = conv.kernel_size, conv.stride, conv.dilation
    ph, pw = _same_pad(x.shape[1], kh, sh, dh), _same_pad(x.shape[2], kw, sw,
                                                            dw)
    y = x.permute(0, 3, 1, 2)
    if ph[0] != ph[1] or pw[0] != pw[1]:
        y = F.pad(y, (pw[0], pw[1], ph[0], ph[1]))
        pad = (0, 0)
    else:
        pad = (ph[0], pw[0])
    y = F.conv2d(y, conv.weight.to(x.dtype),
                 None if conv.bias is None else conv.bias.to(x.dtype),
                 conv.stride, pad, conv.dilation, conv.groups)
    return y.permute(0, 2, 3, 1).contiguous()


def _dense_conv(x, conv: nn.Conv2d):
    """conv2d_nhwc for the stem and downsampling convolutions. In bf16 one
    frame at a time, so that a frame's features do not depend on the
    frames batched with it (ROADMAP C14): on the card cuDNN picks a bf16
    convolution's algorithm by the batch size, and a 2x2 / stride-2 one of
    a 4-frame batch rounded otherwise than of 2-frame slices, with its
    deterministic flag on too (tools/kmax_dense_conv_ab.py, which also
    times the cost: 1.5 ms a full-width 8-frame chunk on an H100). In f32
    the whole batch: there the card's convolutions measured invariant, and
    one frame at a time would round otherwise on the CPU than the batch
    does. The depthwise convolutions and B2 give each frame the same bits
    in any batch in both dtypes."""
    if x.dtype != torch.bfloat16 or x.shape[0] == 1:
        return conv2d_nhwc(x, conv)
    return torch.cat([conv2d_nhwc(x[i:i + 1], conv)
                      for i in range(x.shape[0])])


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int, layer_scale_init: float = 1e-6):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.pwconv1 = nn.Linear(dim, 4 * dim)
        self.pwconv2 = nn.Linear(4 * dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), layer_scale_init))

    def forward(self, x):
        """x [B, H, W, C] contiguous -> [B, H, W, C]."""
        B, H, W, C = x.shape
        h = conv2d_nhwc(x, self.dwconv)
        out = fused_ln_mlp(
            h.reshape(B * H * W, C), x.reshape(B * H * W, C),
            self.norm.weight, self.norm.bias,
            self.pwconv1.weight.t(), self.pwconv1.bias,
            self.pwconv2.weight.t(), self.pwconv2.bias, self.gamma,
            act="gelu", eps=1e-6,
        )
        return out.reshape(B, H, W, C)


class ConvNeXt(nn.Module):
    def __init__(self, cfg: ConvNeXtConfig = CONVNEXT_LARGE):
        super().__init__()
        self.cfg = cfg
        d = cfg.dims
        # [conv, LN] for the stem, [LN, conv] between stages: the torch
        # ConvNeXt's Sequential indices
        self.downsample_layers = nn.ModuleList(
            [nn.ModuleList([nn.Conv2d(3, d[0], 4, stride=4),
                            nn.LayerNorm(d[0], eps=1e-6)])]
            + [nn.ModuleList([nn.LayerNorm(d[i], eps=1e-6),
                              nn.Conv2d(d[i], d[i + 1], 2, stride=2)])
               for i in range(3)])
        self.stages = nn.ModuleList(
            nn.ModuleList(ConvNeXtBlock(d[i], cfg.layer_scale_init)
                          for _ in range(cfg.depths[i]))
            for i in range(4))

    def forward(self, x):
        """x [B, H, W, 3] -> {"os4", "os8", "os16", "os32"} channels-last."""
        feats = {}
        for stage in range(4):
            a, b = self.downsample_layers[stage]
            if stage == 0:
                x = layer_norm(b, _dense_conv(x, a))
            else:
                x = _dense_conv(layer_norm(a, x), b)
            for blk in self.stages[stage]:
                x = blk(x)
            feats[f"os{4 * 2 ** stage}"] = x
        return feats
