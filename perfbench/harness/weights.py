"""Seeded random weights, made on the device in one large draw.

Every floating-point entry of a model's state dict is a view of one
normal draw from a `torch.Generator` on the device, then scaled by a rule
of its owner's kind (lecun-normal for products and convolutions, small
noise around one for norms, as the model's own initialisers do). The
benchmark hands the same state dict to the port and to the reference.
Nothing here imports the port: the shapes come from the reference's
modules, whose parameter names are the port's.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn

from ..reference import clip as ref_clip
from ..reference import kmax as ref_kmax

# salts keep the two models' draws apart under one seed
_SALT = {"clip": 0x5C11, "kmax": 0x6A4A}


def _generator(seed: int, salt: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1_000_003 + salt) % (2 ** 63))
    return gen


def _draw(meta: nn.Module, seed: int, salt: int, device):
    """(state dict of views of one draw, owner module of every entry)."""
    owners = {}
    for mname, mod in meta.named_modules():
        for pname, _ in list(mod.named_parameters(recurse=False)) + list(
                mod.named_buffers(recurse=False)):
            owners[f"{mname}.{pname}" if mname else pname] = (mod, pname)
    shapes = meta.state_dict()
    floats = [k for k, v in shapes.items() if v.is_floating_point()]
    total = sum(shapes[k].numel() for k in floats)
    buf = torch.randn(total, generator=_generator(seed, salt, device),
                      device=device)
    sd, at = {}, 0
    for k, v in shapes.items():
        if v.is_floating_point():
            sd[k] = buf[at:at + v.numel()].view(v.shape)
            at += v.numel()
        else:
            sd[k] = torch.zeros(v.shape, dtype=v.dtype, device=device)
    return sd, owners


def _lecun(t):
    t.mul_(1.0 / math.sqrt(t[0].numel() if t.dim() > 1 else t.numel()))


def clip_state_dict(shape, seed: int, device) -> dict:
    """CLIP weights: lecun-normal products and the conv stem, biases
    0.02, LayerNorms 1 + 0.05 n, embeddings and projections 0.02 (text
    positions 0.01), open_clip's logit scale."""
    with torch.device("meta"):
        meta = ref_clip.CLIP(shape)
    sd, owners = _draw(meta, seed, _SALT["clip"], device)
    with torch.no_grad():
        for k, t in sd.items():
            mod, pname = owners[k]
            if isinstance(mod, nn.LayerNorm) and pname == "weight":
                t.mul_(0.05).add_(1.0)
            elif pname.endswith("bias"):
                t.mul_(0.02)
            elif k in ("positional_embedding",):
                t.mul_(0.01)
            elif k == "logit_scale":
                t.fill_(math.log(1 / 0.07))
            elif (k.endswith("embedding") or k.endswith("proj")
                  or k == "text_projection" or k.startswith("token_")):
                t.mul_(0.02)
            elif t.dim() >= 2:
                _lecun(t)
            else:
                raise ValueError(f"no weight rule for CLIP entry {k}")
    return sd


def kmax_state_dict(cfg, weights: dict, seed: int, device) -> dict:
    """kMaX weights: lecun-normal convolutions and products, biases and
    relative-position biases 0.02, LayerNorms and BN scales 1 + 0.05 n,
    BN statistics 0 / 1, cluster centres N(0, 1), ConvNeXt layer scale
    `weights["convnext_layer_scale"]`; the class head and the pixel-space
    mask BN scale multiplied by `kmax_class_head_scale` and
    `kmax_mask_bn_scale`, so that random weights paint frames."""
    with torch.device("meta"):
        meta = ref_kmax.KMaxDeepLab(cfg)
    sd, owners = _draw(meta, seed, _SALT["kmax"], device)
    norms = (nn.LayerNorm, ref_kmax.FrozenBatchNorm)
    with torch.no_grad():
        for k, t in sd.items():
            mod, pname = owners[k]
            if pname == "num_batches_tracked":
                continue
            if pname == "running_mean":
                t.zero_()
            elif pname == "running_var":
                t.fill_(1.0)
            elif isinstance(mod, norms) and pname == "weight":
                t.mul_(0.05).add_(1.0)
            elif isinstance(mod, norms) or pname in ("bias", "rel_bias"):
                t.mul_(0.02)
            elif pname == "gamma":
                t.fill_(float(weights["convnext_layer_scale"]))
            elif isinstance(mod, nn.Embedding):
                pass
            elif t.dim() >= 2:
                _lecun(t)
            else:
                raise ValueError(f"no weight rule for kMaX entry {k}")
        pred = "sem_seg_head.predictor."
        for name in ("_transformer_class_head.weight",
                     "_transformer_class_head.bias"):
            sd[pred + name].mul_(float(weights["kmax_class_head_scale"]))
        sd[pred + "_pixel_space_mask_batch_norm.weight"].mul_(
            float(weights["kmax_mask_bn_scale"]))
    return sd
