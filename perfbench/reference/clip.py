"""CLIP ViT-B/32 (quick-gelu), the benchmark's plain reference: both
towers as open_clip lays them out, so one state dict loads into this model
and into the port's `ClipEngine`. Plain PyTorch ops only; the precision is
whatever TF32 setting the caller chose.

`tiled_features` is the reference's tiling: each frame is resized once so
that a patch_size tile becomes the tower's 224 pixels, and every tile at
the scaled stride is encoded (the resize-once route the port takes for
256 / 128 tiles of 1024x768 frames)."""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from .ops import activation, attention

OPENAI_CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class ClipShape:
    embed_dim: int = 512
    image_size: int = 224
    patch_size: int = 32
    vision_width: int = 768
    vision_layers: int = 12
    vision_heads: int = 12
    vocab_size: int = 49408
    context_length: int = 77
    text_width: int = 512
    text_heads: int = 8
    text_layers: int = 12
    quick_gelu: bool = True


class MLP(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.c_fc = nn.Linear(width, width * 4)
        self.c_proj = nn.Linear(width * 4, width)


class Attention(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * width))
        self.out_proj = nn.Linear(width, width)

    def forward(self, x, causal: bool = False):
        B, T, D = x.shape
        qkv = F.linear(x, self.in_proj_weight, self.in_proj_bias)
        q, k, v = qkv.view(B, T, 3, self.heads, D // self.heads).permute(
            2, 0, 3, 1, 4)
        return self.out_proj(attention(q, k, v, causal))


class Block(nn.Module):
    def __init__(self, width: int, heads: int, quick: bool):
        super().__init__()
        self.act = "quick_gelu" if quick else "gelu"
        self.ln_1 = nn.LayerNorm(width, eps=1e-5)
        self.attn = Attention(width, heads)
        self.ln_2 = nn.LayerNorm(width, eps=1e-5)
        self.mlp = MLP(width)

    def forward(self, x, causal: bool = False):
        x = x + self.attn(self.ln_1(x), causal)
        h = activation(self.mlp.c_fc(self.ln_2(x)), self.act)
        return x + self.mlp.c_proj(h)


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int, quick: bool):
        super().__init__()
        self.resblocks = nn.ModuleList(
            [Block(width, heads, quick) for _ in range(layers)])

    def forward(self, x, causal: bool = False):
        for blk in self.resblocks:
            x = blk(x, causal)
        return x


class VisionTower(nn.Module):
    def __init__(self, s: ClipShape):
        super().__init__()
        w, p = s.vision_width, s.patch_size
        self.conv1 = nn.Conv2d(3, w, kernel_size=p, stride=p, bias=False)
        self.class_embedding = nn.Parameter(torch.empty(w))
        self.positional_embedding = nn.Parameter(
            torch.empty((s.image_size // p) ** 2 + 1, w))
        self.ln_pre = nn.LayerNorm(w, eps=1e-5)
        self.transformer = Transformer(w, s.vision_layers, s.vision_heads,
                                       s.quick_gelu)
        self.ln_post = nn.LayerNorm(w, eps=1e-5)
        self.proj = nn.Parameter(torch.empty(w, s.embed_dim))

    def forward(self, images):
        """[B, 3, S, S] channel-normalized -> [B, embed_dim]."""
        x = self.conv1(images).flatten(2).transpose(1, 2)
        cls = self.class_embedding.expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding
        x = self.transformer(self.ln_pre(x))
        return self.ln_post(x[:, 0]) @ self.proj


class CLIP(nn.Module):
    def __init__(self, s: ClipShape = ClipShape()):
        super().__init__()
        self.shape = s
        self.visual = VisionTower(s)
        self.token_embedding = nn.Embedding(s.vocab_size, s.text_width)
        self.positional_embedding = nn.Parameter(
            torch.empty(s.context_length, s.text_width))
        self.transformer = Transformer(s.text_width, s.text_layers,
                                       s.text_heads, s.quick_gelu)
        self.ln_final = nn.LayerNorm(s.text_width, eps=1e-5)
        self.text_projection = nn.Parameter(
            torch.empty(s.text_width, s.embed_dim))
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07)))

    def encode_text(self, token_ids):
        """[B, context] int64 -> [B, embed_dim]; the EOT token (the
        largest id) is pooled."""
        x = self.token_embedding(token_ids) + self.positional_embedding
        x = self.ln_final(self.transformer(x, causal=True))
        x = x[torch.arange(x.shape[0], device=x.device),
              token_ids.argmax(dim=-1)]
        return x @ self.text_projection

    def tiled_features(self, frames, patch_size: int, patch_stride: int,
                       tiles_per_call: int = 560):
        """frames [F, H, W, 3] in [0, 1] -> [F, ny, nx, embed_dim]."""
        vs = self.shape.image_size
        Fn, H, W = frames.shape[:3]
        if patch_size < vs or (H * vs) % patch_size or (W * vs) % patch_size \
                or (patch_stride * vs) % patch_size:
            raise ValueError("the reference tiles by resizing each frame "
                             "once: patch_size >= image_size, and the frame "
                             "and the stride scale to whole pixels")
        ny = (H - patch_size) // patch_stride + 1
        nx = (W - patch_size) // patch_stride + 1
        mean = torch.tensor(OPENAI_CLIP_MEAN, device=frames.device)
        std = torch.tensor(OPENAI_CLIP_STD, device=frames.device)
        x = ((frames - mean) / std).permute(0, 3, 1, 2)
        small = F.interpolate(x, size=(H * vs // patch_size,
                                       W * vs // patch_size),
                              mode="bilinear", align_corners=False,
                              antialias=False)
        stride = patch_stride * vs // patch_size
        t = small.unfold(2, vs, stride).unfold(3, vs, stride)
        tiles = t.permute(0, 2, 3, 1, 4, 5).reshape(Fn * ny * nx, 3, vs, vs)
        out = torch.cat([self.visual(tiles[i:i + tiles_per_call])
                         for i in range(0, len(tiles), tiles_per_call)])
        return out.reshape(Fn, ny, nx, -1)
