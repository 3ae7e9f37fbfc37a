"""Plain PyTorch versions of the port's hand-written kernels, for the
reference: LayerNorm -> MLP (B2), attention (B5) and the sequential
panoptic paint (B3). Each is the port's documented contract computed with
unfused ops; none imports the port."""
from __future__ import annotations

import contextlib
import math

import torch


@contextlib.contextmanager
def full_f32():
    """No-op: the reference runs in whatever TF32 setting its caller chose
    (off for the reference, on for the control)."""
    yield


def activation(h, act: str):
    if act == "quick_gelu":
        return h * torch.sigmoid(1.702 * h)
    if act == "gelu":
        return torch.nn.functional.gelu(h)
    raise ValueError(f"unknown activation: {act}")


def ln_mlp(x, residual, ln_scale, ln_bias, w1, b1, w2, b2, gamma=None, *,
           act: str = "gelu", eps: float = 1e-6):
    """residual + gamma * (act(LN(x) @ w1 + b1) @ w2 + b2); w1 [D, H],
    w2 [H, D]."""
    lnx = torch.nn.functional.layer_norm(x, x.shape[-1:], ln_scale, ln_bias,
                                         eps)
    out = activation(lnx @ w1 + b1, act) @ w2 + b2
    if gamma is not None:
        out = out * gamma
    return residual + out


def attention(q, k, v, causal: bool = False):
    """softmax(q k^T / sqrt(hd)) v: [B, H, T, hd] -> [B, T, H * hd]."""
    B, H, T, hd = q.shape
    att = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
    if causal:
        mask = torch.full((T, T), float("-inf"), device=q.device)
        att = att + torch.triu(mask, diagonal=1)
    att = torch.softmax(att, dim=-1)
    return (att @ v).transpose(1, 2).reshape(B, T, H * hd)


def paint_masks(mask_probs, order, keep, *, overlap_threshold: float,
                pixel_threshold: float):
    """The sequential panoptic paint. mask_probs [F, N, h, w]; order [F, N]
    paint order; keep [F, N] in paint order. Returns (claim [F, h, w]
    int32, the paint index that claimed each pixel or -1; accepted [F, N]
    bool in paint order)."""
    F, N, h, w = mask_probs.shape
    dev = mask_probs.device
    binary = mask_probs > torch.tensor(pixel_threshold, dtype=torch.float32,
                                       device=dev)
    area = binary.sum(dim=(2, 3))
    order = order.long()
    frames = torch.arange(F, device=dev)
    thr = torch.tensor(overlap_threshold, dtype=torch.float32, device=dev)
    claim = torch.full((F, h, w), -1, dtype=torch.int32, device=dev)
    accepted = torch.zeros((F, N), dtype=torch.bool, device=dev)
    for j in range(N):
        q = order[:, j]
        m = binary[frames, q]
        new = m & (claim < 0)
        a = area[frames, q]
        ratio = new.sum(dim=(1, 2)).float() / a.clamp_min(1).float()
        ok = (keep[:, j] > 0) & (a > 0) & (ratio >= thr)
        claim = torch.where(new & ok[:, None, None], j, claim)
        accepted[:, j] = ok
    return claim, accepted
