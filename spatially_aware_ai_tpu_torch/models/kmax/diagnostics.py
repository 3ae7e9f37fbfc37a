"""Diagnostics for holding one kMaX-DeepLab run against another. Nothing on
the serving path imports this module: chip_smoke.py and the tests do.

`kmeans_logits` records the mask logits each k-means layer clusters with,
or makes a model cluster with another run's, so that two runs share every
hard assignment. `unit_calls` records every call of a model's units (see
UNIT_KINDS) with its inputs and output, and `replay_units` runs another
model's same units on those inputs, so that two devices (or two builds) are
compared unit by unit on the same inputs, where a chain of forty units
cannot amplify a rounding apart into a large difference.
"""
from __future__ import annotations

import contextlib

import torch

from . import convnext as CN
from . import model as KM

# a unit kind -> (the class whose instances are units, the methods
# recorded). "downsample" is the ConvNeXt stem and downsampling
# convolutions (convnext._dense_conv, by the Conv2d they run)
UNIT_KINDS = {
    "FrozenBatchNorm": (KM.FrozenBatchNorm, ("forward",)),
    "ConvBN": (KM.ConvBN, ("forward",)),
    "ConvNeXtBlock": (CN.ConvNeXtBlock, ("forward",)),
    "downsample": (torch.nn.Conv2d, ("_dense_conv",)),
    "AxialAttention": (KM.AxialAttention, ("forward",)),
    "KMaxTransformerLayer": (KM.KMaxTransformerLayer, ("forward",)),
    "KMaxPredictor": (KM.KMaxPredictor,
                      ("pixel_features", "mask_logits", "class_logits")),
}


@contextlib.contextmanager
def kmeans_logits(model, replay=None):
    """Within the block, record the mask logits each k-means layer of
    `model` clusters with (replay None), in call order (frame by frame,
    layer by layer), into the yielded list; or cluster with `replay`'s, a
    recording of another run (or the JAX package's, in that order), so
    that the two runs share every hard assignment and a flipped argmax
    cannot carry a rounding difference into the cluster centres."""
    layers = model.sem_seg_head.transformer_decoder._kmax_transformer_layers
    seen = [] if replay is None else list(replay)
    calls = [0]

    def wrap(real):
        def forward(query, pixel, mask_logits):
            if replay is None:
                seen.append(mask_logits.cpu())
            else:
                mask_logits = seen[calls[0]].to(mask_logits)
                calls[0] += 1
            return real(query, pixel, mask_logits)
        return forward

    patched = [_patch(lay, "forward", wrap(lay.forward)) for lay in layers]
    try:
        yield seen
    finally:
        _unpatch(patched)


def _patch(obj, meth, fn):
    """Set `fn` as obj's `meth`; returns what _unpatch needs to put back
    what was there (an instance attribute of another patch, or nothing)."""
    prev = obj.__dict__.get(meth)
    setattr(obj, meth, fn)
    return obj, meth, prev


def _unpatch(patched):
    for obj, meth, prev in reversed(patched):
        if prev is None:
            delattr(obj, meth)
        else:
            setattr(obj, meth, prev)


def _cpu(a):
    return a.detach().cpu() if isinstance(a, torch.Tensor) else a


@contextlib.contextmanager
def unit_calls(model):
    """Within the block, record every call of `model`'s units (UNIT_KINDS)
    into the yielded list, in call order, as (kind, module name, method,
    args, output), tensors copied to the CPU. Units inside units are
    recorded too (a ConvBN inside a k-means layer, the BN inside it)."""
    calls = []
    names = {id(m): n for n, m in model.named_modules()}
    patched = []

    def wrap(kind, name, meth, real):
        def call(*args):
            out = real(*args)
            calls.append((kind, name, meth, tuple(_cpu(a) for a in args),
                          _cpu(out)))
            return out
        return call

    for name, mod in model.named_modules():
        for kind, (cls, meths) in UNIT_KINDS.items():
            if isinstance(mod, cls) and kind != "downsample":
                patched += [_patch(mod, meth, wrap(kind, name, meth,
                                                   getattr(mod, meth)))
                            for meth in meths]
    real_dense = CN._dense_conv

    def dense(x, conv):
        out = real_dense(x, conv)
        calls.append(("downsample", names[id(conv)], "_dense_conv",
                      (_cpu(x),), _cpu(out)))
        return out

    CN._dense_conv = dense
    try:
        yield calls
    finally:
        CN._dense_conv = real_dense
        _unpatch(patched)


def replay_units(model, calls):
    """Run each recorded call (`unit_calls`) again on `model`'s unit of the
    same name, on the model's device, with the recorded inputs: yields
    (kind, module name, method, output, the recorded output)."""
    dev = next(model.parameters()).device
    for kind, name, meth, args, want in calls:
        mod = model.get_submodule(name)
        args = tuple(a.to(dev) if isinstance(a, torch.Tensor) else a
                     for a in args)
        if meth == "_dense_conv":
            got = CN._dense_conv(*args, mod)
        else:
            got = getattr(mod, meth)(*args)
        yield kind, name, meth, got, want


# two builds of a unit that round the same ops in other orders (the card's
# kernels and cuDNN / cuBLAS against the CPU's) give outputs within
# UNIT_ULPS bf16 ulps of the largest magnitude, or within ROUNDING_FACTOR
# times what rounding to bf16 itself moves that unit's output on those
# inputs, where that is more: a unit on ill-conditioned inputs (a k-means
# layer whose self-attention reads queries of pooled sums) turns one
# rounding apart into more
UNIT_ULPS = 2.0
ROUNDING_FACTOR = 2.0


def unit_distances(model, reference, calls):
    """For each call recorded on the bf16 `reference` (`unit_calls`):
    (kind, module name, method, ulps, rounding, limit). `ulps` is `model`'s
    unit on the recorded inputs against the recorded output, `rounding`
    the reference's own unit on those inputs cast to f32 (so that it
    computes in f32) against the recorded output, both in bf16 ulps of the
    recorded output's largest magnitude; limit = max(UNIT_ULPS,
    ROUNDING_FACTOR * rounding)."""
    from ..attention import max_bf16_ulps

    up = [(kind, name, meth,
           tuple(a.float() if isinstance(a, torch.Tensor)
                 and a.is_floating_point() else a for a in args), want)
          for kind, name, meth, args, want in calls]
    own = [max_bf16_ulps(got, want)
           for *_, got, want in replay_units(reference, up)]
    out = []
    for (kind, name, meth, got, want), r in zip(replay_units(model, calls),
                                                own):
        out.append((kind, name, meth, max_bf16_ulps(got, want), r,
                    max(UNIT_ULPS, ROUNDING_FACTOR * r)))
    return out
