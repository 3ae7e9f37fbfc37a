#!/usr/bin/env python3
"""Does full-width kMaX's output depend on how the batch is split
(ROADMAP C14)?

    python3 tools/c14_kmax_batch_probe.py [--long-edge 320] [--frames 8]
        [--step 2] [--packages port,jax] [--device cpu|cuda]
        [--dtype f32|bf16] [--cudnn-pinned] [--per-frame] [--modules]

kMaX-DeepLab ConvNeXt-L at full width with the port's random weights
(`KmaxSegmenter.random`, seed 0), scaled as chip_smoke.py's kMaX phases
scale it so that frames are painted (class head x20, mask-logit BN x100).
The JAX package gets the same weights through the port's copy of
`convert_kmax_checkpoint`. Each package runs the hermetic synthetic scan's
first `--frames` frames in one batch and in slices of `--step` frames, at a
test long edge of `--long-edge` (the model's own is 1281, padded to
992x1312; a smaller edge keeps the CPU run short). Per package, whole
batch against the concatenated slices: the largest difference of each
k-means layer's mask logits (the tensor its hard argmax reads) over their
scale, with the share of pixels whose argmax differs, of the final class
and mask logits, and the share of pixels whose panoptic category differs.
Then the two packages' whole-batch outputs against each other.

The port runs its own `KMaxDeepLab.forward` (which runs the head one frame
at a time, the C14 repair), the k-means layers' inputs read by hooks, in
`--dtype` (the JAX package's compute_dtype; the JAX side stays f32).
`--device cuda` runs the port alone on the card; `--cudnn-pinned` sets
cuDNN's deterministic flag on and its benchmark flag off around the
forwards; `--per-frame` runs the whole forward one frame at a time inside
every batch. Prints one JSON line per package (with the seconds of one
whole-batch forward after a warm-up) and a summary line. `--modules`
instead runs the port's model once on the whole batch and, for every
module called on it, runs that module again on its own input in slices:
it prints the modules whose output then differs, in call order, which
names the ops whose result depends on the batch size.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLASS_SCALE, MASK_SCALE = 20.0, 100.0


def inputs(args):
    """(port config, scaled state dict, prepped images [F, H, W, 3])."""
    import numpy as np
    import torch

    from spatially_aware_ai_tpu_torch.data import SyntheticSceneDataset
    from spatially_aware_ai_tpu_torch.models.kmax import model as KM

    cfg = dataclasses.replace(KM.KMAX_CONVNEXT_LARGE,
                              test_long_edge=args.long_edge)
    model = KM.KMaxDeepLab(cfg).init_random_(
        torch.Generator().manual_seed(0))
    pred = model.sem_seg_head.predictor
    with torch.no_grad():
        pred._transformer_class_head.weight.mul_(CLASS_SCALE)
        pred._transformer_class_head.bias.mul_(CLASS_SCALE)
        pred._pixel_space_mask_batch_norm.weight.mul_(MASK_SCALE)
    ds = SyntheticSceneDataset(num_frames=args.frames, width=1024,
                               height=768)
    rgb = torch.from_numpy(np.stack([ds[i].rgb for i in range(args.frames)])
                           .astype(np.float32))
    seg = KM.KmaxSegmenter.__new__(KM.KmaxSegmenter)
    seg.cfg = cfg
    new_h, new_w, pad_h, pad_w = seg._test_shape(*rgb.shape[1:3])
    imgs = KM.prep_batch(rgb, new_h, new_w, pad_h, pad_w)
    return cfg, model.state_dict(), imgs, (new_h, new_w)


def port_stages(cfg, sd, imgs, device, per_frame=False, dtype=None):
    """The port's forward (`KMaxDeepLab.forward`), each k-means layer's
    mask-logit input recorded by a hook: [k-means layer mask logits...],
    class logits, mask logits, category map; one list per batch."""
    import numpy as np
    import torch

    from spatially_aware_ai_tpu_torch.models.kmax import model as KM

    model = KM.KMaxDeepLab(cfg, dtype=dtype or torch.float32)
    model.load_state_dict(sd)
    model = model.to(device).eval().requires_grad_(False)
    layers = model.sem_seg_head.transformer_decoder._kmax_transformer_layers
    seen = [[] for _ in layers]
    for i, layer in enumerate(layers):
        layer.register_forward_pre_hook(
            lambda mod, args, i=i: seen[i].append(args[2].cpu()))

    def run(x, crop):
        if per_frame and x.shape[0] > 1:
            outs = [run(x[i:i + 1], crop) for i in range(x.shape[0])]
            return [np.concatenate([o[j] for o in outs])
                    for j in range(len(outs[0]))]
        for rec in seen:
            rec.clear()
        with torch.inference_mode():
            cls, masks = model(x.to(device))
            cat, _ = KM.panoptic_inference_batch(
                cls, masks[:, :crop[0], :crop[1]], cfg)
        mlogs = [torch.cat(rec) for rec in seen]
        return [t.cpu().float().numpy() if t.is_floating_point()
                else t.cpu().numpy() for t in mlogs + [cls, masks, cat]]

    return run


def batch_variant_modules(cfg, sd, imgs, device, step, dtype=None):
    """The modules of the port's model whose output on their whole-batch
    input differs from the concatenation of their outputs on its slices."""
    import torch

    from spatially_aware_ai_tpu_torch.core.device import full_f32
    from spatially_aware_ai_tpu_torch.models.kmax import model as KM

    model = KM.KMaxDeepLab(cfg, dtype=dtype or torch.float32)
    model.load_state_dict(sd)
    model = model.to(device).eval().requires_grad_(False)
    F = imgs.shape[0]
    busy, found = [False], []

    def hook(name):
        def check(mod, inp, out):
            if (busy[0] or not isinstance(out, torch.Tensor) or not inp
                    or not all(isinstance(t, torch.Tensor)
                               and t.shape[0] == F for t in inp)):
                return
            busy[0] = True
            try:
                parts = torch.cat([mod(*[t[i:i + step] for t in inp])
                                   for i in range(0, F, step)])
                d = float((parts - out).abs().max())
                if d > 0:
                    found.append({"module": name,
                                  "type": type(mod).__name__,
                                  "max_abs": d,
                                  "scale": float(out.abs().max()),
                                  "dtype": str(out.dtype),
                                  "input": list(inp[0].shape)})
            finally:
                busy[0] = False
        return check

    for name, mod in model.named_modules():
        mod.register_forward_hook(hook(name))
    with torch.inference_mode(), full_f32():
        model(imgs.to(device))
        found += conv_ops(model, imgs.to(device), step)
    return found


def conv_ops(model, imgs, step):
    """The backbone's convolutions and LayerNorms, which its modules call as
    functions, each run on its whole-batch input and on slices: those whose
    output differs (name, max abs difference, scale)."""
    import torch

    from spatially_aware_ai_tpu_torch.models.kmax import convnext as CN

    bb = model.backbone
    x = imgs.to(model.dtype)
    found = []

    def check(name, fn, inp):
        out = fn(inp)
        parts = torch.cat([fn(inp[i:i + step])
                           for i in range(0, inp.shape[0], step)])
        d = float((parts.float() - out.float()).abs().max())
        if d > 0:
            found.append({"op": name, "max_abs": d,
                          "scale": float(out.float().abs().max()),
                          "input": list(inp.shape), "dtype": str(out.dtype)})
        return out

    for stage in range(4):
        a, b = bb.downsample_layers[stage]
        if stage == 0:
            x = check("stem_conv", lambda t: CN.conv2d_nhwc(t, a), x)
            x = check("stem_norm", lambda t: CN.layer_norm(b, t), x)
        else:
            x = check(f"down{stage}_norm", lambda t: CN.layer_norm(a, t), x)
            x = check(f"down{stage}_conv", lambda t: CN.conv2d_nhwc(t, b), x)
        for j, blk in enumerate(bb.stages[stage]):
            check(f"stage{stage}.{j}.dwconv",
                  lambda t: CN.conv2d_nhwc(t, blk.dwconv), x)
            x = check(f"stage{stage}.{j}", blk, x)
    return found


def jax_stages(cfg, sd, imgs):
    """The JAX package's forward with its k-means mask logits captured:
    the same list as `port_stages`."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from spatially_aware_ai_tpu.models.kmax import model as JM
    from spatially_aware_ai_tpu.models.kmax.convnext import (
        ConvNeXtConfig as JaxConvNeXtConfig)
    from spatially_aware_ai_tpu_torch.models.kmax.convert import (
        convert_kmax_checkpoint)

    d = dataclasses.asdict(cfg)
    bb = d.pop("backbone")
    jcfg = JM.KMaxConfig(backbone=JaxConvNeXtConfig(**bb), **d)
    variables = jax.tree_util.tree_map(jnp.asarray,
                                       convert_kmax_checkpoint(sd, jcfg))
    model = JM.KMaxDeepLab(jcfg)

    @jax.jit
    def forward(v, x):
        (cls, masks), state = model.apply(
            v, x, capture_intermediates=lambda m, name: name == "mask_logits",
            mutable=["intermediates"])
        mlogs = state["intermediates"]["predictor"]["mask_logits"]
        return list(mlogs[:-1]), cls, masks

    def run(x, crop):
        mlogs, cls, masks = forward(variables, jnp.asarray(x.numpy()))
        cat, _ = JM.panoptic_inference_batch(
            cls, masks[:, :crop[0], :crop[1]], jcfg)
        return [np.asarray(t) for t in mlogs + [cls, masks, cat]]

    return run


def compare(whole, split, n_layers):
    """Stage differences of two stage lists (the module docstring)."""
    import numpy as np

    def rel(a, b):
        scale = float(np.abs(a).max())
        return {"max_abs": float(np.abs(a - b).max()), "scale": scale,
                "rel": float(np.abs(a - b).max()) / max(scale, 1e-30)}

    out = {"kmeans_layers": []}
    for j in range(n_layers):
        d = rel(whole[j], split[j])
        d["flipped_share"] = float((whole[j].argmax(-1)
                                    != split[j].argmax(-1)).mean())
        out["kmeans_layers"].append(d)
    out["class_logits"] = rel(whole[n_layers], split[n_layers])
    out["mask_logits"] = rel(whole[n_layers + 1], split[n_layers + 1])
    out["category_agreement"] = float(
        (whole[n_layers + 2] == split[n_layers + 2]).mean())
    return out


def main(argv=None):
    import numpy as np

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--long-edge", type=int, default=320)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--step", type=int, default=2)
    ap.add_argument("--packages", default="port,jax")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--dtype", default="f32", choices=("f32", "bf16"))
    ap.add_argument("--cudnn-pinned", action="store_true")
    ap.add_argument("--per-frame", action="store_true")
    ap.add_argument("--modules", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    if args.cudnn_pinned:
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[args.dtype]
    cfg, sd, imgs, (new_h, new_w) = inputs(args)
    if args.modules:
        found = batch_variant_modules(cfg, sd, imgs,
                                      torch.device(args.device), args.step,
                                      dtype)
        print(json.dumps({"probe": "c14_modules", "device": args.device,
                          "dtype": args.dtype, "input": list(imgs.shape),
                          "step": args.step,
                          "batch_variant_modules": found}), flush=True)
        return
    crop = (-(-new_h // 4), -(-new_w // 4))
    n_layers = sum(cfg.dec_blocks)
    runners = {}
    for name in args.packages.split(","):
        runners[name] = (port_stages(cfg, sd, imgs, torch.device(args.device),
                                     args.per_frame, dtype)
                         if name == "port" else jax_stages(cfg, sd, imgs))
    wholes = {}
    summary = {"probe": "c14", "long_edge": args.long_edge,
               "input": list(imgs.shape), "step": args.step,
               "device": args.device, "dtype": args.dtype,
               "cudnn_pinned": args.cudnn_pinned,
               "per_frame": args.per_frame}
    if args.device.startswith("cuda"):
        summary["card"] = torch.cuda.get_device_name(0)
    for name, run in runners.items():
        t0 = time.perf_counter()
        run(imgs, crop)
        t_first = time.perf_counter() - t0
        t0 = time.perf_counter()
        whole = run(imgs, crop)
        t_whole = time.perf_counter() - t0
        parts = [run(imgs[i:i + args.step], crop)
                 for i in range(0, imgs.shape[0], args.step)]
        split = [np.concatenate([p[j] for p in parts])
                 for j in range(len(whole))]
        wholes[name] = whole
        line = {"package": name, "first_forward_s": t_first,
                "whole_batch_s": t_whole, **compare(whole, split, n_layers)}
        print(json.dumps(line), flush=True)
        summary[name] = {
            "class_logits_rel": line["class_logits"]["rel"],
            "holds_2e-4": line["class_logits"]["rel"] <= 2e-4
            and line["mask_logits"]["rel"] <= 2e-4,
            "first_flip_layer": next(
                (i for i, d in enumerate(line["kmeans_layers"])
                 if d["flipped_share"] > 0), None),
            "category_agreement": line["category_agreement"]}
    if len(wholes) == 2:
        cross = compare(wholes["jax"], wholes["port"], n_layers)
        summary["jax_vs_port"] = {
            "class_logits_rel": cross["class_logits"]["rel"],
            "first_flip_layer": next(
                (i for i, d in enumerate(cross["kmeans_layers"])
                 if d["flipped_share"] > 0), None),
            "category_agreement": cross["category_agreement"]}
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
