"""Model operations of one scan, counted once from the cell's shapes by
torch.utils.flop_counter over the benchmark's plain reference on the meta
device: CLIP's vision tower on every tile, and kMaX on every frame at its
padded test size. Counted products and convolutions only, as an MFU
counts them."""
from __future__ import annotations

import functools
import json

import torch
from torch.utils.flop_counter import FlopCounterMode


def _count(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


@functools.lru_cache(maxsize=None)
def _per_scan(config_json: str, frames: int, height: int, width: int):
    from perfbench.harness import models
    from perfbench.reference import clip as ref_clip
    from perfbench.reference import kmax as ref_kmax

    config = json.loads(config_json)
    shape, kcfg = models.shapes_of(config)
    f = config["fusion"]
    ny = (height - f["clip_patch_size"]) // f["clip_patch_stride"] + 1
    nx = (width - f["clip_patch_size"]) // f["clip_patch_stride"] + 1
    s = shape.image_size
    with torch.device("meta"):
        clip = ref_clip.CLIP(shape)
        tiles = torch.empty(ny * nx, 3, s, s)
        total = frames * _count(lambda: clip.visual(tiles))
        if kcfg is not None and f.get("with_labels"):
            seg = ref_kmax.KMaxDeepLab(kcfg)
            long_edge = kcfg.test_long_edge
            if width >= height:
                nw, nh = long_edge, int(round(long_edge * height / width))
            else:
                nh, nw = long_edge, int(round(long_edge * width / height))
            img = torch.empty(1, nh + (-nh) % 32, nw + (-nw) % 32, 3)
            total += frames * _count(lambda: seg(img))
    return total


def per_scan(config: dict, frames: int, height: int, width: int) -> int:
    return _per_scan(json.dumps(config, sort_keys=True), frames, height,
                     width)
