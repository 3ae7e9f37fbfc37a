"""The two sides of a cell, built from one configuration file and one
seed: the port's engines (the system under test) and the reference's
models, both loaded from the same seeded state dicts."""
from __future__ import annotations

import torch

from ..reference import clip as ref_clip
from ..reference import kmax as ref_kmax
from . import weights


def kmax_config(module, block: dict):
    """A KMaxConfig of `module` (the port's or the reference's kmax module)
    from the configuration file's "kmax" block."""
    bb = dict(block["backbone"])
    tup = {k: tuple(v) if isinstance(v, list) else v for k, v in bb.items()}
    backbone = module.ConvNeXtConfig(**tup)
    rest = {k: tuple(v) if isinstance(v, list) else v
            for k, v in block.items() if k != "backbone"}
    return module.KMaxConfig(backbone=backbone, **rest)


def state_dicts(config: dict, seed: int, device):
    """{"clip": ..., "kmax": ... (when the configuration has kMaX)}."""
    out = {"clip": weights.clip_state_dict(
        ref_clip.ClipShape(**config["clip"]), seed, device)}
    if "kmax" in config:
        out["kmax"] = weights.kmax_state_dict(
            kmax_config(ref_kmax, config["kmax"]), config["weights"], seed,
            device)
    return out


def port_models(config: dict, seed: int, device, say=lambda msg: None):
    """(ClipEngine, KmaxSegmenter or None, FusionConfig) of the port;
    `say` hears when each part is ready."""
    from spatially_aware_ai_tpu_torch.models.clip.engine import ClipEngine
    from spatially_aware_ai_tpu_torch.models.clip.model import CLIPConfig
    from spatially_aware_ai_tpu_torch.models.kmax import convnext as pcn
    from spatially_aware_ai_tpu_torch.models.kmax import model as pkm
    from spatially_aware_ai_tpu_torch.pipeline import FusionConfig

    dtype = {"float32": torch.float32,
             "bfloat16": torch.bfloat16}[config["dtype"]]
    sds = state_dicts(config, seed, device)
    say("weights drawn")
    # the engines' modules are made on the device (their own initial
    # values are overwritten by the state dicts at once)
    with torch.device(device):
        engine = ClipEngine(CLIPConfig(**config["clip"]), sds.pop("clip"),
                            compute_dtype=dtype, device=device)
        say("CLIP engine built")
        seg = None
        if "kmax" in config:
            mod = type("kmax_module", (),
                       {"ConvNeXtConfig": pcn.ConvNeXtConfig,
                        "KMaxConfig": pkm.KMaxConfig})
            seg = pkm.KmaxSegmenter(kmax_config(mod, config["kmax"]),
                                    sds.pop("kmax"), device=device,
                                    compute_dtype=dtype)
    fusion = FusionConfig(**config["fusion"])
    return engine, seg, fusion


def reference_models(config: dict, seed: int, device):
    """(reference CLIP, reference KmaxSegmenter or None), from the same
    seeded state dicts the port was given."""
    sds = state_dicts(config, seed, device)
    with torch.device(device):
        clip = ref_clip.CLIP(ref_clip.ClipShape(**config["clip"]))
        clip.load_state_dict(sds.pop("clip"))
        clip.eval().requires_grad_(False)
        seg = None
        if "kmax" in config:
            seg = ref_kmax.KmaxSegmenter(
                kmax_config(ref_kmax, config["kmax"]), sds.pop("kmax"),
                device=device)
    return clip, seg


def fusion_params(config: dict) -> dict:
    f = config["fusion"]
    return {"voxel_size": f["voxel_size"], "trunc_vox": f["trunc_vox"],
            "max_depth": f["max_depth"], "patch_size": f["clip_patch_size"],
            "patch_stride": f["clip_patch_stride"],
            "chunk": f["frame_chunk"]}


def shapes_of(config: dict):
    """The reference's shape objects, for counting operations."""
    kcfg = (kmax_config(ref_kmax, config["kmax"]) if "kmax" in config
            else None)
    return ref_clip.ClipShape(**config["clip"]), kcfg

