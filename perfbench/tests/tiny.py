"""Small sizes of the cells' configurations and traffic, for CPU tests:
the same code paths at widths and frame sizes a test run can hold."""
import copy
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

CLIP = {"embed_dim": 32, "image_size": 224, "patch_size": 56,
        "vision_width": 64, "vision_layers": 2, "vision_heads": 4,
        "vocab_size": 49408, "context_length": 77, "text_width": 64,
        "text_heads": 4, "text_layers": 2, "quick_gelu": True}
KMAX = {"backbone": {"depths": [1, 1, 2, 1], "dims": [16, 32, 48, 64]},
        "num_queries": 16, "dec_dim": 32, "num_heads": 4,
        "dec_blocks": [1, 1, 1], "mask_dim": 32, "pd_dims": [32, 24, 16, 16],
        "pd_blocks": [1, 2, 1, 1], "aspp_rates": [1, 2, 3],
        "axial_span": 16, "test_long_edge": 129}
SCENE = {"frames": 6, "width": 512, "height": 384}


def load(*parts):
    with open(os.path.join(ROOT, *parts)) as f:
        return json.load(f)


def config(name: str) -> dict:
    c = copy.deepcopy(load("perfbench", "configs", f"{name}.json"))
    c["clip"] = dict(CLIP)
    if "kmax" in c:
        c["kmax"] = dict(c["kmax"], **copy.deepcopy(KMAX))
    # the card's default integrator, taken on the CPU too
    c["fusion"].update(voxel_size=0.1, frame_chunk=4, integrator="sparse")
    return c


def traffic(name: str) -> dict:
    t = copy.deepcopy(load("perfbench", "traffic", f"{name}.json"))
    t["scene"].update(SCENE)
    t["warmup_frames"] = 2
    return t


def cell(workload: str):
    bench = load("BENCHMARK.json")
    c = {w["name"]: w for w in bench["workloads"]}[workload]
    metrics = {"end_to_end": [m for m in bench["end_to_end"]
                              if workload in m.get("workloads", [workload])],
               "per_layer": [m for m in bench["per_layer"]
                             if workload in m.get("workloads", [workload])]}
    limits = load("perfbench", "limits", f"{workload}.json")
    return c, config(c["config"]), traffic(c["traffic"]), limits, metrics
