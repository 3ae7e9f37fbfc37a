"""The benchmark's arithmetic against hand counts at small shapes, and the
rule that a run loads nothing of JAX or the JAX package."""
import json
import os
import subprocess
import sys

import pytest

from perfbench.harness import cli
from perfbench.metrics import flops, roofline
from perfbench.tests import tiny


def test_b2_operations_and_bytes_by_hand():
    # M = 4 rows, D = 2, H = 8: two products of 2*4*2*8 = 128 each
    assert roofline.b2_flops(4, 2, 8) == 256
    # x and residual 4*2 each, out 4*2, w1 + w2 2*2*8, vectors 3*2 + 8 + 2
    assert roofline.b2_bytes(4, 2, 8, 4, False, True) == 4 * (
        8 + 8 + 8 + 32 + 6 + 8 + 2)
    # x is the residual: read once; no gamma
    assert roofline.b2_bytes(4, 2, 8, 2, True, False) == 2 * (
        8 + 8 + 32 + 6 + 8)


def test_b2_bound_is_the_larger_of_the_two():
    big = {"M": 14000, "D": 768, "H": 3072, "esize": 4, "dtype": "float32",
           "same_residual": True, "gamma": False}
    ops = roofline.b2_flops(14000, 768, 3072) / 495e12
    assert roofline.b2_bound_s(big) == pytest.approx(ops)
    small = dict(big, M=8)
    by_bytes = roofline.b2_bytes(8, 768, 3072, 4, True, False) / 3.35e12
    assert roofline.b2_bound_s(small) == pytest.approx(by_bytes)


def _vision_flops_by_hand(c, tiles):
    g = c["image_size"] // c["patch_size"]
    T, w = g * g + 1, c["vision_width"]
    stem = 2 * g * g * 3 * c["patch_size"] ** 2 * w
    block = (2 * T * w * 3 * w          # qkv
             + 2 * 2 * T * T * w        # q k^T and att v
             + 2 * T * w * w            # out proj
             + 2 * 2 * T * w * 4 * w)   # the MLP's two products
    return tiles * (stem + c["vision_layers"] * block
                    + 2 * w * c["embed_dim"])


def test_scan_flops_by_hand_without_labels():
    cfg = tiny.config("clip_vit_b32.f32")
    # 384 x 512 frames, 256 / 128 tiles: 2 x 3 tiles a frame
    got = flops.per_scan(cfg, 5, 384, 512)
    assert got == 5 * _vision_flops_by_hand(cfg["clip"], 6)


def test_scan_flops_count_kmax_once_a_frame():
    cfg = tiny.config("clip_vit_b32_kmax_convnext_l.f32")
    one = flops.per_scan(cfg, 1, 384, 512)
    three = flops.per_scan(cfg, 3, 384, 512)
    clip_only = _vision_flops_by_hand(cfg["clip"], 6)
    assert three == 3 * one and one > clip_only


def test_banned_names_are_compared_whole():
    assert cli.banned_modules(["spatially_aware_ai_tpu_torch.pipeline",
                               "torch", "jaxtyping"]) == []
    assert cli.banned_modules(["jax.numpy", "flax.linen",
                               "spatially_aware_ai_tpu.pipeline"]) == [
        "flax", "jax", "spatially_aware_ai_tpu"]


_DRIVE = """
import json, sys, time, torch
sys.path.insert(0, {root!r})
from perfbench.harness import cli
from perfbench.tests import tiny
cell, config, traffic, limits, metrics = tiny.cell({workload!r})
cli.runner(traffic)(
    cell=cell, config=config, traffic=traffic, limits=limits,
    metrics=metrics, seed=7, seconds=2.0, trace=False,
    device=torch.device("cpu"), root={root!r}, setup_clock=time.perf_counter)
print(json.dumps(cli.banned_modules()))
"""


@pytest.mark.parametrize("workload", ["scan.kmax_f32", "scan.clip_f32"])
def test_a_run_loads_no_jax(workload, tmp_path):
    """Drive a cell at a small size on the CPU in a fresh process, then
    look at sys.modules by whole top-level names."""
    env = dict(os.environ, TMPDIR=str(tmp_path))
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run(
        [sys.executable, "-c", _DRIVE.format(root=tiny.ROOT,
                                             workload=workload)],
        capture_output=True, text=True, env=env, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_run_refuses_a_machine_without_a_card(tmp_path):
    """No CPU fallback: without CUDA the command exits non-zero and prints
    no result line."""
    out = subprocess.run(
        [sys.executable, os.path.join(tiny.ROOT, "perfbench", "run.py"),
         "--workload", "scan.clip_f32", "--seed", "3", "--seconds", "1",
         "--trace", "0"], cwd=tiny.ROOT, capture_output=True, text=True,
        env=dict(os.environ, TMPDIR=str(tmp_path), CUDA_VISIBLE_DEVICES=""),
        timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
