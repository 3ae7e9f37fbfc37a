"""The control of every cell comes out not correct: the reference put in
the program's place and computed with TF32 (the precision below the
configurations' float32), held to the cell's own limits. TF32 exists only
on the card, so these run there (`-m cuda`), at a size a test run holds:
the cells' code paths at the smallest widths the card's kernels take."""
import time

import pytest

from perfbench.harness import cli
from perfbench.tests import tiny

CARD_CLIP = {"embed_dim": 64, "image_size": 224, "patch_size": 32,
             "vision_width": 128, "vision_layers": 2, "vision_heads": 2,
             "vocab_size": 49408, "context_length": 77, "text_width": 128,
             "text_heads": 2, "text_layers": 2, "quick_gelu": True}
CARD_BACKBONE = {"depths": [1, 1, 2, 1], "dims": [64, 128, 192, 256]}


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["scan.kmax_f32", "scan.clip_f32"])
def test_control_is_not_correct(workload, card, tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    cell, config, traffic, limits, metrics = tiny.cell(workload)
    config["clip"] = dict(CARD_CLIP)
    if "kmax" in config:
        config["kmax"]["backbone"] = dict(CARD_BACKBONE)
    traffic["scene"]["frames"] = 8
    result = cli.runner(traffic)(
        cell=cell, config=config, traffic=traffic, limits=limits,
        metrics=metrics, seed=2 ** 31 + 41, seconds=0.0, trace=False,
        device=card, root=tiny.ROOT, setup_clock=time.perf_counter,
        side="control")
    assert not result["correct"]
