"""A run's `correct` against the timed path broken underneath it, at a
small size on the CPU (the harness's look for a card skipped, the rest of
the run driven as the card runs it). Each fault must come out not
correct; the sound path must come out correct. The cells have one chip,
so no exchange between chips can be left out."""
import time

import pytest
import torch

from perfbench.harness import cli
from perfbench.tests import tiny


def _run(workload, tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    cell, config, traffic, limits, metrics = tiny.cell(workload)
    return cli.runner(traffic)(
        cell=cell, config=config, traffic=traffic, limits=limits,
        metrics=metrics, seed=2 ** 31 + 21,
        seconds=0.0, trace=False,
        device=torch.device("cpu"), root=tiny.ROOT,
        setup_clock=time.perf_counter)


def _state_unchanged(monkeypatch):
    from spatially_aware_ai_tpu_torch import pipeline

    monkeypatch.setattr(pipeline, "integrate_frames_sparse",
                        lambda grid, batch, **kw: grid)


def _half_batch(monkeypatch):
    import dataclasses

    from spatially_aware_ai_tpu_torch import pipeline

    fn = pipeline.integrate_frames_sparse

    def half(grid, batch, **kw):
        valid = batch.frame_valid.clone()
        valid[valid.shape[0] // 2:] = False
        return fn(grid, dataclasses.replace(batch, frame_valid=valid), **kw)

    monkeypatch.setattr(pipeline, "integrate_frames_sparse", half)


def _features_altered(monkeypatch):
    from spatially_aware_ai_tpu_torch.models.clip.engine import ClipEngine

    fn = ClipEngine.img_inference_tiled_batch
    monkeypatch.setattr(ClipEngine, "img_inference_tiled_batch",
                        lambda self, *a, **kw: fn(self, *a, **kw) * 1.01)


def _labels_altered(monkeypatch):
    from spatially_aware_ai_tpu_torch.models.kmax.model import KmaxSegmenter

    fn = KmaxSegmenter.run_on_batch_fused_labels

    def shifted(self, *a, **kw):
        out = fn(self, *a, **kw).clone()
        out[:, : out.shape[1] // 2] = (out[:, : out.shape[1] // 2] + 1) % 133
        return out

    monkeypatch.setattr(KmaxSegmenter, "run_on_batch_fused_labels", shifted)


def _query_altered(monkeypatch):
    from spatially_aware_ai_tpu_torch.models.clip.engine import ClipEngine

    fn = ClipEngine.run_query
    monkeypatch.setattr(ClipEngine, "run_query",
                        lambda self, *a: fn(self, *a)[:, ::-1].copy())


def _layer_altered(monkeypatch):
    from spatially_aware_ai_tpu_torch.models.kmax.model import (
        KMaxTransformerLayer)

    fn = KMaxTransformerLayer.forward
    monkeypatch.setattr(KMaxTransformerLayer, "forward",
                        lambda self, *a: fn(self, *a) * 1.01)


def _logits_altered(monkeypatch):
    from spatially_aware_ai_tpu_torch.models.kmax.model import KMaxDeepLab

    fn = KMaxDeepLab._head

    def altered(self, feats):
        cls, masks = fn(self, feats)
        return cls, masks * 1.01

    monkeypatch.setattr(KMaxDeepLab, "_head", altered)


@pytest.mark.parametrize("workload", ["scan.kmax_f32", "scan.clip_f32"])
def test_sound_path_is_correct(workload, tmp_path, monkeypatch):
    assert _run(workload, tmp_path, monkeypatch)["correct"]


@pytest.mark.parametrize("workload,fault", [
    ("scan.kmax_f32", _state_unchanged),
    ("scan.kmax_f32", _half_batch),
    ("scan.kmax_f32", _features_altered),
    ("scan.kmax_f32", _labels_altered),
    ("scan.kmax_f32", _query_altered),
    ("scan.kmax_f32", _layer_altered),
    ("scan.kmax_f32", _logits_altered),
    ("scan.clip_f32", _state_unchanged),
    ("scan.clip_f32", _half_batch),
    ("scan.clip_f32", _features_altered),
])
def test_fault_is_not_correct(workload, fault, tmp_path, monkeypatch):
    fault(monkeypatch)
    result = _run(workload, tmp_path, monkeypatch)
    failed = [k for k, c in result["checks"].items() if not c["passes"]]
    assert not result["correct"] and failed


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 5])
def test_kmax_sample_meets_every_chunk_and_slot(seed):
    from perfbench.harness.scan import kmax_sample

    frames = kmax_sample(seed, 96, 8, 12)
    assert len(frames) == 12
    assert sorted({f // 8 for f in frames}) == list(range(12))
    assert sorted({f % 8 for f in frames}) == list(range(8))
