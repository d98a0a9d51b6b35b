"""A run's correctness check, driven on the CPU at a small size: a sound
program passes; each fault a cell can have, planted under the timed path,
makes ``correct`` false."""

import pytest
import torch

import detjax_torch.modeling
import detjax_torch.train.step
from benchmark import harness
from benchmark.run import execute
from benchmark.tests.small import small_run
from detjax_torch.ops.nms import Detections
from detjax_torch.train.optim import OptaxOptimizer


def test_sound_training_run_is_correct():
    res = execute(small_run("r50_1024-train", seconds=0.5))
    assert res["correct"], res["checks"]


def test_training_state_left_unchanged(monkeypatch):
    monkeypatch.setattr(OptaxOptimizer, "step", lambda self, closure=None:
                        None)
    res = execute(small_run("r50_1024-train", seconds=0.5))
    assert not res["correct"]
    assert res["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_training_half_batch(monkeypatch):
    step = detjax_torch.train.step.train_step

    def half(state, batch, **kw):
        b = batch["images"].shape[0] // 2
        return step(state, {k: v[:b] for k, v in batch.items()}, **kw)
    monkeypatch.setattr(detjax_torch.train.step, "train_step", half)
    res = execute(small_run("r50_1024-train", seconds=0.5))
    assert not res["correct"], res["checks"]


def test_sound_serving_run_is_correct():
    res = execute(small_run("r101_1024-serve-closed", seconds=1.0))
    assert res["correct"], res["checks"]


def test_sound_open_loop_run_is_correct():
    res = execute(small_run("r50_1024-serve-rate", seconds=1.0))
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0


def _broken_detect(monkeypatch, fault):
    detect = detjax_torch.modeling.detect_u8

    def broken(model, canvases, *a, **kw):
        return fault(detect(model, canvases, *a, **kw))
    monkeypatch.setattr(detjax_torch.modeling, "detect_u8", broken)


def test_serving_half_batch(monkeypatch):
    def fault(d):
        half = d.boxes.shape[0] // 2
        keep = (torch.arange(d.boxes.shape[0]) < half).to(d.boxes.device)
        return Detections(d.boxes * keep[:, None, None],
                          d.scores * keep[:, None],
                          torch.where(keep[:, None], d.labels, -1),
                          d.num_valid * keep)
    _broken_detect(monkeypatch, fault)
    res = execute(small_run("r101_1024-serve-closed", seconds=1.0))
    assert not res["correct"], res["checks"]


def test_serving_altered_answer(monkeypatch):
    def fault(d):
        labels = d.labels.clone()
        labels[:, 0] = (labels[:, 0] + 1) % 80
        return Detections(d.boxes, d.scores, labels, d.num_valid)
    _broken_detect(monkeypatch, fault)
    res = execute(small_run("r101_1024-serve-closed", seconds=1.0))
    assert not res["correct"], res["checks"]
    assert res["checks"]["logit_gap"]["value"] > \
        res["checks"]["logit_gap"]["limit"]


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  harness.manifest()["workloads"]])
def test_traced_run_reports_its_host_side_metrics(cell):
    """Without a device trace (the CPU) the spans, counters and host
    clocks are still read; the device's readers find nothing and are left
    out."""
    res = execute(small_run(cell, seconds=1.0, trace=True))
    assert res["correct"], res["checks"]
    host = {m["name"] for m in harness.manifest()["per_layer"]
            if cell in m["workloads"] and m["source"] != "device_trace"}
    assert host and host <= set(res["metrics"]), res["metrics"]
    assert not any(k.startswith(("idle_pct", "mfu")) for k in res["metrics"])
