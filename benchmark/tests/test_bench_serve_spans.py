"""The serving readers over a synthetic device trace and planted spans:
the clocks tied by the fetches, the idle time put down to the worker's
phases, and None wherever the ties are too few or do not agree."""

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.metrics import _serve_spans
from detjax_torch.utils import profiling

OFF_US = 7_345_678.25  # host us minus device us
W0, W1 = 1_000.0, 2_001_000.0
PERIOD, BATCH = 100_000.0, 32
NEW = ("queue_wait_ms", "dispatch_ms", "dispatch_fill", "idle_gather_pct",
       "idle_assemble_pct", "idle_dispatch_pct", "idle_finalize_pct")


def _ns(device_us):
    return int(round((device_us + OFF_US) * 1e3))


def _scene(seed=0, scramble=False, batches=20):
    """A trace of ``batches`` batches a period apart and the server's
    spans over it: upload, forward, four copies back; the worker fetches,
    finalizes, gathers, assembles and dispatches the next."""
    rng = np.random.default_rng(seed)
    events, spans = [], []
    t = W0 + 5_000.0
    end_prev = W0
    for k in range(batches):
        n = BATCH if k % 2 else BATCH // 2
        up0, up1 = t, t + 10_000.0
        fwd1 = up1 + 50_000.0
        copies = [fwd1 + 40.0 * i + 20.0 for i in range(4)]
        events += [("Memcpy HtoD (Pageable -> Device)", up0, up1),
                   ("detect_forward", up1, fwd1)]
        events += [("Memcpy DtoH (Device -> Pageable)", c - 20.0, c)
                   for c in copies]
        fetch_end = copies[-1] + rng.uniform(2.0, 8.0)
        if scramble:
            fetch_end = rng.uniform(W0, W1)
        fin_end = fetch_end + 500.0
        nxt = t + PERIOD
        spans += [("serve.dispatch", up0 - 1_000.0, up1,
                   {"batch": k, "n": n}),
                  ("serve.gather", end_prev, up0 - 3_000.0, {"batch": k}),
                  ("serve.assemble", up0 - 3_000.0, up0 - 1_000.0,
                   {"batch": k, "n": n}),
                  ("serve.fetch", up1 + 1_000.0, fetch_end, {}),
                  ("serve.finalize", up1, fin_end, {"batch": k - 1,
                                                      "n": n})]
        spans += [("serve.queue_wait", up0 - 3_000.0 - 30_000.0,
                   up0 - 3_000.0, {"request": k * BATCH + i, "batch": k})
                  for i in range(n)]
        end_prev, t = fin_end, nxt
    spans.append(("serve.gather", end_prev, W1 + 1_000.0,
                  {"batch": batches}))
    tr = harness.DeviceTrace(torch.device("cpu"))
    tr.window = (W0, W1)
    tr.events = sorted(((nm, s, e) for nm, s, e in events
                        if s >= W0 and e <= W1), key=lambda ev: ev[1])
    tr.host = [(W0 + OFF_US) / 1e6, (W1 + OFF_US) / 1e6]
    rec = {"trace": tr, "batch": BATCH, "images": 0, "model": {},
           "batch_sizes": [], "flops_forward": 0.0, "kept": [],
           "candidates": 1000, "max_det": 100, "latency_ms": [],
           "window_s": tr.window_s}
    return rec, spans


@pytest.fixture
def planted():
    """Plant spans through the program's recorder."""
    def plant(spans):
        profiling.clear_spans()
        profiling.enable_spans(True)
        for name, s, e, ids in spans:
            profiling.add_span(name, _ns(s), _ns(e), **ids)
        profiling.enable_spans(False)
    yield plant
    profiling.enable_spans(False)
    profiling.clear_spans()


def test_fetches_recover_the_offset(planted):
    rec, spans = _scene()
    planted(spans)
    al = _serve_spans.align(rec)
    assert al is not None and al.pairs >= 19
    assert abs(al.offset_us - OFF_US) < 10.0
    assert al.spread_us < 5.0
    assert _serve_spans.align(rec) is al  # computed once a record


@pytest.mark.parametrize("case", ["four_fetches", "scrambled", "none"])
def test_too_few_or_scrambled_fetches_give_none(planted, case):
    rec, spans = _scene(batches=4 if case == "four_fetches" else 20,
                        scramble=case == "scrambled", seed=3)
    planted([] if case == "none" else spans)
    assert _serve_spans.align(rec) is None
    got = harness.read_metrics("r50_1024-serve-rate", rec)
    assert got.keys().isdisjoint(f"{m}.serve_rate" for m in NEW)


@pytest.mark.parametrize("cell,suffix", [("r50_1024-serve-rate",
                                          "serve_rate"),
                                         ("r101_1024-serve-closed",
                                          "serve_closed")])
def test_readers_on_planted_spans(planted, cell, suffix):
    rec, spans = _scene()
    planted(spans)
    got = {k: v["value"] for k, v in
           harness.read_metrics(cell, rec).items()}
    assert {f"{m}.{suffix}" for m in NEW} <= set(got)
    assert got[f"queue_wait_ms.{suffix}"] == pytest.approx(30.0)
    assert got[f"dispatch_ms.{suffix}"] == pytest.approx(11.0)
    assert got[f"dispatch_fill.{suffix}"] == pytest.approx(75.0)
    idle = got[f"idle_pct.{suffix}"]
    parts = [got[f"idle_{p}_pct.{suffix}"]
             for p in ("gather", "assemble", "dispatch", "finalize")]
    assert sum(parts) == pytest.approx(idle)  # the phases cover the window
    window = W1 - W0
    # each of the 20 batches: 2 ms assembling, 1 ms dispatching before the
    # upload, and finalizing 60 us between its copies back and 2-8 us
    # after them to the fetch's end, then 0.5 ms; the fit's offset is the
    # median fetch's lag behind its copy, so a boundary may move by 8 us
    us = 100 * 20 / window
    assert parts[1] == pytest.approx(2_000.0 * us)
    assert parts[2] == pytest.approx(1_000.0 * us, abs=8.0 * us)
    assert 554.0 * us < parts[3] < 576.0 * us


def test_idle_goes_to_the_innermost_span():
    spans = [("serve.finalize", 0.0, 10.0, {}),
             ("serve.fetch", 2.0, 6.0, {}),
             ("serve.gather", 10.0, 20.0, {}),
             ("serve.queue_wait", 0.0, 20.0, {})]
    idle = _serve_spans.idle_intervals([("k", 4.0, 5.0), ("k", 12.0, 30.0)],
                                       (0.0, 30.0))
    assert idle == [(0.0, 4.0), (5.0, 12.0)]
    by = _serve_spans.attribute(idle, spans)
    assert by == {"finalize": 9.0, "gather": 2.0, "assemble": 0.0,
                  "dispatch": 0.0}
