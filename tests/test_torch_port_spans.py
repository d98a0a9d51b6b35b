"""The port's span recorder (``detjax_torch.utils.profiling``) and the
serving layer's spans and counters (``MicroBatcher``, ``/healthz``), on
the CPU."""

import json
import sys
import threading
import time
import urllib.request
from collections import Counter

import numpy as np
import pytest
import torch

import detjax_torch
from detjax_torch.ops.nms import Detections
from detjax_torch.serve import DetectionServer, MicroBatcher, finalize_batch
from detjax_torch.utils import profiling

torch.set_num_threads(1)

PHASES = ("serve.gather", "serve.assemble", "serve.dispatch",
          "serve.finalize")


@pytest.fixture
def spans_on():
    profiling.clear_spans()
    profiling.enable_spans(True)
    try:
        yield
    finally:
        profiling.enable_spans(False)
        profiling.clear_spans()


@pytest.fixture
def spans_off():
    profiling.enable_spans(False)
    profiling.clear_spans()
    yield
    profiling.clear_spans()


def test_spans_off_record_nothing(spans_off):
    assert profiling.clock() == 0
    with profiling.span("a", batch=1):
        assert profiling.open_span("b") == 0
    profiling.add_span("c", 1, 2, request=3)
    phases = profiling.Phases()
    phases.enter("d", 1, 2)
    phases.enter(None)
    assert profiling.spans() == []


def test_span_nesting_ids_and_parents(spans_on):
    with profiling.span("outer", batch=7):
        with profiling.span("inner", n=3):
            pass
        t = profiling.open_span("opened")
        profiling.close_span(t, request=9)
        profiling.add_span("elsewhere", 5, 6, request=1)
    inner, opened, elsewhere, outer = profiling.spans()
    assert (inner.name, inner.parent, inner.ids) == ("inner", "outer",
                                                     {"n": 3})
    assert (opened.parent, opened.ids) == ("outer", {"request": 9})
    assert (outer.parent, outer.ids) == (None, {"batch": 7})
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    assert (elsewhere.start_ns, elsewhere.end_ns, elsewhere.parent,
            elsewhere.ids) == (5, 6, None, {"request": 1})
    assert {s.thread for s in profiling.spans()} == {threading.get_ident()}


def test_phases_abut_and_parent_what_opens_inside(spans_on):
    phases = profiling.Phases()
    phases.enter("p1", batch=1)
    with profiling.span("child"):
        pass
    phases.enter("p2", batch=1, n=4)
    t = profiling.open_span("left_open")  # a phase change ends it unrecorded
    assert t
    phases.enter(None)
    child, p1, p2 = profiling.spans()
    assert child.parent == "p1" and p1.parent is None
    assert p1.end_ns == p2.start_ns
    assert (p1.ids, p2.ids) == ({"batch": 1}, {"batch": 1, "n": 4})
    assert p1.start_ns <= child.start_ns <= child.end_ns <= p1.end_ns


def test_buffer_keeps_the_newest(spans_on):
    for i in range(profiling.MAX_SPANS + 10):
        profiling.add_span("s", i, i + 1)
    got = profiling.spans()
    assert len(got) == profiling.MAX_SPANS
    assert got[0].start_ns == 10 and got[-1].start_ns == (
        profiling.MAX_SPANS + 9)


def test_appends_from_many_threads_are_kept(spans_on):
    threads_n, each = 16, 500
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            for i in range(each):
                with profiling.span("w", request=k * each + i):
                    pass

        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(threads_n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    got = profiling.spans()
    assert sorted(s.ids["request"] for s in got) == list(
        range(threads_n * each))
    assert all(s.parent is None for s in got)


def test_a_profiler_session_turns_recording_on(spans_off):
    with profiling.span("before"):
        pass
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        assert profiling.clock()
        with profiling.span("during", batch=2):
            pass
    assert profiling.clock() == 0
    with profiling.span("after"):
        pass
    assert [(s.name, s.ids) for s in profiling.spans()] == [
        ("during", {"batch": 2})]


def _fake_engine(seen, fail=False):
    """A split-phase engine over CPU tensors: dispatch keeps each batch's
    canvas values and returns detections whose scores are them; finalize
    is the server's own."""
    def dispatch(batch):
        if fail:
            raise RuntimeError("dispatch failed")
        seen.append(batch[:, 0, 0, 0].copy())
        b = batch.shape[0]
        return Detections(torch.zeros(b, 2, 4),
                          torch.as_tensor(batch[:, 0, 0, :2],
                                          dtype=torch.float32),
                          torch.zeros(b, 2, dtype=torch.int64),
                          torch.full((b,), 2, dtype=torch.int32))
    return dispatch, finalize_batch


def _serve_requests(mb, values):
    out = {}

    def go(v):
        try:
            out[v] = mb.submit(np.full((4, 4, 3), v, np.uint8))
        except RuntimeError as e:
            out[v] = e

    threads = [threading.Thread(target=go, args=(v,)) for v in values]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    mb.close()
    return out


def _batcher(seen, **kw):
    dispatch, finalize = _fake_engine(seen, **kw)
    return MicroBatcher(None, 4, (4, 4), max_wait_ms=20.0,
                        dispatch=dispatch, finalize=finalize)


def test_microbatcher_spans_each_batch_and_request_once(spans_on):
    seen = []
    mb = _batcher(seen)
    values = list(range(1, 11))
    out = _serve_requests(mb, values)
    assert all(out[v][1][0] == v for v in values)
    got = profiling.spans()
    by = {name: [s for s in got if s.name == name]
          for name in PHASES + ("serve.fetch", "serve.queue_wait")}
    fills = [int(np.count_nonzero(b)) for b in seen]
    ids = list(range(1, len(seen) + 1))
    for name in ("serve.assemble", "serve.dispatch", "serve.finalize"):
        assert sorted(s.ids["batch"] for s in by[name]) == ids, name
        assert sorted((s.ids["batch"], s.ids["n"]) for s in by[name]) == \
            list(zip(ids, fills)), name
    assert len(by["serve.fetch"]) == len(seen)
    for s in by["serve.fetch"]:
        assert s.parent == "serve.finalize"
        assert any(f.start_ns <= s.start_ns <= s.end_ns <= f.end_ns
                   for f in by["serve.finalize"])
    for k in ids:  # loop order within each batch
        a, d, f = (next(s for s in by[n] if s.ids["batch"] == k)
                   for n in PHASES[1:])
        assert a.end_ns <= d.start_ns and d.end_ns <= f.start_ns
    waits = by["serve.queue_wait"]
    assert sorted(s.ids["request"] for s in waits) == values
    assert Counter(s.ids["batch"] for s in waits) == dict(zip(ids, fills))
    assert all(s.start_ns <= s.end_ns for s in waits)
    assert (mb.batches, mb.slots) == (len(seen), sum(fills))
    assert mb.slots == len(values) == mb.completed


def test_worker_phases_cover_its_loop_with_no_gap(spans_on):
    mb = _batcher([])
    _serve_requests(mb, list(range(1, 8)))
    worker = sorted((s for s in profiling.spans() if s.name in PHASES),
                    key=lambda s: s.start_ns)
    assert {s.name for s in worker} == set(PHASES)
    assert len({s.thread for s in worker}) == 1
    for prev, nxt in zip(worker, worker[1:]):
        assert prev.end_ns == nxt.start_ns, (prev, nxt)


def test_microbatcher_records_nothing_when_off(spans_off):
    seen = []
    mb = _batcher(seen)
    out = _serve_requests(mb, [1, 2, 3, 4, 5])
    assert sorted(o[1][0] for o in out.values()) == [1, 2, 3, 4, 5]
    assert profiling.spans() == []
    assert mb.batches == len(seen) and mb.slots == 5


def test_a_failed_dispatch_counts_no_batch(spans_on):
    mb = _batcher([], fail=True)
    out = _serve_requests(mb, [1, 2, 3])
    assert all(isinstance(o, RuntimeError) for o in out.values())
    assert (mb.batches, mb.slots, mb.completed) == (0, 0, 3)
    names = Counter(s.name for s in profiling.spans())
    assert names["serve.dispatch"] >= 1
    assert names["serve.finalize"] == names["serve.fetch"] == 0


def _staging_engine(log, gate, work_s=0.005):
    """A split-phase engine whose handle keeps the dispatched batch array
    itself, not a copy: dispatch waits for ``gate``; finalize, after
    ``work_s`` of stand-in device work, logs whether the array still
    holds what was dispatched, and answers each slot with its row's first
    value."""
    def dispatch(batch):
        assert gate.wait(30)
        log.append({"buffer": batch.ctypes.data})
        return batch, batch.copy(), len(log)

    def finalize(handle, n):
        batch, sent, k = handle
        time.sleep(work_s)
        log[k - 1]["intact"] = np.array_equal(batch, sent)
        return [int(sent[i, 0, 0, 0]) for i in range(n)]
    return dispatch, finalize


def _loaded(values, batch_size=4):
    """Serve a canvas full of each value from its own thread through
    ``_staging_engine`` under a loaded queue: the first dispatch waits
    until every request is queued. (answers, log, batcher)"""
    log, gate = [], threading.Event()
    dispatch, finalize = _staging_engine(log, gate)
    mb = MicroBatcher(None, batch_size, (4, 4), max_wait_ms=20.0,
                      max_queue_batches=len(values) // batch_size + 1,
                      dispatch=dispatch, finalize=finalize)
    out = {}

    def go(v):
        out[v] = mb.submit(np.full((4, 4, 3), v, np.uint8))

    threads = [threading.Thread(target=go, args=(v,)) for v in values]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 30
    while mb.submitted < len(values) and time.monotonic() < deadline:
        time.sleep(0.001)
    gate.set()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    mb.close()
    return out, log, mb


def test_a_buffer_in_flight_is_never_written(spans_off):
    values = list(range(1, 49))
    out, log, mb = _loaded(values)
    assert all(out[v] == v for v in values)  # each its own batch's row
    assert all(entry["intact"] for entry in log)
    assert {e["buffer"] for e in log} == {b.ctypes.data for b in mb._buffers}
    assert len(mb._buffers) == 2
    assert mb.batches == len(log) and mb.slots == len(values)
    # every batch after the first was assembled while one was in flight
    assert mb.ahead == mb.batches - 1 >= 10


def test_padding_rows_are_zero_after_a_fuller_batch(spans_off):
    """A first request holds the engine while four more queue, so they
    make one full batch; two single requests follow, the second in the
    buffer the full batch used."""
    seen, where = [], []
    entered, gate = threading.Event(), threading.Event()

    def run_batch(batch):
        entered.set()
        assert gate.wait(30)
        seen.append(batch.copy())
        where.append(batch.ctypes.data)
        return [int(batch[i, 0, 0, 0]) for i in range(batch.shape[0])]

    mb = MicroBatcher(run_batch, 4, (4, 4), max_wait_ms=20.0)
    out = {}

    def go(v):
        out[v] = mb.submit(np.full((4, 4, 3), v, np.uint8))

    try:
        threads = [threading.Thread(target=go, args=(v,))
                   for v in (1, 11, 12, 13, 14)]
        threads[0].start()
        assert entered.wait(30)  # the engine holds request 1
        for t in threads[1:]:
            t.start()
        deadline = time.monotonic() + 30
        while mb.submitted < 5 and time.monotonic() < deadline:
            time.sleep(0.001)
        gate.set()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        for v in (21, 31):
            go(v)
    finally:
        mb.close()
    assert all(out[v] == v for v in out) and len(out) == 7
    assert [int(np.count_nonzero(b[:, 0, 0, 0])) for b in seen] == [1, 4, 1, 1]
    assert where[3] == where[1] != where[2] == where[0]
    assert sorted(seen[1][:, 0, 0, 0]) == [11, 12, 13, 14]
    assert (seen[1] != 0).all()
    for b, v in zip(seen[2:], (21, 31)):
        assert (b[0] == v).all() and not b[1:].any()


def test_the_order_under_load_is_assemble_finalize_dispatch(spans_on):
    values = list(range(1, 41))
    out, log, mb = _loaded(values)
    assert all(out[v] == v for v in values)
    got = profiling.spans()
    by = {name: {s.ids["batch"]: s for s in got if s.name == name}
          for name in PHASES[1:]}
    ids = sorted(by["serve.dispatch"])
    assert ids == list(range(1, len(log) + 1))
    ahead = 0
    for k in ids[1:]:
        a, d = by["serve.assemble"][k], by["serve.dispatch"][k]
        f = by["serve.finalize"][k - 1]  # batch N, before N+1 goes out
        assert f.end_ns <= d.start_ns
        if a.start_ns < f.start_ns:  # assembled while N was in flight
            ahead += 1
            assert a.end_ns <= f.start_ns
    assert ahead == mb.ahead == len(ids) - 1


def test_healthz_reports_batches_and_slots(spans_on):
    cfg = detjax_torch.get_config(
        "retinanet_r50_640", **{
            "model.image_size": (32, 32), "model.num_classes": 2,
            "model.backbone_depth": 18, "model.dtype": "float32",
            "model.fpn_channels": 16, "model.head_channels": 16,
            "eval.pre_nms_top_k": 20, "eval.max_detections": 5})
    model = detjax_torch.build_model(cfg, seed=1, device="cpu")
    srv = DetectionServer(model, cfg, batch_size=2, max_wait_ms=5.0)
    ready = threading.Event()
    th = threading.Thread(target=srv.serve, args=("127.0.0.1", 0, ready),
                          kwargs={"warmup": False}, daemon=True)
    th.start()
    try:
        assert ready.wait(60)
        canvases = np.random.default_rng(0).integers(0, 256, (3, 32, 32, 3),
                                                      np.uint8)
        for c in canvases:
            srv.batcher.submit(c)
        url = f"http://127.0.0.1:{srv.port}/healthz"
        with urllib.request.urlopen(url, timeout=30) as r:
            health = json.loads(r.read())
    finally:
        srv.shutdown()
        th.join(timeout=10)
    assert not th.is_alive()
    dispatched = [s for s in profiling.spans() if s.name == "serve.dispatch"]
    assert health["batches"] == srv.batcher.batches == len(dispatched) == 3
    assert health["slots"] == srv.batcher.slots == sum(
        s.ids["n"] for s in dispatched) == 3
    assert health["submitted"] == health["completed"] == 3
    # one request at a time: nothing in flight while a batch is assembled
    assert health["ahead"] == srv.batcher.ahead == 0
