"""Requests into the program's micro-batching server,
``DetectionServer(model, cfg, engine="fp", batch_size=B).batcher.submit``,
from sender threads: an open loop (Poisson arrivals at the mix's rate,
each request timed from its due time) or a closed loop (a fixed pool of
clients, each sending its next canvas when the last returns).

Set-up makes the pool of letterboxed canvases and the weights, builds the
model and the server, runs the server's warm-up batch and then the mix
for ``warmup_s`` seconds; the window follows on the same stream. After the
window every request still in flight is waited for, the program is freed,
and a sample of the answers, drawn from the seed, is held against the
reference's detections of the same canvases.
"""

from __future__ import annotations

import gc
import math
import sys
import threading
import time
from typing import List

import numpy as np
import torch

from benchmark import counts, harness, weights
from benchmark.reference import model as R
from benchmark.reference import serve as RS
from benchmark.traffic import arrivals, scenes

MISSING_MS = 3.6e6  # the latency a refused or failed request counts as
DRAIN_S = 90.0  # how long after the window in-flight requests are awaited


def content_sizes(canvas_hw, sources_wh, min_max) -> List[List[int]]:
    """Each source (w, h) resized by the configuration's rule, shortest
    side to ``min_max[0]`` unless the longest would pass ``min_max[1]``,
    then that, and held top-left on the canvas: the content's (h, w)."""
    h, w = canvas_hw
    out = []
    for sw, sh in sources_wh:
        s = min(min_max[0] / min(sw, sh), min_max[1] / max(sw, sh),
                h / sh, w / sw)
        out.append([min(h, max(1, int(round(sh * s)))),
                    min(w, max(1, int(round(sw * s))))])
    return out


def batch_of(answer):
    """The device batch an answer came from: the server hands each slot a
    view of its batch's result arrays, so the view's base names the batch
    (None where the answer is no view)."""
    base = getattr(answer[0], "base", None)
    return None if base is None else id(base)


def _percentile(values, q: float) -> float:
    """Nearest-rank percentile."""
    v = sorted(values)
    return v[max(0, math.ceil(q / 100 * len(v)) - 1)]


def setup(r: harness.Run):
    import detjax_torch
    from detjax_torch.serve import DetectionServer

    conf, tr = r.config, r.traffic
    mc = conf["model"]
    cfg = harness.program_config(conf)
    gen = torch.Generator(device=r.device).manual_seed(int(r.seed) + 1)
    pool = scenes.canvases(tr["pool"], mc["image_size"], content_sizes(
        mc["image_size"], tr["source_sizes_wh"], tr["resize_min_max"]), gen, r.device)
    ref = R.build(mc, r.device)
    w0 = weights.make(ref, r.seed, pool[:tr["desaturate_images"]])
    model = detjax_torch.build_model(cfg, seed=0, device=r.device)
    model.load_state_dict(w0)
    del w0
    pool_np = pool.cpu().numpy()
    if r.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(r.device)
    server = DetectionServer(model, cfg, engine="fp",
                             batch_size=tr["batch"],
                             max_wait_ms=tr["max_wait_ms"])
    for _ in range(tr["warmup_batches"]):
        server.warmup()
    return pool, pool_np, ref, model, server


def finish(r: harness.Run, ref, model, server, pool, answers, reqs,
           window_idx, tracer, e2e: dict, latency_ms=None) -> dict:
    """Free the program, judge a sample of the window's answers, and make
    the result. ``latency_ms``: the open loop's latencies of the window,
    for the traced run's readers."""
    conf, tr = r.config, r.traffic
    peak = (torch.cuda.max_memory_allocated(r.device)
            if r.device.type == "cuda" else 0)
    batcher = server.batcher
    counters = (batcher.submitted, batcher.completed, batcher.rejected)
    server.shutdown()
    del server, model
    gc.collect()
    if r.device.type == "cuda":
        torch.cuda.empty_cache()
    ok_idx = [i for i in window_idx if reqs[i]["status"] == "ok"]
    rng = np.random.default_rng(int(r.seed) + 2)
    pick = rng.choice(len(ok_idx), size=min(tr["sample"], len(ok_idx)),
                      replace=False)
    chosen = [ok_idx[j] for j in sorted(pick)]
    canv = sorted({reqs[i]["canvas"] for i in chosen})
    slot = {c: k for k, c in enumerate(canv)}
    served = [[] for _ in canv]
    for i in chosen:
        served[slot[reqs[i]["canvas"]]].append(answers[i])
    notes = []
    numbers = RS.compare(ref, conf, pool[canv], served, notes)
    for n in notes[:8]:
        print(f"answer far from the reference: canvas {canv[n['canvas']]} "
              f"kept {n['kept']} gaps {n['gaps']}", file=sys.stderr)
    lost = sum(1 for q in reqs if q["status"] in ("pending", "error"))
    numbers["lost"] = float(lost)
    ok, shown = harness.checks(numbers, conf["limits"]["serve"])
    failed = sum(1 for i in window_idx if reqs[i]["status"] != "ok")
    print(f"server counters submitted/completed/rejected: {counters}; "
          f"sample {len(chosen)} answers of {len(canv)} canvases",
          file=sys.stderr)
    out = {"correct": ok and len(chosen) > 0,
           "attempted": len(window_idx), "failed": failed,
           "device": harness.device_info(r.device, peak), "checks": shown}
    if tracer is None:
        out["metrics"] = harness.e2e(r.cell["name"], e2e)
        return out
    mc = conf["model"]
    done = [reqs[i] for i in range(len(reqs)) if reqs[i]["status"] == "ok"
            and tracer.host[0] <= reqs[i]["done"] < tracer.host[1]]
    batches = {}
    for q in done:
        batches[q["batch"]] = batches.get(q["batch"], 0) + 1
    if None in batches:  # answers that are no views name no batch
        batches = {}
    record = {"trace": tracer, "batch": tr["batch"],
              "images": len(done), "model": mc,
              "batch_sizes": list(batches.values()),
              "flops_forward": counts.forward_flops(mc),
              "kept": [q["kept"] for q in done],
              "candidates": conf["eval"]["pre_nms_top_k"],
              "max_det": conf["eval"]["max_detections"],
              "window_s": tracer.window_s, "latency_ms": latency_ms or []}
    out["metrics"] = harness.read_metrics(r.cell["name"], record)
    out["device"].update(busy_s=tracer.busy_s(), window_s=tracer.window_s)
    if tracer.window is not None:
        out["breakdown"] = tracer.breakdown()
    return out


def run_open(r: harness.Run) -> dict:
    from detjax_torch.serve import Overloaded

    tr = r.traffic
    pool, pool_np, ref, model, server = setup(r)
    rate = float(tr["rate_img_s"])
    span = tr["warmup_s"] + r.seconds
    n = int(math.ceil(span * rate))
    rng = np.random.default_rng(int(r.seed))
    due = arrivals.poisson_offsets(n, rate, rng)
    order = arrivals.canvas_order(n, tr["pool"], rng)
    reqs = [{"status": "pending", "canvas": int(order[i])} for i in range(n)]
    answers = [None] * n
    nxt = [0]
    lock = threading.Lock()
    batcher = server.batcher

    def sender(t0):
        while True:
            with lock:
                i = nxt[0]
                nxt[0] += 1
            if i >= n:
                return
            q = reqs[i]
            q["due"] = t0 + due[i]
            wait = q["due"] - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            q["sent"] = time.perf_counter()
            try:
                answers[i] = batcher.submit(pool_np[q["canvas"]])
                q["kept"], status = answers[i][3], "ok"
                q["batch"] = batch_of(answers[i])
            except Overloaded:
                status = "refused"
            except Exception as exc:  # noqa: BLE001 - counted, then judged
                status, q["error"] = "error", repr(exc)
            q["done"] = time.perf_counter()
            q["status"] = status

    t0 = time.perf_counter() + 0.05
    threads = [threading.Thread(target=sender, args=(t0,), daemon=True)
               for _ in range(tr["senders"])]
    for t in threads:
        t.start()
    w0 = t0 + tr["warmup_s"]
    w1 = w0 + r.seconds
    tracer = None
    if r.trace:
        tracer = harness.DeviceTrace(r.device)
        time.sleep(max(0.0, w0 + (r.seconds - tr["trace_s"]) / 2
                       - time.perf_counter()))
        tracer.start()
        time.sleep(tr["trace_s"])
        tracer.stop()
    t_setup = w0 - r.t_start
    deadline = w1 + DRAIN_S
    for t in threads:
        t.join(timeout=max(0.0, deadline - time.perf_counter()))
    window_idx = [i for i in range(n) if w0 <= t0 + due[i] < w1]
    lat = [((reqs[i]["done"] - reqs[i]["due"]) * 1e3
            if reqs[i]["status"] == "ok" else MISSING_MS)
           for i in window_idx]
    late = [reqs[i]["sent"] - reqs[i]["due"] for i in window_idx
            if "sent" in reqs[i]]
    print(f"generator lateness ms: p50 {_percentile(late, 50) * 1e3:.4f} "
          f"p99 {_percentile(late, 99) * 1e3:.4f} "
          f"max {max(late) * 1e3:.4f}", file=sys.stderr)
    e2e = {"serve_p95_ms": _percentile(lat, 95), "setup_s": t_setup}
    out = finish(r, ref, model, server, pool, answers, reqs, window_idx,
                 tracer, e2e, latency_ms=lat)
    half = len(lat) // 2
    out["diag"] = {"offered": len(window_idx), "refused": sum(
        1 for i in window_idx if reqs[i]["status"] == "refused"),
        "p50_ms": _percentile(lat, 50), "p95_ms": _percentile(lat, 95),
        "p95_first_half_ms": _percentile(lat[:half] or lat, 95),
        "p95_second_half_ms": _percentile(lat[half:], 95),
        "max_ms": max(lat), "late_p99_ms": _percentile(late, 99) * 1e3}
    return out


def run_closed(r: harness.Run) -> dict:
    tr = r.traffic
    pool, pool_np, ref, model, server = setup(r)
    clients = tr["clients"]
    rng = np.random.default_rng(int(r.seed))
    per = int(math.ceil((tr["warmup_s"] + r.seconds) * tr["max_img_s"]
                        / clients)) + 2
    order = arrivals.canvas_order(per * clients, tr["pool"], rng)
    reqs: list = []
    answers: list = []
    lock = threading.Lock()
    stop = threading.Event()
    batcher = server.batcher

    def client(k):
        for j in range(per):
            if stop.is_set():
                return
            q = {"status": "pending", "canvas": int(order[j * clients + k]),
                 "sent": time.perf_counter()}
            with lock:
                reqs.append(q)
                answers.append(None)
                i = len(reqs) - 1
            try:
                answers[i] = batcher.submit(pool_np[q["canvas"]])
                q["kept"], status = answers[i][3], "ok"
                q["batch"] = batch_of(answers[i])
            except Exception as exc:  # noqa: BLE001 - counted, then judged
                status, q["error"] = "error", repr(exc)
            q["done"] = time.perf_counter()
            q["status"] = status

    threads = [threading.Thread(target=client, args=(k,), daemon=True)
               for k in range(clients)]
    t_launch = time.perf_counter()
    for t in threads:
        t.start()
    w0 = t_launch + tr["warmup_s"]
    w1 = w0 + r.seconds
    tracer = None
    time.sleep(max(0.0, w0 - time.perf_counter()))
    if r.trace:
        tracer = harness.DeviceTrace(r.device)
        time.sleep(max(0.0, (r.seconds - tr["trace_s"]) / 2))
        tracer.start()
        time.sleep(tr["trace_s"])
        tracer.stop()
    time.sleep(max(0.0, w1 - time.perf_counter()))
    stop.set()
    for t in threads:
        t.join(timeout=max(0.0, w1 + DRAIN_S - time.perf_counter()))
    if any(t.is_alive() for t in threads):
        print("clients still waiting past the drain", file=sys.stderr)
    window_idx = [i for i, q in enumerate(reqs)
                  if q["status"] != "pending" and w0 <= q["done"] < w1]
    done = sum(1 for i in window_idx if reqs[i]["status"] == "ok")
    if done and per * clients <= len(reqs):
        print("the closed loop ran out of canvases to send", file=sys.stderr)
    e2e = {"serve_img_s": done / r.seconds, "setup_s": w0 - r.t_start}
    return finish(r, ref, model, server, pool, answers, reqs, window_idx,
                  tracer, e2e)
