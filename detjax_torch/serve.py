"""Micro-batching detection server over the port's detect path.

The counterpart of ``detjax/serve.py``. ``Overloaded`` and ``MicroBatcher``
are host code, ported verbatim: concurrent requests coalesce into
fixed-size padded batches, one worker thread owns the device, and with a
split-phase engine the worker dispatches batch N+1 before it finalizes
batch N. The fp engine's ``dispatch`` enqueues ``detect_u8`` on the
current CUDA stream and returns device tensors; ``finalize`` copies them to
the host, which waits for the device.

Three engines behind one callable interface, as in detjax: the live fp
path (``detect_u8``), the int8 PTQ engine (``quant.detect_int8_u8``,
calibrated when the server starts) and a saved detect program
(``export.load_detect``). Over a single-process mesh
(``detjax_torch.parallel.make_mesh(devices)``) the fp and int8 engines
hold one replica of the model (or of the int8 qtree) on each device, split
every batch into contiguous slices, dispatch each on its device and gather
the slices in order, as detjax's SPMD serving does. A mesh with a
``space`` axis raises: detjax's server splits rows over local chips in one
process, which the port's single-process mesh cannot do without a
shard-parallel forward (ROADMAP Queue 1 #8). Request bodies are
decoded with the in-repo libjpeg binding (``detjax_torch.native``), then
PIL, as detjax decodes them.

HTTP API (stdlib ThreadingHTTPServer; no extra deps):
    POST /detect   body = JPEG/PNG bytes -> {"detections": [{box, score,
                   label, class}, ...]} in ORIGINAL image coordinates
    GET  /healthz  -> {"status": "ok", "batch_size": N, ...}
"""

from __future__ import annotations

import dataclasses
import json
import queue
import threading
from typing import Callable, List, Optional, Sequence

import numpy as np


class Overloaded(RuntimeError):
    """Admission queue full — shed load instead of queueing unboundedly."""


class MicroBatcher:
    """Coalesce concurrent requests into fixed-size padded device batches.

    ``run_batch`` is called with a [B, H, W, 3] uint8 canvas batch and must
    return per-slot results; requests beyond ``batch_size`` wait for the
    next cycle. Thread-safe; one worker thread owns the device.
    """

    def __init__(self, run_batch: Callable[[np.ndarray], Sequence],
                 batch_size: int, canvas_hw, max_wait_ms: float = 2.0,
                 max_queue_batches: int = 8,
                 dispatch: Optional[Callable] = None,
                 finalize: Optional[Callable] = None):
        self.run_batch = run_batch
        # split-phase engine (serving overlap): ``dispatch`` enqueues the
        # device work asynchronously and returns a handle; ``finalize``
        # blocks on the handle and builds per-slot results. When a loaded
        # queue holds the NEXT batch already, the worker dispatches it
        # BEFORE finalizing the current one, so batch N+1's normalize+H2D
        # overlaps batch N's compute. Without the pair, run_batch runs
        # synchronously (no overlap, identical results).
        self._dispatch = dispatch if dispatch is not None else run_batch
        self._finalize = (finalize if finalize is not None
                          else lambda handle, n: handle)
        self.batch_size = batch_size
        self.canvas_hw = tuple(canvas_hw)
        self.max_wait = max_wait_ms / 1e3
        # bounded admission: past ``max_queue_batches`` worth of waiting
        # requests, reject instead of letting latency grow without bound
        self._q: "queue.Queue" = queue.Queue(
            maxsize=max(1, max_queue_batches) * batch_size)
        self._stop = threading.Event()
        self._counter_lock = threading.Lock()
        self.submitted = 0
        self.completed = 0  # worker-thread only
        self.rejected = 0
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    def submit(self, canvas: np.ndarray):
        """Blocking: enqueue one [H, W, 3] uint8 canvas, wait for its result.

        Raises :class:`Overloaded` immediately when the admission queue is
        full — callers (the HTTP front) map this to 503."""
        # fail fast in the CALLER's thread — a bad canvas must never reach
        # the worker, where an exception would wedge every in-flight request
        expect = (*self.canvas_hw, 3)
        if canvas.shape != expect or canvas.dtype != np.uint8:
            raise ValueError(
                f"canvas must be uint8 {expect}, got "
                f"{canvas.dtype} {canvas.shape}")
        if self._stop.is_set():
            raise RuntimeError("MicroBatcher is closed")
        done = threading.Event()
        slot = {"canvas": canvas, "done": done, "result": None, "error": None}
        try:
            self._q.put_nowait(slot)
        except queue.Full:
            with self._counter_lock:
                self.rejected += 1
            raise Overloaded(
                f"admission queue full ({self._q.maxsize} waiting)")
        with self._counter_lock:
            self.submitted += 1
        # Bounded waits: a submit racing with close() can enqueue after the
        # worker consumed the shutdown sentinel and exited, in which case
        # this slot's event would never be set — detect that instead of
        # blocking forever (close() also drains such slots with an error).
        while not done.wait(timeout=0.5):
            if self._stop.is_set() and not self._worker.is_alive():
                raise RuntimeError("MicroBatcher closed while waiting")
        if slot["error"] is not None:
            raise slot["error"]
        return slot["result"]

    def close(self):
        self._stop.set()
        self._q.put(None)  # wake the worker
        self._worker.join(timeout=5)
        # fail any straggler slots that raced past the sentinel
        while True:
            try:
                slot = self._q.get_nowait()
            except queue.Empty:
                break
            if slot is not None:
                slot["error"] = RuntimeError("MicroBatcher closed")
                slot["done"].set()
                self.completed += 1  # keep /healthz submitted==completed

    def _finish(self, pending):
        """Block on a dispatched batch's handle and release its waiters."""
        slots, handle = pending
        try:
            results = self._finalize(handle, len(slots))
            for i, s in enumerate(slots):
                s["result"] = results[i]
        except Exception as e:  # propagate to every waiter in the batch
            for s in slots:
                s["error"] = e
        finally:
            self.completed += len(slots)
            for s in slots:
                s["done"].set()

    def _loop(self):
        h, w = self.canvas_hw
        pending = None  # previously dispatched, not yet finalized
        while not self._stop.is_set():
            if pending is not None:
                # device is busy with `pending` — poll briefly for the next
                # batch so its dispatch can overlap, else finalize now
                try:
                    first = self._q.get(timeout=self.max_wait)
                except queue.Empty:
                    self._finish(pending)
                    pending = None
                    continue
            else:
                first = self._q.get()
            if first is None:
                if pending is not None:
                    self._finish(pending)
                    pending = None
                continue
            slots = [first]
            # drain whatever else is queued, briefly waiting out the
            # coalescing window for stragglers
            while len(slots) < self.batch_size:
                try:
                    nxt = self._q.get(timeout=self.max_wait)
                except queue.Empty:
                    break
                if nxt is None:
                    break
                slots.append(nxt)
            try:  # NOTHING outside this try: an escaped exception would
                # kill the worker thread and hang every future submit()
                batch = np.zeros((self.batch_size, h, w, 3), np.uint8)
                for i, s in enumerate(slots):
                    batch[i] = s["canvas"]
                # async dispatch FIRST: batch N+1's normalize+H2D rides
                # along while batch N (pending) still computes
                handle = self._dispatch(batch)
            except Exception as e:
                for s in slots:
                    s["error"] = e
                self.completed += len(slots)
                for s in slots:
                    s["done"].set()
                handle = None
            if pending is not None:
                self._finish(pending)
                pending = None
            if handle is not None:
                pending = (slots, handle)
                if self._q.empty():  # idle: no latency hiding to gain
                    self._finish(pending)
                    pending = None
        if pending is not None:
            self._finish(pending)


def _build_engine(model, cfg, engine: str, batch_size: int,
                  calibration: Optional[np.ndarray] = None, mesh=None,
                  calib_mode: str = "absmax"):
    """One detect engine at ``cfg.model.image_size``.

    Returns ``(dispatch, finalize, run_batch)``, the MicroBatcher trio.
    ``engine``: "fp" (the live model), "int8" (the PTQ engine,
    :mod:`detjax_torch.quant`, calibrated on ``calibration``: uint8
    canvases of the served shape, REQUIRED), or the path of a saved detect
    program (:func:`detjax_torch.export.save_detect`, exported for input
    ``(batch_size, H, W, 3)``). ``mesh``: a single-process mesh; each
    batch is split over its devices (fp and int8 only: a program runs on
    the one device it was exported for).
    """
    import torch

    from detjax_torch.data.pipeline import normalize_u8
    from detjax_torch.modeling import detect_u8

    h, w = cfg.model.image_size
    dev = next(model.parameters()).device
    if mesh is not None:
        from detjax_torch.parallel.mesh import (SPACE_SERVING_NOT_PORTED,
                                                 check_mesh, replicate,
                                                 split_over)

        check_mesh(mesh)
        if mesh.space > 1:
            raise NotImplementedError(SPACE_SERVING_NOT_PORTED)
        if mesh.multi_process:
            raise ValueError(
                "mesh= serving runs in one process over its local devices "
                "(make_mesh(devices) outside torchrun); a multi-process "
                "mesh trains")
        if engine not in ("fp", "int8"):
            raise ValueError(
                "mesh= requires the fp or int8 engine: a saved detect "
                "program runs on the one device it was exported for")
        if batch_size % mesh.size:
            raise ValueError(
                f"batch_size={batch_size} must be divisible by the mesh's "
                f"data axis ({mesh.size} devices)")

    def _normalize(canvases_u8, device):  # artifact engine + calibration
        return normalize_u8(torch.as_tensor(canvases_u8).to(device),
                            cfg.data.mean, cfg.data.std)

    if engine == "fp":
        def run(canvases_u8):
            return detect_u8(model, canvases_u8, cfg)

        if mesh is not None:
            run = split_over(dev, [
                (lambda c, m=m: detect_u8(m, c, cfg)) for m in
                replicate(model, mesh)])
    elif engine == "int8":
        from detjax_torch import quant

        # PTQ activation scales are frozen at calibration time; scales
        # taken from whatever request arrives first (mostly zero-padded
        # slots) would clip later activations for the server's lifetime,
        # so calibration is required, as in detjax
        if calibration is None:
            raise ValueError(
                "engine='int8' requires calibration images "
                "(--int8-calibrate): PTQ activation ranges frozen from "
                "an arbitrary first request batch are unrepresentative "
                "and non-reproducible")
        calibration = np.asarray(calibration, np.uint8)
        if calibration.shape[1:] != (h, w, 3):
            raise ValueError(
                f"calibration must be [N, {h}, {w}, 3] uint8 "
                f"canvases, got {calibration.shape}")
        qtree = quant.quantize_model(model, cfg, _normalize(calibration, dev),
                                     calib_mode=calib_mode)

        def run(canvases_u8):
            return quant.detect_int8_u8(qtree, canvases_u8, cfg)

        if mesh is not None:
            run = split_over(dev, [
                (lambda c, q=q: quant.detect_int8_u8(q, c, cfg)) for q in
                replicate(qtree, mesh)])
    else:  # the path of a saved detect program
        from detjax_torch.export import load_detect

        artifact = load_detect(engine)
        want = (batch_size, h, w, 3)
        if artifact.in_shape != want:
            raise ValueError(
                f"artifact {engine!r} was exported for input shape "
                f"{artifact.in_shape}, but this server feeds {want} "
                f"(--batch-size / preset image_size must match the "
                f"export)")
        if artifact.in_dtype == torch.uint8:
            run = artifact  # normalization inside the program
        else:
            def run(canvases_u8):
                return artifact(_normalize(canvases_u8, artifact.device))

    def dispatch_batch(canvases_u8: np.ndarray):
        # enqueues the device work and returns device tensors: the NEXT
        # batch's H2D and normalize are issued while this one computes
        return run(canvases_u8)

    def finalize_batch(det, n: int):
        boxes = det.boxes.cpu().numpy()  # waits for the device
        scores = det.scores.cpu().numpy()
        labels = det.labels.cpu().numpy()
        nv = det.num_valid.cpu().numpy()
        return [(boxes[i], scores[i], labels[i], int(nv[i]))
                for i in range(n)]

    def run_batch(canvases_u8: np.ndarray):
        return finalize_batch(dispatch_batch(canvases_u8),
                              canvases_u8.shape[0])

    return dispatch_batch, finalize_batch, run_batch


def _resize_canvases_u8(canvases: np.ndarray, size_hw) -> np.ndarray:
    """Bilinear-resize a [N, H, W, 3] uint8 canvas stack on the host (the
    PTQ calibration canvases of each serving bucket)."""
    from PIL import Image

    th, tw = size_hw
    out = np.empty((canvases.shape[0], th, tw, 3), np.uint8)
    for i, c in enumerate(canvases):
        out[i] = np.asarray(
            Image.fromarray(c).resize((tw, th), Image.BILINEAR))
    return out


class DetectionServer:
    """HTTP detection service over one of the port's detect engines.

    ``model``: a :class:`detjax_torch.models.detector.Detector` on its
    device (``detjax_torch.build_model``); ``cfg``: the config it serves.
    ``engine``: "fp" (the live model), "int8" (PTQ; ``calibration``
    canvases, uint8 [N, H, W, 3], are REQUIRED; ``int8_calib_mode`` picks
    the range estimator), or the path of a saved detect program
    (:func:`detjax_torch.export.save_detect`, exported at ``batch_size``).

    ``buckets``: optional square canvas sizes (e.g. ``(320, 640)``): one
    engine per canvas, each image routed to the smallest canvas that holds
    it unscaled (larger images letterbox down onto the largest bucket).
    fp and int8 engines only (a program has one input shape); int8
    recalibrates each bucket from the calibration canvases, resized on the
    host.

    ``mesh``: a single-process :class:`detjax_torch.parallel.Mesh` over
    this host's devices; fp and int8 engines, ``batch_size`` divisible by
    the devices. Each device holds a replica and detects a contiguous
    slice of every batch.
    """

    def __init__(self, model, cfg, engine: str = "fp",
                 batch_size: int = 8, max_wait_ms: float = 2.0,
                 score_threshold: float = 0.3,
                 calibration: Optional[np.ndarray] = None,
                 class_names: Optional[Sequence[str]] = None,
                 max_queue_batches: int = 8, overlap: bool = True,
                 buckets: Optional[Sequence[int]] = None, mesh=None,
                 int8_calib_mode: str = "absmax"):
        self.cfg = cfg
        self.score_threshold = float(score_threshold)
        self.class_names = class_names
        self.engine = engine
        self._httpd = None

        if buckets:
            if engine not in ("fp", "int8"):
                raise ValueError(
                    "buckets= requires the fp or int8 engine: a saved "
                    "detect program has one input shape")
            sizes = sorted({int(s) for s in buckets})
        else:
            sizes = [None]  # one bucket at cfg.model.image_size
        self._buckets = []  # [(canvas_hw, MicroBatcher)], ascending size
        self._runs = []  # per-bucket run_batch, for warmup()
        for s in sizes:
            cfg_b = cfg if s is None else dataclasses.replace(
                cfg, model=dataclasses.replace(cfg.model, image_size=(s, s)))
            cal_b = calibration
            if s is not None and calibration is not None and \
                    np.asarray(calibration).shape[1:3] != \
                    cfg_b.model.image_size:
                cal_b = _resize_canvases_u8(
                    np.asarray(calibration, np.uint8), cfg_b.model.image_size)
            dispatch, finalize, run_batch = _build_engine(
                model, cfg_b, engine, batch_size, cal_b, mesh=mesh,
                calib_mode=int8_calib_mode)
            batcher = MicroBatcher(
                run_batch, batch_size, cfg_b.model.image_size, max_wait_ms,
                max_queue_batches=max_queue_batches,
                dispatch=dispatch if overlap else None,
                finalize=finalize if overlap else None)
            self._buckets.append((cfg_b.model.image_size, batcher))
            self._runs.append(run_batch)
        # `.batcher` is the largest (base) bucket
        self.batcher = self._buckets[-1][1]

    def _route(self, ih: int, iw: int):
        """Smallest bucket whose canvas holds the image unscaled; larger
        images fall through to the largest canvas (letterbox downscales)."""
        for hw, batcher in self._buckets:
            if ih <= hw[0] and iw <= hw[1]:
                return hw, batcher
        return self._buckets[-1]

    def warmup(self):
        """Run every bucket's engine once on a dummy batch, so the first
        request never pays the kernel build or cuDNN's first-call set-up.
        Called by :meth:`serve` before binding."""
        for (hw, batcher), run in zip(self._buckets, self._runs):
            run(np.zeros((batcher.batch_size, *hw, 3), np.uint8))

    # ---- request path (runs in HTTP handler threads) ----

    def detect_bytes(self, data: bytes) -> List[dict]:
        """Image bytes → list of detection dicts in original coordinates."""
        from detjax_torch.data.transforms import letterbox

        img = self._decode(data)
        ih, iw = img.shape[:2]
        canvas_hw, batcher = self._route(ih, iw)
        canvas, _, scale = letterbox(img, np.zeros((0, 4), np.float32),
                                     canvas_hw)
        boxes, scores, labels, nv = batcher.submit(canvas)
        out = []
        for i in range(nv):
            if scores[i] < self.score_threshold:
                continue
            # unscale to source coords and clip: boxes touching the
            # letterbox padding region must not map outside the image
            b = np.clip(boxes[i] / scale,
                        [0, 0, 0, 0], [iw, ih, iw, ih]).tolist()
            rec = {"box": [round(v, 2) for v in b],
                   "score": round(float(scores[i]), 4),
                   "label": int(labels[i])}
            if self.class_names and 0 <= labels[i] < len(self.class_names):
                rec["class"] = self.class_names[int(labels[i])]
            out.append(rec)
        return out

    @staticmethod
    def _decode(data: bytes) -> np.ndarray:
        from detjax_torch import native

        return native.decode_image(data)  # libjpeg, then PIL

    # ---- HTTP front ----

    def serve(self, host: str = "127.0.0.1", port: int = 8000,
              ready: Optional[threading.Event] = None,
              warmup: bool = True):
        """Run the HTTP server (blocking). ``ready`` is set once bound.
        Warms the engine (one dummy batch) BEFORE binding the socket so the
        cold start never lands inside a request."""
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        if warmup:
            self.warmup()

        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _json(self, code: int, obj):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    bs = [b for _, b in outer._buckets]
                    self._json(200, {
                        "status": "ok", "engine": outer.engine,
                        "batch_size": outer.batcher.batch_size,
                        "image_size": list(outer.cfg.model.image_size),
                        "buckets": [list(hw) for hw, _ in outer._buckets],
                        "submitted": sum(b.submitted for b in bs),
                        "completed": sum(b.completed for b in bs),
                        "rejected": sum(b.rejected for b in bs)})
                else:
                    self._json(404, {"error": "not found"})

            def do_POST(self):
                if self.path != "/detect":
                    self._json(404, {"error": "not found"})
                    return
                n = int(self.headers.get("Content-Length", 0))
                if n <= 0:
                    self._json(400, {"error": "empty body"})
                    return
                try:
                    dets = outer.detect_bytes(self.rfile.read(n))
                    self._json(200, {"detections": dets})
                except Overloaded as e:
                    self._json(503, {"error": str(e), "retry": True})
                except Exception as e:
                    self._json(500, {"error": repr(e)})

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        if ready is not None:
            ready.set()
        try:
            self._httpd.serve_forever()
        finally:
            self._httpd.server_close()

    @property
    def port(self) -> Optional[int]:
        return self._httpd.server_address[1] if self._httpd else None

    def shutdown(self):
        if self._httpd is not None:
            self._httpd.shutdown()
        for _, batcher in self._buckets:
            batcher.close()
