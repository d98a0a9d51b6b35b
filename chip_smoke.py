"""Smoke run of the PyTorch port on one NVIDIA GPU.

Drives ``detjax_torch``'s serving path (RetinaNet-R50-FPN at 640, eval
batch 8, bf16, seeded random weights), its full-anchor-set eval branch
(decode + clip of every anchor, per-class NMS), the same serving path with
``model.fused_backbone="on"`` (layer1/layer2 identity bottlenecks through
the fused block's kernels; also on a 608x832 canvas), detjax's other two
serving engines on the same model (``int8``: the int8 PTQ engine,
calibrated, ``conv_int8`` held to an fp64 reference at every site shape;
``export``: detect programs "off", "on" and int8, saved and run in fresh
processes that load no model code; ``serve_engines``: the HTTP server with
the int8 engine and with a program, and the custom ops' host time), its
training
path (the same model, train batch 16, bf16 autocast over fp32 parameters,
Adam, clip 0.1, synthetic scenes; then with "on", and retinanet_r50_1024
with "on") through the entry points a user calls; then its data pipeline
and evaluation over 256 synthetic scenes written as JPEGs with a COCO
JSON: the native library on the card's host (``data``),
``detjax_torch.evaluate`` through the NMS kernel and through its twin
(``evaluate``), the protocol evaluator at retinanet_r50_1024 with "off"
and "on" (``evaluate_protocol``), and training fed by the threaded
iterator through ``device_prefetch`` (``train_data``); then ``fit`` on
detjax's mid-gate recipe (batch-statistics BatchNorm, checkpoints, a
periodic ``evaluate``, a resume, a traced window) and through ``fit`` with
frozen BatchNorm and "on" (``fit``); and the R50 stem
(conv1 -> bn1 -> ReLU -> 3x3/s2 max-pool) forward and backward at the 640
and 1024 training shapes, with ATen's pool backward and with the max-pool
backward kernel (``kernels/stem.py::max_pool_3x3s2``, which no model path
calls); then detjax's other two single-card configs at full width
(``ssd``: ssd_512 serving "off" and "on", its int8 engine and a detect
program, training through the matching kernel at A = 32,736; ``r101``:
retinanet_r101_fpn serving "off" and "on", training, and multi-scale
steps at 512 and 640 with batch-statistics BatchNorm); then R50-640
training under each of detjax's backbone A/B knobs (``knobs``:
``dot_1x1``, ``remat_early``, ``f8_remat_stages``, each against its
baseline, timed in turns) and the port's bench,
``python -m detjax_torch.cli.bench``, in a fresh process (``bench``);
then data parallelism (``detjax_torch.parallel``) at config 5's model,
coco_v5e8 at its per-chip batch 16 (``parallel``: ``fit`` on a world-1
NCCL group bit-equal to ``fit`` without a mesh and timed in turns with
it, two gloo ranks sharing the card against the single-process steps in
bf16 and fp32 and a sharded evaluation, mesh serving, and the train CLI
under ``torch.distributed.run``; config 5's scaling over 8 cards cannot
be measured on one card).
Builds every CUDA kernel of those paths from ``detjax_torch/csrc/`` (one
nvcc per source, all started together; also, from ``smoke_prior/``, the
fused forward as it stood at commit 2503cdf, one kernel on wmma, timed in
turns against the current one and the unfused cuDNN block, the NMS and
matching kernels as they stood at commits be25ba5 and b5fd515, and the
max-pool backward as it stood at b5fd515, each timed in turns against
the current one; and the NMS kernel's instrumented build, which reports
cycles by phase), holds each kernel against its plain PyTorch twin on the
card, also where NMS rows pass 16,384 candidates and matching passes
9,642 GT slots, and checks that each path really launched its kernels. Prints JSON lines; the last line is
``{"ok": true, "device": {...}}`` and appears only when every phase
passed. Exits non-zero without a CUDA device. ``mid_gate(steps)``,
``ssd_gate()`` and ``r101_multiscale_gate()`` run detjax's mid, SSD and
R101 multi-scale gates (not called by ``main``).

    python3 chip_smoke.py
    python3 -c "import chip_smoke as cs; cs.mid_gate(6000)"
    python3 -c "import chip_smoke as cs; cs.ssd_gate()"
    python3 -c "import chip_smoke as cs; cs.r101_multiscale_gate()"
"""

from __future__ import annotations

import contextlib
import copy
import itertools
import json
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

H100 = {"bytes_per_s": 3.35e12, "fp32_flops": 67e12,
        "bf16_flops": 989e12, "int8_ops": 1979e12}  # SXM data sheet, dense


def print_card() -> str:
    """The card's name and power limit as nvidia-smi gives them, printed on
    a line of their own."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip()
    print(card, flush=True)
    return card


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def sm_clock():
    """The card's SM clock now, as ``nvidia-smi --query-gpu=clocks.sm
    --format=csv,noheader`` gives it (e.g. "1980 MHz"), or None."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    return smi.stdout.strip() if smi.returncode == 0 else None


def with_sm_clocks(fn):
    """``(fn(), clocks)``: the SM clock (sm_clock) sampled just before
    ``fn`` and just after it, so that no sampling runs beside what ``fn``
    times."""
    before = sm_clock()
    out = fn()
    return out, [before, sm_clock()]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean ms per call from CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


_SPIN_CYCLES_PER_MS = []


def spin_cycles_per_ms() -> float:
    """Cycles of torch.cuda._sleep's spin kernel a ms on this card, timed
    once with CUDA events."""
    if not _SPIN_CYCLES_PER_MS:
        cycles = 20_000_000
        torch.cuda._sleep(cycles)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(cycles)
        end.record()
        end.synchronize()
        _SPIN_CYCLES_PER_MS.append(cycles / start.elapsed_time(end))
    return _SPIN_CYCLES_PER_MS[0]


def device_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device ms per call of ``fn``: CUDA events around ``iters`` calls,
    as cuda_ms, with the calls queued behind a spin kernel long enough for
    the host to enqueue them all first, so that they run back to back and
    the host's own time per call (allocation, checks, launches) is not in
    the number; cuda_ms of a wrapper measures whichever of the two is
    slower. When the host takes longer to enqueue the calls than the spin
    lasts, the timing is taken again behind a longer spin, at most three
    times, and then the phase fails."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(warmup):
        fn()
    host_ms = (time.perf_counter() - t0) / warmup * 1e3
    torch.cuda.synchronize()
    spin_ms = 2.0 * host_ms * iters + 2.0
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(spin_ms * spin_cycles_per_ms()))
        t0 = time.perf_counter()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        end.synchronize()
        if enqueue_ms < spin_ms:
            return start.elapsed_time(end) / iters
        emit({"device_ms": "the host fell behind the spin; again, longer",
              "spin_ms": spin_ms, "enqueue_ms": enqueue_ms})
        spin_ms = 2.0 * enqueue_ms
    raise SystemExit(f"device_ms: the host fell behind the spin three times "
                     f"(last {enqueue_ms:.3f} ms to enqueue {iters} calls)")


def hard_candidates(seed: int, b: int = 8, n: int = 1000, k: int = 24):
    """Seeded NMS inputs built to be hard: overlapping clusters, >= 20
    classes, exact score ties, pre-suppressed -1e10 entries, one image that
    runs out of candidates before max_det, and one with none."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0, 640, (b, 40, 2))
    member = rng.integers(0, 40, (b, n))
    c = np.take_along_axis(centers, member[..., None], axis=1)
    c = c + rng.normal(0, 6, (b, n, 2))
    wh = rng.uniform(16, 120, (b, n, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1)
    boxes = np.clip(boxes, 0, 640).astype(np.float32)
    scores = rng.uniform(0.05, 1.0, (b, n)).astype(np.float32)
    tie_src = rng.integers(0, n, (b, n // 5))
    tie_dst = rng.integers(0, n, (b, n // 5))
    np.put_along_axis(scores, tie_dst,
                      np.take_along_axis(scores, tie_src, 1), 1)
    scores[:, : n // 10] = np.round(scores[:, : n // 10], 1)  # tie blocks
    scores[rng.uniform(size=(b, n)) < 0.1] = -1e10
    scores[b - 2, n // 20:] = -1e10  # runs out before max_det
    scores[b - 1] = -1e10
    labels = rng.integers(0, k, (b, n)).astype(np.int32)
    labels[:, : n // 2] = rng.integers(0, 3, (b, n // 2))  # crowded classes
    return boxes, scores, labels


def nms_bound_ms(b: int, n: int, max_det: int, pairs: int) -> tuple:
    """Least time for the NMS at these shapes: bytes moved (inputs read
    once, outputs written once) over the memory rate, and the IoU work of
    ``pairs`` (keep, candidate) comparisons (14 fp32 operations each) over
    the fp32 rate."""
    nbytes = b * n * (16 + 4 + 4) + b * max_det * (4 + 4)
    ops = 14.0 * pairs
    t_bytes = nbytes / H100["bytes_per_s"] * 1e3
    t_ops = ops / H100["fp32_flops"] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# Timing reference of the fused forward, in smoke_prior/ beside this script
# (no code path of detjax_torch calls it): the one-kernel design with every
# product on wmma fragments, as it stood at commit 2503cdf, through its own C
# interface.
PRIOR_DIR = Path(__file__).resolve().parent / "smoke_prior"
PRIOR_FWD = "2503cdf"


def prior_fwd_lib():
    """The library of smoke_prior/bottleneck_fwd_<PRIOR_FWD>.cu."""
    import ctypes

    from detjax_torch.kernels._build import load_library

    lib = load_library(f"detjax_bottleneck_fwd_{PRIOR_FWD}",
                       [f"bottleneck_fwd_{PRIOR_FWD}.cu"], src_dir=PRIOR_DIR)
    fn = lib.detjax_bottleneck_fwd_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def prior_fwd_call(x, wts):
    """A no-argument call of the prior forward on (x, wts), its output
    allocated once, outside the call."""
    lib = prior_fwd_lib()
    b, h, w, c = x.shape
    out = torch.empty_like(x)
    ptrs = [t.data_ptr() for t in (x, *wts, out)]

    def call():
        err = lib.detjax_bottleneck_fwd_launch(
            *ptrs, b, h, w, c // 4, x.device.index or 0,
            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise SystemExit(f"the forward at {PRIOR_FWD} failed to launch: "
                             f"cudaError {err}")
    return call


# Timing references of the NMS and matching kernels as they stood at commit
# be25ba5 (one block per image with max_det block-wide argmaxes; one
# thread per anchor scanning every GT slot), in smoke_prior/ beside this
# script, through their own C interfaces; no code path of detjax_torch
# calls them.
PRIOR_NMS_MATCH = "be25ba5"


def prior_nms_lib():
    """The library of smoke_prior/nms_<PRIOR_NMS_MATCH>.cu."""
    import ctypes

    from detjax_torch.kernels._build import load_library

    lib = load_library(f"detjax_nms_{PRIOR_NMS_MATCH}",
                       [f"nms_{PRIOR_NMS_MATCH}.cu"], src_dir=PRIOR_DIR)
    fn = lib.detjax_nms_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def prior_match_lib():
    """The library of smoke_prior/matching_<PRIOR_NMS_MATCH>.cu."""
    import ctypes

    from detjax_torch.kernels._build import load_library

    lib = load_library(f"detjax_match_{PRIOR_NMS_MATCH}",
                       [f"matching_{PRIOR_NMS_MATCH}.cu"], src_dir=PRIOR_DIR)
    fn = lib.detjax_match_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


# Timing references of the NMS, matching and max-pool backward kernels as
# they stood at commit b5fd515 (before NMS took rows past 16,384 candidates,
# matching took more than 9,642 GT slots, and the max-pool backward had its
# strip instance), in smoke_prior/ beside this script, through their own C
# interfaces; no code path of detjax_torch calls them.
PRIOR_B5 = "b5fd515"


def prior_b5_lib(kind: str):
    """The library of smoke_prior/<kind>_<PRIOR_B5>.cu, kind one of "nms",
    "matching", "maxpool_bwd"."""
    import ctypes

    from detjax_torch.kernels._build import load_library

    lib = load_library(f"detjax_{kind}_{PRIOR_B5}", [f"{kind}_{PRIOR_B5}.cu"],
                       src_dir=PRIOR_DIR)
    if kind == "nms":
        fn = lib.detjax_nms_launch
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
            ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int)]
    elif kind == "matching":
        fn = lib.detjax_match_launch
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    else:
        fn = lib.detjax_maxpool_bwd_launch
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def prior_b5_nms_call(boxes, scores, labels, thr, max_det, offset):
    """A no-argument call of the NMS kernel at PRIOR_B5 on these inputs
    (rows of at most 16,384 candidates); it returns its outputs, allocated
    once, outside the call."""
    import ctypes

    from detjax_torch.kernels import postprocess as pp

    lib = prior_b5_lib("nms")
    b, n = scores.shape
    dev = boxes.device
    keep_idx = torch.empty((b, max_det), dtype=torch.int32, device=dev)
    keep_scores = torch.empty((b, max_det), device=dev)
    scratch = torch.empty((pp.nms_scratch_bytes(b, max_det),),
                          dtype=torch.uint8, device=dev)
    launched = ctypes.c_int(0)

    def call():
        err = lib.detjax_nms_launch(
            boxes.data_ptr(), scores.data_ptr(), labels.data_ptr(),
            keep_idx.data_ptr(), keep_scores.data_ptr(), scratch.data_ptr(),
            b, n, max_det, float(thr), float(offset), dev.index or 0,
            torch.cuda.current_stream().cuda_stream, ctypes.byref(launched))
        if err != 0:
            raise SystemExit(f"the NMS at {PRIOR_B5} failed to launch: "
                             f"cudaError {err}")
        return keep_idx, keep_scores
    return call


def prior_b5_match_call(anchors, boxes, valid, labels):
    """A no-argument call of the matching kernel at PRIOR_B5 on these
    inputs (at most 9,642 GT slots); it returns its four outputs,
    allocated once, outside the call."""
    import ctypes

    lib = prior_b5_lib("matching")
    b, g = valid.shape
    a = anchors.shape[0]
    dev = anchors.device
    outs = (torch.empty((b, a), device=dev),
            torch.empty((b, a), dtype=torch.int32, device=dev),
            torch.empty((b, a, 4), device=dev),
            torch.empty((b, a), dtype=torch.int32, device=dev))
    launched = ctypes.c_int(0)

    def call():
        err = lib.detjax_match_launch(
            anchors.data_ptr(), boxes.data_ptr(), valid.data_ptr(),
            labels.data_ptr(), *(t.data_ptr() for t in outs), b, a, g,
            dev.index or 0, torch.cuda.current_stream().cuda_stream,
            ctypes.byref(launched))
        if err != 0:
            raise SystemExit(f"the matching at {PRIOR_B5} failed to launch: "
                             f"cudaError {err}")
        return outs
    return call


def prior_b5_pool_call(z, dp):
    """A no-argument call of the max-pool backward at PRIOR_B5 (the
    gather kernel alone) on channels-last z and dp; it returns dz, allocated
    once, outside the call."""
    lib = prior_b5_lib("maxpool_bwd")
    b, c, hz, wz = z.shape
    dz = torch.empty_like(z, memory_format=torch.channels_last)
    aligned = int(z.data_ptr() % 4 == 0 and dp.data_ptr() % 4 == 0)

    def call():
        err = lib.detjax_maxpool_bwd_launch(
            z.data_ptr(), dp.data_ptr(), dz.data_ptr(), b, hz // 2, wz // 2,
            c, int(z.dtype == torch.bfloat16), aligned, z.device.index or 0,
            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise SystemExit(f"the max-pool backward at {PRIOR_B5} failed "
                             f"to launch: cudaError {err}")
        return dz
    return call


def nms_profile_lib():
    """csrc/nms.cu built with -DDETJAX_NMS_PROFILE: the same kernel, with
    clock reads at its barriers, through ``detjax_nms_profile_launch``;
    no code path of detjax_torch loads it."""
    import ctypes

    from detjax_torch.kernels._build import load_library

    lib = load_library("detjax_nms_profile", ["nms.cu"],
                       flags=("-DDETJAX_NMS_PROFILE",))
    fn = lib.detjax_nms_profile_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    return lib


def prior_nms_call(boxes, scores, labels, thr, max_det, offset):
    """A no-argument call of the prior NMS kernel on these inputs; it
    returns its outputs, allocated once, outside the call."""
    lib = prior_nms_lib()
    b, n = scores.shape
    keep_idx = torch.empty((b, max_det), dtype=torch.int32,
                           device=boxes.device)
    keep_scores = torch.empty((b, max_det), device=boxes.device)

    def call():
        err = lib.detjax_nms_launch(
            boxes.data_ptr(), scores.data_ptr(), labels.data_ptr(),
            keep_idx.data_ptr(), keep_scores.data_ptr(), b, n, max_det,
            float(thr), float(offset), boxes.device.index or 0,
            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise SystemExit(f"the NMS at {PRIOR_NMS_MATCH} failed to "
                             f"launch: cudaError {err}")
        return keep_idx, keep_scores
    return call


def prior_match_call(anchors, boxes, valid, labels):
    """A no-argument call of the prior matching kernel on these inputs; it
    returns its four outputs, allocated once, outside the call."""
    lib = prior_match_lib()
    b, g = valid.shape
    a = anchors.shape[0]
    dev = anchors.device
    outs = (torch.empty((b, a), device=dev),
            torch.empty((b, a), dtype=torch.int32, device=dev),
            torch.empty((b, a, 4), device=dev),
            torch.empty((b, a), dtype=torch.int32, device=dev))

    def call():
        err = lib.detjax_match_launch(
            anchors.data_ptr(), boxes.data_ptr(), valid.data_ptr(),
            labels.data_ptr(), *(t.data_ptr() for t in outs), b, a, g,
            dev.index or 0, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise SystemExit(f"the matching at {PRIOR_NMS_MATCH} failed to "
                             f"launch: cudaError {err}")
        return outs
    return call


def in_turns(calls: dict, order, iters: int) -> dict:
    """Device ms a call of each of ``calls`` (device_ms), timed in
    ``order`` (e.g. prior, new, new, prior) in one call; the mean of each
    name's turns, and the turns themselves."""
    turns = [(c, device_ms(calls[c], iters=iters)) for c in order]
    return {"ms": {c: float(np.mean([t for k, t in turns if k == c]))
                   for c in calls}, "turns": turns}


def ptxas_by_kernel(log: str, names) -> dict:
    """Registers, spill bytes and static shared memory of each instance of
    the kernels ``names`` in an ``nvcc -Xptxas -v`` log, keyed "name<M>"
    or "name<T,A>" (templates over ints and bools) or "name"."""
    found, current = {}, None
    for line in log.splitlines():
        entry = re.search(r"(?:Compiling entry function|Function properties "
                          r"for) '?(\w+)", line)
        if entry:
            current = None
            for name in names:
                m = re.search(rf"{name}(?:I((?:L[ib]\d+E)+)E|E)",
                              entry.group(1))
                if m:
                    args = re.findall(r"L[ib](\d+)E", m.group(1) or "")
                    key = f"{name}<{','.join(args)}>" if args else name
                    current = found.setdefault(key, {})
            continue
        if current is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
        if spill:
            current["spill_stores"] = int(spill.group(1))
            current["spill_loads"] = int(spill.group(2))
        regs = re.search(r"Used (\d+) registers", line)
        if regs:
            current["registers"] = int(regs.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            current["static_smem"] = int(smem.group(1)) if smem else 0
    return found


def phase_build() -> None:
    """Build every kernel library at once, one nvcc process per source."""
    from detjax_torch.kernels import bottleneck as kb
    from detjax_torch.kernels import matching as km
    from detjax_torch.kernels import postprocess as pp
    from detjax_torch.kernels import stem as ks
    from detjax_torch.kernels._build import build_info

    libs = {f"detjax_{name}": (f"detjax_torch/csrc/{source}", fn)
            for name, source, fn in (
                ("nms", "nms.cu", pp._lib),
                ("match", "matching.cu", km._lib),
                ("bottleneck", "bottleneck.cu", kb._lib),
                ("bottleneck_bwd", "bottleneck_bwd.cu", kb._bwd_lib),
                ("decode", "decode.cu", pp._decode_lib),
                ("maxpool_bwd", "maxpool_bwd.cu", ks._lib))}
    libs[f"detjax_bottleneck_fwd_{PRIOR_FWD}"] = (
        f"smoke_prior/bottleneck_fwd_{PRIOR_FWD}.cu", prior_fwd_lib)
    libs[f"detjax_nms_{PRIOR_NMS_MATCH}"] = (
        f"smoke_prior/nms_{PRIOR_NMS_MATCH}.cu", prior_nms_lib)
    libs[f"detjax_match_{PRIOR_NMS_MATCH}"] = (
        f"smoke_prior/matching_{PRIOR_NMS_MATCH}.cu", prior_match_lib)
    libs["detjax_nms_profile"] = (
        "detjax_torch/csrc/nms.cu -DDETJAX_NMS_PROFILE", nms_profile_lib)
    for kind in ("nms", "matching", "maxpool_bwd"):
        libs[f"detjax_{kind}_{PRIOR_B5}"] = (
            f"smoke_prior/{kind}_{PRIOR_B5}.cu",
            lambda kind=kind: prior_b5_lib(kind))
    errors: dict = {}

    def build(name, fn):
        try:
            fn()
        except Exception as exc:  # reported below, then fatal
            errors[name] = repr(exc)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=build, args=(name, fn))
               for name, (_, fn) in libs.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall_s = time.perf_counter() - t0
    if errors:
        raise SystemExit(f"kernel build failed: {errors}")
    for name, (source, _) in libs.items():
        info = build_info[name]
        emit({"phase": "build", "kernel": name,
              "source": source, "target": "sm_90a",
              "nvcc_s": info["seconds"], "parallel_wall_s": wall_s,
              "ptxas": [ln for ln in info["log"].splitlines()
                        if "registers" in ln or "smem" in ln
                        or "Compiling entry" in ln or "spill" in ln]})


# the CUDA kernels of one nms_cuda call
NMS_KERNEL_NAMES = ("nms_kernel",)


def sorted_rows(boxes, scores, labels):
    """The same candidates in the main path's order: each row by a stable
    descending sort of its scores, pre-suppressed entries last."""
    order = torch.sort(scores, dim=1, descending=True, stable=True).indices
    return (boxes.gather(1, order[..., None].expand(-1, -1, 4)).contiguous(),
            scores.gather(1, order).contiguous(),
            labels.gather(1, order).contiguous())


def rows_out_of_order(scores) -> int:
    """Rows the NMS kernel sorts: a live candidate after a dead one, or
    live scores rising."""
    live = scores > -5e9
    bad = live[:, 1:] & (~live[:, :-1] | (scores[:, :-1] < scores[:, 1:]))
    return int(bad.any(dim=1).sum())


# calls traced by traced_counts
TRACED_CALLS = 10
# windows a launch count is traced in before its check fails
PROFILER_WINDOWS = 3


def short_window(seen: dict, want: dict) -> bool:
    """Whether a profiler window's launch counts ``seen`` fall short of
    ``want`` (kernel -> count) and nowhere exceed it: torch.profiler can
    drop a window's kernel records (the first launches, while it finishes
    enabling itself; smoke_prior/profiler_window.py) but never adds one."""
    return (seen != want and set(seen) <= set(want)
            and all(seen[k] <= want[k] for k in seen))


def complete_window(trace, want: dict, what: str):
    """``trace()``'s counts (a window's launches, kernel -> count; None
    when the profiler cannot trace the card), traced again while they fall
    short of ``want`` (short_window), at most PROFILER_WINDOWS windows in
    all. Each short window is printed. The caller's check holds the
    returned counts to ``want`` exactly: a count above it, another
    kernel, or a shortfall in every window fails it."""
    for i in range(PROFILER_WINDOWS):
        seen = trace()
        if seen is None or not short_window(seen, want):
            return seen
        emit({"profiler_short_window": what, "window": i + 1, "seen": seen,
              "want": want})
    return seen


def traced_counts(fn, want: dict, what: str):
    """Device ms a call of ``fn`` spends in each CUDA kernel, from
    torch.profiler over TRACED_CALLS calls; the phase fails unless the
    profiler's launches a call equal ``want`` (kernel -> launches a call,
    the launcher's count), with no other kernel, in one of
    PROFILER_WINDOWS windows (complete_window). None when the profiler
    records no device time."""
    found = {}

    def trace():
        found["traced"] = kernel_ms_by_name(fn, calls=TRACED_CALLS)
        if found["traced"] is None:
            return None
        return {k: round(v * TRACED_CALLS)
                for k, v in found["traced"][1].items()}

    seen = complete_window(trace, {k: v * TRACED_CALLS
                                   for k, v in want.items()}, what)
    if seen is None:
        return None
    ms = found["traced"][0]
    if seen != {k: v * TRACED_CALLS for k, v in want.items()}:
        raise SystemExit(f"torch.profiler saw {seen} records over "
                         f"{TRACED_CALLS} calls of {what}, the launcher "
                         f"counted {want} a call")
    return ms


# the phases the NMS kernel's instrumented build times, in clock64 cycles
# of thread 0 between barriers, per row
NMS_PHASES = ("order", "load", "a_against_keeps", "b_triangle", "c_keeps",
              "c_outputs", "row", "rounds")


def nms_phase_cycles(args) -> dict:
    """Cycles a row of ``args`` spends in each phase of the NMS kernel,
    from its instrumented build (nms_profile_lib; its keep-sets checked
    against the twin's): the mean over rows with a live candidate, and the
    max."""
    import ctypes

    from detjax_torch.kernels import postprocess as pp

    boxes, scores, labels, thr, max_det, offset = args
    b, n = scores.shape
    dev = boxes.device
    keep_idx = torch.empty((b, max_det), dtype=torch.int32, device=dev)
    keep_scores = torch.empty((b, max_det), device=dev)
    scratch = torch.empty((pp.nms_scratch_bytes(b, max_det),),
                          dtype=torch.uint8, device=dev)
    cycles = torch.zeros((b, len(NMS_PHASES)), dtype=torch.int64, device=dev)
    launched = ctypes.c_int(0)
    for _ in range(2):  # the second run's clocks, after a warm-up
        err = nms_profile_lib().detjax_nms_profile_launch(
            boxes.data_ptr(), scores.data_ptr(), labels.data_ptr(),
            keep_idx.data_ptr(), keep_scores.data_ptr(), scratch.data_ptr(),
            b, n, max_det, float(thr), float(offset), cycles.data_ptr(),
            dev.index or 0, torch.cuda.current_stream().cuda_stream,
            ctypes.byref(launched))
        if err != 0:
            raise SystemExit(f"the instrumented NMS failed: cudaError {err}")
    ri, rs = pp.nms_reference(*args)
    if not (torch.equal(keep_idx, ri) and torch.equal(keep_scores, rs)):
        raise SystemExit("the NMS kernel's instrumented build disagrees "
                         "with the twin")
    c = cycles.double()
    walked = c[:, NMS_PHASES.index("rounds")] > 0
    return {"mean": dict(zip(NMS_PHASES, c[walked].mean(0).tolist())),
            "max": dict(zip(NMS_PHASES, c.max(0).values.tolist())),
            "rows_walked": int(walked.sum())}


def nms_pairs_needed(args, keep_idx) -> tuple:
    """Candidates a row walks and the (keep, candidate) IoU pairs the
    greedy sweep needs, for the NMS on ``args`` that kept ``keep_idx`` (the
    twin's): a row's candidates in (score desc, index asc) order up to its
    last keep (all its live ones when it kept fewer than max_det), each
    compared with the keeps before it up to the first that suppresses
    it."""
    boxes, scores, labels, thr, max_det, offset = args
    b = scores.shape[0]
    dev = scores.device
    kept = (keep_idx >= 0).sum(dim=1)
    live = (scores > -5e9).sum(dim=1)
    order = torch.sort(scores, dim=1, descending=True, stable=True).indices
    rank = torch.argsort(order, dim=1)
    keeps = keep_idx.clamp(min=0).long()
    ranks = rank.gather(1, keeps)  # [B, max_det]
    last = ranks.gather(1, (kept - 1).clamp(min=0)[:, None])[:, 0]
    walked = torch.where(kept == max_det, last + 1, live)
    off = boxes + (labels.to(torch.float32) * offset)[..., None]

    def area(x):
        return ((x[..., 2] - x[..., 0]).clamp(min=0)
                * (x[..., 3] - x[..., 1]).clamp(min=0))
    pairs = 0
    for r0 in range(0, b, 64):
        rows = slice(r0, r0 + 64)
        w = int(walked[rows].max())
        if w == 0:
            continue
        cand = off[rows].gather(1, order[rows, :w, None].expand(-1, -1, 4))
        kb = off[rows].gather(1, keeps[rows, :, None].expand(-1, -1, 4))
        lt = torch.maximum(kb[:, :, None, :2], cand[:, None, :, :2])
        wh = (torch.minimum(kb[:, :, None, 2:], cand[:, None, :, 2:])
              - lt).clamp(min=0)
        inter = wh[..., 0] * wh[..., 1]  # [R, max_det, w]
        union = (area(kb)[:, :, None] + area(cand)[:, None, :]) - inter
        q = torch.arange(w, device=dev)
        before = ((torch.arange(max_det, device=dev)[None, :, None]
                   < kept[rows, None, None])
                  & (ranks[rows, :, None] < q[None, None, :]))
        hits = before & (inter / union.clamp(min=1e-8) > thr)
        removed = hits.any(dim=1)
        first = hits.to(torch.uint8).argmax(dim=1)  # the first such keep
        per_q = torch.where(removed, first + 1, before.sum(dim=1))
        pairs += int((per_q * (q[None] < walked[rows, None])).sum())
    return walked, pairs


# the prior NMS kernels' no-argument calls, by commit
PRIOR_NMS_CALLS = {PRIOR_NMS_MATCH: prior_nms_call,
                   PRIOR_B5: prior_b5_nms_call}


def nms_case(name: str, args, iters: int,
             priors=(PRIOR_NMS_MATCH, PRIOR_B5)) -> dict:
    """nms_cuda on ``args`` against its twin and the prior kernels
    ``priors`` (keep-sets and scores bit-equal), timed in turns with them
    (be25ba5, b5fd515, new, new, b5fd515, be25ba5), its CUDA kernels
    counted by the launcher and by torch.profiler (which must agree), its
    scratch, and its bound from the pairs this data needs (beside the
    first port's count: every candidate against each of a row's steps). Rows past
    16,384 candidates run no prior kernel: neither took them."""
    from detjax_torch.kernels import postprocess as pp

    boxes, scores, labels, thr, max_det, offset = args
    b, n = scores.shape
    c0, k0 = pp.nms_launches, pp.nms_kernel_launches
    ki, ks = pp.nms_cuda(*args)
    calls, kernels = pp.nms_launches - c0, pp.nms_kernel_launches - k0
    ri, rs = pp.nms_reference(*args)
    prior_calls = {p: PRIOR_NMS_CALLS[p](*args) for p in priors}
    equal = {"keep_idx": torch.equal(ki, ri),
             "keep_scores": torch.equal(ks, rs)}
    for p, call in prior_calls.items():
        pi, ps = call()
        equal[f"{p}_keep_idx"] = torch.equal(pi, ri)
        equal[f"{p}_keep_scores"] = torch.equal(ps, rs)
    torch.cuda.synchronize()
    if not all(equal.values()):
        raise SystemExit(f"nms_cuda or a prior kernel disagrees with the "
                         f"twin on {name}: {equal}")
    if (calls, kernels) != (1, len(NMS_KERNEL_NAMES)):
        raise SystemExit(f"nms_cuda counted {calls} calls and {kernels} "
                         f"CUDA kernels for one call")
    traced = traced_counts(lambda: pp.nms_cuda(*args),
                           {k: 1 for k in NMS_KERNEL_NAMES}, "nms_cuda")
    timed = in_turns({"new": lambda: pp.nms_cuda(*args), **prior_calls},
                     (*priors, "new", "new", *reversed(priors)), iters)
    call_ms = cuda_ms(lambda: pp.nms_cuda(*args), iters=iters)
    kept = (ri >= 0).sum(dim=1)
    live = (scores > -5e9).sum(dim=1)
    walked, pairs = nms_pairs_needed(args, ri)
    steps = int(torch.clamp(kept + 1, max=max_det).sum())
    bound_ms, bound_by = nms_bound_ms(b, n, max_det, pairs)
    bound_steps, bound_steps_by = nms_bound_ms(b, n, max_det, n * steps)
    return {"case": name, "B": b, "N": n, "max_det": max_det,
            "iou_threshold": thr, "bit_equal": equal,
            "rows_out_of_order": rows_out_of_order(scores),
            "live_per_row": {"min": int(live.min()), "max": int(live.max()),
                             "mean": float(live.float().mean())},
            "kept_per_row": {"min": int(kept.min()), "max": int(kept.max()),
                             "sum": int(kept.sum())},
            "kept": kept.tolist(),
            "walked_per_row": {"min": int(walked.min()),
                               "max": int(walked.max()),
                               "mean": float(walked.float().mean())},
            "ms": timed["ms"]["new"], "ms_by": "device_ms",
            "prior_ms": timed["ms"].get(PRIOR_NMS_MATCH),
            f"ms_at_{PRIOR_B5}": timed["ms"].get(PRIOR_B5),
            "timed_in_turns": timed["turns"], "call_ms": call_ms,
            "kernels_a_call": kernels, "ms_by_kernel": traced,
            "phase_cycles_per_row": nms_phase_cycles(args),
            "max_abs_err": float((ks - rs).abs().max()),
            "scratch_bytes": pp.nms_scratch_bytes(b, max_det),
            "pairs_needed": pairs, "steps": steps,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_ms_steps": bound_steps, "bound_by_steps": bound_steps_by}


# rows longer than the kernel sorts at once: one past the split point, and
# the full anchor set of retinanet_r50_640
LONG_ROWS = (16385, 76725)


def phase_kernel(report: dict) -> None:
    """nms_cuda at B = 8, N = 1000, max_det = 100 on the hard candidate set
    as it is (every row but the empty one out of order: the kernel sorts
    them) and on the same rows sorted (the main path's case), each
    bit-equal to its twin and timed in turns with the kernels at
    PRIOR_NMS_MATCH and PRIOR_B5; then rows past the split point
    (LONG_ROWS, B = 8, the hard set at that length, as it is and sorted:
    the unsorted ones take the large instance's radix select), bit-equal
    to the twin, timed beside it; the kernel's registers and spills."""
    from detjax_torch.kernels import postprocess as pp
    from detjax_torch.kernels._build import build_info

    ptxas = ptxas_by_kernel(build_info["detjax_nms"]["log"], NMS_KERNEL_NAMES)
    spills = {k: v for k, v in ptxas.items()
              if v.get("spill_stores") or v.get("spill_loads")}
    emit({"phase": "kernel_build", "kernel": "nms_cuda", "ptxas": ptxas,
          "instances": "nms_kernel<512,0> for fewer than two rows an SM, "
                       "else nms_kernel<256,0>; nms_kernel<512,1> for rows "
                       "past 16,384 candidates",
          "profile_build_ptxas": ptxas_by_kernel(
              build_info["detjax_nms_profile"]["log"], NMS_KERNEL_NAMES)})
    if sorted(ptxas) != ["nms_kernel<256,0>", "nms_kernel<512,0>",
                         "nms_kernel<512,1>"] or spills:
        raise SystemExit(f"the NMS kernel spills or is missing from the "
                         f"ptxas log: {ptxas}")
    b, n, max_det, thr, offset = 8, 1000, 100, 0.5, 642.0
    boxes, scores, labels = (torch.from_numpy(a).cuda()
                             for a in hard_candidates(0, b, n))
    rows = []
    for name, cand in (("unsorted", (boxes, scores, labels)),
                       ("sorted", sorted_rows(boxes, scores, labels))):
        args = (*cand, thr, max_det, offset)
        row = nms_case(name, args, iters=200)
        row["plain_ms"] = cuda_ms(lambda: pp.nms_reference(*args), iters=10)
        emit({"phase": "kernel", "kernel": "nms_cuda", **row})
        rows.append(row)
    unsorted, in_order = rows
    if unsorted["rows_out_of_order"] != b - 1 or in_order["rows_out_of_order"]:
        raise SystemExit("the hard candidate set lost its unsorted rows")
    kept = unsorted["kept"]
    if kept[-1] != 0 or min(kept[:-1]) == 0:
        raise SystemExit("hard candidate set lost its empty / live images")
    long_rows = {}
    for n_long in LONG_ROWS:
        boxes, scores, labels = (torch.from_numpy(a).cuda()
                                 for a in hard_candidates(1, b, n_long))
        for name, cand in (("unsorted", (boxes, scores, labels)),
                           ("sorted", sorted_rows(boxes, scores, labels))):
            args = (*cand, thr, max_det, offset)
            row = nms_case(f"{name}_{n_long}", args, iters=20, priors=())
            row["plain_ms"] = cuda_ms(lambda: pp.nms_reference(*args),
                                      iters=3, warmup=1)
            # what a global sort of the rows alone takes (torch.sort, a
            # library call the port never makes): the floor of the other
            # design, a sort of every key before the rounds
            row["torch_sort_rows_ms"] = device_ms(
                lambda: torch.sort(cand[1], dim=1, descending=True,
                                   stable=True), iters=20)
            emit({"phase": "kernel_long_rows", "kernel": "nms_cuda", **row})
            if row["rows_out_of_order"] != (b - 1 if name == "unsorted"
                                            else 0):
                raise SystemExit(f"the long rows lost their order: {name}")
            long_rows[f"{name}_{n_long}"] = {
                k: row[k] for k in ("ms", "call_ms", "plain_ms", "bound_ms",
                                    "bound_by", "torch_sort_rows_ms",
                                    "kernels_a_call",
                                    "scratch_bytes", "kept_per_row",
                                    "walked_per_row")}
    report["nms_cuda"] = {
        "name": "nms_cuda", "route": "cuda",
        "source": "detjax_torch/csrc/nms.cu",
        "replaces": "detjax/kernels/postprocess.py:102",
        "launches": None, "match": True,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": unsorted["ms"], "ms_by": "device_ms",
        "plain_ms": unsorted["plain_ms"],
        "bound_ms": unsorted["bound_ms"], "bound_by": unsorted["bound_by"],
        "library_ms": None,
        "library_note": "no single PyTorch call computes class-aware greedy "
                        "NMS (torchvision is not installed)",
        f"ms_at_{PRIOR_NMS_MATCH}": unsorted["prior_ms"],
        "ms_sorted_rows": in_order["ms"],
        f"ms_sorted_rows_at_{PRIOR_NMS_MATCH}": in_order["prior_ms"],
        f"ms_at_{PRIOR_B5}": unsorted[f"ms_at_{PRIOR_B5}"],
        f"ms_sorted_rows_at_{PRIOR_B5}": in_order[f"ms_at_{PRIOR_B5}"],
        "bound_ms_steps": unsorted["bound_ms_steps"],
        "kernels_a_call": unsorted["kernels_a_call"],
        "long_rows": long_rows,
        "per": "one call at B=8, N=1000, max_det=100 on hard_candidates "
               "(unsorted rows); ms_sorted_rows on the same rows sorted; "
               "long_rows at N = 16,385 and 76,725",
        "ptxas": ptxas}


def decode_bound_ms(b: int, n: int, delta_bytes: int) -> tuple:
    """Least time for the full-set decode: deltas and anchors read once and
    the boxes written once over the memory rate; about 30 fp32 operations a
    box (the exps counted as one each) over the fp32 rate."""
    nbytes = b * n * 4 * delta_bytes + n * 16 + b * n * 16
    t_bytes = nbytes / H100["bytes_per_s"] * 1e3
    t_ops = 30.0 * b * n / H100["fp32_flops"] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def same_or_both_nan(a: torch.Tensor, b: torch.Tensor) -> bool:
    return bool(((a == b) | (a.isnan() & b.isnan())).all())


def phase_decode_kernel(report: dict) -> None:
    """decode_boxes_cuda against its twin on the card at R50-640, B = 8,
    over the full 76,725-anchor set: fp32 and bf16 deltas, clip on and
    off, with hard rows (dw = +-80 and +-500, so that exp overflows to inf
    and corners become inf - inf; NaN deltas; the edge anchors of the set
    reach past the canvas). Bar: bit-equal, NaN equal to NaN."""
    from detjax_torch.kernels import postprocess as pp
    from detjax_torch.modeling import anchor_config
    from detjax_torch.ops.anchors import anchors_for_shape

    cfg = smoke_config()
    anchors_np = anchors_for_shape(cfg.model.image_size, anchor_config(cfg))
    b, n = cfg.eval.batch_size, anchors_np.shape[0]
    rng = np.random.default_rng(6)
    d = rng.normal(0, 1.0, (b, n, 4)).astype(np.float32)
    d[:, ::5] *= 8.0
    rows = rng.choice(n, (b, 64), replace=False)
    for i in range(b):
        r = rows[i]
        d[i, r[:8], 2] = [80, -80, 500, -500] * 2
        d[i, r[8:16], 3] = [80, -80, 500, -500] * 2
        d[i, r[16:20], 0] = 1e38  # px = inf; with pw = inf, inf - inf
        d[i, r[16:20], 2] = 500
        d[i, r[20:24], rng.integers(0, 4, 4)] = np.nan
    anchors = torch.from_numpy(anchors_np).cuda()
    edge = anchors_np.min(axis=0)[:2].min() < 0 and anchors_np.max() > 640
    std, size = cfg.model.box_std, cfg.model.image_size
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        deltas = torch.from_numpy(d).to("cuda", dtype)
        for clip in (True, False):
            img = size if clip else None
            got = pp.decode_boxes_cuda(deltas, anchors, std, img)
            want = pp.decode_boxes_reference(deltas, anchors, std, img)
            torch.cuda.synchronize()
            equal = same_or_both_nan(got, want)
            fin = torch.isfinite(want)
            err = float((got - want)[fin].abs().max())
            counts = {"nan": int(got.isnan().sum()),
                      "inf": int(got.isinf().sum())}
            pp.decode_launches = 0
            ms = cuda_ms(lambda: pp.decode_boxes_cuda(deltas, anchors, std,
                                                      img), iters=200,
                         warmup=10)
            timed = pp.decode_launches
            dev_ms = device_ms(lambda: pp.decode_boxes_cuda(
                deltas, anchors, std, img), iters=200)
            plain_ms = cuda_ms(lambda: pp.decode_boxes_reference(
                deltas, anchors, std, img), iters=50)
            bound_ms, bound_by = decode_bound_ms(b, n, deltas.element_size())
            row = {"deltas": str(dtype).split(".")[-1], "clip": clip,
                   "bit_equal_nan_equal": equal, "max_abs_err_finite": err,
                   **counts, "ms": ms, "device_ms": dev_ms,
                   "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "launches_timed": timed}
            emit({"phase": "decode_kernel", "kernel": "decode_boxes_cuda",
                  "B": b, "N": n, **row})
            if not equal:
                raise SystemExit(f"decode_boxes_cuda differs from its twin: "
                                 f"{row}")
            if not (counts["nan"] and (clip or counts["inf"])):
                raise SystemExit(f"the hard rows lost their NaN / inf: {row}")
            cases.append(row)
    if not edge:
        raise SystemExit("the anchor set has no anchor past the canvas edge")
    main = cases[0]  # fp32 deltas, clipped: what the eval branch runs
    report["decode_boxes_cuda"] = {
        "name": "decode_boxes_cuda", "route": "cuda",
        "source": "detjax_torch/csrc/decode.cu",
        "replaces": "detjax/kernels/postprocess.py:214",
        "launches": None, "match": True,
        "max_abs_err": max(c["max_abs_err_finite"] for c in cases),
        "ms": main["ms"], "ms_by": "cuda_ms",
        "device_ms": main["device_ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": None,
        "library_note": "no single PyTorch call decodes boxes",
        "per": "one eval batch at 640 px, bs 8, fp32 deltas, clipped",
        "cases": cases}


def hard_gt(seed: int, anchors: np.ndarray, b: int = 16, g: int = 100):
    """Seeded GT built to be hard for matching, on the 640 canvas: exact
    duplicates (tied IoUs), padding between valid GTs, one image with no
    valid GT and one with a single GT, zero-area GTs, GTs larger than the
    canvas, GTs equal to an anchor (IoU exactly 1) and GTs at IoU 0.5 and
    (as near as fp32 lets) 0.4 against an anchor."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(0, 640, (b, g, 2))
    wh = rng.uniform(6, 420, (b, g, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    labels = rng.integers(0, 80, (b, g)).astype(np.int32)
    n_valid = rng.integers(10, g + 1, b)
    for i in range(b):
        labels[i, n_valid[i]:] = -1  # trailing padding
    labels[::2, 3::7] = -1  # padding between valid GTs
    for i in range(b):
        src = rng.integers(0, g, 8)
        boxes[i, rng.integers(0, g, 8)] = boxes[i, src]  # exact duplicates
    boxes[:, 5, 2] = boxes[:, 5, 0]  # zero width
    boxes[:, 6, 3] = boxes[:, 6, 1]  # zero height
    boxes[:, 7] = [-60.0, -40.0, 700.0, 690.0]  # larger than the canvas
    wh_a = anchors[:, 2:] - anchors[:, :2]
    square = anchors[(wh_a[:, 0] == 32) & (wh_a[:, 1] == 32)]
    picks = square[rng.choice(len(square), (b, 3), replace=False)]
    boxes[:, 0] = picks[:, 0]  # IoU exactly 1
    boxes[:, 1] = picks[:, 1]
    boxes[:, 1, 3] = picks[:, 1, 1] + 16.0  # IoU exactly 0.5
    boxes[:, 2] = picks[:, 2]
    boxes[:, 2, 3] = picks[:, 2, 1] + 12.8  # IoU at fp32(0.4)
    labels[:, :3] = rng.integers(0, 80, (b, 3))
    labels[b - 1] = -1  # no valid GT
    labels[b - 2] = -1
    labels[b - 2, g // 2 - 1] = 7  # a single valid GT, behind padding
    return anchors, boxes, labels


# About 15 fp32 operations and one IEEE division per (anchor, GT) pair:
# two min, two max, two subtractions and two clamps for the overlap, one
# product, an add and a subtraction and a clamp for the union, the
# division, the validity select and the running-max compare.
MATCH_OPS_PER_PAIR = 16


def match_bound_ms(b: int, a: int, g: int, pairs: int) -> tuple:
    """Least time for matching at these shapes: anchors [A,4] f32 and GT
    (box, valid, label) read once, the four outputs written once, over the
    memory rate; the IoU work of ``pairs`` (anchor, GT) pairs over the
    fp32 rate."""
    nbytes = a * 16 + b * g * (16 + 1 + 4) + b * a * (4 + 4 + 16 + 4)
    ops = float(MATCH_OPS_PER_PAIR) * pairs
    t_bytes = nbytes / H100["bytes_per_s"] * 1e3
    t_ops = ops / H100["fp32_flops"] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def match_listed_pairs(anchors, boxes, valid, per: int) -> int:
    """(anchor, GT) pairs left after culling, which the kernel divides:
    for each block of ``per`` consecutive anchors, its anchors times the
    valid GTs its union box does not cull (every coordinate here is finite
    and small). The other pairs' IoUs are known without one: -1 for an
    invalid GT, exactly 0 for a culled one."""
    a = anchors.shape[0]
    nb = -(-a // per)
    an = torch.cat([anchors, anchors[-1:].expand(nb * per - a, 4)])
    an = an.view(nb, per, 4)
    u = torch.stack([an[..., 0].amin(1), an[..., 1].amin(1),
                     an[..., 2].amax(1), an[..., 3].amax(1)], -1)[None, :,
                                                                 None]
    g = boxes[:, None]  # [B, 1, G, 4] against [1, nb, 1, 4]
    apart = ((torch.minimum(u[..., 2], g[..., 2])
              <= torch.maximum(u[..., 0], g[..., 0]))
             | (torch.minimum(u[..., 3], g[..., 3])
                <= torch.maximum(u[..., 1], g[..., 1])))
    listed = (valid[:, None] & ~apart).sum(-1)  # [B, nb]
    counts = torch.full((nb,), per, device=anchors.device)
    counts[-1] = a - (nb - 1) * per
    return int((listed * counts).sum())


def phase_match_kernel(report: dict) -> None:
    """match_iou_cuda against its twin at the training shape of
    retinanet_r50_640 (B=16, its 76,725 anchors, G=100) on two GT sets:
    the hard set and the GT of the training batch (1-20 objects an image).
    All four outputs bit-equal; timed in turns with the kernels at
    PRIOR_NMS_MATCH and PRIOR_B5; its CUDA kernels counted by the launcher
    and by torch.profiler; its bound from the pairs left after culling,
    beside the earlier counts (every pair; the pairs with a valid GT).
    Then G = LONG_GT slots (hard_gt at that width), past what one list in
    shared memory holds: the chunked instance, bit-equal to the twin
    (compared a run of anchors at a time), timed alone."""
    from detjax_torch.kernels import matching as km
    from detjax_torch.kernels._build import build_info
    from detjax_torch.modeling import anchor_config
    from detjax_torch.ops.anchors import anchors_for_shape

    ptxas = ptxas_by_kernel(build_info["detjax_match"]["log"],
                            ("match_kernel",))
    spills = {k: v for k, v in ptxas.items()
              if v.get("spill_stores") or v.get("spill_loads")}
    emit({"phase": "match_kernel_build", "ptxas": ptxas,
          "instances": "match_kernel<0>: one list of up to 9,642 GT slots; "
                       "match_kernel<1>: the slots 4,096 at a time"})
    if sorted(ptxas) != ["match_kernel<0>", "match_kernel<1>"] or spills:
        raise SystemExit(f"the matching kernels spill or are missing from "
                         f"the ptxas log: {ptxas}")
    cfg = smoke_config()
    anchors_np = anchors_for_shape(cfg.model.image_size, anchor_config(cfg))
    b, g = cfg.train.batch_size, cfg.train.max_gt
    _, hard_boxes, hard_labels = hard_gt(4, anchors_np, b, g)
    batch = train_batch(cfg, seed=0)
    anchors = torch.from_numpy(anchors_np).cuda()
    a = anchors.shape[0]
    names = ("max_iou", "argmax", "boxes", "labels")
    rows = []
    for case, (boxes_np, labels_np) in (
            ("hard_gt", (hard_boxes, hard_labels)),
            ("train_batch", (batch["gt_boxes"], batch["gt_labels"]))):
        boxes = torch.from_numpy(np.ascontiguousarray(
            boxes_np, np.float32)).cuda()
        labels = torch.from_numpy(np.ascontiguousarray(
            labels_np, np.int32)).cuda()
        valid = labels >= 0
        args = (anchors, boxes, valid, labels)
        c0, k0 = km.match_launches, km.match_kernel_launches
        got = km.match_iou_cuda(*args)
        calls, kernels = km.match_launches - c0, km.match_kernel_launches - k0
        want = km.match_iou_reference(*args)
        priors = {PRIOR_NMS_MATCH: prior_match_call(*args),
                  PRIOR_B5: prior_b5_match_call(*args)}
        equal = {n: torch.equal(x, y) for n, x, y in zip(names, got, want)}
        for p, call in priors.items():
            equal.update({f"{p}_{n}": torch.equal(x, y)
                          for n, x, y in zip(names, call(), want)})
        torch.cuda.synchronize()
        if not all(equal.values()):
            raise SystemExit(f"match_iou_cuda or the prior kernel disagrees "
                             f"with its twin on {case}: {equal}")
        if (calls, kernels) != (1, 1):
            raise SystemExit(f"match_iou_cuda counted {calls} calls and "
                             f"{kernels} CUDA kernels for one call")
        traced = traced_counts(lambda: km.match_iou_cuda(*args),
                               {"match_kernel": kernels}, "match_iou_cuda")
        max_iou = got[0]
        edges = {"iou_1": int((max_iou == 1.0).sum()),
                 "iou_0.5": int((max_iou == 0.5).sum()),
                 "iou_within_1e-6_of_0.4": int(((max_iou - 0.4).abs()
                                                < 1e-6).sum()),
                 "images_without_gt": int((max_iou == -1).all(dim=1).sum()),
                 "valid_gt_per_image": valid.sum(dim=1).tolist()}
        timed = in_turns({"new": lambda: km.match_iou_cuda(*args), **priors},
                         (PRIOR_NMS_MATCH, PRIOR_B5, "new", "new", PRIOR_B5,
                          PRIOR_NMS_MATCH), iters=100)
        call_ms = cuda_ms(lambda: km.match_iou_cuda(*args), iters=100)
        plain_ms = cuda_ms(lambda: km.match_iou_reference(*args), iters=5,
                           warmup=1)
        valid_pairs = a * int(valid.sum())
        divided = match_listed_pairs(anchors, boxes, valid,
                                     km.ANCHORS_PER_BLOCK)
        bound_ms, bound_by = match_bound_ms(b, a, g, divided)
        bound_valid, bound_valid_by = match_bound_ms(b, a, g, valid_pairs)
        bound_all, bound_all_by = match_bound_ms(b, a, g, b * a * g)
        row = {"case": case, "B": b, "A": a, "G": g, "bit_equal": equal,
               "edges": edges, "ms": timed["ms"]["new"],
               "ms_by": "device_ms",
               "prior_ms": timed["ms"][PRIOR_NMS_MATCH],
               f"ms_at_{PRIOR_B5}": timed["ms"][PRIOR_B5],
               "timed_in_turns": timed["turns"], "call_ms": call_ms,
               "anchors_per_block": km.ANCHORS_PER_BLOCK,
               "kernels_a_call": kernels,
               "ms_by_kernel": traced, "plain_ms": plain_ms,
               "pairs_all": b * a * g, "pairs_valid": valid_pairs,
               "pairs_divided": divided,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "bound_ms_valid_pairs": bound_valid,
               "bound_by_valid_pairs": bound_valid_by,
               "bound_ms_all_pairs": bound_all,
               "bound_by_all_pairs": bound_all_by,
               "max_abs_err": float((got[0] - want[0]).abs().max()),
               "library_ms": None}
        emit({"phase": "match_kernel", "kernel": "match_iou_cuda", **row,
              "library_note": "no single PyTorch call computes it; "
                              "torchvision's box_iou is not installed and "
                              "would still need an argmax and gathers"})
        rows.append(row)
    hard, train = rows
    edges = hard["edges"]
    if not (edges["iou_1"] and edges["iou_0.5"]
            and edges["images_without_gt"] == 1):
        raise SystemExit(f"the hard GT set lost its edges: {edges}")
    report["match_iou_cuda"] = {
        "name": "match_iou_cuda", "route": "cuda",
        "source": "detjax_torch/csrc/matching.cu",
        "replaces": "detjax/kernels/matching.py:88",
        "launches": None, "match": True,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": hard["ms"], "ms_by": "device_ms", "plain_ms": hard["plain_ms"],
        "bound_ms": hard["bound_ms"], "bound_by": hard["bound_by"],
        "library_ms": None,
        f"ms_at_{PRIOR_NMS_MATCH}": hard["prior_ms"],
        "bound_ms_valid_pairs": hard["bound_ms_valid_pairs"],
        "bound_ms_all_pairs": hard["bound_ms_all_pairs"],
        f"ms_at_{PRIOR_B5}": hard[f"ms_at_{PRIOR_B5}"],
        "ms_train_batch_gt": train["ms"],
        f"ms_train_batch_gt_at_{PRIOR_NMS_MATCH}": train["prior_ms"],
        f"ms_train_batch_gt_at_{PRIOR_B5}": train[f"ms_at_{PRIOR_B5}"],
        "long_gt": match_long_gt(anchors, anchors_np, b),
        "bound_ms_train_batch_gt": train["bound_ms"],
        "kernels_a_call": hard["kernels_a_call"],
        "per": "one call at B=16, A=76,725, G=100 on hard_gt; "
               "ms_train_batch_gt on train_batch(cfg, 0)'s GT",
        "ptxas": ptxas}


# GT slots past what one list in shared memory holds (9,642)
LONG_GT = 20000


def match_long_gt(anchors, anchors_np, b: int) -> dict:
    """match_iou_cuda at G = LONG_GT on hard_gt of that width (B = b, the
    full anchor set): the chunked instance, one launch, all four outputs
    bit-equal to the twin, which runs 2,048 anchors at a time (its
    [B, A, G] IoU whole would take 98 GB); timed by device_ms."""
    from detjax_torch.kernels import matching as km

    _, boxes_np, labels_np = hard_gt(5, anchors_np, b, LONG_GT)
    boxes = torch.from_numpy(boxes_np).cuda()
    labels = torch.from_numpy(labels_np).cuda()
    valid = labels >= 0
    args = (anchors, boxes, valid, labels)
    c0, k0 = km.match_launches, km.match_kernel_launches
    got = km.match_iou_cuda(*args)
    calls, kernels = km.match_launches - c0, km.match_kernel_launches - k0
    equal = True
    for a0 in range(0, anchors.shape[0], 2048):
        want = km.match_iou_reference(anchors[a0:a0 + 2048], boxes, valid,
                                      labels)
        equal &= all(torch.equal(x[:, a0:a0 + 2048], y)
                     for x, y in zip(got, want))
    del want
    ms = device_ms(lambda: km.match_iou_cuda(*args), iters=10)
    row = {"B": b, "A": int(anchors.shape[0]), "G": LONG_GT,
           "gt_chunk": km.GT_CHUNK, "bit_equal": equal,
           "kernels_a_call": kernels, "ms": ms, "ms_by": "device_ms",
           "valid_gt_per_image": valid.sum(dim=1).tolist()}
    emit({"phase": "match_kernel_long_gt", "kernel": "match_iou_cuda",
          **row})
    if not equal or (calls, kernels) != (1, 1):
        raise SystemExit(f"match_iou_cuda at G={LONG_GT}: {row}")
    return row


# The identity bottlenecks that fuse in R50 at 640 px, eval batch 8:
# (name, B, H, W, M, launches per forward); C = 4 M.
FUSED_SHAPES = (("layer1", 8, 160, 160, 64, 2), ("layer2", 8, 80, 80, 128, 3))
# Held to the twin too, outside the per-forward totals: layer2 of a 608x832
# canvas (W = 104: 128-pixel tiles straddle rows).
EXTRA_FUSED_SHAPES = (("tail_608x832_layer2", 2, 76, 104, 128, None),)
# the CUDA kernels of one call of the fused forward, and of the prior one
FWD_KERNEL_NAMES = ("y1_kernel", "fwd_tile_kernel")
PRIOR_FWD_KERNEL_NAMES = ("bottleneck_fwd_kernel",)


def bottleneck_bound_ms(b: int, h: int, w: int, m: int) -> tuple:
    """Least time for one fused block: x read once and the output written
    once (bf16; the weights are under 1 %) over the memory rate, and the
    three convolutions' multiply-adds over the bf16 tensor-core rate (the
    TPU kernel runs them on the MXU)."""
    c = 4 * m
    nbytes = 2 * b * h * w * c * 2
    ops = 2.0 * (c * m + 9 * m * m + m * c) * b * h * w
    t_bytes = nbytes / H100["bytes_per_s"] * 1e3
    t_ops = ops / H100["bf16_flops"] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance between two bf16 tensors in bf16 steps (-0 = +0);
    large where one side is a ReLU's 0 and the other a tiny value."""
    def ordinal(t):
        v = t.view(torch.int16).to(torch.int32)
        return torch.where(v < 0, -(v & 0x7FFF), v)
    return int((ordinal(a) - ordinal(b)).abs().max())


@contextlib.contextmanager
def tf32_off():
    """cuDNN convolutions and matmuls in full fp32 (both default to TF32
    for convolutions), for the fp32 references."""
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = flags


def phase_bottleneck_kernel(report: dict) -> None:
    """The fused forward against its twin (fp32 convs, TF32 off) at the two
    shapes R50's fused blocks have at 640 px, eval batch 8 and train batch
    16, and at a 104-px tail, with detjax's bars (tests/test_kernels.py:
    175-177); two runs bit-equal. At the 640 shapes, in turns in one call:
    the forward, the prior one-kernel wmma forward (PRIOR_FWD) and the
    port's unfused block (cuDNN, bf16 autocast); beside them the twin and
    the bound, the split by CUDA kernel (torch.profiler, whose launch
    counts must equal the launcher's), each kernel's shared memory,
    registers and spills, and the y1 scratch's bytes."""
    from detjax_torch.kernels import bottleneck as kb
    from detjax_torch.kernels._build import build_info

    ptxas = ptxas_by_kernel(build_info["detjax_bottleneck"]["log"],
                            FWD_KERNEL_NAMES)
    prior_ptxas = ptxas_by_kernel(
        build_info[f"detjax_bottleneck_fwd_{PRIOR_FWD}"]["log"],
        PRIOR_FWD_KERNEL_NAMES)
    spills = {k: v for k, v in ptxas.items()
              if v.get("spill_stores") or v.get("spill_loads")}
    emit({"phase": "bottleneck_kernel_build", "ptxas": ptxas,
          "prior_ptxas": prior_ptxas})
    if len(ptxas) != 2 * len(kb.WIDTHS) or spills:
        raise SystemExit(f"the forward's kernels spill or are missing from "
                         f"the ptxas log: {ptxas}")
    # seeds 10 + i in this order: the eval and tail shapes keep theirs
    groups = {"eval_bs8": FUSED_SHAPES, "extra": EXTRA_FUSED_SHAPES,
              "train_bs16": FUSED_TRAIN_SHAPES}
    rows = {g: [] for g in groups}
    for i, (group, (name, b, h, w, m, n_fwd)) in enumerate(
            (g, shape) for g, shapes in groups.items() for shape in shapes):
        x, block = kb.seeded_block(10 + i, b, h, w, m, "cuda")
        with torch.no_grad():
            wts = block.folded_weights()
        plan = kb.fwd_plan(b, h, w, m)
        k0 = kb.bottleneck_kernel_launches
        got = kb.bottleneck_identity(x, *wts)
        kernels_a_call = kb.bottleneck_kernel_launches - k0
        again = kb.bottleneck_identity(x, *wts)
        with tf32_off():
            want = kb.bottleneck_identity_reference(x, *wts)
        torch.cuda.synchronize()
        bit_equal = torch.equal(got.view(torch.int16), again.view(torch.int16))
        gf, wf = got.float(), want.float()
        err = float((gf - wf).abs().max())
        tol = 0.05 * max(float(wf.abs().max()), 1.0)
        frac = float((got != want).float().mean())
        ulps = bf16_ulps(got, want)
        # the same error in bf16 steps at the output's largest magnitude
        ulp_at_max = 2.0 ** (np.floor(np.log2(float(wf.abs().max()))) - 7)
        finite = bool(torch.isfinite(gf).all())
        del got, again, want, gf, wf
        row = {"shape": name, "B": b, "H": h, "W": w, "C": 4 * m, "M": m,
               "launches_per_forward": n_fwd, "max_abs_err": err,
               "tolerance": tol, "frac_differ": frac, "max_bf16_ulps": ulps,
               "max_err_in_bf16_ulps_at_max_twin": err / ulp_at_max,
               "bit_equal_across_two_runs": bit_equal,
               "kernels_a_call": kernels_a_call,
               "pixel_tiles": plan["tiles"],
               "scratch_bytes": plan["scratch_bytes"],
               "smem_bytes": {k: v for k, v in kb.fwd_geometry(m).items()
                              if k.startswith("smem")},
               "ptxas": {k: v for k, v in ptxas.items()
                         if k.endswith(f"<{m}>")}}
        if not (finite and err <= tol and frac < 0.01 and bit_equal):
            raise SystemExit(f"the bottleneck kernel disagrees with its twin "
                             f"at {name} (B={b}): {row}")
        if kernels_a_call != plan["kernels"]:
            raise SystemExit(f"the forward launched {kernels_a_call} CUDA "
                             f"kernels a call, planned {plan['kernels']}")
        def current():
            return kb.bottleneck_identity(x, *wts)
        x_nchw = x.permute(0, 3, 1, 2)  # channels-last view, no copy

        def unfused():
            with torch.autocast(x.device.type, dtype=torch.bfloat16):
                return block(x_nchw)
        if group != "extra":
            # in turns in one call: prior, current, cuDNN, then back
            calls = {"current": current, PRIOR_FWD: prior_fwd_call(x, wts),
                     "unfused_cudnn": unfused}
            with torch.inference_mode():
                turns = [(c, cuda_ms(calls[c], iters=20)) for c in
                         (PRIOR_FWD, "current", "unfused_cudnn",
                          "unfused_cudnn", "current", PRIOR_FWD)]

            def mean_of(c):
                return float(np.mean([t for k, t in turns if k == c]))
            traced = kernel_ms_complete(
                current, {k: 1.0 for k in FWD_KERNEL_NAMES},
                f"the forward at {tuple(x.shape)}")
            prior_traced = kernel_ms_by_name(calls[PRIOR_FWD])
            row.update({
                "ms": mean_of("current"), "prior_ms": mean_of(PRIOR_FWD),
                "unfused_cudnn_ms": mean_of("unfused_cudnn"),
                "timed_in_turns": turns,
                "ms_by_kernel": traced and {"ms": traced[0],
                                            "launches_a_call": traced[1]},
                "prior_ms_by_kernel": prior_traced and prior_traced[0]})
            if traced and (sorted(traced[1]) != sorted(FWD_KERNEL_NAMES)
                           or sum(traced[1].values()) != kernels_a_call):
                raise SystemExit(f"torch.profiler saw {traced[1]} a call of "
                                 f"the forward, the launcher counted "
                                 f"{kernels_a_call} of {FWD_KERNEL_NAMES}")
            del calls
        else:
            row["ms"] = cuda_ms(current, iters=20)
        with tf32_off():
            row["plain_ms"] = cuda_ms(
                lambda: kb.bottleneck_identity_reference(x, *wts), iters=5,
                warmup=1)
        row["bound_ms"], row["bound_by"] = bottleneck_bound_ms(b, h, w, m)
        emit({"phase": "bottleneck_kernel", "kernel": "bottleneck_identity",
              "group": group, **row, "library_ms": None,
              "bars": "max |kernel - twin| <= 0.05 * max(|twin|, 1) and "
                      "under 1 % of elements differ (detjax's own): the "
                      "kernel sums fp32 in another order than cuDNN; two "
                      "runs bit-equal"})
        rows[group].append(row)
        del x, block, wts, x_nchw, current
    keys = ("ms", "prior_ms", "plain_ms", "unfused_cudnn_ms", "bound_ms")
    total = {g: {k: sum(r[k] * r["launches_per_forward"] for r in rows[g])
                 for k in keys} for g in ("eval_bs8", "train_bs16")}
    per_shape = rows["eval_bs8"]
    report["bottleneck_identity_cuda"] = {
        "name": "bottleneck_identity_cuda", "route": "cuda",
        "source": "detjax_torch/csrc/bottleneck.cu",
        "replaces": "detjax/kernels/bottleneck.py:131",
        "launches": None, "match": True,
        "max_abs_err": max(r["max_abs_err"] for g in rows for r in rows[g]),
        "ms": total["eval_bs8"]["ms"], "ms_by": "cuda_ms",
        "plain_ms": total["eval_bs8"]["plain_ms"],
        "bound_ms": total["eval_bs8"]["bound_ms"],
        "bound_by": "/".join(sorted({r["bound_by"] for r in per_shape})),
        "library_ms": None,
        "library_note": "no single PyTorch call computes the fused block; "
                        "the port's unfused cuDNN block is unfused_cudnn_ms",
        "unfused_cudnn_ms": total["eval_bs8"]["unfused_cudnn_ms"],
        f"ms_at_{PRIOR_FWD}": total["eval_bs8"]["prior_ms"],
        "kernels_a_call": per_shape[0]["kernels_a_call"],
        "per": "one R50 forward at 640 px, bs 8: 2 layer1 + 3 layer2 "
               "launches",
        "train_bs16_per_step": total["train_bs16"],
        "shapes": per_shape,
        "extra_shapes": rows["train_bs16"] + rows["extra"]}


# The identity bottlenecks that fuse in R50 at 640 px, train batch 16:
# (name, B, H, W, M, launches per step); C = 4 M.
FUSED_TRAIN_SHAPES = (("layer1", 16, 160, 160, 64, 2),
                      ("layer2", 16, 80, 80, 128, 3))
# Held to the twin too, outside the per-step totals: retinanet_r50_1024's
# training shapes (train batch 8; rows of 256 and 128 px), and layer2 of a
# 608x832 canvas (W = 104: 128-pixel tiles straddle rows, parts end
# mid-row).
EXTRA_FUSED_TRAIN_SHAPES = (("r50_1024_layer1", 8, 256, 256, 64, 2),
                            ("r50_1024_layer2", 8, 128, 128, 128, 3),
                            ("tail_608x832_layer2", 2, 76, 104, 128, None))


def bottleneck_bwd_bound_ms(b: int, h: int, w: int, m: int) -> tuple:
    """Least time for one fused block's backward: x and dy read once and
    dx written once (bf16; the weights and their gradients are under 1 %)
    over the memory rate, and three times the forward's multiply-adds
    (recompute, the input gradient, the weight gradients) over the bf16
    tensor-core rate."""
    c = 4 * m
    nbytes = 3 * b * h * w * c * 2
    ops = 3 * 2.0 * (c * m + 9 * m * m + m * c) * b * h * w
    t_bytes = nbytes / H100["bytes_per_s"] * 1e3
    t_ops = ops / H100["bf16_flops"] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# host wait inside a profiler window before the calls' first launch and
# after their last kernel's end, and the spin kernels that open the window
PROFILER_PAD_S = 0.05
PROFILER_WARMUP_LAUNCHES = 4


def profile_calls(fn, calls: int,
                  warmup_launches: int = PROFILER_WARMUP_LAUNCHES):
    """torch.profiler (CUDA activity) over ``calls`` calls of ``fn``, after
    one call outside it; None when the profiler cannot trace the card. The
    window opens with ``warmup_launches`` spin kernels, waited for: the
    profiler can miss the kernels of a window's first two launches while
    it finishes enabling itself (the first launch then takes about 0.5
    ms). It is open PROFILER_PAD_S before the calls' first launch and
    after their last kernel has finished: the profiler places a window's
    records on the host's clock with an error of milliseconds and drops
    those it places outside the window (smoke_prior/profiler_window.py
    shows both)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(warmup_launches):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            time.sleep(PROFILER_PAD_S)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            time.sleep(PROFILER_PAD_S)
    except (AssertionError, RuntimeError) as exc:
        emit({"profiler": "no device trace", "error": repr(exc)})
        return None
    return prof


def kernel_ms_by_name(fn, calls: int = 3):
    """Device ms a call of ``fn`` spends in each CUDA kernel, and how many
    times a call launches each, from torch.profiler over ``calls`` calls
    (profile_calls); None when the profiler cannot trace the card or
    records no device time."""
    prof = profile_calls(fn, calls)
    if prof is None:
        return None
    ms, launches = {}, {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", 0.0)
        if t > 0:  # "void (anonymous namespace)::y1_kernel<64>(...)"
            name = re.sub(r"^void |\(anonymous namespace\)::", "", e.key)
            name = re.split(r"[<(]", name)[0]
            if "spin_kernel" in name:  # the window's warm-up launches
                continue
            ms[name] = ms.get(name, 0.0) + t / calls / 1e3
            launches[name] = launches.get(name, 0) + e.count / calls
    return (ms, launches) if ms else None


def kernel_ms_complete(fn, want: dict, what: str, calls: int = 3):
    """kernel_ms_by_name of ``fn``, traced again while the launches a call
    of the kernels in ``want`` (kernel -> the launcher's count a call) fall
    short of it (complete_window); the caller holds the counts."""
    found = {}

    def trace():
        found["traced"] = kernel_ms_by_name(fn, calls)
        if found["traced"] is None:
            return None
        return {k: found["traced"][1].get(k, 0.0) for k in want}

    return None if complete_window(trace, want, what) is None else (
        found["traced"])


def forward_busy(model, x, grad: bool) -> dict:
    """One forward of ``model`` on ``x`` as serving runs it (inference
    mode) or as the training step does (autograd recording): ms a call by
    CUDA events, the device time its CUDA kernels take (torch.profiler),
    and the share of the call the device is idle. The same forward with
    every fused block unfused beside it, on the same weights."""
    def run(m):
        def fwd():
            if grad:
                return m(x)
            with torch.inference_mode():
                return m(x)
        ms = cuda_ms(fwd, iters=10)
        traced = kernel_ms_by_name(fwd)
        busy = sum(traced[0].values()) if traced else None
        return {"ms": ms, "device_busy_ms": busy,
                "idle_share": None if busy is None else 1 - busy / ms}
    unfused = copy.deepcopy(model)
    for blk in unfused.fused_blocks():
        blk.fused = False
    out = {"on": run(model), "off": run(unfused)}
    del unfused
    return out


BWD_NAMES = ("dx", "dw1", "db1", "dw2", "db2", "dw3", "db3")
# the CUDA kernels of one call of the fused backward
BWD_KERNEL_NAMES = ("y1_kernel", "dc2_kernel", "dc1_kernel", "wgrad_kernel",
                    "sum_rows")
# dx may leave the 0.02 x max|twin| bar on this share of its elements,
# where a ReLU mask flips between the kernel's and cuDNN's fp32 sums
# (measured on an H100: 8.5e-6 at layer1, 8.9e-5 at layer2)
DX_FLIP_SHARE = 1e-3


def phase_bottleneck_bwd_kernel(report: dict) -> None:
    """The fused block's backward kernel against its twin (fp32 convs, TF32
    off) at the two shapes R50's fused blocks have at 640 px, train batch
    16, with detjax's bar for its backward (tests/test_kernels.py:196-197);
    two runs on the same inputs bit-equal; the CUDA kernels a call, the
    split-K parts and the scratch bytes; times beside the bound, the twin,
    the forward kernel and the port's unfused block's forward and backward
    (cuDNN, bf16 autocast). At those two shapes the backward is also split
    by CUDA kernel with torch.profiler, whose launch counts must match the
    launcher's."""
    from detjax_torch.kernels import bottleneck as kb

    per_shape, extra = [], []
    for i, (name, b, h, w, m, n_step) in enumerate(FUSED_TRAIN_SHAPES
                                                   + EXTRA_FUSED_TRAIN_SHAPES):
        x, block = kb.seeded_block(20 + i, b, h, w, m, "cuda")
        rng = np.random.default_rng(30 + i)
        dy = torch.from_numpy(rng.normal(0, 1, x.shape).astype(np.float32)
                              ).to(x.device, torch.bfloat16)
        with torch.no_grad():
            wts = block.folded_weights()
        args = (x, dy, *wts)
        plan = kb.bwd_plan(b, h, w, m)
        # the CUDA kernels each of the two calls launched, as the launcher
        # counts them
        k0 = kb.bottleneck_bwd_kernel_launches
        got = kb.bottleneck_identity_backward(*args)
        k1 = kb.bottleneck_bwd_kernel_launches
        again = kb.bottleneck_identity_backward(*args)
        k2 = kb.bottleneck_bwd_kernel_launches
        kernels_a_call = k1 - k0 if k1 - k0 == k2 - k1 else [k1 - k0, k2 - k1]
        with tf32_off():
            want = kb.bottleneck_identity_backward_reference(*args)
        torch.cuda.synchronize()
        bit_equal = all(torch.equal(g, a) for g, a in zip(got, again))
        errs = {}
        for key, g, r in zip(BWD_NAMES, got, want):
            gf, rf = g.float(), r.float()
            tol = 0.02 * max(float(rf.abs().max()), 1e-3)
            err = (gf - rf).abs()
            errs[key] = {"max_abs_err": float(err.max()), "tolerance": tol,
                         "frac_over_tolerance": float((err > tol).float()
                                                      .mean()),
                         "norm_rel_err": float(torch.linalg.vector_norm(
                             gf - rf) / torch.linalg.vector_norm(rf)),
                         "finite": bool(torch.isfinite(gf).all())}
            del err
        dx_max = float(want[0].float().abs().max())
        ulp_at_max = 2.0 ** (np.floor(np.log2(dx_max)) - 7)
        dx_info = {"frac_differ": float((got[0] != want[0]).float().mean()),
                   "max_bf16_ulps": bf16_ulps(got[0], want[0]),
                   "max_err_in_bf16_ulps_at_max_twin":
                       errs["dx"]["max_abs_err"] / ulp_at_max}
        del got, again, want
        def current():
            return kb.bottleneck_identity_backward(*args)
        ms = cuda_ms(current, iters=10)
        kernel_split, traced = None, None
        if i < len(FUSED_TRAIN_SHAPES):
            traced = kernel_ms_complete(
                current, {k: 1.0 for k in BWD_KERNEL_NAMES},
                f"the backward at {tuple(x.shape)}")
            kernel_split = traced and {"ms": traced[0],
                                       "launches_a_call": traced[1]}
        with tf32_off():
            plain_ms = cuda_ms(
                lambda: kb.bottleneck_identity_backward_reference(*args),
                iters=3, warmup=1)
        fwd_ms = cuda_ms(lambda: kb.bottleneck_identity(x, *wts), iters=10)
        block.requires_grad_(True)
        x_nchw = x.permute(0, 3, 1, 2).detach().requires_grad_(True)
        dy_nchw = dy.permute(0, 3, 1, 2)

        def unfused():
            with torch.autocast(x.device.type, dtype=torch.bfloat16):
                y = block(x_nchw)
            y.backward(dy_nchw)
        unfused_ms = cuda_ms(unfused, iters=10)
        bound_ms, bound_by = bottleneck_bwd_bound_ms(b, h, w, m)
        geom = kb.bwd_geometry(m)
        row = {"shape": name, "B": b, "H": h, "W": w, "C": 4 * m, "M": m,
               "launches_per_step": n_step, "outputs": errs,
               "dx": dx_info, "bit_equal_across_two_runs": bit_equal,
               "ms": ms, "ms_by_kernel": kernel_split,
               "plain_ms": plain_ms, "forward_kernel_ms": fwd_ms,
               "unfused_cudnn_ms": unfused_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "kernels_a_call": kernels_a_call,
               "pixel_tiles": plan["tiles"],
               "split_k_parts": plan["parts"],
               "split_k_part_pixels": plan["part_pixels"],
               "weight_jobs": plan["jobs"],
               "scratch_bytes": plan["scratch_bytes"],
               "workspace_bytes": plan["workspace_bytes"],
               "smem_bytes": {k: geom[k] for k in
                              ("smem_y1", "smem_tile", "smem_wgrad")}}
        emit({"phase": "bottleneck_bwd_kernel",
              "kernel": "bottleneck_identity_backward", **row,
              "library_ms": None,
              "bars": "the six fp32 sums within 0.02 * max(|twin|, 1e-3) "
                      "(detjax's bar for its backward); dx within it on "
                      f"all but {DX_FLIP_SHARE} of its elements and "
                      "within 0.02 of the twin in the 2-norm: the kernel "
                      "sums fp32 in other orders than cuDNN, which moves "
                      "bf16 roundings of y1 and y2 by a step, and where "
                      "y3 + x, y2 or y1 lies that close to 0 the two "
                      "decide its ReLU mask differently and dx moves by up "
                      "to |dy| there; two runs bit-equal (no atomics)"})
        ok = all(e["finite"] for e in errs.values()) and all(
            errs[k]["max_abs_err"] <= errs[k]["tolerance"]
            for k in BWD_NAMES[1:])
        ok = ok and (errs["dx"]["frac_over_tolerance"] <= DX_FLIP_SHARE
                     and errs["dx"]["norm_rel_err"] <= 0.02)
        if not (ok and bit_equal):
            raise SystemExit(f"the bottleneck backward kernel disagrees with "
                             f"its twin at {name}: {row}")
        if kernels_a_call != plan["kernels"]:
            raise SystemExit(f"the backward launched {kernels_a_call} CUDA "
                             f"kernels a call, planned {plan['kernels']}")
        if traced and (sorted(traced[1]) != sorted(BWD_KERNEL_NAMES)
                       or sum(traced[1].values()) != kernels_a_call):
            raise SystemExit(f"torch.profiler saw {traced[1]} a call of the "
                             f"backward, the launcher counted "
                             f"{kernels_a_call} of {BWD_KERNEL_NAMES}")
        (per_shape if i < len(FUSED_TRAIN_SHAPES) else extra).append(row)
        del x, dy, block, wts, args, x_nchw, dy_nchw, current
    total = {k: sum(r[k] * r["launches_per_step"] for r in per_shape)
             for k in ("ms", "plain_ms", "unfused_cudnn_ms", "bound_ms",
                       "forward_kernel_ms")}
    report["bottleneck_identity_bwd_cuda"] = {
        "name": "bottleneck_identity_bwd_cuda", "route": "cuda",
        "source": "detjax_torch/csrc/bottleneck_bwd.cu",
        "replaces": "detjax/kernels/bottleneck.py:270",
        "launches": None, "match": True,
        "max_abs_err": max(e["max_abs_err"] for r in per_shape
                           for e in r["outputs"].values()),
        "max_abs_err_note": "dx at an element whose ReLU mask flips "
                            "between the kernel's and cuDNN's fp32 sums",
        "ms": total["ms"], "ms_by": "cuda_ms", "plain_ms": total["plain_ms"],
        "bound_ms": total["bound_ms"],
        "bound_by": "/".join(sorted({r["bound_by"] for r in per_shape})),
        "library_ms": None,
        "library_note": "no single PyTorch call computes the fused block's "
                        "backward; the port's unfused cuDNN block, forward "
                        "and backward, is unfused_cudnn_ms",
        "unfused_cudnn_ms": total["unfused_cudnn_ms"],
        "forward_kernel_ms": total["forward_kernel_ms"],
        "kernels_a_call": per_shape[0]["kernels_a_call"],
        "per": "one R50 train step at 640 px, bs 16: 2 layer1 + 3 layer2 "
               "calls",
        "shapes": per_shape, "extra_shapes": extra}


PRIOR_PROB = 0.05  # prior bias = logit(0.05), the score floor


def smoke_config(**extra):
    import detjax_torch

    return detjax_torch.get_config(
        "retinanet_r50_640", **{"model.prior_prob": PRIOR_PROB, **extra})


def seeded_canvases(seed: int, n: int, hw=(640, 640)) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (n, *hw, 3),
                                                dtype=np.uint8)


def normalized_nchw(model, canvases, cfg) -> torch.Tensor:
    from detjax_torch.data.pipeline import normalize_u8

    dev = next(model.parameters()).device
    x = normalize_u8(torch.as_tensor(canvases).to(dev), cfg.data.mean,
                     cfg.data.std, model.compute_dtype)
    return x.permute(0, 3, 1, 2)


def level_rows(cfg) -> list:
    """Rows of the head's flattened outputs a pyramid level, in order."""
    m = cfg.model
    h, w = m.image_size
    return [m.num_anchors_per_cell * -(-h // 2**lvl) * -(-w // 2**lvl)
            for lvl in range(m.min_level, m.max_level + 1)]


def desaturate_(model, canvases, cfg) -> dict:
    """Rescale the output convs of a seeded model so that on these
    canvases the class logits spread with std 2 around the prior bias and
    the box deltas with std 0.5: RetinaNet's one shared pair over all the
    rows, SSD's pair a level over that level's rows. Random towers over
    identity BatchNorm otherwise give logits with a std near 17 (SSD's
    predictors, over the FPN's outputs, far more): every score saturates
    to 1.0 and every decoded box clips to the whole canvas."""
    with torch.inference_mode():
        cls, box = model(normalized_nchw(model, canvases, cfg))
    cls_convs, box_convs = model.output_convs()
    rows = ([cls.shape[1]] if len(cls_convs) == 1 else level_rows(cfg))
    scales = {
        "cls": [2.0 / float(c.float().std())
                for c in torch.split(cls, rows, dim=1)],
        "box": [0.5 / float(b.float().std())
                for b in torch.split(box, rows, dim=1)]}
    with torch.no_grad():
        for convs, key in ((cls_convs, "cls"), (box_convs, "box")):
            for conv, s in zip(convs, scales[key]):
                conv.weight.mul_(s)
    return scales


def same_detections(a, b) -> bool:
    return all(torch.equal(u, v) for u, v in zip(a, b))


def phase_reference() -> None:
    """fp32 forward on the card against the CPU's (the path the tier-1
    tests hold against detjax) on a small input: R50, 128 px, batch 2,
    TF32 off for both cuDNN and matmuls."""
    import detjax_torch

    cfg = smoke_config(**{"model.image_size": (128, 128),
                          "model.dtype": "float32"})
    cpu = detjax_torch.build_model(cfg, seed=0, device="cpu")
    gpu = detjax_torch.build_model(cfg, seed=0)
    canvases = seeded_canvases(2, 2, (128, 128))
    with tf32_off(), torch.inference_mode():
        want = cpu(normalized_nchw(cpu, canvases, cfg))
        got = [t.cpu() for t in gpu(normalized_nchw(gpu, canvases, cfg))]
    errs = []
    for g, w in zip(got, want):
        tol = 1e-3 * float(w.abs().max())  # cuDNN vs CPU summation order
        errs.append(float((g - w).abs().max()))
        ok = bool(torch.isfinite(g).all()) and errs[-1] <= tol
        if not ok or g.shape != w.shape:
            raise SystemExit(f"fp32 forward on the card disagrees with the "
                             f"CPU: max |err| {errs[-1]} > {tol}")
    emit({"phase": "reference", "what": "fp32 forward, card vs CPU",
          "shape": list(got[0].shape), "max_abs_err_cls": errs[0],
          "max_abs_err_box": errs[1],
          "tolerance": "1e-3 x max |output|"})


def host_ms(model, cfg, batch, iters: int = 20) -> float:
    """Host clock per detect_u8 call, results copied to the host."""
    import detjax_torch

    def one():
        return [t.cpu() for t in detjax_torch.detect_u8(model, batch, cfg)]
    one()
    t0 = time.perf_counter()
    for _ in range(iters):
        one()
    return (time.perf_counter() - t0) / iters * 1e3


def phase_main(report: dict, state: dict) -> None:
    import detjax_torch
    from detjax_torch.kernels import postprocess as pp
    from detjax_torch.modeling import _anchors, anchor_config
    from detjax_torch.ops import nms as ops_nms

    cfg = smoke_config()
    b, e = cfg.eval.batch_size, cfg.eval
    canvases = seeded_canvases(1, b)
    t0 = time.perf_counter()
    model = detjax_torch.build_model(cfg, seed=0)  # default device: cuda
    scales = desaturate_(model, canvases, cfg)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    detjax_torch.detect_u8(model, canvases, cfg)  # warm-up
    torch.cuda.synchronize()

    pp.nms_launches = pp.nms_kernel_launches = 0
    det = detjax_torch.detect_u8(model, canvases, cfg)
    torch.cuda.synchronize()
    launches, nms_kernels = pp.nms_launches, pp.nms_kernel_launches
    twin = detjax_torch.detect_u8(model, canvases, cfg, nms_backend="torch")
    torch.cuda.synchronize()

    with torch.inference_mode():
        x = normalized_nchw(model, canvases, cfg)
        cls, box = model(x)
        thr = ops_nms._threshold(e.score_threshold, True, cls.dtype)
        live_pairs = (cls > thr).sum(dim=(1, 2))
        anchors = _anchors(cfg.model.image_size, anchor_config(cfg),
                           x.device)
        box32 = box.float()
        cand = ops_nms._select_candidates(
            box32, anchors, cls, cfg.model.box_std, cfg.model.image_size,
            e.score_threshold, e.pre_nms_top_k, e.exact_candidates, True)
        live_cands = (cand[1] > ops_nms.NEG_INF / 2).sum(dim=1)
        labels32 = cand[2].to(torch.int32)
        offset = float(max(cfg.model.image_size) + 2)
        nms_args = (cand[0], cand[1], labels32, e.nms_iou_threshold,
                    e.max_detections, offset)
        fwd_ms = cuda_ms(lambda: model(x), iters=20)
        post_ms = cuda_ms(lambda: ops_nms.fused_detect_postprocess(
            box32, anchors, cls, cfg.model.box_std, cfg.model.image_size,
            e.score_threshold, e.nms_iou_threshold, e.pre_nms_top_k,
            e.max_detections, e.exact_candidates, "auto", True,
            e.topk_mode), iters=20)
        select_ms = cuda_ms(lambda: ops_nms._select_candidates(
            box32, anchors, cls, cfg.model.box_std, cfg.model.image_size,
            e.score_threshold, e.pre_nms_top_k, e.exact_candidates, True),
            iters=20)
    nms = nms_case("main", nms_args, iters=200)
    emit({"phase": "main_nms", "kernel": "nms_cuda", **nms})

    batch_ms = host_ms(model, cfg, canvases)
    latency_cfg = detjax_torch.get_config(
        "retinanet_r50_640_latency", **{"model.prior_prob": PRIOR_PROB})
    latency_ms = host_ms(model, latency_cfg, canvases[:1])

    finite = all(bool(torch.isfinite(t.float()).all()) for t in det)
    shapes_ok = (tuple(det.boxes.shape) == (b, e.max_detections, 4)
                 and tuple(det.num_valid.shape) == (b,))
    identical = same_detections(det, twin)
    emit({"phase": "main", "preset": cfg.model.name,
          "depth": cfg.model.backbone_depth, "dtype": cfg.model.dtype,
          "batch": b, "canvas": list(cfg.model.image_size),
          "anchors": int(anchors.shape[0]),
          "classes": cfg.model.num_classes, "prior_prob": PRIOR_PROB,
          "output_scales": scales, "build_s": build_s,
          "live_pairs_per_image": live_pairs.tolist(),
          "live_candidates_per_image": live_cands.tolist(),
          "num_valid": det.num_valid.tolist(),
          "nms_launches": launches, "nms_cuda_kernels": nms_kernels,
          "identical_to_twin_route": identical,
          "tolerance": "keep-sets, scores and boxes bit-equal",
          "card": state["card"],
          "ms_per_batch": batch_ms, "img_per_s": b / batch_ms * 1e3,
          "latency_preset_ms_bs1": latency_ms,
          "forward_ms": fwd_ms, "postprocess_ms": post_ms,
          "select_ms": select_ms, "nms_kernel_ms": nms["ms"],
          f"nms_kernel_ms_at_{PRIOR_NMS_MATCH}": nms["prior_ms"],
          f"nms_kernel_ms_at_{PRIOR_B5}": nms[f"ms_at_{PRIOR_B5}"]})
    if not (finite and shapes_ok):
        raise SystemExit("detect_u8 returned non-finite or misshapen output")
    if launches != 1 or nms_kernels != len(NMS_KERNEL_NAMES):
        raise SystemExit(f"the main path made {launches} NMS calls "
                         f"({nms_kernels} CUDA kernels) a batch, expected 1 "
                         f"({len(NMS_KERNEL_NAMES)})")
    if not identical:
        raise SystemExit("detect_u8 through the kernel differs from the "
                         "same call through the plain twin")
    if int(live_cands.min()) == 0 or int(det.num_valid.min()) == 0:
        raise SystemExit("no live candidates: the NMS ran over sentinels")
    report["nms_cuda"]["launches"] = launches
    report["nms_cuda"]["main_path_candidates"] = {
        k: nms[k] for k in ("ms", "prior_ms", f"ms_at_{PRIOR_B5}",
                            "bound_ms", "bound_by",
                            "bound_ms_steps", "rows_out_of_order")}
    state.update(model=model, cfg=cfg, main={
        "ms_per_batch": batch_ms, "img_per_s": b / batch_ms * 1e3,
        "forward_ms": fwd_ms})


def phase_eval_branch(report: dict, state: dict) -> None:
    """The full-anchor-set eval branch (the lineage's BBoxTransform ->
    ClipBoxes -> per-class NMS) at R50-640, bs 8, "off", on phase_main's
    desaturated model: the forward as modeling._run calls it -> fp32 deltas
    and logits -> decode_clip_boxes -> sigmoid -> batched_detect_postprocess
    (pre-NMS top-k 1000, max_det 100). The kernel route (decode and NMS
    kernels) against the twin route (backend="torch" on both ops):
    detections bit-equal; 1 decode and 1 NMS launch a batch; ms per batch
    beside fused_detect_postprocess on the same deltas and logits. Then
    the same branch with pre-NMS top-k LONG_TOP_K, whose per-class rows
    pass the NMS kernel's split point: bit-equal to the twin route, 1
    decode and 1 NMS launch a batch."""
    from detjax_torch.data.pipeline import normalize_u8
    from detjax_torch.kernels import postprocess as pp
    from detjax_torch.modeling import _anchors, anchor_config
    from detjax_torch.ops import (batched_detect_postprocess,
                                  decode_clip_boxes, fused_detect_postprocess)
    from detjax_torch.ops.nms import _per_class_candidates

    model, cfg = state["model"], state["cfg"]
    b, e, m = cfg.eval.batch_size, cfg.eval, cfg.model
    canvases = torch.as_tensor(seeded_canvases(1, b)).cuda()
    anchors = _anchors(m.image_size, anchor_config(cfg), canvases.device)

    def branch(backend: str, top_k: int = e.pre_nms_top_k):
        with torch.inference_mode():
            x = normalize_u8(canvases, cfg.data.mean, cfg.data.std,
                             model.compute_dtype)
            cls, box = model(x.permute(0, 3, 1, 2))
            boxes = decode_clip_boxes(box.to(torch.float32), anchors,
                                      m.image_size, m.box_std,
                                      backend=backend)
            return batched_detect_postprocess(
                boxes, torch.sigmoid(cls.to(torch.float32)),
                e.score_threshold, e.nms_iou_threshold, top_k,
                e.max_detections, backend=backend)

    branch("auto")  # warm-up
    torch.cuda.synchronize()
    pp.decode_launches = pp.nms_launches = pp.nms_kernel_launches = 0
    det = branch("auto")
    torch.cuda.synchronize()
    launches = {"decode": pp.decode_launches, "nms": pp.nms_launches,
                "nms_cuda_kernels": pp.nms_kernel_launches}
    twin = branch("torch")
    torch.cuda.synchronize()
    identical = same_detections(det, twin)
    pp.decode_launches = pp.nms_launches = pp.nms_kernel_launches = 0
    det_long = branch("auto", LONG_TOP_K)
    torch.cuda.synchronize()
    launches_long = {"decode": pp.decode_launches, "nms": pp.nms_launches,
                     "nms_cuda_kernels": pp.nms_kernel_launches}
    identical_long = same_detections(det_long, branch("torch", LONG_TOP_K))
    long_ms = cuda_ms(lambda: branch("auto", LONG_TOP_K), iters=3)
    long_twin_ms = cuda_ms(lambda: branch("torch", LONG_TOP_K), iters=1,
                           warmup=1)
    emit({"phase": "eval_branch_long_rows", "pre_nms_top_k": LONG_TOP_K,
          "launches": launches_long,
          "identical_to_twin_route": identical_long,
          "num_valid": det_long.num_valid.tolist(),
          "branch_ms_per_batch": long_ms,
          "twin_branch_ms_per_batch": long_twin_ms,
          "tolerance": "boxes, scores, labels and num_valid bit-equal"})
    if launches_long != {"decode": 1, "nms": 1,
                         "nms_cuda_kernels": len(NMS_KERNEL_NAMES)} \
            or not identical_long:
        raise SystemExit(f"the eval branch at pre-NMS top-k {LONG_TOP_K} "
                         f"differs from its twin route or launched "
                         f"{launches_long}")
    with torch.inference_mode():
        x = normalize_u8(canvases, cfg.data.mean, cfg.data.std,
                         model.compute_dtype)
        cls, box = model(x.permute(0, 3, 1, 2))
        box32, cls32 = box.to(torch.float32), cls.to(torch.float32)
        scores = torch.sigmoid(cls32)
        boxes = decode_clip_boxes(box32, anchors, m.image_size, m.box_std)
        fwd_ms = cuda_ms(lambda: model(x.permute(0, 3, 1, 2)), iters=10)
        branch_ms = cuda_ms(lambda: branch("auto"), iters=10)
        twin_ms = cuda_ms(lambda: branch("torch"), iters=3, warmup=1)
        decode_ms = cuda_ms(lambda: decode_clip_boxes(
            box32, anchors, m.image_size, m.box_std), iters=100)
        post_ms = cuda_ms(lambda: batched_detect_postprocess(
            boxes, scores, e.score_threshold, e.nms_iou_threshold,
            e.pre_nms_top_k, e.max_detections), iters=10)
        # the NMS kernel alone on its 640 rows (image, class) of 1000
        top_boxes, top_scores = _per_class_candidates(
            boxes, scores, e.score_threshold, e.pre_nms_top_k)
        rows = top_scores.reshape(-1, top_scores.shape[-1])
        nms_args = (top_boxes.reshape(*rows.shape, 4), rows,
                    torch.zeros_like(rows, dtype=torch.int32),
                    e.nms_iou_threshold, 100, 0.0)
        nms, clocks = with_sm_clocks(
            lambda: nms_case("eval_branch_640_rows", nms_args, iters=50))
        emit({"phase": "eval_branch_nms", "kernel": "nms_cuda", **nms,
              "sm_clock_before_after": clocks})
        fused_ms = cuda_ms(lambda: fused_detect_postprocess(
            box32, anchors, cls32, m.box_std, m.image_size,
            e.score_threshold, e.nms_iou_threshold, e.pre_nms_top_k,
            e.max_detections, e.exact_candidates, "auto", True,
            e.topk_mode), iters=20)
        fused = fused_detect_postprocess(
            box32, anchors, cls32, m.box_std, m.image_size,
            e.score_threshold, e.nms_iou_threshold, e.pre_nms_top_k,
            e.max_detections, e.exact_candidates, "auto", True, e.topk_mode)
    live = (scores > e.score_threshold).sum(dim=1)  # [B, K]
    found, total = kept_pairs_found(det, fused)
    finite = all(bool(torch.isfinite(t.float()).all()) for t in det)
    shapes_ok = tuple(det.boxes.shape) == (b, e.max_detections, 4)
    emit({"phase": "eval_branch", "preset": m.name, "dtype": m.dtype,
          "batch": b, "anchors": int(anchors.shape[0]),
          "classes": m.num_classes, "pre_nms_top_k": e.pre_nms_top_k,
          "max_detections": e.max_detections,
          "nms_rows": b * m.num_classes,
          "live_pairs_per_image": live.sum(dim=1).tolist(),
          "classes_with_pre_k_live": int((live >= e.pre_nms_top_k).sum()),
          "num_valid": det.num_valid.tolist(),
          "launches": launches, "identical_to_twin_route": identical,
          "tolerance": "boxes, scores, labels and num_valid bit-equal",
          "forward_ms": fwd_ms, "branch_ms_per_batch": branch_ms,
          "twin_branch_ms_per_batch": twin_ms,
          "decode_clip_ms": decode_ms,
          "batched_detect_postprocess_ms": post_ms,
          "nms_kernel_ms_640_rows": nms["ms"],
          f"nms_kernel_ms_640_rows_at_{PRIOR_NMS_MATCH}": nms["prior_ms"],
          f"nms_kernel_ms_640_rows_at_{PRIOR_B5}": nms[f"ms_at_{PRIOR_B5}"],
          "nms_bound_ms_640_rows": nms["bound_ms"],
          "fused_detect_postprocess_ms": fused_ms,
          "fused_pairs_found_in_branch": [found, total],
          "card": state["card"]})
    if not (finite and shapes_ok):
        raise SystemExit("the eval branch returned non-finite or misshapen "
                         "detections")
    if launches != {"decode": 1, "nms": 1,
                    "nms_cuda_kernels": len(NMS_KERNEL_NAMES)}:
        raise SystemExit(f"expected 1 decode and 1 NMS launch a batch, got "
                         f"{launches}")
    if not identical:
        raise SystemExit("the eval branch through the kernels differs from "
                         "its twin route")
    if int(det.num_valid.min()) == 0:
        raise SystemExit("the eval branch kept no detection")
    report["decode_boxes_cuda"]["launches"] = launches["decode"]
    report["nms_cuda"]["eval_branch_long_rows"] = {
        "pre_nms_top_k": LONG_TOP_K, "identical_to_twin_route": True,
        "branch_ms_per_batch": long_ms}
    report["nms_cuda"]["eval_branch_640_rows"] = {
        k: nms[k] for k in ("ms", "prior_ms", f"ms_at_{PRIOR_B5}",
                            "bound_ms", "bound_by",
                            "bound_ms_steps", "pairs_needed", "live_per_row",
                            "kept_per_row", "walked_per_row",
                            "scratch_bytes")}


# the eval branch's pre-NMS top-k past the NMS kernel's split point
LONG_TOP_K = 20000


# A kept pair of the twin route is "clear" when its margin (see
# clear_margins) is at least this many bf16 steps.
CLEAR_STEPS = 8


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU of every box of ``a`` [N, 4] with every box of ``b`` [M, 4]."""
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = (rb - lt).clamp(min=0).prod(-1)
    area_a = (a[:, 2:] - a[:, :2]).clamp(min=0).prod(-1)
    area_b = (b[:, 2:] - b[:, :2]).clamp(min=0).prod(-1)
    return inter / (area_a[:, None] + area_b[None, :] - inter).clamp(min=1e-8)


def logits_and_steps(scores: torch.Tensor) -> tuple:
    """Logits back from fp32 sigmoid scores (well inside a bf16 step below
    logit 12), and the bf16 step at each logit's magnitude."""
    lg = torch.logit(scores.double())
    step = torch.exp2(torch.floor(torch.log2(lg.abs().clamp(min=1e-30))) - 7)
    return lg, step


def clear_margins(det, cand, iou_threshold: float) -> list:
    """For each image, each kept pair's margin in bf16 steps at its logit:
    the least of its height above the image's lowest kept logit and its
    distance from the logit of every other candidate of its class that
    overlaps it beyond the NMS threshold. Logit noise of fewer steps can
    neither drop the pair below the cut nor swap it with a box it
    suppresses or that suppresses it. ``cand``: the candidates (boxes,
    scores, labels) the NMS took."""
    from detjax_torch.ops.nms import NEG_INF

    out = []
    for i in range(det.scores.shape[0]):
        n = int(det.num_valid[i])
        boxes, labels, scores = (det.boxes[i, :n], det.labels[i, :n],
                                 det.scores[i, :n])
        lg, step = logits_and_steps(scores)
        live = cand[1][i] > NEG_INF / 2
        cb, cs, cl = cand[0][i][live], cand[1][i][live], cand[2][i][live]
        itself = ((boxes[:, None] == cb[None]).all(-1)
                  & (scores[:, None] == cs[None]))
        rival = ((box_iou(boxes, cb) > iou_threshold)
                 & (labels[:, None] == cl[None]) & ~itself)
        gap = (lg[:, None] - logits_and_steps(cs)[0][None]).abs()
        gap = torch.where(rival, gap, torch.inf).amin(dim=1)
        out.append(torch.minimum(lg - lg.min(), gap) / step)
    return out


def kept_pairs_found(ref, got, min_iou: float = 0.9, select=None) -> tuple:
    """How many of ``ref``'s kept (class, box) pairs have a kept pair of
    the same class in ``got`` at IoU >= ``min_iou``, out of how many;
    ``select``: per image, a mask over ``ref``'s kept pairs to count."""
    found = total = 0
    for i in range(ref.boxes.shape[0]):
        nr, ng = int(ref.num_valid[i]), int(got.num_valid[i])
        iou = box_iou(ref.boxes[i, :nr].float(), got.boxes[i, :ng].float())
        same = ref.labels[i, :nr, None] == got.labels[i, None, :ng]
        hit = ((iou >= min_iou) & same).any(dim=1)
        if select is not None:
            hit, nr = hit[select[i]], int(select[i].sum())
        found += int(hit.sum())
        total += nr
    return found, total


def fused_against_twin(model, cfg, canvases, x, det, outs, others=None
                       ) -> dict:
    """main_fused's comparison of a fused ("on") model's kernel route with
    its twin route (``bottleneck_backend="torch"``, fp32 convs, TF32 off)
    on the same canvases: the logits and deltas ``outs`` of the kernel
    route on the normalized ``x`` within 0.05 x max|twin|, and the twin
    route's kept (class, box) pairs found in the kernel route's ``det`` at
    IoU >= 0.9, by their margin in bf16 steps; ``others`` (name ->
    detections) are counted beside as yardsticks."""
    import detjax_torch
    from detjax_torch.modeling import _anchors, anchor_config
    from detjax_torch.ops import nms as ops_nms

    e = cfg.eval
    model.bottleneck_backend = "torch"
    with tf32_off():
        twin = detjax_torch.detect_u8(model, canvases, cfg)
        with torch.inference_mode():
            cls_t, box_t = model(x)
    model.bottleneck_backend = "auto"
    torch.cuda.synchronize()
    errs = {}
    for key, got, want in (("cls", outs[0], cls_t), ("box", outs[1], box_t)):
        g, w = got.float(), want.float()
        errs[key] = {"max_abs_err": float((g - w).abs().max()),
                     "tolerance": 0.05 * float(w.abs().max()),
                     "finite": bool(torch.isfinite(g).all())}
    # kept pairs found at IoU >= 0.9, same class, among the twin route's
    # pairs whose margin is at least k bf16 steps (k = 0: all)
    with torch.inference_mode():
        cand = ops_nms._select_candidates(
            box_t.float(), _anchors(cfg.model.image_size, anchor_config(cfg),
                                    x.device),
            cls_t, cfg.model.box_std, cfg.model.image_size,
            e.score_threshold, e.pre_nms_top_k, e.exact_candidates, True)
    margins = clear_margins(twin, cand, e.nms_iou_threshold)
    pairs = {}
    for k in sorted({0, 2, 4, CLEAR_STEPS, 16}):
        sel = [mg >= k for mg in margins]
        found, n_k = kept_pairs_found(twin, det, select=sel)
        pairs[f"{k}_steps"] = {
            "twin_pairs": n_k, "kernel_route": found,
            **{name: kept_pairs_found(twin, d, select=sel)[0]
               for name, d in (others or {}).items()}}
    return {"twin": twin, "errs": errs, "pairs": pairs, "margins": margins,
            "total": pairs["0_steps"]["twin_pairs"],
            "clear": pairs[f"{CLEAR_STEPS}_steps"]}


def check_fused_bars(check: dict) -> None:
    """Fail unless :func:`fused_against_twin`'s result meets main_fused's
    bars."""
    errs, clear, total = check["errs"], check["clear"], check["total"]
    if not all(e["finite"] and e["max_abs_err"] <= e["tolerance"]
               for e in errs.values()):
        raise SystemExit(f"the fused kernel route differs from the twin "
                         f"route: {errs}")
    if (clear["twin_pairs"] < 0.05 * total
            or clear["kernel_route"] < 0.95 * clear["twin_pairs"]):
        raise SystemExit(f"the kernel route found {clear['kernel_route']} "
                         f"of the twin route's {clear['twin_pairs']} clear "
                         f"kept pairs ({total} kept in all)")


def phase_main_fused(report: dict, state: dict) -> None:
    """detect_u8 at full width with model.fused_backbone="on": the same
    seeded model and desaturate_ as phase_main, bs 8, bf16; exactly 5
    fused-block launches a forward (R50: layer1 blocks 1-2, layer2 blocks
    1-3); the kernel route against the twin route (fp32 convs, TF32 off)
    on logits, deltas and the twin route's clear kept pairs, and the
    port's unfused path on the same weights against the same twin route
    as a printed yardstick; the forward with the BN fold kept against the
    forward that folds on every call."""
    import detjax_torch
    from detjax_torch.kernels import bottleneck as kb

    cfg = smoke_config(**{"model.fused_backbone": "on"})
    b = cfg.eval.batch_size
    canvases = seeded_canvases(1, b)
    model = detjax_torch.build_model(cfg, seed=0)
    scales = desaturate_(model, canvases, cfg)
    n_fused = len(model.fused_blocks())
    detjax_torch.detect_u8(model, canvases, cfg)  # warm-up
    torch.cuda.synchronize()

    kb.bottleneck_launches = kb.bottleneck_kernel_launches = 0
    det = detjax_torch.detect_u8(model, canvases, cfg)
    torch.cuda.synchronize()
    launches = kb.bottleneck_launches
    kernels = kb.bottleneck_kernel_launches
    fused = model.fused_blocks()

    def forward_fold_each_call():
        for blk in fused:
            blk._folded = None  # drop the kept fold: fold again
        return model(x)
    with torch.inference_mode():
        x = normalized_nchw(model, canvases, cfg)
        cls_k, box_k = model(x)
        fwd_ms = cuda_ms(lambda: model(x), iters=20)
        fwd_fold_ms = cuda_ms(forward_fold_each_call, iters=20)
        fwd_ms_again = cuda_ms(lambda: model(x), iters=20)
    busy = forward_busy(model, x, grad=False)
    batch_ms = host_ms(model, cfg, canvases)

    unfused_cfg = smoke_config()
    unfused = detjax_torch.build_model(unfused_cfg, seed=0)
    unfused.load_state_dict(model.state_dict())
    det_unfused = detjax_torch.detect_u8(unfused, canvases, unfused_cfg)
    del unfused
    check = fused_against_twin(model, cfg, canvases, x, det, (cls_k, box_k),
                               {"unfused_path": det_unfused})
    twin, errs, pairs = check["twin"], check["errs"], check["pairs"]
    margins, total, clear = check["margins"], check["total"], check["clear"]
    shapes_ok = (tuple(det.boxes.shape) == (b, cfg.eval.max_detections, 4)
                 and bool(torch.isfinite(det.boxes).all()))
    main = state["main"]
    emit({"phase": "main_fused", "preset": cfg.model.name,
          "fused_backbone": cfg.model.fused_backbone,
          "dtype": cfg.model.dtype, "batch": b, "model_seed": 0,
          "canvas_seed": 1,
          "fused_blocks": n_fused, "bottleneck_launches": launches,
          "bottleneck_cuda_kernels": kernels, "output_scales": scales,
          "outputs_vs_twin_route": errs,
          "twin_pairs_found_by_margin": pairs,
          "clear_pairs_per_image": [int((mg >= CLEAR_STEPS).sum())
                                    for mg in margins],
          "num_valid": det.num_valid.tolist(),
          "num_valid_twin": twin.num_valid.tolist(),
          "tolerance": f"logits and deltas within 0.05 x max|twin| "
                       f"(detjax's drop-in bar); at least 95 % of the twin "
                       f"route's clear kept (class, box) pairs, those "
                       f">= {CLEAR_STEPS} bf16 steps above their image's "
                       f"lowest kept logit and as far from every "
                       f"same-class candidate overlapping them beyond the "
                       f"NMS threshold, have a kept pair of the same "
                       f"class at IoU >= 0.9 in the kernel route, and the "
                       f"clear pairs are >= 5 % of all. Not bit-equal: the "
                       f"kernel and cuDNN sum fp32 in other orders, and a "
                       f"one-ulp bf16 step in y1 or y2 moves later "
                       f"roundings; kept pairs near the cut or near a rival "
                       f"are near-ties in bf16 that such noise reorders, "
                       f"for the unfused path as well (printed beside)",
          "card": state["card"],
          "ms_per_batch": batch_ms, "img_per_s": b / batch_ms * 1e3,
          "forward_ms": fwd_ms, "forward_ms_again": fwd_ms_again,
          "forward_ms_fold_each_call": fwd_fold_ms,
          "forward_on_off_device_busy": busy,
          "unfused_ms_per_batch": main["ms_per_batch"],
          "unfused_img_per_s": main["img_per_s"],
          "unfused_forward_ms": main["forward_ms"]})
    if launches != 5 or n_fused != 5 or kernels != kb.FWD_KERNELS * 5:
        raise SystemExit(f"expected 5 fused-block launches and "
                         f"{kb.FWD_KERNELS * 5} CUDA kernels in one forward "
                         f"of R50, got {launches} and {kernels} ({n_fused} "
                         f"fused blocks)")
    if not shapes_ok:
        raise SystemExit("the fused detect returned misshapen or "
                         "non-finite boxes")
    check_fused_bars(check)
    report["bottleneck_identity_cuda"]["launches"] = launches
    report["bottleneck_identity_cuda"]["cuda_kernels_per_forward"] = kernels
    fused_detect_608x832(model, state)
    del model


def fused_detect_608x832(model, state: dict) -> None:
    """detect_u8 with "on" at bs 2 on a 608x832 canvas (a 480x640 image's
    protocol canvas) with ``model``'s weights: layer1 rows of 208 px and
    layer2 rows of 104 px (a masked tail tile); 5 fused launches a
    forward; logits and deltas within 0.05 x max|twin| of the twin
    route."""
    import detjax_torch
    from detjax_torch.kernels import bottleneck as kb

    hw = (608, 832)
    cfg = smoke_config(**{"model.fused_backbone": "on",
                          "model.image_size": hw})
    wide = detjax_torch.build_model(cfg, seed=0)
    wide.load_state_dict(model.state_dict())
    canvases = seeded_canvases(4, 2, hw)
    kb.bottleneck_launches = 0
    det = detjax_torch.detect_u8(wide, canvases, cfg)
    torch.cuda.synchronize()
    launches = kb.bottleneck_launches
    with torch.inference_mode():
        x = normalized_nchw(wide, canvases, cfg)
        got = wide(x)
        wide.bottleneck_backend = "torch"
        with tf32_off():
            want = wide(x)
    errs = {}
    for key, g, w in zip(("cls", "box"), got, want):
        g, w = g.float(), w.float()
        errs[key] = {"max_abs_err": float((g - w).abs().max()),
                     "tolerance": 0.05 * float(w.abs().max()),
                     "finite": bool(torch.isfinite(g).all())}
    emit({"phase": "main_fused_608x832", "batch": 2, "canvas": list(hw),
          "bottleneck_launches": launches,
          "num_valid": det.num_valid.tolist(),
          "outputs_vs_twin_route": errs,
          "tolerance": "logits and deltas within 0.05 x max|twin|",
          "card": state["card"]})
    if launches != 5:
        raise SystemExit(f"expected 5 fused launches on the 608x832 canvas, "
                         f"got {launches}")
    if not all(e["finite"] and e["max_abs_err"] <= e["tolerance"]
               for e in errs.values()):
        raise SystemExit(f"the fused route differs from the twin route on "
                         f"the 608x832 canvas: {errs}")


def phase_serve(state: dict) -> None:
    """>= 8 concurrent requests through the HTTP DetectionServer (PNG
    bodies when PIL imports, else canvases through its batcher from
    threads), each equal to a direct detect_u8 of the same canvas."""
    import importlib.util
    import threading
    import urllib.request

    import detjax_torch
    from detjax_torch.kernels import postprocess as pp
    from detjax_torch.serve import DetectionServer

    model, cfg = state["model"], state["cfg"]
    b = cfg.eval.batch_size
    n_req = 2 * b
    canvases = seeded_canvases(3, n_req)
    direct = []
    for lo in range(0, n_req, b):
        d = detjax_torch.detect_u8(model, canvases[lo:lo + b], cfg)
        d = [t.cpu().numpy() for t in d]
        direct += [(d[0][i], d[1][i], d[2][i], int(d[3][i]))
                   for i in range(b)]
    route = "http_png" if importlib.util.find_spec("PIL") else "batcher"

    srv = DetectionServer(model, cfg, batch_size=b, max_wait_ms=200.0,
                          score_threshold=0.0)
    ready = threading.Event()
    th = threading.Thread(target=srv.serve, args=("127.0.0.1", 0, ready),
                          daemon=True)
    th.start()
    outs = [None] * n_req
    try:
        if not ready.wait(300):
            raise SystemExit("the server did not come up")
        base = f"http://127.0.0.1:{srv.port}"
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            health = json.loads(r.read())
        bodies = []
        if route == "http_png":
            import io

            from PIL import Image

            for c in canvases:
                buf = io.BytesIO()
                Image.fromarray(c).save(buf, format="PNG")
                bodies.append(buf.getvalue())

        def hit(i):
            if route == "http_png":
                req = urllib.request.Request(f"{base}/detect",
                                             data=bodies[i])
                with urllib.request.urlopen(req, timeout=120) as r:
                    outs[i] = json.loads(r.read())["detections"]
            else:
                outs[i] = srv.batcher.submit(canvases[i])

        pp.nms_launches = 0
        t0 = time.perf_counter()
        threads = [threading.Thread(target=hit, args=(i,))
                   for i in range(n_req)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        wall_s = time.perf_counter() - t0
        batches = pp.nms_launches
    finally:
        srv.shutdown()
        th.join(timeout=30)
    if th.is_alive():
        raise SystemExit("the server thread did not stop")

    mismatches = 0
    for i, (boxes, scores, labels, nv) in enumerate(direct):
        got = outs[i]
        if got is None:
            mismatches += 1
        elif route == "http_png":  # the server rounds and clips its JSON
            ok = ([d["label"] for d in got] == labels[:nv].tolist()
                  and np.allclose([d["score"] for d in got],
                                  np.round(scores[:nv], 4), rtol=0,
                                  atol=1.01e-4)
                  and np.allclose(np.reshape([d["box"] for d in got],
                                             (-1, 4)),
                                  np.clip(boxes[:nv], 0, 640), rtol=0,
                                  atol=1.1e-2))
            mismatches += not ok
        else:
            mismatches += not (got[3] == nv
                               and np.array_equal(got[2], labels)
                               and np.array_equal(got[1], scores)
                               and np.array_equal(got[0], boxes))
    emit({"phase": "serve", "route": route, "healthz": health["status"],
          "requests": n_req, "device_batches": batches,
          "requests_per_batch": n_req / max(batches, 1),
          "wall_s": wall_s, "mismatches": mismatches,
          "detections": sum(d[3] for d in direct),
          "tolerance": ("scores 1e-4 and boxes 1e-2 (JSON rounding)"
                        if route == "http_png" else "bit-equal")})
    if health["status"] != "ok" or mismatches or batches >= n_req:
        raise SystemExit("the server's answers differ from a direct "
                         "detect, or its requests did not coalesce")


INT8_CALIB_IMAGES = 16
INT8_BARS = {"corr": 0.99, "mean_abs": 0.1}  # detjax's, tests/test_quant.py


def corr_and_mean_abs(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """Pearson correlation and mean |a - b| of two tensors, in fp64 on
    their device."""
    a, b = a.double().flatten(), b.double().flatten()
    da, db = a - a.mean(), b - b.mean()
    corr = float((da * db).sum() / (da.norm() * db.norm()))
    return corr, float((a - b).abs().mean())


def int8_conv_sites(qtree, cfg, x) -> dict:
    """Every conv_int8 call of one int8 forward on ``x``, grouped by
    (input shape, weight shape, stride): the first call's operands and the
    number of calls of that shape."""
    from detjax_torch import quant

    sites: dict = {}
    inner = quant.conv_int8

    def record(xq, w, stride=1):
        key = (tuple(xq.shape), tuple(w.shape), int(stride))
        if key not in sites:
            sites[key] = {"xq": xq.clone(), "w": w, "calls": 0}
        sites[key]["calls"] += 1
        return inner(xq, w, stride)
    quant.conv_int8 = record
    try:
        quant.forward_int8(qtree, cfg, x)
    finally:
        quant.conv_int8 = inner
    return sites


def int8_gemm_bound_ms(key) -> tuple:
    """The least time of one conv_int8 on the H100: its patch matrix and
    weights read and the int32 result written once (bytes), or its
    multiply-adds at the int8 tensor-core rate (operations)."""
    (b, h, w, c), (k, _, _, n), s = key
    ho, wo = (h + 2 * (k // 2) - k) // s + 1, (w + 2 * (k // 2) - k) // s + 1
    m, kk = b * ho * wo, k * k * c
    byts = b * h * w * c + kk * n + 4 * m * n
    ops = 2 * m * kk * n
    t_b, t_o = byts / H100["bytes_per_s"] * 1e3, ops / H100["int8_ops"] * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def int8_bars_at_detjax_test_shape() -> dict:
    """detjax's own int8-vs-fp check (tests/test_quant.py:94-110) on the
    card: R18, 64 px, 4 classes, fp32, seeded weights, two N(0, 1) images
    that are also the calibration batch; the int8 logits against the fp32
    traversal's, correlation > 0.99 and mean |d| < 0.1."""
    import detjax_torch
    from detjax_torch import quant

    cfg = detjax_torch.get_config("retinanet_r50_640", **{
        "model.image_size": (64, 64), "model.backbone_depth": 18,
        "model.num_classes": 4, "model.dtype": "float32"})
    model = detjax_torch.build_model(cfg, seed=0)
    x = torch.from_numpy(np.random.default_rng(1).normal(
        0, 1, (2, 64, 64, 3)).astype(np.float32)).cuda()
    qtree = quant.quantize_model(model, cfg, x)
    with tf32_off():
        f_cls, _ = quant.forward_fp(model, cfg, x, dtype=torch.float32)
    q_cls, _ = quant.forward_int8(qtree, cfg, x)
    corr, mean_abs = corr_and_mean_abs(q_cls, f_cls)
    return {"corr": corr, "mean_abs": mean_abs,
            "ok": corr > INT8_BARS["corr"] and mean_abs < INT8_BARS["mean_abs"]}


def phase_int8(report: dict, state: dict) -> None:
    """detjax's int8 PTQ engine at full width: R50-640, bf16, bs 8, on
    ``main``'s de-saturated model. Calibrates on INT8_CALIB_IMAGES seeded
    canvases with "absmax" and "p999"; holds conv_int8 bit-equal to an
    fp64 conv of the integer values at every distinct site shape of the
    forward (each timed by device_ms, beside its bound); counts
    detect_int8_u8's NMS launches (the launcher's and the profiler's);
    holds the int8 logits to the fp traversal's within detjax's bars at
    detjax's test shape, and within its correlation bar at full width
    for both calibration modes (printing the mean |d|);
    times detect_int8_u8 against detect_u8 in turns (CUDA events, the
    device's busy ms by torch.profiler, the host clock with the results
    copied)."""
    import detjax_torch
    from detjax_torch import quant
    from detjax_torch.data.pipeline import normalize_u8
    from detjax_torch.kernels import postprocess as pp

    model, cfg = state["model"], state["cfg"]
    b = cfg.eval.batch_size
    dev = next(model.parameters()).device
    calib_u8 = seeded_canvases(4, INT8_CALIB_IMAGES)
    calib = normalize_u8(torch.as_tensor(calib_u8).to(dev), cfg.data.mean,
                         cfg.data.std)  # fp32, as the server calibrates
    qtrees, calib_s = {}, {}
    for mode in quant.CALIB_MODES:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        qtrees[mode] = detjax_torch.quantize_model(model, cfg, calib,
                                                   calib_mode=mode)
        torch.cuda.synchronize()
        calib_s[mode] = time.perf_counter() - t0
    qtree = qtrees["absmax"]
    scales = {m: [float(v) for v in q["act_scales"].values()]
              for m, q in qtrees.items()}
    p999_below = all(p <= a * (1 + 1e-6)
                     for p, a in zip(scales["p999"], scales["absmax"]))

    canvases = seeded_canvases(1, b)
    canvases_dev = torch.as_tensor(canvases).to(dev)
    x = normalize_u8(canvases_dev, cfg.data.mean, cfg.data.std,
                     model.compute_dtype)
    sites = int8_conv_sites(qtree, cfg, x)
    conv_rows, conv_ms_total, conv_bound_total = [], 0.0, 0.0
    for key, site in sites.items():
        xq, w, s = site["xq"], site["w"], key[2]
        got = quant.conv_int8(xq, w, s)
        want = quant.conv_int8_reference(xq, w, s)
        equal = bool(torch.equal(got, want))
        ms = device_ms(lambda: quant.conv_int8(xq, w, s), iters=5)
        bound, by = int8_gemm_bound_ms(key)
        conv_ms_total += ms * site["calls"]
        conv_bound_total += bound * site["calls"]
        conv_rows.append({"x": list(key[0]), "w": list(key[1]),
                          "stride": s, "calls": site["calls"],
                          "bit_equal": equal, "ms": ms, "bound_ms": bound,
                          "bound_by": by})
        if not equal:
            emit({"phase": "int8", "conv_int8_mismatch": conv_rows[-1]})
            raise SystemExit(f"conv_int8 differs from the fp64 reference "
                             f"at x {key[0]}, w {key[1]}, stride {s}")
    del sites

    detjax_torch.detect_int8_u8(qtree, canvases_dev, cfg)  # warm-up
    torch.cuda.synchronize()
    pp.nms_launches = pp.nms_kernel_launches = 0
    det = detjax_torch.detect_int8_u8(qtree, canvases_dev, cfg)
    torch.cuda.synchronize()
    launches, nms_kernels = pp.nms_launches, pp.nms_kernel_launches
    traced = kernel_ms_complete(
        lambda: detjax_torch.detect_int8_u8(qtree, canvases_dev, cfg),
        {"nms_kernel": 1.0}, "detect_int8_u8")
    traced_nms = None if traced is None else traced[1].get("nms_kernel")
    top = (None if traced is None else sorted(
        traced[0].items(), key=lambda kv: -kv[1])[:10])

    with torch.inference_mode():
        with tf32_off():
            f_cls, f_box = quant.forward_fp(model, cfg, x,
                                            dtype=torch.float32)
        m_cls, _ = model(x.permute(0, 3, 1, 2))
        tracking = {}
        for mode, q in qtrees.items():
            q_cls, q_box = quant.forward_int8(q, cfg, x)
            tracking[mode] = {
                "logits_vs_fp32_traversal": corr_and_mean_abs(q_cls, f_cls),
                "deltas_vs_fp32_traversal": corr_and_mean_abs(q_box, f_box),
                "logits_vs_bf16_model": corr_and_mean_abs(q_cls, m_cls)}
            del q_cls, q_box
        fp_logit_std = float(f_cls.float().std())
        del f_cls, f_box, m_cls
    corr, mean_abs = tracking["absmax"]["logits_vs_fp32_traversal"]
    small = int8_bars_at_detjax_test_shape()

    def int8_call():
        return detjax_torch.detect_int8_u8(qtree, canvases_dev, cfg)

    def fp_call():
        return detjax_torch.detect_u8(model, canvases_dev, cfg)
    # a call launches hundreds of kernels: queued behind device_ms's spin,
    # ten of them fill the launch queue and the host waits on the spin.
    # So: CUDA events around back-to-back calls (the slower of host and
    # device), and the device's busy ms a call from torch.profiler
    calls = {"fp": fp_call, "int8": int8_call}
    turns = [(c, cuda_ms(calls[c], iters=10))
             for c in ("fp", "int8", "int8", "fp")]
    events_ms = {c: float(np.mean([t for k, t in turns if k == c]))
                 for c in calls}
    busy = {}
    for c, fn in calls.items():
        traced_c = kernel_ms_by_name(fn)
        busy[c] = None if traced_c is None else sum(traced_c[0].values())
    wall = {}
    for name in ("fp", "int8", "int8", "fp"):
        fn = fp_call if name == "fp" else int8_call
        [t.cpu() for t in fn()]
        t0 = time.perf_counter()
        for _ in range(10):
            [t.cpu() for t in fn()]
        wall.setdefault(name, []).append(
            (time.perf_counter() - t0) / 10 * 1e3)
    finite = all(bool(torch.isfinite(t.float()).all()) for t in det)
    row = {"phase": "int8", "preset": cfg.model.name, "batch": b,
           "dtype": cfg.model.dtype, "calib_images": INT8_CALIB_IMAGES,
           "calib_s": calib_s, "sites": len(qtree["act_scales"]),
           "conv_weights": len(qtree["weights"]),
           "p999_scales_below_absmax": p999_below,
           "conv_int8_shapes": len(conv_rows),
           "conv_int8_bit_equal": all(r["bit_equal"] for r in conv_rows),
           "conv_int8_rows": conv_rows,
           "int8_convs_device_ms": conv_ms_total,
           "int8_convs_bound_ms": conv_bound_total,
           "nms_launches": launches, "nms_cuda_kernels": nms_kernels,
           "nms_launches_traced": traced_nms,
           "top_kernels_ms": top,
           "num_valid": det.num_valid.tolist(),
           "tracking_corr_mean_abs": tracking,
           "fp32_logit_std": fp_logit_std,
           "bars": INT8_BARS,
           "bars_at_detjax_test_shape": small,
           "events_ms": events_ms, "events_ms_turns": turns,
           "device_busy_ms": busy,
           "int8_convs_share_of_int8_device_busy":
               None if busy["int8"] is None else conv_ms_total / busy["int8"],
           "wall_ms": {k: float(np.mean(v)) for k, v in wall.items()},
           "wall_ms_turns": wall, "card": state["card"]}
    emit(row)
    if not (finite and p999_below):
        raise SystemExit("the int8 engine returned non-finite output, or a "
                         "p999 scale above its absmax scale")
    if launches != 1 or nms_kernels != 1 or traced_nms not in (None, 1.0):
        raise SystemExit(f"detect_int8_u8 made {launches} NMS calls "
                         f"({nms_kernels} CUDA kernels, {traced_nms} traced)"
                         f" a batch, expected 1")
    # detjax's bars (tests/test_quant.py:94-110) hold at its test's shape;
    # at full width the scale-free one, the correlation, is held for both
    # calibration modes, and the mean |d| (whose 0.1 was set for logits
    # near the prior bias) is printed beside the logits' spread
    if not small["ok"]:
        raise SystemExit(f"int8 logits off the fp traversal's at detjax's "
                         f"test shape: {small}")
    low = {m: t["logits_vs_fp32_traversal"][0] for m, t in tracking.items()
           if t["logits_vs_fp32_traversal"][0] <= INT8_BARS["corr"]}
    if low:
        raise SystemExit(f"int8 logits decorrelated from the fp traversal's "
                         f"at full width: {low} (bar {INT8_BARS['corr']})")
    if int(det.num_valid.min()) == 0:
        raise SystemExit("the int8 engine kept no detection")
    report["nms_cuda"]["launches_int8"] = launches
    state["int8"] = {"qtree": qtree, "calib_u8": calib_u8}


ARTIFACT_LOADER = r"""
import json, sys, time
t0 = time.perf_counter()
import numpy as np
import torch
import detjax_torch.kernels.ops  # registers the custom ops
from detjax_torch.export import load_detect
from detjax_torch.kernels import bottleneck as kb
from detjax_torch.kernels import postprocess as pp
path, canvases_path, out_path = sys.argv[1:4]
run = load_detect(path)
load_s = time.perf_counter() - t0
canvases = torch.from_numpy(np.load(canvases_path)).cuda()
run(canvases)
torch.cuda.synchronize()
pp.nms_launches = pp.nms_kernel_launches = 0
kb.bottleneck_launches = kb.bottleneck_kernel_launches = 0
det = run(canvases)
torch.cuda.synchronize()
counts = {"nms_launches": pp.nms_launches,
          "nms_cuda_kernels": pp.nms_kernel_launches,
          "bottleneck_launches": kb.bottleneck_launches,
          "bottleneck_cuda_kernels": kb.bottleneck_kernel_launches}
t0 = time.perf_counter()
for _ in range(10):
    [t.cpu() for t in run(canvases)]
ms = (time.perf_counter() - t0) / 10 * 1e3
loaded = sorted(m for m in sys.modules
                if m.startswith(("detjax_torch.models", "detjax_torch.quant",
                                 "detjax_torch.modeling", "jax"))
                or m == "detjax" or m.startswith("detjax."))
torch.save(tuple(t.cpu() for t in det), out_path)
print(json.dumps({"load_s": load_s, "ms_per_batch": ms, "loaded": loaded,
                  "in_shape": list(run.in_shape), "in_dtype": str(run.in_dtype),
                  **counts}))
"""


def within_detect_bars(got, want) -> dict:
    """tests/test_torch_port_detect.py's bars: keep-sets (counts, labels,
    order) equal, scores within 2e-5, boxes within 5e-3."""
    keep = (torch.equal(got.num_valid, want.num_valid)
            and torch.equal(got.labels, want.labels))
    ds = float((got.scores - want.scores).abs().max())
    db = float((got.boxes - want.boxes).abs().max())
    return {"bit_equal": all(torch.equal(a, b) for a, b in zip(got, want)),
            "keep_sets_equal": keep, "max_score_diff": ds,
            "max_box_diff": db, "ok": keep and ds <= 2e-5 and db <= 5e-3}


def phase_export(report: dict, state: dict) -> None:
    """Detect programs at full width (R50-640, bs 8, uint8 input): the fp
    engine "off" and "on" (same weights) and the int8 engine (phase_int8's
    qtree), each exported, saved, and loaded and run in a fresh process
    that imports detjax_torch.kernels.ops and no model module; each
    program's detections against its live engine's; launches through the
    program: 1 NMS a batch, and 10 fused-forward CUDA kernels with "on"."""
    import tempfile

    import detjax_torch

    model, cfg = state["model"], state["cfg"]
    b = cfg.eval.batch_size
    qtree = state["int8"]["qtree"]
    on_cfg = smoke_config(**{"model.fused_backbone": "on"})
    on_model = detjax_torch.build_model(on_cfg, seed=0)
    on_model.load_state_dict(model.state_dict())
    canvases = seeded_canvases(1, b)
    live = {"off": detjax_torch.detect_u8(model, canvases, cfg),
            "on": detjax_torch.detect_u8(on_model, canvases, on_cfg),
            "int8": detjax_torch.detect_int8_u8(qtree, canvases, cfg)}
    live = {k: type(v)(*(t.cpu() for t in v)) for k, v in live.items()}
    tmp = tempfile.TemporaryDirectory(prefix="detjax_export_")
    root = Path(tmp.name)
    np.save(root / "canvases.npy", canvases)
    rows, fails = {}, []
    for name, (m, c, q) in {"off": (model, cfg, None),
                            "on": (on_model, on_cfg, None),
                            "int8": (model, cfg, qtree)}.items():
        path = root / f"detect_{name}.pt2"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prog = detjax_torch.export_detect(m, c, batch_size=b,
                                          input_format="u8", qtree=q)
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        torch.export.save(prog, str(path))
        save_s = time.perf_counter() - t0
        nodes = [str(n.target) for n in prog.graph.nodes
                 if n.op == "call_function"]
        del prog
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", ARTIFACT_LOADER, str(path),
             str(root / "canvases.npy"), str(root / f"det_{name}.pt")],
            capture_output=True, text=True, timeout=600,
            cwd=str(Path(__file__).resolve().parent))
        sub_s = time.perf_counter() - t0
        if proc.returncode != 0:
            emit({"phase": "export", "program": name,
                  "loader_stderr": proc.stderr[-3000:]})
            raise SystemExit(f"the {name} program did not load and run in "
                             f"a fresh process")
        sub = json.loads(proc.stdout.strip().splitlines()[-1])
        from detjax_torch.ops.nms import Detections

        got = Detections(*torch.load(root / f"det_{name}.pt"))
        cmp = within_detect_bars(got, live[name])
        want_fused = 5 if name == "on" else 0
        rows[name] = {"export_s": export_s, "save_s": save_s,
                      "subprocess_s": sub_s,
                      "file_mb": path.stat().st_size / 1e6,
                      "graph_nodes": len(nodes),
                      "nms_ops_in_graph": nodes.count(
                          "detjax_torch.nms.default"),
                      "bottleneck_ops_in_graph": nodes.count(
                          "detjax_torch.bottleneck_identity.default"),
                      **sub, **cmp}
        if not cmp["ok"]:
            fails.append(f"{name}: detections off the live engine's {cmp}")
        if sub["loaded"]:
            fails.append(f"{name}: the loader imported {sub['loaded']}")
        if (sub["nms_launches"], sub["nms_cuda_kernels"]) != (1, 1):
            fails.append(f"{name}: {sub['nms_launches']} NMS launches a "
                         f"batch through the program")
        if (sub["bottleneck_launches"] != want_fused
                or sub["bottleneck_cuda_kernels"] != 2 * want_fused):
            fails.append(f"{name}: {sub['bottleneck_launches']} fused calls "
                         f"({sub['bottleneck_cuda_kernels']} CUDA kernels) a "
                         f"batch through the program, expected {want_fused}")
    state["artifact"] = {"tmp": tmp, "off": str(root / "detect_off.pt2")}
    emit({"phase": "export", "batch": b, "input_format": "u8",
          "programs": rows, "tolerance": "keep-sets equal, scores 2e-5, "
          "boxes 5e-3 (tests/test_torch_port_detect.py)",
          "card": state["card"]})
    if fails:
        raise SystemExit("; ".join(fails))
    report["nms_cuda"]["launches_artifact"] = {
        k: r["nms_launches"] for k, r in rows.items()}
    report["bottleneck_identity_cuda"]["launches_artifact_on"] = rows["on"][
        "bottleneck_launches"]


def http_answers(srv, canvases) -> tuple:
    """POST each canvas (PNG) concurrently to a running ``srv``; the
    answers, the NMS launches meanwhile, the wall seconds."""
    import io
    import urllib.request

    from PIL import Image

    from detjax_torch.kernels import postprocess as pp

    ready = threading.Event()
    th = threading.Thread(target=srv.serve, args=("127.0.0.1", 0, ready),
                          daemon=True)
    th.start()
    outs = [None] * len(canvases)
    try:
        if not ready.wait(300):
            raise SystemExit("the server did not come up")
        base = f"http://127.0.0.1:{srv.port}"
        bodies = []
        for c in canvases:
            buf = io.BytesIO()
            Image.fromarray(c).save(buf, format="PNG")
            bodies.append(buf.getvalue())

        def hit(i):
            req = urllib.request.Request(f"{base}/detect", data=bodies[i])
            with urllib.request.urlopen(req, timeout=120) as r:
                outs[i] = json.loads(r.read())["detections"]
        pp.nms_launches = 0
        t0 = time.perf_counter()
        threads = [threading.Thread(target=hit, args=(i,))
                   for i in range(len(canvases))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        wall_s = time.perf_counter() - t0
        batches = pp.nms_launches
    finally:
        srv.shutdown()
        th.join(timeout=30)
    if th.is_alive():
        raise SystemExit("the server thread did not stop")
    return outs, batches, wall_s


def answers_mismatch(outs, direct) -> int:
    """Answers that differ from ``direct`` (per canvas: boxes, scores,
    labels, num_valid) beyond the JSON's rounding."""
    bad = 0
    for got, (boxes, scores, labels, nv) in zip(outs, direct):
        bad += got is None or not (
            [d["label"] for d in got] == labels[:nv].tolist()
            and np.allclose([d["score"] for d in got], np.round(scores[:nv], 4),
                            rtol=0, atol=1.01e-4)
            and np.allclose(np.reshape([d["box"] for d in got], (-1, 4)),
                            np.clip(boxes[:nv], 0, 640), rtol=0, atol=1.1e-2))
    return bad


def op_host_us(op_call, direct_call, iters: int = 200) -> dict:
    """Host microseconds a call through the custom op and through the
    wrapper it calls, in turns (op, direct, direct, op), each the mean of
    ``iters`` calls with one synchronize at the end."""
    turns = []
    for name in ("op", "direct", "direct", "op"):
        fn = op_call if name == "op" else direct_call
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        turns.append((name, (time.perf_counter() - t0) / iters * 1e6))
    us = {n: float(np.mean([t for k, t in turns if k == n]))
          for n in ("op", "direct")}
    return {"us": us, "added_us": us["op"] - us["direct"], "turns": turns}


def phase_serve_engines(state: dict) -> None:
    """The HTTP DetectionServer with engine="int8" (calibrated on
    phase_int8's canvases) and engine=<phase_export's "off" program>,
    2 x batch requests each, every answer equal to a direct call of the
    same engine; then the host time the custom ops add a call against a
    direct wrapper call, in turns."""
    import detjax_torch
    from detjax_torch.export import load_detect
    from detjax_torch.kernels import bottleneck as kb
    from detjax_torch.kernels import ops as kops
    from detjax_torch.kernels import postprocess as pp
    from detjax_torch.serve import DetectionServer

    model, cfg = state["model"], state["cfg"]
    b = cfg.eval.batch_size
    n_req = 2 * b
    canvases = seeded_canvases(5, n_req)
    qtree = state["int8"]["qtree"]
    program = load_detect(state["artifact"]["off"])
    direct_fns = {"int8": lambda x: detjax_torch.detect_int8_u8(qtree, x,
                                                                cfg),
                  "program": program}
    rows, fails = {}, []
    for name, engine in (("int8", "int8"),
                         ("program", state["artifact"]["off"])):
        direct = []
        for lo in range(0, n_req, b):
            d = [t.cpu().numpy() for t in direct_fns[name](
                canvases[lo:lo + b])]
            direct += [(d[0][i], d[1][i], d[2][i], int(d[3][i]))
                       for i in range(b)]
        t0 = time.perf_counter()
        srv = DetectionServer(model, cfg, engine=engine, batch_size=b,
                              max_wait_ms=200.0, score_threshold=0.0,
                              calibration=state["int8"]["calib_u8"])
        start_s = time.perf_counter() - t0
        outs, batches, wall_s = http_answers(srv, canvases)
        bad = answers_mismatch(outs, direct)
        rows[name] = {"requests": n_req, "device_batches": batches,
                      "start_s": start_s, "wall_s": wall_s,
                      "mismatches": bad,
                      "detections": sum(d[3] for d in direct)}
        if bad or batches >= n_req or batches == 0:
            fails.append(f"{name}: {bad} answers differ from a direct call, "
                         f"{batches} device batches for {n_req} requests")

    # the custom ops' host time a call against the wrapper they call
    boxes, scores, labels = (torch.from_numpy(t).cuda()
                             for t in hard_candidates(7))
    nms_args = (boxes, scores, labels, 0.5, 100, 642.0)
    nms_us = op_host_us(lambda: kops.nms(*nms_args),
                        lambda: pp.nms_cuda(*nms_args))
    x, block = kb.seeded_block(0, b, 160, 160, 64, torch.device("cuda"))
    wts = block.folded_weights()
    with torch.inference_mode():
        bott_us = op_host_us(lambda: kops.bottleneck_identity(x, *wts),
                             lambda: kb.bottleneck_identity(x, *wts),
                             iters=50)
    emit({"phase": "serve_engines", "engines": rows,
          "tolerance": "scores 1e-4 and boxes 1e-2 (JSON rounding)",
          "custom_op_host_us": {"nms": nms_us, "bottleneck_identity":
                                bott_us},
          "card": state["card"]})
    state.pop("artifact")["tmp"].cleanup()
    if fails:
        raise SystemExit("; ".join(fails))


def train_batch(cfg, seed: int) -> dict:
    """One uint8 training batch: seeded synthetic scenes at the canvas
    size with 1-20 objects each, letterboxed and padded to max_gt."""
    from detjax_torch.data.synthetic import SyntheticDetectionDataset
    from detjax_torch.data.transforms import letterbox, pad_annotations

    t = cfg.train
    ds = SyntheticDetectionDataset(t.batch_size, cfg.model.image_size,
                                   cfg.model.num_classes, max_objects=20,
                                   seed=seed)
    images, gt_boxes, gt_labels = [], [], []
    for i in range(len(ds)):
        rec = ds[i]
        canvas, boxes, _ = letterbox(rec["image"], rec["boxes"],
                                     cfg.model.image_size)
        boxes, labels = pad_annotations(boxes, rec["labels"], t.max_gt)
        images.append(canvas)
        gt_boxes.append(boxes)
        gt_labels.append(labels)
    return {"images": np.stack(images), "gt_boxes": np.stack(gt_boxes),
            "gt_labels": np.stack(gt_labels)}


def _params(state) -> dict:
    return {n: p.detach().clone() for n, p in state.model.named_parameters()}


def phase_train(report: dict, state: dict) -> None:
    """retinanet_r50_640 training at full width through make_train_state /
    train_step on the default device: bs 16, bf16 autocast, 640 px, 80
    classes, max_gt 100, Adam lr 1e-5, clip 0.1."""
    import detjax_torch
    from detjax_torch.data.pipeline import device_augment
    from detjax_torch.kernels import matching as km
    from detjax_torch.modeling import _anchors, anchor_config
    from detjax_torch.ops.matching import match_anchors
    from detjax_torch.train import step as tstep

    t0 = time.perf_counter()
    train = detjax_torch.make_train_state("retinanet_r50_640", seed=0)
    cfg = train.cfg
    b = cfg.train.batch_size
    batch = train_batch(cfg, seed=0)
    # seeded R50 towers saturate the focal loss (logit std near 17): the
    # same output-conv rescale as the serving phases, before any step
    scales = desaturate_(train.model, batch["images"][:4], cfg)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_pos_gt = int((batch["gt_labels"] >= 0).sum())

    # 1. kernel route vs twin route from one state and one batch
    twin = copy.deepcopy(train)
    dev = next(train.model.parameters()).device
    images = torch.as_tensor(batch["images"]).to(dev)
    _, gt_aug = device_augment(
        images, torch.as_tensor(batch["gt_boxes"]).to(dev),
        flip=tstep.flip_mask(cfg, 0, b), hflip_prob=0.0,
        mean=cfg.data.mean, std=cfg.data.std)
    anchors = _anchors(cfg.model.image_size, anchor_config(cfg), dev)
    labels = torch.as_tensor(batch["gt_labels"]).to(dev)
    m_kernel = match_anchors(anchors, gt_aug, labels, backend="auto")
    m_twin = match_anchors(anchors, gt_aug, labels, backend="torch")
    match_equal = {f: torch.equal(getattr(m_kernel, f), getattr(m_twin, f))
                   for f in m_kernel._fields}
    before = _params(train)
    _, mk = detjax_torch.train_step(train, batch)
    _, mt = detjax_torch.train_step(twin, batch, match_backend="torch")
    after = _params(train)
    unchanged = [n for n in before if torch.equal(before[n], after[n])]
    bn_moved = sum(1 for n in before if (".bn" in n or n.startswith("bn")
                                         or "downsample.1" in n)
                   and n not in unchanged)
    twin_params = _params(twin)
    param_diff = max(float((after[n] - twin_params[n]).abs().max())
                     for n in after)
    loss_k, loss_t = float(mk["loss"]), float(mt["loss"])
    del twin, before, after, twin_params
    emit({"phase": "train_routes", "match_result_equal": match_equal,
          "loss_kernel_route": loss_k, "loss_twin_route": loss_t,
          "loss_tolerance": "1e-6 relative; bit-equal expected (the same "
                            "forward and the same targets)",
          "max_param_diff_after_step": param_diff,
          "param_tolerance": "2 * lr: cuDNN's backward may sum in another "
                             "order between two runs, and Adam's first "
                             "step turns a noise-signed gradient into "
                             "+-lr",
          "trainable_tensors": len(_params(train)),
          "unchanged_after_step_1": unchanged,
          "bn_affine_tensors_moved": bn_moved})
    if not all(match_equal.values()):
        raise SystemExit(f"kernel and twin MatchResults differ: "
                         f"{match_equal}")
    if abs(loss_k - loss_t) > 1e-6 * abs(loss_t):
        raise SystemExit(f"step-1 loss differs between the kernel and "
                         f"twin routes: {loss_k} vs {loss_t}")
    if param_diff > 2 * cfg.train.learning_rate:
        raise SystemExit(f"parameters after one step differ by "
                         f"{param_diff} between the routes")
    if unchanged or bn_moved == 0:
        raise SystemExit(f"trainable tensors unchanged by step 1: "
                         f"{unchanged}")

    # 2. the main path: warm-up, timed steps, one step split by events
    warmup, timed = 2, 6
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    km.match_launches = km.match_kernel_launches = 0
    steps = []
    for _ in range(warmup):
        steps.append(detjax_torch.train_step(train, batch)[1])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(timed):
        steps.append(detjax_torch.train_step(train, batch)[1])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / timed * 1e3
    events = {"start": torch.cuda.Event(enable_timing=True)}

    def record(name):
        events[name] = torch.cuda.Event(enable_timing=True)
        events[name].record()

    events["start"].record()
    steps.append(detjax_torch.train_step(train, batch, record=record)[1])
    torch.cuda.synchronize()
    launches = km.match_launches
    match_kernels = km.match_kernel_launches
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    order = ["start", "forward", "loss", "backward", "update"]
    split = {f"{b_}_ms": events[a_].elapsed_time(events[b_])
             for a_, b_ in zip(order, order[1:])}
    split["step_ms"] = events["start"].elapsed_time(events["update"])
    per_step = [{k: float(v) for k, v in m.items()} for m in steps]
    for i, m in enumerate(per_step):
        emit({"phase": "train_step", "step": i + 2, **m})
    finite = all(np.isfinite(list(m.values())).all() for m in per_step)
    emit({"phase": "train", "preset": cfg.model.name,
          "depth": cfg.model.backbone_depth, "dtype": cfg.model.dtype,
          "batch": b, "canvas": list(cfg.model.image_size),
          "classes": cfg.model.num_classes, "max_gt": cfg.train.max_gt,
          "anchors": int(anchors.shape[0]), "gt_per_batch": n_pos_gt,
          "optimizer": cfg.train.optimizer, "lr": cfg.train.learning_rate,
          "output_scales": scales, "setup_s": setup_s,
          "steps_in_window": len(steps), "match_launches": launches,
          "match_cuda_kernels": match_kernels,
          "ms_per_step": step_ms, "img_per_s": b / step_ms * 1e3,
          "split_one_step": split, "peak_memory_gib": peak_gb,
          "card": state["card"]})
    if not finite:
        raise SystemExit("a training metric is not finite")
    if min(m["num_pos"] for m in per_step) <= 0:
        raise SystemExit("a training step had no positive anchor")
    if launches != len(steps) or match_kernels != launches:
        raise SystemExit(f"match kernel launched {launches} times "
                         f"({match_kernels} CUDA kernels) in {len(steps)} "
                         f"steps")
    report["match_iou_cuda"]["launches"] = launches
    state["train"] = {"ms_per_step": step_ms, "img_per_s": b / step_ms * 1e3,
                      "split_one_step": split, "peak_memory_gib": peak_gb}


# The gradients train_fused holds the kernel route to: every parameter of
# the five fused blocks and of layer1.0, below them (reached only through
# the kernel's dx).
FUSED_GRAD_PREFIXES = ("layer1.0.", "layer1.1.", "layer1.2.", "layer2.1.",
                       "layer2.2.", "layer2.3.")


def _fused_grads(train) -> dict:
    return {n: p.grad.detach().clone()
            for n, p in train.model.named_parameters()
            if n.startswith(FUSED_GRAD_PREFIXES)}


def phase_train_fused(report: dict, state: dict) -> None:
    """retinanet_r50_640 training with model.fused_backbone="on" through
    make_train_state / train_step: bs 16, bf16 autocast, 640 px, the batch
    and desaturate_ of phase_train. The kernel route against the twin
    route (model.bottleneck_backend = "torch": the forward twin, by plain
    autograd) from one state and one batch; then timed steps beside the
    unfused train phase, with 5 forward and 5 backward fused-block
    launches and 1 matching launch a step."""
    import detjax_torch
    from detjax_torch.kernels import bottleneck as kb
    from detjax_torch.kernels import matching as km
    from detjax_torch.train import step as tstep

    t0 = time.perf_counter()
    train = detjax_torch.make_train_state(
        "retinanet_r50_640", seed=0, **{"model.fused_backbone": "on"})
    cfg = train.cfg
    b = cfg.train.batch_size
    n_fused = len(train.model.fused_blocks())
    batch = train_batch(cfg, seed=0)
    scales = desaturate_(train.model, batch["images"][:4], cfg)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    # 1. kernel route vs twin route from one state and one batch
    twin = copy.deepcopy(train)
    twin.model.bottleneck_backend = "torch"
    kb.bottleneck_bwd_launches = 0
    loss_k = float(tstep.compute_gradients(train, batch)[0])
    route_bwd = kb.bottleneck_bwd_launches
    grads_k = _fused_grads(train)
    with tf32_off():
        loss_t = float(tstep.compute_gradients(twin, batch)[0])
    grads_t = _fused_grads(twin)
    twin_bwd = kb.bottleneck_bwd_launches - route_bwd
    del twin
    grad_errs = {}
    for n, gt in grads_t.items():
        err = float((grads_k[n] - gt).abs().max())
        tol = 0.05 * float(gt.abs().max())
        grad_errs[n] = (err, tol)
    bad = {n: v for n, v in grad_errs.items()
           if not (np.isfinite(v[0]) and v[0] <= v[1])}
    worst = max(grad_errs, key=lambda n: grad_errs[n][0]
                / max(grad_errs[n][1], 1e-30))
    before = _params(train)
    _, m1 = detjax_torch.train_step(train, batch)
    after = _params(train)
    unchanged = [n for n in before if torch.equal(before[n], after[n])]
    del before, after, grads_k, grads_t
    emit({"phase": "train_fused_routes", "fused_blocks": n_fused,
          "loss_kernel_route": loss_k, "loss_twin_route": loss_t,
          "loss_tolerance": "1e-2 relative",
          "bottleneck_bwd_launches": {"kernel_route": route_bwd,
                                      "twin_route": twin_bwd},
          "grads_compared": len(grad_errs),
          "worst_grad": {"name": worst, "max_abs_err": grad_errs[worst][0],
                         "tolerance": grad_errs[worst][1]},
          "grads_outside": bad,
          "grad_tolerance": "0.05 x max|twin| per tensor, over the fused "
                            "blocks' and layer1.0's parameters: bf16 "
                            "products summed in other orders (the kernels "
                            "against cuDNN's fp32 twin convolutions), "
                            "carried back through up to 5 blocks",
          "trainable_tensors": len(_params(train)),
          "unchanged_after_step_1": unchanged,
          "step_1_loss": float(m1["loss"])})
    if n_fused != 5 or route_bwd != 5 or twin_bwd != 0:
        raise SystemExit(f"expected 5 fused blocks and 5 backward launches "
                         f"on the kernel route only, got {n_fused}, "
                         f"{route_bwd}, {twin_bwd}")
    if not abs(loss_k - loss_t) <= 1e-2 * abs(loss_t):
        raise SystemExit(f"fused-route loss differs from the twin route: "
                         f"{loss_k} vs {loss_t}")
    if bad:
        raise SystemExit(f"fused-route gradients outside the bar: {bad}")
    if unchanged:
        raise SystemExit(f"trainable tensors unchanged by step 1 with "
                         f"fused_backbone='on': {unchanged}")

    # 2. the main path: warm-up, timed steps, one step split by events
    warmup, timed = 2, 6
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kb.bottleneck_launches = kb.bottleneck_bwd_launches = 0
    kb.bottleneck_kernel_launches = kb.bottleneck_bwd_kernel_launches = 0
    kb.bottleneck_bwd_grad_copies = km.match_launches = 0
    steps = []
    for _ in range(warmup):
        steps.append(detjax_torch.train_step(train, batch)[1])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(timed):
        steps.append(detjax_torch.train_step(train, batch)[1])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / timed * 1e3
    events = {"start": torch.cuda.Event(enable_timing=True)}

    def record(name):
        events[name] = torch.cuda.Event(enable_timing=True)
        events[name].record()

    events["start"].record()
    steps.append(detjax_torch.train_step(train, batch, record=record)[1])
    torch.cuda.synchronize()
    n = len(steps)
    launches = {"bottleneck_fwd": kb.bottleneck_launches,
                "bottleneck_bwd": kb.bottleneck_bwd_launches,
                "match": km.match_launches}
    copies = kb.bottleneck_bwd_grad_copies
    fwd_kernels = kb.bottleneck_kernel_launches
    bwd_kernels = kb.bottleneck_bwd_kernel_launches
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    order = ["start", "forward", "loss", "backward", "update"]
    split = {f"{b_}_ms": events[a_].elapsed_time(events[b_])
             for a_, b_ in zip(order, order[1:])}
    split["step_ms"] = events["start"].elapsed_time(events["update"])
    per_step = [{k: float(v) for k, v in m.items()} for m in steps]
    finite = all(np.isfinite(list(m.values())).all() for m in per_step)
    busy = forward_busy(train.model,
                        normalized_nchw(train.model, batch["images"], cfg),
                        grad=True)
    unfused = state["train"]
    emit({"phase": "train_fused", "preset": cfg.model.name,
          "fused_backbone": cfg.model.fused_backbone,
          "dtype": cfg.model.dtype, "batch": b,
          "canvas": list(cfg.model.image_size),
          "output_scales": scales, "setup_s": setup_s,
          "steps_in_window": n, "launches_in_window": launches,
          "launches_per_step": {k: v / n for k, v in launches.items()},
          "bottleneck_fwd_cuda_kernels_per_step": fwd_kernels / n,
          "bottleneck_bwd_cuda_kernels_per_step": bwd_kernels / n,
          "grad_out_copies_per_step": copies / n,
          "losses": [m["loss"] for m in per_step],
          "ms_per_step": step_ms, "img_per_s": b / step_ms * 1e3,
          "split_one_step": split, "peak_memory_gib": peak_gb,
          "unfused_ms_per_step": unfused["ms_per_step"],
          "unfused_img_per_s": unfused["img_per_s"],
          "unfused_split_one_step": unfused["split_one_step"],
          "forward_on_off_device_busy": busy,
          "forward_share": split["forward_ms"] / split["step_ms"],
          "unfused_forward_share": (unfused["split_one_step"]["forward_ms"]
                                    / unfused["split_one_step"]["step_ms"]),
          "unfused_peak_memory_gib": unfused["peak_memory_gib"],
          "card": state["card"]})
    if not finite:
        raise SystemExit("a fused training metric is not finite")
    if launches != {"bottleneck_fwd": 5 * n, "bottleneck_bwd": 5 * n,
                    "match": n}:
        raise SystemExit(f"expected 5 forward, 5 backward fused-block "
                         f"launches and 1 matching launch a step in {n} "
                         f"steps, got {launches}")
    if fwd_kernels != kb.FWD_KERNELS * launches["bottleneck_fwd"]:
        raise SystemExit(f"the fused forward's {launches['bottleneck_fwd']} "
                         f"calls launched {fwd_kernels} CUDA kernels, not "
                         f"{kb.FWD_KERNELS} each")
    if bwd_kernels != kb.BWD_KERNELS * launches["bottleneck_bwd"]:
        raise SystemExit(f"the fused backward's {launches['bottleneck_bwd']} "
                         f"calls launched {bwd_kernels} CUDA kernels, not "
                         f"{kb.BWD_KERNELS} each")
    if not peak_gb < unfused["peak_memory_gib"]:
        raise SystemExit(f"peak memory with 'on' {peak_gb} GiB is not below "
                         f"'off''s {unfused['peak_memory_gib']} GiB")
    report["bottleneck_identity_bwd_cuda"]["launches"] = launches[
        "bottleneck_bwd"]
    report["bottleneck_identity_bwd_cuda"]["launches_per_step"] = 5
    del train, batch
    train_fused_1024(state)


def train_fused_1024(state: dict) -> None:
    """Two train_steps of retinanet_r50_1024 (train batch 8, 1024 px) with
    "on": rows of 256 px at layer1 and 128 px at layer2; 5 forward and 5
    backward fused launches a step; each step's loss within 1e-2 relative
    of the twin route's (model.bottleneck_backend = "torch") from the same
    state and batch."""
    import detjax_torch
    from detjax_torch.kernels import bottleneck as kb

    train = detjax_torch.make_train_state(
        "retinanet_r50_1024", seed=0, **{"model.fused_backbone": "on"})
    cfg = train.cfg
    batch = train_batch(cfg, seed=2)
    desaturate_(train.model, batch["images"][:2], cfg)
    twin = copy.deepcopy(train)
    twin.model.bottleneck_backend = "torch"
    kb.bottleneck_launches = kb.bottleneck_bwd_launches = 0
    losses_k = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(2):
        losses_k.append(float(detjax_torch.train_step(train, batch)[1]
                              ["loss"]))
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 2 * 1e3
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    launches = {"bottleneck_fwd": kb.bottleneck_launches,
                "bottleneck_bwd": kb.bottleneck_bwd_launches}
    with tf32_off():
        losses_t = [float(detjax_torch.train_step(twin, batch)[1]["loss"])
                    for _ in range(2)]
    del twin, train
    off_peak_gb = unfused_peak_gib("retinanet_r50_1024", batch)
    rel = [abs(k - t) / abs(t) for k, t in zip(losses_k, losses_t)]
    emit({"phase": "train_fused_1024", "preset": cfg.model.name,
          "batch": cfg.train.batch_size, "canvas": list(cfg.model.image_size),
          "launches_in_2_steps": launches, "losses_kernel_route": losses_k,
          "losses_twin_route": losses_t, "loss_rel_err": rel,
          "loss_tolerance": "1e-2 relative",
          "ms_per_step_incl_first": step_ms,
          "peak_memory_gib": peak_gb, "unfused_peak_memory_gib": off_peak_gb,
          "peak_note": "two steps each, with a second copy of the train "
                       "state resident on both sides (the twin route's "
                       "on 'on', an idle copy on 'off')",
          "card": state["card"]})
    if launches != {"bottleneck_fwd": 10, "bottleneck_bwd": 10}:
        raise SystemExit(f"expected 5 + 5 fused launches a step at 1024 px, "
                         f"got {launches} in 2 steps")
    if not (all(np.isfinite(losses_k)) and max(rel) <= 1e-2):
        raise SystemExit(f"retinanet_r50_1024 with 'on': kernel-route "
                         f"losses {losses_k} vs twin route {losses_t}")


def unfused_peak_gib(preset: str, batch: dict) -> float:
    """Peak memory of two train_steps of ``preset`` with "off" on
    ``batch``, with an idle copy of the train state resident, as the fused
    run holds its twin's."""
    import detjax_torch

    train = detjax_torch.make_train_state(preset, seed=0)
    desaturate_(train.model, batch["images"][:2], train.cfg)
    spare = copy.deepcopy(train)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        detjax_torch.train_step(train, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    del train, spare
    return peak


# The stem max-pool's input z at the two training stems, (name, B, 2H, 2W,
# C): retinanet_r50_640 at train batch 16 and retinanet_r50_1024 at 8.
STEM_SHAPES = (("r50_640", 16, 320, 320, 64), ("r50_1024", 8, 512, 512, 64))


def maxpool_bwd_bound_ms(b: int, hz: int, wz: int, c: int,
                         elem_bytes: int) -> tuple:
    """Least time for the max-pool backward: z and dp read once and dz
    written once over the memory rate; per window 8 maxima and 9
    comparisons, and up to 4 adds per dz block, over the fp32 rate."""
    windows = b * (hz // 2) * (wz // 2) * c
    nbytes = (2 * b * hz * wz * c + windows) * elem_bytes
    t_bytes = nbytes / H100["bytes_per_s"] * 1e3
    t_ops = 21.0 * windows / H100["fp32_flops"] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit (-0 and +0 differ, NaN equals the same NaN)."""
    view = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    return a.dtype == b.dtype and torch.equal(
        a.contiguous(memory_format=torch.channels_last).view(view),
        b.contiguous(memory_format=torch.channels_last).view(view))


def pool_inputs(seed: int, b: int, hz: int, wz: int, c: int, dtype,
                hard: bool = False) -> tuple:
    """``seeded_pool_inputs`` on the card as channels-last NCHW tensors."""
    from detjax_torch.kernels import stem as ks

    z, dp = ks.seeded_pool_inputs(seed, b, hz, wz, c, hard=hard)
    return tuple(torch.from_numpy(a).to("cuda", dtype).permute(0, 3, 1, 2)
                 for a in (z, dp))


def aten_pool_bwd(z: torch.Tensor, dp: torch.Tensor, idx: torch.Tensor):
    """ATen's max-pool backward from the forward's saved indices, what
    ``F.max_pool2d``'s autograd runs."""
    return torch.ops.aten.max_pool2d_with_indices_backward(
        dp, z, [3, 3], [2, 2], [1, 1], [1, 1], False, idx)


def phase_maxpool_bwd_kernel(report: dict) -> None:
    """The stem max-pool backward kernel against its twin at the two
    training stems, bf16, channels-last: bit-equal on post-ReLU z and on a
    hard z (ties, -inf corner, border and interior windows, NaN), and in
    fp32 at the 640 stem; two runs bit-equal. Against ATen's backward on
    the post-ReLU z: the same support, at least 99.9 % of dz bit-equal and
    the rest within 1 bf16 step. The bf16 calls take the strip instance
    (counted). Times by device_ms, in turns with the gather kernel as it
    stood at PRIOR_B5 (bit-equal too) and ATen's backward (the library
    yardstick), beside the bound and the twin."""
    from detjax_torch.kernels import stem as ks

    rows = []
    for i, (name, b, hz, wz, c) in enumerate(STEM_SHAPES):
        z, dp = pool_inputs(40 + i, b, hz, wz, c, torch.bfloat16)
        zh, dph = pool_inputs(50 + i, b, hz, wz, c, torch.bfloat16,
                              hard=True)
        s0 = ks.maxpool_bwd_strip_launches
        got = ks.maxpool_bwd_cuda(z, dp)
        again = ks.maxpool_bwd_cuda(z, dp)
        strip = ks.maxpool_bwd_strip_launches - s0
        want = ks.maxpool_bwd_reference(z, dp)
        prior = prior_b5_pool_call(z, dp)
        prior_equal = same_bits(prior(), want)
        bit_equal = same_bits(got, want)
        twin_err = float((got.float() - want.float()).abs().max())
        twice = same_bits(got, again)
        del again, want
        hard_equal = same_bits(ks.maxpool_bwd_cuda(zh, dph),
                               ks.maxpool_bwd_reference(zh, dph))
        hard_nan = bool(zh.isnan().any())
        del zh, dph
        fp32_equal = None
        if i == 0:
            zf, dpf = z.float(), dp.float()
            fp32_equal = same_bits(ks.maxpool_bwd_cuda(zf, dpf),
                                   ks.maxpool_bwd_reference(zf, dpf))
            del zf, dpf
        _, idx = torch.ops.aten.max_pool2d_with_indices(z, [3, 3], [2, 2],
                                                        [1, 1])
        aten = aten_pool_bwd(z, dp, idx)
        torch.cuda.synchronize()
        support = torch.equal(got != 0, aten != 0)
        frac_equal = float((got == aten).float().mean())
        ulps = bf16_ulps(got, aten)
        err = float((got.float() - aten.float()).abs().max())
        del got, aten
        timed = in_turns({"new": lambda: ks.maxpool_bwd_cuda(z, dp),
                          PRIOR_B5: prior,
                          "aten": lambda: aten_pool_bwd(z, dp, idx)},
                         (PRIOR_B5, "new", "aten", "new", PRIOR_B5, "aten"),
                         iters=50)
        ms, aten_ms = timed["ms"]["new"], timed["ms"]["aten"]
        call_ms = cuda_ms(lambda: ks.maxpool_bwd_cuda(z, dp), iters=50,
                          warmup=5)
        plain_ms = device_ms(lambda: ks.maxpool_bwd_reference(z, dp),
                             iters=3, warmup=1)
        bound_ms, bound_by = maxpool_bwd_bound_ms(b, hz, wz, c, 2)
        # what the card moves in practice: z copied to a buffer of its
        # size (z read once, written once), scaled to the kernel's bytes
        # (dp read besides)
        copy_to = torch.empty_like(z)
        copy_ms = device_ms(lambda: copy_to.copy_(z), iters=50)
        del copy_to
        copy_floor_ms = copy_ms * (2 * z.numel() + dp.numel()) / (
            2 * z.numel())
        row = {"shape": name, "z": [b, c, hz, wz], "dtype": "bfloat16",
               "bit_equal_post_relu": bit_equal, "bit_equal_hard": hard_equal,
               "hard_has_nan": hard_nan, "bit_equal_fp32": fp32_equal,
               "bit_equal_across_two_runs": twice,
               "max_abs_err_twin": twin_err, "aten_same_support": support,
               "aten_frac_bit_equal": frac_equal,
               "aten_max_bf16_ulps": ulps, "aten_max_abs_err": err,
               "strip_launches": strip,
               f"bit_equal_{PRIOR_B5}": prior_equal,
               "ms": ms, "ms_by": "device_ms",
               f"ms_at_{PRIOR_B5}": timed["ms"][PRIOR_B5],
               "timed_in_turns": timed["turns"], "call_ms": call_ms,
               "plain_ms": plain_ms, "aten_bwd_ms": aten_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "bound_share": bound_ms / ms, "copy_z_ms": copy_ms,
               "copy_floor_ms": copy_floor_ms,
               "copy_floor_share": copy_floor_ms / ms}
        emit({"phase": "maxpool_bwd_kernel", "kernel": "maxpool_bwd_cuda",
              **row, "bars": "bit-equal to the twin (post-ReLU, hard, fp32 "
                             "at 640), two runs bit-equal; against ATen "
                             "on post-ReLU z: same support, >= 99.9 % "
                             "bit-equal, the rest within 1 bf16 step"})
        ok = bit_equal and hard_equal and hard_nan and twice and \
            fp32_equal is not False and prior_equal and strip == 2
        ok = ok and support and frac_equal >= 0.999 and ulps <= 1
        if not ok:
            raise SystemExit(f"the max-pool backward kernel disagrees at "
                             f"{name}: {row}")
        rows.append(row)
        del z, dp, idx, prior
    main = rows[0]
    report["maxpool_bwd_cuda"] = {
        "name": "maxpool_bwd_cuda", "route": "cuda",
        "source": "detjax_torch/csrc/maxpool_bwd.cu",
        "replaces": "detjax/kernels/stem.py:163",
        "launches": None, "match": True,
        "max_abs_err": max(r["max_abs_err_twin"] for r in rows),
        "max_abs_err_note": "against its twin, post-ReLU z; against ATen's "
                            "backward see aten_max_abs_err",
        "ms": main["ms"], "ms_by": "device_ms", "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": main["aten_bwd_ms"],
        f"ms_at_{PRIOR_B5}": main[f"ms_at_{PRIOR_B5}"],
        "library_note": "torch.ops.aten.max_pool2d_with_indices_backward "
                        "with the forward's indices",
        "per": "one backward of the R50-640 training stem, bs 16, bf16",
        "shapes": rows}


def stem_forward(conv1, bn1, x, pool):
    with torch.autocast("cuda", dtype=torch.bfloat16):
        return pool(torch.relu(bn1(conv1(x))))


def stem_cell(preset: str, state: dict, full: bool) -> dict:
    """The stem of ``preset`` (conv1 7x7/s2 -> frozen bn1 -> ReLU -> 3x3/s2
    max-pool) at its train batch, bf16 autocast, channels-last, with
    ``make_train_state``'s conv1 and bn1; times by CUDA events and the
    kernel's launches in one forward + backward. ``full`` adds the pool
    and conv timings, memory (what the forward holds for the backward, its
    output included, and the peak of forward + backward, both above the
    inputs) and the gradients between routes."""
    import detjax_torch
    from detjax_torch.kernels import stem as ks

    train = detjax_torch.make_train_state(preset, seed=0)
    cfg = train.cfg
    conv1, bn1 = train.model.conv1, train.model.bn1
    del train
    b, (hh, ww) = cfg.train.batch_size, cfg.model.image_size
    rng = np.random.default_rng(60)
    x = torch.from_numpy(rng.standard_normal((b, hh, ww, 3),
                                             dtype=np.float32)).to(
        "cuda").permute(0, 3, 1, 2)
    dp = torch.from_numpy(rng.standard_normal(
        (b, hh // 4, ww // 4, 64), dtype=np.float32)).to(
        "cuda", torch.bfloat16).permute(0, 3, 1, 2)
    params = [conv1.weight, bn1.weight, bn1.bias]
    pools = {"aten": ks.max_pool_3x3s2_reference,
             "kernel": ks.max_pool_3x3s2}
    routes = {k: (lambda pool=pool: torch.autograd.grad(
        stem_forward(conv1, bn1, x, pool), params, dp))
        for k, pool in pools.items()}
    ks.maxpool_bwd_launches = ks.maxpool_bwd_copies = 0
    ks.maxpool_bwd_strip_launches = 0
    grads_k = routes["kernel"]()
    torch.cuda.synchronize()
    launches, copies = ks.maxpool_bwd_launches, ks.maxpool_bwd_copies
    strip = ks.maxpool_bwd_strip_launches
    row = {"preset": preset, "x": [b, 3, hh, ww],
           "z": [b, 64, hh // 2, ww // 2], "launches_per_backward": launches,
           "strip_launches_per_backward": strip,
           "copies_per_backward": copies}
    ms = {k: cuda_ms(fn, iters=10) for k, fn in routes.items()}
    row["stem_fwd_bwd_ms"] = ms
    if full:
        grads_a = routes["aten"]()
        rel = {n: float(torch.linalg.vector_norm(k - a)
                        / torch.linalg.vector_norm(a))
               for n, k, a in zip(("conv1.weight", "bn1.weight", "bn1.bias"),
                                  grads_k, grads_a)}
        finite = all(bool(torch.isfinite(g).all()) for g in grads_k)
        del grads_a
        with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
            row["conv_fwd_ms"] = cuda_ms(lambda: conv1(x), iters=10)
            row["stem_fwd_ms"] = cuda_ms(
                lambda: ks.max_pool_3x3s2_reference(
                    torch.relu(bn1(conv1(x)))), iters=10)
            z = torch.relu(bn1(conv1(x)))
        z.requires_grad_(True)

        def pool_fb(pool):
            return lambda: torch.autograd.grad(pool(z), z, dp)
        row["pool_fwd_bwd_ms"] = {
            "aten": cuda_ms(pool_fb(ks.max_pool_3x3s2_reference), iters=20),
            "kernel": cuda_ms(pool_fb(ks.max_pool_3x3s2), iters=20)}
        del z
        peak, held = {}, {}
        for k, pool in pools.items():
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            p = stem_forward(conv1, bn1, x, pool)
            torch.cuda.synchronize()
            held[k] = (torch.cuda.memory_allocated() - base) / 2**20
            torch.autograd.grad(p, params, dp)
            del p
            torch.cuda.synchronize()
            peak[k] = (torch.cuda.max_memory_allocated() - base) / 2**20
        row.update(peak_mib_above_inputs=peak, forward_holds_mib=held,
                   forward_holds_saving_mib=held["aten"] - held["kernel"],
                   grad_rel_err=rel, grads_finite=finite)
    emit({"phase": "stem", **row, "card": state["card"]})
    if launches != 1 or strip != 1 or copies != 0:
        raise SystemExit(f"expected 1 max-pool backward launch (the strip "
                         f"instance) and 0 copies in one stem backward at "
                         f"{preset}, got {launches} ({strip}) and {copies}")
    if full and not (row["grads_finite"]
                     and max(row["grad_rel_err"].values()) <= 1e-3):
        raise SystemExit(f"stem gradients differ between routes: {row}")
    return row


def phase_stem(report: dict, state: dict) -> None:
    """The port's counterpart of scripts/profile_stem.py: the R50 stem
    forward and backward at retinanet_r50_640's training shape (bs 16),
    ATen's pool against max_pool_3x3s2 (the kernel as its backward), then
    retinanet_r50_1024's (bs 8). The kernel's launches are counted in one
    stem forward + backward at 640."""
    row = stem_cell("retinanet_r50_640", state, full=True)
    report["maxpool_bwd_cuda"]["launches"] = row["launches_per_backward"]
    stem_cell("retinanet_r50_1024", state, full=False)


# ---- the data pipeline and evaluation ----

EVAL_SET_SIZE = 256
# COCO val2017's most common source shapes, (H, W), in turn
COCO_VAL_SHAPES = ((480, 640), (640, 480), (427, 640), (640, 427),
                   (375, 500), (500, 375))


def write_eval_set(root: Path) -> Path:
    """EVAL_SET_SIZE scenes of the port's SyntheticDetectionDataset written
    into ``root`` as JPEGs (PIL, quality 95) with a COCO instances JSON: 80
    classes (category ids 1-80), COCO_VAL_SHAPES in turn, 1-12 objects an
    image with sides from 1/32 to 1/3 of the image's (COCO-small objects
    at these sizes), 10 % of them crowd. Returns the JSON's path."""
    from detjax_torch.data import COCO_CLASSES
    from detjax_torch.data.synthetic import SyntheticDetectionDataset

    ds = SyntheticDetectionDataset(
        num_images=EVAL_SET_SIZE, num_classes=80, max_objects=12, seed=12,
        size_range=(1 / 32, 1 / 3), crowd_prob=0.1,
        image_sizes=COCO_VAL_SHAPES)
    return write_coco_jpegs(ds, root, COCO_CLASSES, first_category=1,
                            quality=95)


def write_coco_jpegs(ds, root: Path, class_names, first_category: int,
                     **save_kw) -> Path:
    """Every record of ``ds`` written into ``root`` as a JPEG (PIL,
    ``save_kw``) with a COCO instances JSON whose category ids start at
    ``first_category``. Returns the JSON's path."""
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    def one(i):
        rec = ds[i]
        name = f"{i:012d}.jpg"
        Image.fromarray(rec["image"]).save(root / name, **save_kw)
        h, w = rec["size"]
        anns = [{"image_id": i, "category_id": int(lab) + first_category,
                 "bbox": [float(x1), float(y1), float(x2 - x1),
                          float(y2 - y1)],
                 "area": float((x2 - x1) * (y2 - y1)),
                 "iscrowd": int(crowd)}
                for (x1, y1, x2, y2), lab, crowd in zip(
                    rec["boxes"], rec["labels"], rec["iscrowd"])]
        return {"id": i, "file_name": name, "height": h, "width": w}, anns

    with ThreadPoolExecutor(8) as pool:
        rows = list(pool.map(one, range(len(ds))))
    anns = [a for _, image_anns in rows for a in image_anns]
    for k, a in enumerate(anns):
        a["id"] = k + 1
    path = root / "instances_synthetic.json"
    path.write_text(json.dumps({
        "images": [img for img, _ in rows], "annotations": anns,
        "categories": [{"id": k + first_category, "name": n}
                       for k, n in enumerate(class_names)]}))
    return path


def eval_set(state: dict):
    from detjax_torch.data import CocoDataset

    return CocoDataset(state["eval_set"]["ann"], state["eval_set"]["root"])


def phase_data(state: dict) -> None:
    """Write the synthetic JPEG set with its COCO JSON, read it back
    through CocoDataset, and report the native layer on the card's host:
    whether the library and the JPEG decoder built, the decode route of
    every image, and whether native decode and resize equal PIL's on the
    set (the resize at each image's 640 letterbox and protocol sizes).
    Fails when the native library did not build (a missing libjpeg is
    reported, as detjax falls back to PIL for it)."""
    import tempfile

    import PIL
    from PIL import Image

    from detjax_torch import native
    from detjax_torch.data.transforms import protocol_scale

    tmp = tempfile.TemporaryDirectory(prefix="detjax_eval_set_")
    root = Path(tmp.name)
    t0 = time.perf_counter()
    ann = write_eval_set(root)
    write_s = time.perf_counter() - t0
    state["eval_set"] = {"tmp": tmp, "ann": str(ann), "root": str(root)}
    native_built, jpeg_native = native.available(), native.jpeg_available()
    if not native_built:
        raise SystemExit(f"the native library did not build on the card's "
                         f"host: {native.build_errors}")
    ds = eval_set(state)
    before = dict(native.decode_routes)
    t0 = time.perf_counter()
    images = [ds.load_image(i) for i in range(len(ds))]
    decode_ms = (time.perf_counter() - t0) / len(ds) * 1e3
    routes = {k: native.decode_routes[k] - before[k] for k in before}
    t0 = time.perf_counter()
    pil = []
    for info in ds.images:
        with Image.open(root / info["file_name"]) as im:
            pil.append(np.asarray(im.convert("RGB"), np.uint8))
    pil_decode_ms = (time.perf_counter() - t0) / len(ds) * 1e3
    decode_equal = sum(np.array_equal(a, b) for a, b in zip(images, pil))
    resize_equal, resize_cases, native_s, pil_s = 0, 0, 0.0, 0.0
    for img in images:
        h, w = img.shape[:2]
        for scale in (min(640 / h, 640 / w), protocol_scale(h, w)):
            nh, nw = max(1, int(round(h * scale))), max(1, int(round(w * scale)))
            t0 = time.perf_counter()
            a = native.resize_bilinear(img, nh, nw)
            t1 = time.perf_counter()
            b = np.asarray(Image.fromarray(img).resize((nw, nh),
                                                       Image.BILINEAR))
            pil_s += time.perf_counter() - t1
            native_s += t1 - t0
            resize_equal += bool(np.array_equal(a, b))
            resize_cases += 1
    n_gt = sum(len(ds.load_annotations(i["id"])["labels"])
               for i in ds.images)
    emit({"phase": "data", "images": len(ds), "source_shapes":
          [list(s) for s in COCO_VAL_SHAPES], "classes": ds.num_classes,
          "annotations": n_gt, "write_s": write_s,
          "native_built": native_built, "jpeg_native": jpeg_native,
          "build_errors": native.build_errors, "decode_routes": routes,
          "decode_ms_per_image": decode_ms,
          "pil_decode_ms_per_image": pil_decode_ms,
          "native_decode_equal_to_pil": f"{decode_equal}/{len(images)}",
          "native_resize_equal_to_pil": f"{resize_equal}/{resize_cases}",
          "resize_ms_per_image": {"native": native_s / len(images) * 1e3,
                                  "pil": pil_s / len(images) * 1e3},
          "pil_version": PIL.__version__, "card": state["card"]})
    if routes["native"] + routes["pil"] != len(ds):
        raise SystemExit(f"decode routes {routes} do not cover the "
                         f"{len(ds)} images")


def device_events(prof):
    """(name, device ms) of the kernels and copies a torch.profiler window
    recorded. Left out: CPU records (with CPU activity traced, an op's
    record carries its kernels' device time too) and the device ranges
    of ``record_function`` annotations, which span other kernels."""
    from torch.autograd import DeviceType

    return [(e.name, e.device_time_total / 1e3) for e in prof.events()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and e.device_time_total > 0]


def busy_and_idle(prof, wall_ms: float) -> dict:
    """Device ms of the CUDA kernels and of the copies in a torch.profiler
    window, and the share of ``wall_ms`` in which no kernel ran (kernels
    on one stream; copies on the side stream overlap them)."""
    kernels = copies = 0.0
    for name, t in device_events(prof):
        if "spin_kernel" in name:
            continue
        if name.startswith(("Memcpy", "Memset")):
            copies += t
        else:
            kernels += t
    return {"wall_ms": wall_ms, "kernel_busy_ms": kernels,
            "copy_ms": copies, "idle_share": 1 - kernels / wall_ms}


def profiled_wall(fn):
    """torch.profiler over one call of ``fn`` (profile_calls) and that
    call's host-clock ms, synchronized; None when the profiler cannot
    trace the card."""
    wall = []

    def timed():
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)

    prof = profile_calls(timed, 1)
    return None if prof is None else busy_and_idle(prof, wall[-1])


def kernel_launches_traced(fn, want: dict, what: str, calls: int = 3):
    """Launches a call of ``fn`` of the CUDA kernels whose names contain
    each key of ``want`` (kernel -> the launcher's count a call), from
    torch.profiler's device records over ``calls`` calls (profile_calls,
    device_events), traced again while they fall short of ``want``
    (complete_window); None when the profiler cannot trace the card."""
    def trace():
        prof = profile_calls(fn, calls)
        if prof is None:
            return None
        events = device_events(prof)
        return {n: sum(n in name for name, _ in events) / calls
                for n in want}

    return complete_window(trace, want, what)


def jittered_detections(gts: dict, seed: int) -> dict:
    """Detections made from the ground truth: 85 % of the boxes jittered
    by 5 % of their side, with random scores, and two false positives an
    image, so that AP is far from 0 and from 1."""
    rng = np.random.default_rng(seed)
    dets = {}
    for img_id, g in gts.items():
        hit = rng.uniform(size=len(g.labels)) < 0.85
        boxes = g.boxes[hit]
        side = np.maximum(boxes[:, 2:] - boxes[:, :2], 1.0)
        boxes = boxes + rng.normal(0, 0.05, boxes.shape) * np.tile(side, 2)
        fp = rng.uniform(0, 400, (2, 2))
        fp = np.concatenate([fp, fp + rng.uniform(10, 200, (2, 2))], 1)
        dets[img_id] = {
            "boxes": np.concatenate([boxes, fp]).astype(np.float32),
            "scores": rng.uniform(0.05, 1, len(boxes) + 2).astype(np.float32),
            "labels": np.concatenate([g.labels[hit], rng.integers(0, 80, 2)
                                      ]).astype(np.int32)}
    return dets


def both_cores(gts: dict, dets: dict) -> dict:
    """COCO stats from the numpy core and the native core on the same
    ground truth and detections, with each one's host ms."""
    import os

    from detjax_torch.evaluation.coco_map import evaluate_detections

    out, old = {}, os.environ.get("DETJAX_NATIVE")
    try:
        for name, flag in (("native", "1"), ("numpy", "0")):
            os.environ["DETJAX_NATIVE"] = flag
            t0 = time.perf_counter()
            res = evaluate_detections(gts, dets, list(range(80)))
            out[name] = (res, (time.perf_counter() - t0) * 1e3)
    finally:
        if old is None:
            os.environ.pop("DETJAX_NATIVE", None)
        else:
            os.environ["DETJAX_NATIVE"] = old
    return out


def phase_evaluate(report: dict, state: dict) -> None:
    """detjax_torch.evaluate at retinanet_r50_640 (eval batch 8, bf16,
    full width) on phase_main's desaturated model over the JPEG set: the
    NMS kernel's route against the twin's (detect_fn with
    nms_backend="torch"), all 12 stats and every per-class AP equal; one
    NMS launch per eval batch; the numpy and native COCO cores equal on
    the route's detections and on detections jittered from the GT. Times
    the whole call (host decode included), the host alone (decode +
    letterbox a batch), the device's busy time and idle share over a call
    (torch.profiler), and the same detect on one pre-loaded batch. Also
    holds every image's detections bit-equal between the routes."""
    import detjax_torch
    from detjax_torch.data import make_eval_iterator
    from detjax_torch.evaluation import evaluator
    from detjax_torch.kernels import postprocess as pp

    model, cfg = state["model"], state["cfg"]
    ds = eval_set(state)
    b = cfg.eval.batch_size
    n_batches = -(-len(ds) // b)

    t0 = time.perf_counter()
    host_batches = list(make_eval_iterator(ds, cfg))
    host_ms_per_batch = (time.perf_counter() - t0) / len(host_batches) * 1e3

    torch.cuda.synchronize()
    pp.nms_launches = pp.nms_kernel_launches = 0
    t0 = time.perf_counter()
    got = detjax_torch.evaluate(model, ds, cfg)
    eval_s = time.perf_counter() - t0
    launches, nms_kernels = pp.nms_launches, pp.nms_kernel_launches

    def twin(m, x):
        return detjax_torch.detect(m, x, cfg, nms_backend="torch")

    pp.nms_launches = 0
    t0 = time.perf_counter()
    want = evaluator.run_coco_eval(model, ds, cfg, detect_fn=twin)
    twin_s = time.perf_counter() - t0
    twin_launches = pp.nms_launches

    busy = profiled_wall(lambda: detjax_torch.evaluate(model, ds, cfg))
    gts = evaluator.ground_truths(ds)
    dets = {i: {"boxes": bx, "scores": s, "labels": lab}
            for i, bx, s, lab in evaluator.iter_detections(model, ds, cfg)}
    twin_dets = {i: (bx, s, lab) for i, bx, s, lab in
                 evaluator.iter_detections(model, ds, cfg, detect_fn=twin)}
    same_dets = sorted(dets) == sorted(twin_dets) and all(
        np.array_equal(d[k], twin_dets[i][j]) for i, d in dets.items()
        for j, k in enumerate(("boxes", "scores", "labels")))
    cores = both_cores(gts, dets)
    jittered = both_cores(gts, jittered_detections(gts, seed=0))
    batch_ms = host_ms(model, cfg, host_batches[0]["images"])

    def same(pair):
        return (pair["native"][0].stats == pair["numpy"][0].stats
                and pair["native"][0].per_class_ap
                == pair["numpy"][0].per_class_ap)

    equal = (got.stats == want.stats and got.per_class_ap == want.per_class_ap
             and same_dets)
    kept = sum(len(d["labels"]) for d in dets.values())
    emit({"phase": "evaluate", "preset": cfg.model.name,
          "dtype": cfg.model.dtype, "eval_batch": b, "images": len(ds),
          "eval_batches": n_batches, "host_workers": cfg.data.host_workers,
          "prefetch": cfg.data.prefetch,
          "stats": got.stats, "stats_twin_route": want.stats,
          "stats_and_per_class_ap_equal": equal,
          "detections_bit_equal": same_dets, "kept_detections": kept,
          "nms_launches": launches, "nms_cuda_kernels": nms_kernels,
          "nms_launches_twin_route": twin_launches,
          "evaluate_s": eval_s, "img_per_s": len(ds) / eval_s,
          "twin_route_img_per_s": len(ds) / twin_s,
          "host_decode_letterbox_ms_per_batch": host_ms_per_batch,
          "device_over_one_call": busy,
          "detect_u8_ms_preloaded_batch": batch_ms,
          "img_per_s_preloaded_batch": b / batch_ms * 1e3,
          "cores_equal_on_route_detections": same(cores),
          "cores_ms": {k: v[1] for k, v in cores.items()},
          "cores_equal_on_jittered_gt": same(jittered),
          "jittered_gt_stats": jittered["native"][0].stats,
          "card": state["card"]})
    if not equal:
        raise SystemExit("evaluate through the NMS kernel and through its "
                         "twin give different stats or detections")
    if launches != n_batches or nms_kernels != n_batches or twin_launches:
        raise SystemExit(f"evaluate made {launches} NMS launches "
                         f"({nms_kernels} CUDA kernels) over {n_batches} "
                         f"eval batches; the twin route {twin_launches}")
    if not (same(cores) and same(jittered)):
        raise SystemExit("the numpy and native COCO cores disagree")
    if not 0.2 < jittered["native"][0].stats["AP"] < 0.9 or kept == 0:
        raise SystemExit("the core check is degenerate: AP "
                         f"{jittered['native'][0].stats['AP']}, {kept} kept")
    report["nms_cuda"]["evaluate_launches"] = launches


def phase_evaluate_protocol(state: dict) -> None:
    """run_coco_eval_protocol over the JPEG set with retinanet_r50_1024's
    config (eval_scale_minmax (608, 1024), eval batch 4) on the main
    model's weights, once with fused_backbone="off" and once "on": the
    buckets equal bucket_by_canvas of the set's sizes, 5 fused-block calls
    a batch with "on" (none with "off"); img/s and stats of each (a
    warm-up pass first, as each canvas is new to cuDNN), and the host's ms
    a batch inside detect_u8 (the rest of a batch's wall is loading and
    scoring)."""
    import detjax_torch
    from detjax_torch.evaluation.protocol import (
        bucket_by_canvas,
        image_sizes,
        run_coco_eval_protocol,
    )
    from detjax_torch.kernels import bottleneck as kb

    ds = eval_set(state)
    rows = {}
    for fused in ("off", "on"):
        cfg = detjax_torch.get_config("retinanet_r50_1024", **{
            "model.prior_prob": PRIOR_PROB, "model.fused_backbone": fused})
        want = bucket_by_canvas(image_sizes(ds), *cfg.data.eval_scale_minmax)
        want_batches = {hw: -(-len(ix) // cfg.eval.batch_size)
                        for hw, ix in want.items()}
        if fused == "off":
            model = state["model"]
        else:
            model = detjax_torch.build_model(cfg, seed=0)
            model.load_state_dict(state["model"].state_dict())
        seen: dict = {}
        dispatch_s: list = []

        def detect_fn_for(bcfg, seen=seen, dispatch_s=dispatch_s):
            hw = tuple(bcfg.model.image_size)

            def run(m, x):
                seen[hw] = seen.get(hw, 0) + 1
                t0 = time.perf_counter()
                det = detjax_torch.detect_u8(m, x, bcfg)
                dispatch_s.append(time.perf_counter() - t0)
                return det
            return run

        run_coco_eval_protocol(model, ds, cfg)  # warm-up
        torch.cuda.synchronize()
        kb.bottleneck_launches = 0
        t0 = time.perf_counter()
        res = run_coco_eval_protocol(model, ds, cfg,
                                     detect_fn_for=detect_fn_for)
        secs = time.perf_counter() - t0
        calls = kb.bottleneck_launches
        n_batches = sum(seen.values())
        rows[fused] = {"img_per_s": len(ds) / secs, "evaluate_s": secs,
                       "batches": n_batches, "fused_calls": calls,
                       "host_ms_in_detect_u8_per_batch":
                           sum(dispatch_s) / n_batches * 1e3,
                       "stats": res.stats}
        if seen != want_batches:
            raise SystemExit(f"protocol buckets {seen} differ from "
                             f"bucket_by_canvas's {want_batches}")
        expect = 5 * n_batches if fused == "on" else 0
        if calls != expect:
            raise SystemExit(f'fused_backbone="{fused}": {calls} fused '
                             f"calls over {n_batches} batches, expected "
                             f"{expect}")
        if fused == "on":
            del model
            torch.cuda.empty_cache()
    emit({"phase": "evaluate_protocol", "preset": cfg.model.name,
          "eval_batch": cfg.eval.batch_size,
          "eval_scale_minmax": list(cfg.data.eval_scale_minmax),
          "buckets": {f"{h}x{w}": len(ix) for (h, w), ix in sorted(
              want.items())},
          "off": rows["off"], "on": rows["on"], "card": state["card"]})


def phase_train_data(report: dict, state: dict) -> None:
    """retinanet_r50_640 training (bs 16, bf16, "off") fed by
    make_train_iterator over the JPEG set (random crop on, as the preset
    has it; 8 host threads, prefetch 2) through device_prefetch: the first
    batch byte-equal to a second iterator's with the same seed;
    iter_from(3) equal to the fourth batch; 2 warm-up and 10 timed steps,
    one matching launch a step. Reports ms a step beside the fixed-batch
    train phase's, the host's ms a batch alone, one batch's H2D copy from
    pinned memory (CUDA events), and the device's idle share over three
    data-fed steps (torch.profiler); then 10 steps fed one batch again
    and again through device_prefetch, without the loader threads."""
    import detjax_torch
    from detjax_torch.data import device_prefetch, make_train_iterator
    from detjax_torch.kernels import matching as km

    train = detjax_torch.make_train_state("retinanet_r50_640", seed=0)
    cfg = train.cfg
    ds = eval_set(state)
    it = make_train_iterator(ds, cfg)
    stream = iter(it)
    first = [next(stream) for _ in range(4)]
    stream.close()
    again = iter(make_train_iterator(ds, cfg))
    same_first = all(np.array_equal(first[0][k], v)
                     for k, v in next(again).items())
    again.close()
    resumed = it.iter_from(3)
    same_resume = all(np.array_equal(first[3][k], v)
                      for k, v in next(resumed).items())
    resumed.close()

    host = iter(make_train_iterator(ds, cfg))
    next(host)
    t0 = time.perf_counter()
    for _ in range(8):
        next(host)
    host_ms_per_batch = (time.perf_counter() - t0) / 8 * 1e3
    host.close()

    pin_ms = []
    for _ in range(3):  # the first allocates; then the cache serves
        t0 = time.perf_counter()
        pinned = {k: torch.from_numpy(v).pin_memory()
                  for k, v in first[0].items()}
        pin_ms.append((time.perf_counter() - t0) * 1e3)
    h2d_ms = cuda_ms(lambda: [t.to("cuda", non_blocking=True)
                              for t in pinned.values()], iters=10)
    batch_mib = sum(v.nbytes for v in first[0].values()) / 2**20

    scales = desaturate_(train.model, first[0]["images"][:4], cfg)
    fed = device_prefetch(iter(make_train_iterator(ds, cfg)), "cuda")
    torch.cuda.synchronize()
    km.match_launches = km.match_kernel_launches = 0
    steps = [detjax_torch.train_step(train, next(fed))[1] for _ in range(2)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        steps.append(detjax_torch.train_step(train, next(fed))[1])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 10 * 1e3
    launches, match_kernels = km.match_launches, km.match_kernel_launches
    busy = profiled_wall(lambda: [detjax_torch.train_step(train, next(fed))
                                  for _ in range(3)])
    if busy is not None:
        busy["wall_ms_per_step"] = busy["wall_ms"] / 3
    fed.close()
    # the same steps fed one batch again and again through device_prefetch:
    # pinning and the side-stream copy without the loader threads
    same = device_prefetch(itertools.repeat(first[0], 12), "cuda")
    for _ in range(2):
        detjax_torch.train_step(train, next(same))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        detjax_torch.train_step(train, next(same))
    torch.cuda.synchronize()
    same_batch_ms = (time.perf_counter() - t0) / 10 * 1e3
    losses = [float(m["loss"]) for m in steps]
    emit({"phase": "train_data", "preset": cfg.model.name,
          "batch": cfg.train.batch_size, "dtype": cfg.model.dtype,
          "random_crop": cfg.data.random_crop,
          "host_workers": cfg.data.host_workers,
          "prefetch": cfg.data.prefetch, "output_scales": scales,
          "first_batch_equal_across_iterators": same_first,
          "iter_from_3_equals_fourth_batch": same_resume,
          "ms_per_step": step_ms,
          "fixed_batch_ms_per_step": state["train"]["ms_per_step"],
          "same_batch_through_device_prefetch_ms_per_step": same_batch_ms,
          "host_ms_per_batch": host_ms_per_batch,
          "batch_mib": batch_mib, "pin_ms": pin_ms, "h2d_ms": h2d_ms,
          "device_over_three_steps": busy, "match_launches": launches,
          "match_cuda_kernels": match_kernels, "losses": losses,
          "card": state["card"]})
    if not (same_first and same_resume):
        raise SystemExit("the train stream is not deterministic in its seed")
    if launches != len(steps) or match_kernels != launches:
        raise SystemExit(f"match kernel launched {launches} times "
                         f"({match_kernels} CUDA kernels) in {len(steps)} "
                         f"data-fed steps")
    if not np.isfinite(losses).all():
        raise SystemExit("a data-fed training loss is not finite")
    report["match_iou_cuda"]["train_data_launches"] = launches
    del train


# ---- fit: detjax's mid-gate recipe ----

# detjax's COCO-typical source shapes (scripts/e2e_gate.py:921)
COCO_TYPICAL_SIZES = ((640, 480), (480, 640), (500, 375), (427, 640),
                      (612, 612), (640, 426), (333, 500), (375, 500))
MID_GATE_AP = 0.6768  # detjax bf16 (GATES_r05.json, torchref-mid)
FIT_STEPS = 300
FIT_CKPT_EVERY = 100
FIT_EVAL_EVERY = 150
FIT_RESUME_FROM = 200
FIT_LOG_EVERY = 50
FIT_WINDOW_STEPS = 20  # a timed steady-state window (no eval, no save)
FIT_TRACE_STEPS = 10  # a traced window (its export is slow)
FIT_WARMUP_STEPS = 3  # before each window: cuDNN's choice for the mode
FIT_RESUME_BAR = 0.02  # of a tensor's change since the resume, if an op
#                        has no deterministic version
FIT_FROZEN_STEPS = 20


def mid_gate_config(**extra):
    """detjax's round-5 mid-gate recipe (scripts/e2e_gate.py:1087-1097):
    R50-640, 12 classes, batch-statistics BatchNorm, bs 8, lr 5e-4
    constant, hflip 0.5, random crop, eval batch 8."""
    import detjax_torch

    return detjax_torch.get_config("retinanet_r50_640", **{
        "model.num_classes": 12,
        "model.frozen_backbone_bn": False,
        "train.batch_size": 8,
        "train.max_gt": 16,
        "train.learning_rate": 5e-4,
        "train.lr_schedule": "constant",
        "data.hflip_prob": 0.5,
        "data.random_crop": True,
        "eval.batch_size": 8, **extra})


def mid_gate_data(root: Path):
    """The recipe's 256 training scenes (seed 31) and its held-out set, the
    gate's ``mid_val``: 24 scenes (seed 222) written into ``root`` as
    JPEGs (quality 95, 4:4:4 chroma) with a COCO JSON whose category ids
    are the labels, as detjax's ``dump_dataset_as_coco`` writes them
    (scripts/e2e_gate.py:1105-1130)."""
    from detjax_torch.data import CocoDataset
    from detjax_torch.data.synthetic import SyntheticDetectionDataset

    kw = dict(num_classes=12, max_objects=8, size_range=(1 / 24, 1 / 3),
              crowd_prob=0.15, image_sizes=COCO_TYPICAL_SIZES)
    train = SyntheticDetectionDataset(num_images=256, seed=31, **kw)
    held = SyntheticDetectionDataset(num_images=24, seed=222, **kw)
    ann = write_coco_jpegs(held, root, held.class_names, first_category=0,
                           quality=95, subsampling=0)
    return train, CocoDataset(str(ann), str(root))


def protocol_config(cfg):
    """detjax's protocol-evaluation config for the gate
    (scripts/e2e_gate.py:964-988): 608/1024 canvases, pre-NMS top-k
    16,384, exact candidates."""
    import dataclasses

    return dataclasses.replace(
        cfg,
        data=dataclasses.replace(cfg.data, eval_scale_minmax=(608, 1024)),
        eval=dataclasses.replace(cfg.eval, pre_nms_top_k=16384,
                                 exact_candidates=True))


@contextlib.contextmanager
def deterministic():
    """cuDNN's deterministic algorithms and torch's deterministic mode
    (warn_only: an op without a deterministic version warns). The first
    line of each such warning goes into the yielded list, once; every
    other warning is shown as usual."""
    import warnings

    old = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled(),
           torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    refused: list = []
    with warnings.catch_warnings():
        warnings.filterwarnings("always", message=".*deterministic")
        show = warnings.showwarning

        def collect(message, category, filename, lineno, file=None,
                    line=None):
            first = str(message).split("\n")[0]
            if "deterministic" not in first:
                show(message, category, filename, lineno, file, line)
            elif first not in refused:
                refused.append(first)

        warnings.showwarning = collect
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        try:
            yield refused
        finally:
            torch.use_deterministic_algorithms(old[0], warn_only=old[1])
            torch.backends.cudnn.deterministic = old[2]
            torch.backends.cudnn.benchmark = old[3]


def state_tensors(train) -> dict:
    """Every tensor of a TrainState: the model's state_dict, the
    optimizer's moments and counts, and the EMA."""
    out = {f"model.{k}": v for k, v in train.model.state_dict().items()}
    for idx, st in train.optimizer.state_dict()["state"].items():
        for k, v in st.items():
            out[f"opt.{idx}.{k}"] = torch.as_tensor(v)
    for k, v in (train.ema or {}).items():
        out[f"ema.{k}"] = v
    return out


# the port's CUDA kernels by name (csrc/*.cu), and substrings of the
# names of cuDNN's and CUTLASS's convolution kernels
PORT_KERNEL_NAMES = (("match_kernel",) + NMS_KERNEL_NAMES + FWD_KERNEL_NAMES
                     + BWD_KERNEL_NAMES + ("decode_kernel", "pool_bwd"))
CONV_KERNEL_KEYS = ("conv", "xmma", "gemm", "cudnn", "cutlass", "winograd",
                    "implicit", "dgrad", "wgrad")


def device_ms_by_kind(prof) -> dict:
    """Device ms of a torch.profiler window's kernel and copy records by
    kind: the port's CUDA kernels, convolutions (cuDNN / CUTLASS), ATen's
    elementwise and reduction kernels (the plain BatchNorm, the optimizer,
    the losses), copies, and the rest."""
    out = dict.fromkeys(("port_kernels", "convolutions",
                         "elementwise_and_reductions", "copies", "other"),
                        0.0)
    for name, t in device_events(prof):
        low = name.lower()
        if name.startswith(("Memcpy", "Memset")):
            kind = "copies"
        elif any(k in name for k in PORT_KERNEL_NAMES):
            kind = "port_kernels"
        elif any(k in low for k in CONV_KERNEL_KEYS):
            kind = "convolutions"
        elif "elementwise" in low or "reduce" in low:
            kind = "elementwise_and_reductions"
        else:
            kind = "other"
        out[kind] += t
    return out


def top_device_ops(prof, n: int = 12) -> list:
    """The ``n`` device records (kernels, copies) with the most device
    time in a torch.profiler window."""
    ms: dict = {}
    calls: dict = {}
    for name, t in device_events(prof):
        ms[name] = ms.get(name, 0.0) + t
        calls[name] = calls.get(name, 0) + 1
    top = sorted(ms, key=ms.get, reverse=True)[:n]
    return [{"op": k[:100], "device_ms": ms[k], "calls": calls[k]}
            for k in top]


def fit_window(train, cfg, train_ds, steps: int, det: bool,
               trace_dir=None) -> dict:
    """``steps`` steps of fit in steady state, with the deterministic
    algorithms (``det``) or without: prefetch on (no calibration steps),
    no evaluation or save, after FIT_WARMUP_STEPS steps in the same mode
    (cuDNN chooses its algorithms anew), the loader's threads started and
    its queue filled before the clock starts. Host-clock ms a step; with
    ``trace_dir``, the window under trace_context with the device's
    activity alone: kernel and copy ms, the idle share, device ms by kind
    and the top device ops."""
    import dataclasses

    import detjax_torch
    from detjax_torch.data import make_train_iterator
    from detjax_torch.utils.profiling import trace_context

    wcfg = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, device_prefetch=True))
    mode = deterministic() if det else contextlib.nullcontext([])
    with mode as refused:
        for steps_now, timed in ((FIT_WARMUP_STEPS, False), (steps, True)):
            stream = iter(make_train_iterator(train_ds, wcfg).iter_from(
                train.step))
            batches = itertools.chain([next(stream)], stream)
            time.sleep(1.0)
            name = f"fit_window_{'deterministic' if det else 'default'}"
            ctx = (trace_context(name, str(trace_dir), host=False)
                   if timed and trace_dir else contextlib.nullcontext())
            with ctx as prof:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                detjax_torch.fit(wcfg, batches, train.step + steps_now,
                                 state=train, log_every=steps_now)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            stream.close()
    out = {"steps": steps, "deterministic": det,
           "ms_per_step": wall_ms / steps, "refused": refused}
    if trace_dir:
        out.update(busy_and_idle(prof, wall_ms))
        out["kernel_ms_per_step"] = out["kernel_busy_ms"] / steps
        out["device_ms_by_kind"] = device_ms_by_kind(prof)
        out["top_device_ops"] = top_device_ops(prof)
    return out


def phase_fit(report: dict, state: dict) -> None:
    """detjax_torch.fit on detjax's mid-gate recipe at full width (R50-640,
    12 classes, batch-statistics BatchNorm, bs 8, bf16, random crop, hflip
    0.5, lr 5e-4) with fused_backbone="on", which with batch statistics
    fuses only in evaluation (detjax's rule): FIT_STEPS steps over the
    recipe's 256 scenes from make_train_iterator, a checkpoint every
    FIT_CKPT_EVERY steps, a periodic evaluate every FIT_EVAL_EVERY steps
    over the 24 held-out JPEGs, under cuDNN's deterministic algorithms.
    Checks: one matching launch a step, one NMS launch and 5 fused
    forwards an eval batch, no fused launch in training, the loss falls,
    the running statistics move, a resume from step FIT_RESUME_FROM
    equals the straight run bit for bit (if an op has no deterministic
    version, it is named and each tensor's difference is held within
    FIT_RESUME_BAR of its change since the resume). Reports the run's
    img/s (its evaluations and saves included), peak memory, the
    synchronous and the background time of a save; then, in steady state
    (fit_window), ms a step with the deterministic algorithms and
    without, in turns, and, from trace_context over a window of
    FIT_TRACE_STEPS steps in each mode with the device's activity alone,
    kernel ms a step, the device's idle share and its top kernels. Then
    FIT_FROZEN_STEPS steps of
    the default preset (bs 16, frozen BN) with "on" through fit: 5 fused
    forwards (10 CUDA kernels) and 5 fused backwards (25) a step."""
    import shutil
    import tempfile

    import detjax_torch
    from detjax_torch.data import make_train_iterator
    from detjax_torch.kernels import bottleneck as kb
    from detjax_torch.kernels import matching as km
    from detjax_torch.kernels import postprocess as pp
    from detjax_torch.train.checkpoint import Checkpointer

    tmp = tempfile.TemporaryDirectory(prefix="detjax_fit_")
    root = Path(tmp.name)
    (root / "mid_val").mkdir()
    train_ds, held = mid_gate_data(root / "mid_val")
    cfg = mid_gate_config(**{
        "model.fused_backbone": "on",
        "train.checkpoint_every_steps": FIT_CKPT_EVERY,
        "train.eval_every_steps": FIT_EVAL_EVERY})
    eval_batches = -(-len(held) // cfg.eval.batch_size)
    n_evals = FIT_STEPS // FIT_EVAL_EVERY

    def run(train, steps, ckpt_dir, **kw):
        return detjax_torch.fit(
            cfg, make_train_iterator(train_ds, cfg), steps, state=train,
            eval_dataset=held, checkpoint_dir=str(ckpt_dir),
            log_every=FIT_LOG_EVERY, **kw)

    train = detjax_torch.make_train_state(cfg, seed=0)
    stats0 = train.model.bn1.running_mean.clone()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    km.match_launches = pp.nms_launches = kb.bottleneck_launches = 0
    t0 = time.perf_counter()
    with deterministic() as refused:
        res = run(train, FIT_STEPS, root / "ck", log_dir=str(root / "log"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {"match": km.match_launches, "nms": pp.nms_launches,
                  "fused": kb.bottleneck_launches}
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        straight = {k: v.clone() for k, v in state_tensors(train).items()}
        moved = not torch.equal(train.model.bn1.running_mean, stats0)
        # the resume: a fresh state from another seed, fed the checkpoint
        # of step FIT_RESUME_FROM alone
        (root / "resume").mkdir()
        shutil.copytree(root / "ck" / str(FIT_RESUME_FROM),
                        root / "resume" / str(FIT_RESUME_FROM))
        again = detjax_torch.make_train_state(cfg, seed=1)
        km.match_launches = 0
        resumed = run(again, FIT_STEPS, root / "resume")
        resume_launches = km.match_launches
    got = state_tensors(again)
    diffs = {k: float((got[k].double() - v.double()).abs().max())
             for k, v in straight.items() if not torch.equal(got[k], v)}
    # each differing tensor's difference as a share of its change since
    # the resume (the checkpoint of step FIT_RESUME_FROM, read back)
    del again, resumed
    base = Checkpointer(str(root / "ck")).restore(
        detjax_torch.make_train_state(cfg, seed=2), step=FIT_RESUME_FROM)
    at_resume = state_tensors(base)
    shares = {}
    for k in diffs:
        change = float((straight[k].double()
                        - at_resume[k].double()).abs().max())
        shares[k] = diffs[k] / change if change > 0 else float("inf")
    del base, at_resume
    losses = [h["loss"] for h in res.history if "loss" in h]
    evals = [h["eval"] for h in res.history if "eval" in h]

    ck = Checkpointer(str(root / "timing"))
    t0 = time.perf_counter()
    ck.save(train)
    save_sync_s = time.perf_counter() - t0
    ck.wait()
    save_background_s = time.perf_counter() - t0 - save_sync_s
    ckpt_mib = sum(f.stat().st_size for f in (root / "timing").rglob("*")
                   if f.is_file()) / 2**20

    # steady-state windows, no evaluation or save inside: timed ones
    # with the deterministic algorithms and without, in turns, then one
    # traced window of each (device activity only, so that the host runs
    # at its own pace)
    windows: dict = {"deterministic": [], "default": []}
    for det in (True, False, True, False):
        w = fit_window(train, cfg, train_ds, FIT_WINDOW_STEPS, det)
        windows["deterministic" if det else "default"].append(
            w["ms_per_step"])
    traced = {("deterministic" if det else "default"): fit_window(
        train, cfg, train_ds, FIT_TRACE_STEPS, det, root / "trace")
        for det in (True, False)}
    del train
    torch.cuda.empty_cache()

    frozen = phase_fit_frozen(train_ds)
    tmp.cleanup()
    emit({"phase": "fit", "preset": cfg.model.name, "recipe":
          "scripts/e2e_gate.py:1087-1097 with model.fused_backbone=on",
          "batch": cfg.train.batch_size, "dtype": cfg.model.dtype,
          "steps": FIT_STEPS, "wall_s": wall,
          "img_per_s_with_evals_and_saves": res.images_per_sec,
          "ms_per_step_with_evals_and_saves":
              cfg.train.batch_size / res.images_per_sec * 1e3,
          "deterministic": True, "peak_gib": peak_gib,
          "window_ms_per_step": windows, "window_steps": FIT_WINDOW_STEPS,
          "logged_losses": losses, "evals": evals,
          "launches": counts, "eval_batches": eval_batches * n_evals,
          "running_stats_moved": moved,
          "resume_from": FIT_RESUME_FROM, "resume_bit_equal": not diffs,
          "resume_tensors_off": len(diffs),
          "resume_max_abs_diff": max(diffs.values(), default=0.0),
          "resume_max_share_of_change": max(shares.values(), default=0.0),
          "resume_match_launches": resume_launches,
          "ops_without_a_deterministic_version": refused,
          "save_sync_s": save_sync_s, "save_background_s": save_background_s,
          "checkpoint_mib": ckpt_mib, "trace_windows": traced,
          "frozen_on": frozen, "card": state["card"]})
    if counts["match"] != FIT_STEPS:
        raise SystemExit(f"fit made {counts['match']} matching launches in "
                         f"{FIT_STEPS} steps")
    if counts["nms"] != eval_batches * n_evals:
        raise SystemExit(f"fit's evaluations made {counts['nms']} NMS "
                         f"launches over {eval_batches * n_evals} batches")
    if counts["fused"] != 5 * eval_batches * n_evals:
        raise SystemExit(f"{counts['fused']} fused forwards in fit: "
                         f"expected none in its batch-statistics training "
                         f"and 5 in each of its {eval_batches * n_evals} "
                         f"eval batches")
    if len(evals) != n_evals or any(len(e) != 12 for e in evals):
        raise SystemExit(f"fit recorded evaluations {evals}")
    if not (np.isfinite(losses).all()
            and np.mean(losses[-2:]) < np.mean(losses[:2])):
        raise SystemExit(f"the fit loss does not fall: {losses}")
    if not moved:
        raise SystemExit("the running statistics did not move in fit")
    if resume_launches != FIT_STEPS - FIT_RESUME_FROM:
        raise SystemExit(f"the resumed fit made {resume_launches} matching "
                         f"launches")
    if diffs and not refused:
        raise SystemExit(f"the resume from step {FIT_RESUME_FROM} differs "
                         f"from the straight run in {len(diffs)} tensors "
                         f"though every op ran deterministically")
    worst = max(shares, key=shares.get, default=None)
    if worst is not None and shares[worst] > FIT_RESUME_BAR:
        raise SystemExit(f"the resume from step {FIT_RESUME_FROM} differs "
                         f"from the straight run in {worst} by "
                         f"{shares[worst]:.3g} of its change since the "
                         f"resume (bar {FIT_RESUME_BAR}); ops without a "
                         f"deterministic version: {refused}")
    report["match_iou_cuda"]["fit_launches"] = counts["match"]
    report["nms_cuda"]["fit_eval_launches"] = counts["nms"]
    report["bottleneck_identity_cuda"]["fit_launches"] = counts["fused"]
    report["bottleneck_identity_cuda"]["fit_frozen_on_launches"] = frozen[
        "launches"]["fwd_calls"]
    report["bottleneck_identity_bwd_cuda"]["fit_frozen_on_launches"] = \
        frozen["launches"]["bwd_calls"]


def phase_fit_frozen(train_ds) -> dict:
    """FIT_FROZEN_STEPS steps of retinanet_r50_640 (bs 16, frozen BN,
    bf16) with fused_backbone="on" through fit, on the mid-gate scenes:
    5 fused forward calls (10 CUDA kernels) and 5 fused backward calls (25
    CUDA kernels) a step."""
    import detjax_torch
    from detjax_torch.data import make_train_iterator
    from detjax_torch.kernels import bottleneck as kb

    cfg = smoke_config(**{"model.fused_backbone": "on",
                          "train.checkpoint_every_steps": 10**9,
                          "train.eval_every_steps": 10**9})
    train = detjax_torch.make_train_state(cfg, seed=0)
    it = make_train_iterator(train_ds, cfg)
    first = next(iter(it))
    scales = desaturate_(train.model, first["images"][:4], cfg)
    torch.cuda.synchronize()
    kb.bottleneck_launches = kb.bottleneck_kernel_launches = 0
    kb.bottleneck_bwd_launches = kb.bottleneck_bwd_kernel_launches = 0
    res = detjax_torch.fit(cfg, make_train_iterator(train_ds, cfg),
                           FIT_FROZEN_STEPS, state=train, log_every=5)
    torch.cuda.synchronize()
    n = FIT_FROZEN_STEPS
    launches = {"fwd_calls": kb.bottleneck_launches,
                "fwd_cuda_kernels": kb.bottleneck_kernel_launches,
                "bwd_calls": kb.bottleneck_bwd_launches,
                "bwd_cuda_kernels": kb.bottleneck_bwd_kernel_launches}
    want = {"fwd_calls": 5 * n, "fwd_cuda_kernels": 10 * n,
            "bwd_calls": 5 * n, "bwd_cuda_kernels": 25 * n}
    losses = [h["loss"] for h in res.history]
    if launches != want or not np.isfinite(losses).all():
        raise SystemExit(f'fit with "on" and frozen BN: launches '
                         f"{launches}, expected {want}; losses {losses}")
    return {"preset": cfg.model.name, "batch": cfg.train.batch_size,
            "steps": n, "launches": launches, "output_scales": scales,
            "img_per_s": res.images_per_sec, "logged_losses": losses}


def mid_gate(steps: int) -> int:
    """detjax's mid gate on the card: fit the recipe (fused_backbone
    "off", as detjax's) for ``steps`` steps, then the train-set AP50
    through ``evaluate`` (detjax's floor: > 0.15,
    scripts/e2e_gate.py:1118) and the held-out AP through
    run_coco_eval_protocol with detjax's protocol config (its check: 0.05
    < AP < 0.95, scripts/e2e_gate.py:1138), beside detjax's recorded bf16
    AP. Not called by main; run as
    ``python3 -c "import chip_smoke as cs; cs.mid_gate(6000)"``."""
    import tempfile

    import detjax_torch
    from detjax_torch.data import make_train_iterator
    from detjax_torch.evaluation.protocol import run_coco_eval_protocol

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    card = print_card()
    with tempfile.TemporaryDirectory(prefix="detjax_mid_gate_") as tmp:
        train_ds, held = mid_gate_data(Path(tmp))
        cfg = mid_gate_config(**{"train.checkpoint_every_steps": 10**9,
                                 "train.eval_every_steps": 10**9})
        t0 = time.perf_counter()
        res = detjax_torch.fit(cfg, make_train_iterator(train_ds, cfg),
                               steps, log_every=max(steps // 6, 1))
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        model = res.state.model
        t0 = time.perf_counter()
        train_stats = detjax_torch.evaluate(model, train_ds, cfg).stats
        held_stats = run_coco_eval_protocol(model, held,
                                            protocol_config(cfg)).stats
        eval_s = time.perf_counter() - t0
    emit({"phase": "mid_gate", "preset": cfg.model.name, "steps": steps,
          "batch": cfg.train.batch_size, "fit_s": fit_s,
          "img_per_s": res.images_per_sec, "eval_s": eval_s,
          "logged_losses": [h["loss"] for h in res.history],
          "train_stats": train_stats, "held_out_stats": held_stats,
          "detjax_bf16_held_out_AP": MID_GATE_AP,
          "gap": held_stats["AP"] - MID_GATE_AP, "card": card})
    ok = train_stats["AP50"] > 0.15 and 0.05 < held_stats["AP"] < 0.95
    print(json.dumps({"mid_gate_passed": ok}), flush=True)
    return 0 if ok else 1


# -- other presets: ssd_512 (benchmark config 2), retinanet_r101_fpn (4) ----

FAMILY_TRAIN_STEPS = 10  # steps of each new preset's main training path
MULTISCALE = ((512, 512), (640, 640))
MULTISCALE_STEPS = 8  # four at each resolution
SSD_GATE_AP50 = 0.5  # detjax's floor (scripts/e2e_gate.py:287)
R101_GATE_AP50 = 0.5  # at both resolutions (scripts/e2e_gate.py:475)


def match_at(anchors, boxes, labels, b: int, g: int) -> dict:
    """match_iou_cuda on the main path's anchors and augmented GT, against
    its twin: device ms, plain ms and the bound from the pairs left after
    culling (as match_kernel)."""
    from detjax_torch.kernels import matching as km

    valid = labels >= 0
    args = (anchors, boxes, valid, labels)
    got, want = km.match_iou_cuda(*args), km.match_iou_reference(*args)
    equal = all(torch.equal(x, y) for x, y in zip(got, want))
    a = anchors.shape[0]
    pairs = match_listed_pairs(anchors, boxes, valid, km.ANCHORS_PER_BLOCK)
    bound_ms, bound_by = match_bound_ms(b, a, g, pairs)
    return {"B": b, "A": a, "G": g, "bit_equal": equal,
            "ms": device_ms(lambda: km.match_iou_cuda(*args), iters=100),
            "ms_by": "device_ms",
            "plain_ms": cuda_ms(lambda: km.match_iou_reference(*args),
                                iters=5, warmup=1),
            "pairs_divided": pairs, "bound_ms": bound_ms,
            "bound_by": bound_by,
            "max_abs_err": float((got[0] - want[0]).abs().max())}


RESIDUAL_SCALE = 0.2  # each block's last BatchNorm scale in detect_cell


def damp_residuals_(model, scale: float = RESIDUAL_SCALE) -> None:
    """Scale every bottleneck's last BatchNorm (``bn3``) by ``scale``, as
    a trained ResNet's are small. At detjax's identity-BatchNorm init the
    residual sums grow with depth until one common component dominates
    the features: the logits of neighbouring anchors then tie within a
    few bf16 steps, and main_fused's clear kept pairs vanish (R101: 0 of
    800; SSD-512, whose predictors read the FPN directly: 25 of 800).
    Damped: 29 and 75 of 200 (bs 2, the twin route on the CPU)."""
    from detjax_torch.models.resnet import Bottleneck

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, Bottleneck):
                m.bn3.weight.mul_(scale)


def detect_cell(name: str, cfg, canvases, state: dict) -> dict:
    """``detect_u8`` at full width on a seeded model of ``cfg``, its
    residual branches damped (damp_residuals_) and its output convs
    desaturated: "off" through the NMS kernel against the twin route (bit-equal,
    one NMS launch a batch, by the launcher and by torch.profiler's device
    records), the NMS kernel on the real candidates against
    its twin with its bound, ms a batch, img/s and the device's busy ms
    and idle share over one call; then "on" on the same weights (5 fused
    calls, 10 CUDA kernels a batch) held to its twin route by main_fused's
    bars. Returns the model, its detections and the rows."""
    import dataclasses

    import detjax_torch
    from detjax_torch.kernels import bottleneck as kb
    from detjax_torch.kernels import postprocess as pp
    from detjax_torch.modeling import _anchors, anchor_config
    from detjax_torch.ops import nms as ops_nms

    b, e = cfg.eval.batch_size, cfg.eval
    model = detjax_torch.build_model(cfg, seed=0)
    damp_residuals_(model)
    scales = desaturate_(model, canvases, cfg)
    detjax_torch.detect_u8(model, canvases, cfg)  # warm-up
    torch.cuda.synchronize()
    pp.nms_launches = pp.nms_kernel_launches = 0
    det = detjax_torch.detect_u8(model, canvases, cfg)
    torch.cuda.synchronize()
    launches, nms_kernels = pp.nms_launches, pp.nms_kernel_launches
    twin = detjax_torch.detect_u8(model, canvases, cfg, nms_backend="torch")
    identical = same_detections(det, twin)
    with torch.inference_mode():
        x = normalized_nchw(model, canvases, cfg)
        cls, box = model(x)
        anchors = _anchors(cfg.model.image_size, anchor_config(cfg),
                           x.device)
        cand = ops_nms._select_candidates(
            box.float(), anchors, cls, cfg.model.box_std,
            cfg.model.image_size, e.score_threshold, e.pre_nms_top_k,
            e.exact_candidates, True)
        live_cands = (cand[1] > ops_nms.NEG_INF / 2).sum(dim=1)
        nms_args = (cand[0], cand[1], cand[2].to(torch.int32),
                    e.nms_iou_threshold, e.max_detections,
                    float(max(cfg.model.image_size) + 2))
        fwd_ms = cuda_ms(lambda: model(x), iters=10)
    nms = nms_case(name, nms_args, iters=200, priors=())
    traced = kernel_launches_traced(
        lambda: detjax_torch.detect_u8(model, canvases, cfg),
        {"nms_kernel": 1.0}, f"{name} detect_u8")
    batch_ms = host_ms(model, cfg, canvases)
    busy = profiled_wall(lambda: detjax_torch.detect_u8(model, canvases,
                                                        cfg))
    off = {"preset": cfg.model.name, "depth": cfg.model.backbone_depth,
           "family": cfg.model.family, "dtype": cfg.model.dtype,
           "batch": b, "canvas": list(cfg.model.image_size),
           "anchors": int(anchors.shape[0]),
           "anchors_per_cell": cfg.model.num_anchors_per_cell,
           "residual_scale": RESIDUAL_SCALE, "output_scales": scales,
           "live_candidates_per_image": live_cands.tolist(),
           "num_valid": det.num_valid.tolist(),
           "nms_launches": launches, "nms_cuda_kernels": nms_kernels,
           "profiler_launches_a_batch": traced,
           "identical_to_twin_route": identical,
           "ms_per_batch": batch_ms, "img_per_s": b / batch_ms * 1e3,
           "forward_ms": fwd_ms, "device_one_call": busy,
           "nms_kernel": {k: nms[k] for k in (
               "N", "ms", "call_ms", "bound_ms", "bound_by", "pairs_needed",
               "kept_per_row", "max_abs_err", "ms_by_kernel")}}
    emit({"phase": name, "fused_backbone": "off", **off,
          "tolerance": "keep-sets, scores and boxes bit-equal",
          "card": state["card"]})
    if not (all(bool(torch.isfinite(t.float()).all()) for t in det)
            and tuple(det.boxes.shape) == (b, e.max_detections, 4)):
        raise SystemExit(f"{name}: detect_u8 returned non-finite or "
                         f"misshapen output")
    if (launches != 1 or nms_kernels != len(NMS_KERNEL_NAMES)
            or traced != {"nms_kernel": 1.0}):
        raise SystemExit(f"{name}: {launches} NMS calls ({nms_kernels} CUDA "
                         f"kernels; the profiler's count {traced}) a batch, "
                         f"expected 1")
    if not identical:
        raise SystemExit(f"{name}: detect_u8 through the kernel differs from "
                         f"the twin route")
    if int(live_cands.min()) == 0 or int(det.num_valid.min()) == 0:
        raise SystemExit(f"{name}: no live candidates")

    on_cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, fused_backbone="on"))
    on_model = detjax_torch.build_model(on_cfg, seed=0)
    on_model.load_state_dict(model.state_dict())
    detjax_torch.detect_u8(on_model, canvases, on_cfg)  # warm-up
    torch.cuda.synchronize()
    kb.bottleneck_launches = kb.bottleneck_kernel_launches = 0
    pp.nms_launches = 0
    det_on = detjax_torch.detect_u8(on_model, canvases, on_cfg)
    torch.cuda.synchronize()
    fused_calls, fused_kernels = (kb.bottleneck_launches,
                                  kb.bottleneck_kernel_launches)
    on_nms = pp.nms_launches
    want_traced = {"nms_kernel": 1.0, **{k: 5.0 for k in FWD_KERNEL_NAMES}}
    on_traced = kernel_launches_traced(
        lambda: detjax_torch.detect_u8(on_model, canvases, on_cfg),
        want_traced, f"{name}_fused detect_u8")
    with torch.inference_mode():
        outs = on_model(x)
    check = fused_against_twin(on_model, on_cfg, canvases, x, det_on, outs,
                               {"unfused_path": det})
    on_ms = host_ms(on_model, on_cfg, canvases)
    on = {"fused_blocks": len(on_model.fused_blocks()),
          "bottleneck_launches": fused_calls,
          "bottleneck_cuda_kernels": fused_kernels, "nms_launches": on_nms,
          "profiler_launches_a_batch": on_traced,
          "outputs_vs_twin_route": check["errs"],
          "twin_pairs_found_by_margin": check["pairs"],
          "num_valid": det_on.num_valid.tolist(),
          "ms_per_batch": on_ms, "img_per_s": b / on_ms * 1e3}
    emit({"phase": f"{name}_fused", "fused_backbone": "on", **on,
          "tolerance": "main_fused's: logits and deltas within 0.05 x "
                       "max|twin|; >= 95 % of the twin route's clear kept "
                       "pairs found", "card": state["card"]})
    del on_model
    undamped = undamped_on_vs_twin(on_cfg, canvases)
    emit({"phase": f"{name}_fused_undamped", "fused_backbone": "on",
          "outputs_vs_twin_route": undamped,
          "tolerance": "logits and deltas within 0.05 x max|twin|, on the "
                       "seeded weights without damp_residuals_",
          "card": state["card"]})
    if not all(e["finite"] and e["max_abs_err"] <= e["tolerance"]
               for e in undamped.values()):
        raise SystemExit(f"{name}_fused on undamped weights: the kernel "
                         f"route's outputs differ from the twin route's: "
                         f"{undamped}")
    if ((fused_calls, fused_kernels, on_nms) != (5, kb.FWD_KERNELS * 5, 1)
            or on_traced != want_traced):
        raise SystemExit(f"{name}_fused: {fused_calls} fused calls "
                         f"({fused_kernels} CUDA kernels) and {on_nms} NMS "
                         f"launches a batch, expected 5 (10) and 1; the "
                         f"profiler's count {on_traced}")
    check_fused_bars(check)
    return {"model": model, "det": det, "off": off, "on": on, "nms": nms}


def undamped_on_vs_twin(on_cfg, canvases) -> dict:
    """"on" at ``on_cfg`` on the seeded weights without damp_residuals_
    (desaturated only): the kernel route's logits and deltas against the
    twin route's (``bottleneck_backend="torch"``, TF32 off) within
    main_fused's 0.05 x max|twin|, a bar that needs no clear kept pairs
    (undamped, R101 and SSD-512 have too few for the pairs' bar)."""
    import detjax_torch

    model = detjax_torch.build_model(on_cfg, seed=0)
    desaturate_(model, canvases, on_cfg)
    x = normalized_nchw(model, canvases, on_cfg)
    with torch.inference_mode():
        outs = model(x)
    model.bottleneck_backend = "torch"
    with tf32_off(), torch.inference_mode():
        twin = model(x)
    errs = {}
    for key, got, want in (("cls", outs[0], twin[0]),
                           ("box", outs[1], twin[1])):
        g, w = got.float(), want.float()
        errs[key] = {"max_abs_err": float((g - w).abs().max()),
                     "tolerance": 0.05 * float(w.abs().max()),
                     "finite": bool(torch.isfinite(g).all())}
    del model
    return errs


def train_cell(name: str, preset: str, state: dict, traced: bool) -> dict:
    """``preset`` at full width through make_train_state / train_step, its
    default batch (16), bf16, frozen BatchNorm: the kernel route against
    the twin route from one state and one batch (MatchResults identical,
    step-1 loss within 1e-6 relative), then FAMILY_TRAIN_STEPS steps of
    the main path with one matching launch a step (the launcher's count;
    torch.profiler's over one more step), ms a step (after 2),
    peak memory; matching on this batch against its twin, timed, with its
    bound; with ``traced``, the idle share of a 3-step profiler window."""
    import detjax_torch
    from detjax_torch.data.pipeline import device_augment
    from detjax_torch.kernels import matching as km
    from detjax_torch.modeling import _anchors, anchor_config
    from detjax_torch.ops.matching import match_anchors
    from detjax_torch.train import step as tstep

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    train = detjax_torch.make_train_state(preset, seed=0)
    cfg = train.cfg
    b = cfg.train.batch_size
    batch = train_batch(cfg, seed=0)
    scales = desaturate_(train.model, batch["images"][:4], cfg)
    twin = copy.deepcopy(train)
    dev = next(train.model.parameters()).device
    _, gt_aug = device_augment(
        torch.as_tensor(batch["images"]).to(dev),
        torch.as_tensor(batch["gt_boxes"]).to(dev),
        flip=tstep.flip_mask(cfg, 0, b), hflip_prob=0.0,
        mean=cfg.data.mean, std=cfg.data.std)
    anchors = _anchors(cfg.model.image_size, anchor_config(cfg), dev)
    labels = torch.as_tensor(batch["gt_labels"]).to(dev)
    m_kernel = match_anchors(anchors, gt_aug, labels, backend="auto")
    m_twin = match_anchors(anchors, gt_aug, labels, backend="torch")
    match_equal = {f: torch.equal(getattr(m_kernel, f), getattr(m_twin, f))
                   for f in m_kernel._fields}
    _, mk = detjax_torch.train_step(train, batch)
    _, mt = detjax_torch.train_step(twin, batch, match_backend="torch")
    loss_k, loss_t = float(mk["loss"]), float(mt["loss"])
    del twin
    kernel = match_at(anchors, gt_aug, labels, b, cfg.train.max_gt)

    torch.cuda.synchronize()
    km.match_launches = km.match_kernel_launches = 0
    steps, t0 = [], None
    for i in range(FAMILY_TRAIN_STEPS):
        if i == 2:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        steps.append(detjax_torch.train_step(train, batch)[1])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / (FAMILY_TRAIN_STEPS - 2) * 1e3
    launches, kernels = km.match_launches, km.match_kernel_launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    traced_match = kernel_launches_traced(
        lambda: detjax_torch.train_step(train, batch), {"match_kernel": 1.0},
        f"{name} train_step")
    window = (profiled_wall(lambda: [detjax_torch.train_step(train, batch)
                                     for _ in range(3)])
              if traced else None)
    per_step = [{k: float(v) for k, v in m.items()} for m in steps]
    row = {"preset": cfg.model.name, "depth": cfg.model.backbone_depth,
           "family": cfg.model.family, "dtype": cfg.model.dtype,
           "batch": b, "canvas": list(cfg.model.image_size),
           "anchors": int(anchors.shape[0]), "max_gt": cfg.train.max_gt,
           "output_scales": scales, "match_result_equal": match_equal,
           "loss_kernel_route": loss_k, "loss_twin_route": loss_t,
           "steps": len(steps), "match_launches": launches,
           "match_cuda_kernels": kernels,
           "profiler_match_launches_a_step": traced_match,
           "losses": [m["loss"] for m in per_step],
           "num_pos": [m["num_pos"] for m in per_step],
           "ms_per_step": step_ms, "img_per_s": b / step_ms * 1e3,
           "peak_memory_gib": peak, "traced_3_steps": window,
           "match_kernel": kernel}
    emit({"phase": name, **row, "tolerance": "MatchResults identical; "
          "step-1 loss within 1e-6 relative; matching bit-equal to its "
          "twin", "card": state["card"]})
    if not all(match_equal.values()) or not kernel["bit_equal"]:
        raise SystemExit(f"{name}: kernel and twin MatchResults differ: "
                         f"{match_equal}")
    if abs(loss_k - loss_t) > 1e-6 * abs(loss_t):
        raise SystemExit(f"{name}: step-1 loss differs between the routes: "
                         f"{loss_k} vs {loss_t}")
    if not all(np.isfinite(list(m.values())).all() for m in per_step):
        raise SystemExit(f"{name}: a training metric is not finite")
    if min(m["num_pos"] for m in per_step) <= 0:
        raise SystemExit(f"{name}: a step had no positive anchor")
    if (launches != len(steps) or kernels != launches
            or traced_match != {"match_kernel": 1.0}):
        raise SystemExit(f"{name}: the match kernel launched {launches} "
                         f"times ({kernels} CUDA kernels) in {len(steps)} "
                         f"steps; the profiler's count a step "
                         f"{traced_match}")
    del train
    return row


def ssd_gate_config(**extra):
    """detjax's SSD gate recipe (scripts/e2e_gate.py:269-282): ssd_512,
    12 classes, batch-statistics BatchNorm, bs 8, max_gt 8, lr 1e-3
    constant, no flip, no crop, eval batch 8."""
    import detjax_torch

    return detjax_torch.get_config("ssd_512", **{
        "model.num_classes": 12, "model.frozen_backbone_bn": False,
        "train.batch_size": 8, "train.max_gt": 8,
        "train.learning_rate": 1e-3, "train.lr_schedule": "constant",
        "data.hflip_prob": 0.0, "data.random_crop": False,
        "eval.batch_size": 8, **extra})


def ssd_gate_data():
    """The gate's 8 scenes at 512 (seed 11), its train and eval set."""
    from detjax_torch.data.synthetic import SyntheticDetectionDataset

    return SyntheticDetectionDataset(num_images=8, image_size=(512, 512),
                                     num_classes=12, max_objects=3, seed=11,
                                     size_range=(0.15, 0.5))


def r101_multiscale_config(**extra):
    """detjax's R101 multi-scale gate recipe (scripts/e2e_gate.py:434-447):
    retinanet_r101_fpn, 12 classes, batch-statistics BatchNorm, bs 8,
    max_gt 8, lr 1e-3 constant, hflip 0.5, no crop, eval batch 8."""
    import detjax_torch

    return detjax_torch.get_config("retinanet_r101_fpn", **{
        "model.num_classes": 12, "model.frozen_backbone_bn": False,
        "train.batch_size": 8, "train.max_gt": 8,
        "train.learning_rate": 1e-3, "train.lr_schedule": "constant",
        "data.hflip_prob": 0.5, "data.random_crop": False,
        "eval.batch_size": 8, **extra})


def r101_multiscale_data():
    """The gate's 12 scenes at 640 (seed 13)."""
    from detjax_torch.data.synthetic import SyntheticDetectionDataset

    return SyntheticDetectionDataset(num_images=12, image_size=(640, 640),
                                     num_classes=12, max_objects=4, seed=13,
                                     size_range=(0.08, 0.4))


def phase_ssd(report: dict, state: dict) -> None:
    """ssd_512 (benchmark config 2) at full width, bf16, seeded weights
    with every level's output pair rescaled (desaturate_): detect_cell at
    eval batch 8 on 512x512 canvases ("off" and "on"); the int8 engine
    calibrated on those canvases (one NMS launch a batch); a u8 detect
    program loaded and run in a fresh process (one NMS launch, bit-equal
    to detect_u8); then train_cell at bs 16 (A = 32,736 through the
    matching kernel)."""
    import tempfile

    import detjax_torch
    from detjax_torch.data.pipeline import normalize_u8
    from detjax_torch.export import save_detect
    from detjax_torch.kernels import postprocess as pp
    from detjax_torch.ops.nms import Detections

    cfg = detjax_torch.get_config("ssd_512",
                                  **{"model.prior_prob": PRIOR_PROB})
    b = cfg.eval.batch_size
    canvases = seeded_canvases(1, b, cfg.model.image_size)
    cell = detect_cell("ssd", cfg, canvases, state)
    model = cell["model"]

    t0 = time.perf_counter()
    qtree = detjax_torch.quantize_model(model, cfg, normalize_u8(
        torch.as_tensor(canvases).to(next(model.parameters()).device),
        cfg.data.mean, cfg.data.std))
    calib_s = time.perf_counter() - t0
    detjax_torch.detect_int8_u8(qtree, canvases, cfg)  # warm-up
    torch.cuda.synchronize()
    pp.nms_launches = 0
    det8 = detjax_torch.detect_int8_u8(qtree, canvases, cfg)
    torch.cuda.synchronize()
    int8_nms = pp.nms_launches
    int8_ms = cuda_ms(lambda: detjax_torch.detect_int8_u8(qtree, canvases,
                                                          cfg), iters=10)
    del qtree

    tmp = tempfile.TemporaryDirectory(prefix="detjax_ssd_")
    root = Path(tmp.name)
    np.save(root / "canvases.npy", canvases)
    path = root / "detect_ssd.pt2"
    t0 = time.perf_counter()
    save_detect(str(path), model, cfg, batch_size=b, input_format="u8")
    export_s = time.perf_counter() - t0
    proc = subprocess.run(
        [sys.executable, "-c", ARTIFACT_LOADER, str(path),
         str(root / "canvases.npy"), str(root / "det.pt")],
        capture_output=True, text=True, timeout=600,
        cwd=str(Path(__file__).resolve().parent))
    if proc.returncode != 0:
        emit({"phase": "ssd_export", "loader_stderr": proc.stderr[-3000:]})
        raise SystemExit("the SSD program did not load and run in a fresh "
                         "process")
    sub = json.loads(proc.stdout.strip().splitlines()[-1])
    got = Detections(*torch.load(root / "det.pt"))
    cmp = within_detect_bars(got, type(cell["det"])(
        *(t.cpu() for t in cell["det"])))
    tmp.cleanup()
    emit({"phase": "ssd_engines", "int8_calibration_s": calib_s,
          "int8_nms_launches": int8_nms, "int8_ms_per_batch": int8_ms,
          "int8_ms_by": "CUDA events",
          "int8_num_valid": det8.num_valid.tolist(),
          "program_export_and_save_s": export_s,
          "program": {**sub, **cmp}, "card": state["card"],
          "tolerance": "the program bit-equal to detect_u8; one NMS launch "
                       "a batch through each engine"})
    if int8_nms != 1 or not all(bool(torch.isfinite(t.float()).all())
                                for t in det8):
        raise SystemExit(f"ssd int8 engine: {int8_nms} NMS launches a "
                         f"batch, or non-finite detections")
    if not cmp["bit_equal"] or sub["nms_launches"] != 1 or sub["loaded"]:
        raise SystemExit(f"ssd program: {cmp}, {sub['nms_launches']} NMS "
                         f"launches, imported {sub['loaded']}")
    del model, cell["model"]
    train = train_cell("ssd_train", "ssd_512", state, traced=False)
    report["nms_cuda"]["launches_ssd"] = cell["off"]["nms_launches"]
    report["nms_cuda"]["ssd_512_candidates"] = cell["off"]["nms_kernel"]
    report["match_iou_cuda"]["launches_ssd_train"] = train["match_launches"]
    report["match_iou_cuda"]["ssd_512_train"] = train["match_kernel"]
    report["bottleneck_identity_cuda"]["launches_ssd"] = cell["on"][
        "bottleneck_launches"]
    state["ssd"] = {"detect": cell["off"], "fused": cell["on"],
                    "train": train}


def multiscale_cell(state: dict) -> dict:
    """MULTISCALE_STEPS steps of detjax's R101 gate recipe (batch-statistics
    BatchNorm, bs 8) through train/multiscale.py: the seeded round-robin
    over 512 and 640 fed by make_train_iterator, one shared TrainState;
    one matching launch a step; ms a step by resolution (after each one's
    first step), peak memory."""
    import detjax_torch
    from detjax_torch.kernels import matching as km
    from detjax_torch.train.multiscale import (MultiScaleIterator,
                                               make_multiscale_train_step)

    cfg = r101_multiscale_config()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    train = detjax_torch.make_train_state(cfg, seed=0)
    step = make_multiscale_train_step(cfg, MULTISCALE)
    it = iter(MultiScaleIterator(r101_multiscale_data(), cfg, MULTISCALE,
                                 seed=0))
    km.match_launches = km.match_kernel_launches = 0
    ms_by_hw, losses = {}, []
    for _ in range(MULTISCALE_STEPS):
        batch = next(it)
        hw = "x".join(map(str, batch["images"].shape[1:3]))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, m = step(train, batch)
        losses.append(float(m["loss"]))
        ms_by_hw.setdefault(hw, []).append(
            (time.perf_counter() - t0) * 1e3)
    row = {"preset": cfg.model.name, "scales": [list(s) for s in MULTISCALE],
           "batch": cfg.train.batch_size, "frozen_backbone_bn": False,
           "steps": MULTISCALE_STEPS, "steps_by_resolution": {
               k: len(v) for k, v in ms_by_hw.items()},
           "ms_per_step_by_resolution": {
               k: float(np.median(v[1:])) for k, v in ms_by_hw.items()},
           "first_step_ms_by_resolution": {k: v[0]
                                           for k, v in ms_by_hw.items()},
           "losses": losses, "match_launches": km.match_launches,
           "match_cuda_kernels": km.match_kernel_launches,
           "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
           "train_step": train.step}
    emit({"phase": "r101_multiscale", **row, "card": state["card"]})
    if sorted(ms_by_hw) != sorted("x".join(map(str, s)) for s in MULTISCALE):
        raise SystemExit(f"multi-scale steps ran at {sorted(ms_by_hw)}")
    if (km.match_launches, km.match_kernel_launches) != (MULTISCALE_STEPS,
                                                         MULTISCALE_STEPS):
        raise SystemExit(f"multi-scale: {km.match_launches} matching "
                         f"launches in {MULTISCALE_STEPS} steps")
    if not np.isfinite(losses).all() or train.step != MULTISCALE_STEPS:
        raise SystemExit("multi-scale: a loss is not finite or a step "
                         "was lost")
    del train
    return row


def r101_train_fused(state: dict) -> dict:
    """Two train_steps of retinanet_r101_fpn at bs 16 with "on" (frozen
    BatchNorm): 5 forward and 5 backward fused calls (10 + 25 CUDA
    kernels) and one matching launch a step; each step's loss within 1e-2
    relative of the twin route's (``bottleneck_backend="torch"``, TF32
    off) from the same state and batch, as train_fused_1024 holds R50; the
    residual branches damped as in detect_cell."""
    import detjax_torch
    from detjax_torch.kernels import bottleneck as kb
    from detjax_torch.kernels import matching as km

    torch.cuda.empty_cache()
    train = detjax_torch.make_train_state(
        "retinanet_r101_fpn", seed=0, **{"model.fused_backbone": "on"})
    cfg = train.cfg
    batch = train_batch(cfg, seed=0)
    damp_residuals_(train.model)
    desaturate_(train.model, batch["images"][:4], cfg)
    twin = copy.deepcopy(train)
    twin.model.bottleneck_backend = "torch"
    kb.bottleneck_launches = kb.bottleneck_kernel_launches = 0
    kb.bottleneck_bwd_launches = kb.bottleneck_bwd_kernel_launches = 0
    km.match_launches = 0
    losses_k = [float(detjax_torch.train_step(train, batch)[1]["loss"])
                for _ in range(2)]
    torch.cuda.synchronize()
    launches = {"bottleneck_fwd": kb.bottleneck_launches,
                "bottleneck_fwd_cuda_kernels": kb.bottleneck_kernel_launches,
                "bottleneck_bwd": kb.bottleneck_bwd_launches,
                "bottleneck_bwd_cuda_kernels":
                    kb.bottleneck_bwd_kernel_launches,
                "match": km.match_launches}
    with tf32_off():
        losses_t = [float(detjax_torch.train_step(twin, batch)[1]["loss"])
                    for _ in range(2)]
    del twin, train
    rel = [abs(k - t) / abs(t) for k, t in zip(losses_k, losses_t)]
    row = {"preset": cfg.model.name, "fused_backbone": "on",
           "batch": cfg.train.batch_size, "launches_in_2_steps": launches,
           "losses_kernel_route": losses_k, "losses_twin_route": losses_t,
           "loss_rel_err": rel}
    emit({"phase": "r101_train_fused", **row,
          "loss_tolerance": "1e-2 relative", "card": state["card"]})
    want = {"bottleneck_fwd": 10,
            "bottleneck_fwd_cuda_kernels": 10 * kb.FWD_KERNELS,
            "bottleneck_bwd": 10,
            "bottleneck_bwd_cuda_kernels": 10 * kb.BWD_KERNELS, "match": 2}
    if launches != want:
        raise SystemExit(f"r101_train_fused: launches {launches} in two "
                         f"steps, expected {want}")
    if not all(np.isfinite(losses_k)) or max(rel) > 1e-2:
        raise SystemExit(f"r101_train_fused: losses {losses_k} against the "
                         f"twin route's {losses_t}")
    return row


def phase_r101(report: dict, state: dict) -> None:
    """retinanet_r101_fpn (benchmark config 4) at full width, bf16:
    detect_cell at eval batch 8 on 640 canvases ("off" and "on", as main
    and main_fused), train_cell at bs 16 with a traced window, two steps
    with "on" (r101_train_fused), and the multi-scale steps at 512 and
    640 of detjax's R101 gate recipe."""
    import detjax_torch

    cfg = detjax_torch.get_config("retinanet_r101_fpn",
                                  **{"model.prior_prob": PRIOR_PROB})
    cell = detect_cell("r101", cfg, seeded_canvases(1, cfg.eval.batch_size,
                                                    cfg.model.image_size),
                       state)
    del cell["model"]
    torch.cuda.empty_cache()
    train = train_cell("r101_train", "retinanet_r101_fpn", state,
                       traced=True)
    fused = r101_train_fused(state)
    multi = multiscale_cell(state)
    report["nms_cuda"]["launches_r101"] = cell["off"]["nms_launches"]
    report["match_iou_cuda"]["launches_r101_train"] = train["match_launches"]
    report["match_iou_cuda"]["launches_r101_multiscale"] = multi[
        "match_launches"]
    report["bottleneck_identity_cuda"]["launches_r101"] = cell["on"][
        "bottleneck_launches"]
    report["bottleneck_identity_bwd_cuda"]["launches_r101_train_2_steps"] = (
        fused["launches_in_2_steps"]["bottleneck_bwd"])
    state["r101"] = {"detect": cell["off"], "fused": cell["on"],
                     "train": train, "train_fused": fused,
                     "multiscale": multi}



# detjax's backbone A/B knobs, each against its baseline: (name, the
# config's overrides, the baseline's name); "off" is the preset's default
KNOB_CASES = (
    ("off", {}, None),
    ("dot_1x1=dw", {"model.dot_1x1": "dw"}, "off"),
    ("dot_1x1=full", {"model.dot_1x1": "full"}, "off"),
    ("remat_early=1", {"model.remat_early": 1}, "off"),
    ("remat_early=2", {"model.remat_early": 2}, "off"),
    ("remat_early=3", {"model.remat_early": 3}, "off"),
    ("f8_remat_stages=1", {"model.f8_remat_stages": 1}, "off"),
    ("f8_remat_stages=2", {"model.f8_remat_stages": 2}, "off"),
    ("on", {"model.fused_backbone": "on"}, None),
    ("remat_early=3+on", {"model.remat_early": 3,
                          "model.fused_backbone": "on"}, "on"),
    ("batch_stats", {"model.frozen_backbone_bn": False}, None),
    ("remat_early=2+batch_stats", {"model.remat_early": 2,
                                   "model.frozen_backbone_bn": False},
     "batch_stats"),
)
KNOB_WINDOWS = 5  # timed windows a config, in turns
KNOB_WINDOW_STEPS = 4
KNOB_BAR_DOT = 0.05  # of max |baseline gradient|, DotConv1x1 weights
STEM_PREFIXES = ("conv1.", "bn1.")


def knob_step(train, batch) -> dict:
    """One train_step: its loss, the gradients it applied (clipped as the
    step clips them), the parameters after it and the running statistics,
    as copies."""
    import detjax_torch

    _, m = detjax_torch.train_step(train, batch)
    return {"loss": m["loss"].clone(),
            "grads": {n: p.grad.detach().clone()
                      for n, p in train.model.named_parameters()},
            "params": _params(train),
            "stats": {n: b.detach().clone()
                      for n, b in train.model.named_buffers()}}


def zero_and_nan_shares(grads: dict) -> dict:
    """Share of exactly-zero gradient elements in the stem (conv1, bn1),
    in layer1 and in all, and the NaN count."""
    out = {}
    for part, keep in (("stem", lambda n: n.startswith(STEM_PREFIXES)),
                       ("layer1", lambda n: n.startswith("layer1.")),
                       ("all", lambda n: True)):
        g = [v for n, v in grads.items() if keep(n)]
        total = sum(v.numel() for v in g)
        out[f"zero_share_{part}"] = sum(int((v == 0).sum()) for v in g) / total
    out["nan_elements"] = sum(int(torch.isnan(v).sum())
                              for v in grads.values())
    return out


def rows_copy_ms(state: dict) -> dict:
    """``DotConv1x1``'s [B*H*W, C] rows of layer1's conv3 output at bs 16
    (16 x 256 x 160 x 160 bf16): device ms of the view of a channels_last
    tensor (the model's layout) and of the copy an NCHW-contiguous one
    needs, in turns."""
    from detjax_torch.models import resnet as tresnet

    t = torch.randn(16, 256, 160, 160, device="cuda", dtype=torch.bfloat16)
    cl = t.contiguous(memory_format=torch.channels_last)
    ms = in_turns({"view": lambda: tresnet._rows(cl),
                   "copy": lambda: tresnet._rows(t)},
                  ("view", "copy", "copy", "view"), 20)
    return {**ms, "bytes": t.numel() * 2, "card": state["card"]}


def state_bytes(train) -> int:
    """Bytes a TrainState keeps between steps: parameters, gradients and
    the optimizer's state."""
    tensors = [p for p in train.model.parameters()]
    tensors += [p.grad for p in tensors if p.grad is not None]
    tensors += [v for st in train.optimizer.state.values()
                for v in st.values() if torch.is_tensor(v)]
    return sum(t.numel() * t.element_size() for t in tensors)


def phase_knobs(report: dict, state: dict) -> None:
    """retinanet_r50_640 training, bs 16, bf16, under each of detjax's
    backbone knobs (KNOB_CASES), every config from the same seeded,
    desaturated weights and the same batch: one step each under cuDNN's
    deterministic algorithms against its baseline (remat_early: loss,
    gradients, parameters and running statistics bit-equal; dot_1x1: loss
    within 1e-2 relative, each DotConv1x1's weight gradient within 0.05 x
    max |baseline|; f8_remat_stages: loss finite, zero and NaN gradient
    shares printed, and those of the cotangents the e4m3 round crosses);
    ms a step in turns (KNOB_WINDOWS windows of
    KNOB_WINDOW_STEPS steps a config, the median) and the peak memory of
    a config alone (its state's bytes plus the most a step of it adds);
    one matching launch a step (launcher and torch.profiler) under every
    knob; 10 fused forward and 5 fused backward calls a step under
    remat_early=3 with "on"; detect_u8 with f8_remat_stages=1 (one NMS
    launch a batch); the float8 cast on the card against the CPU's rule;
    DotConv1x1's copies a step and a copy's cost."""
    import detjax_torch
    from detjax_torch.kernels import bottleneck as kb
    from detjax_torch.kernels import matching as km
    from detjax_torch.kernels import postprocess as pp
    from detjax_torch.models import resnet as tresnet

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    cfg0 = detjax_torch.get_config("retinanet_r50_640")
    base = detjax_torch.make_train_state(cfg0, seed=0)
    b = cfg0.train.batch_size
    batch = train_batch(cfg0, seed=0)
    scales = desaturate_(base.model, batch["images"][:4], cfg0)
    weights = {k: v.detach().cpu().clone()
               for k, v in base.model.state_dict().items()}
    dev = next(base.model.parameters()).device
    del base
    batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
    batch_bytes = sum(v.numel() * v.element_size() for v in batch.values())

    def fresh(overrides):
        cfg = detjax_torch.get_config("retinanet_r50_640", **overrides)
        train = detjax_torch.make_train_state(cfg, seed=0)
        train.model.load_state_dict(weights, strict=True)
        return train

    # 1. one step each, deterministic, against the baseline
    rows: dict = {}
    trains: dict = {}
    baselines: dict = {}
    refused_all: list = []
    rows_calls = {"calls": 0, "copies": 0}
    real_rows = tresnet._rows
    real_from_e4m3 = tresnet._FromE4M3.backward
    cotangents: dict = {}

    def counted_rows(t):
        rows_calls["calls"] += 1
        rows_calls["copies"] += not t.is_contiguous(
            memory_format=torch.channels_last)
        return real_rows(t)

    def counted_from_e4m3(ctx, g):
        out = real_from_e4m3(ctx, g)
        bits = out[0].view(torch.uint8) & 0x7F
        for key, n in (("elements", g.numel()),
                       ("zero_before", int((g == 0).sum())),
                       ("zero_after", int((bits == 0).sum())),
                       ("nan_after", int((bits == 0x7F).sum()))):
            cotangents[key] = cotangents.get(key, 0) + n
        return out

    for name, overrides, baseline in KNOB_CASES:
        train = trains[name] = fresh(overrides)
        tresnet._rows = counted_rows
        tresnet._FromE4M3.backward = staticmethod(counted_from_e4m3)
        rows_calls.update(calls=0, copies=0)
        cotangents.clear()
        try:
            with deterministic() as refused:
                first = knob_step(train, batch)
                torch.cuda.synchronize()
        finally:
            tresnet._rows = real_rows
            tresnet._FromE4M3.backward = staticmethod(real_from_e4m3)
        refused_all += [r for r in refused if r not in refused_all]
        row = rows[name] = {"loss_step_1": float(first["loss"]),
                            "rows_calls_a_step": rows_calls["calls"],
                            "rows_copies_a_step": rows_calls["copies"],
                            **zero_and_nan_shares(first["grads"])}
        if cotangents:  # the cotangents crossing the f8 blocks' inputs
            row["e4m3_cotangents"] = dict(cotangents)
        if baseline is None:
            baselines[name] = first
            continue
        ref = baselines[baseline]
        row.update(baseline=baseline,
                   baseline_loss_step_1=float(ref["loss"]))
        if name.startswith("remat_early"):
            mism = {part: [n for n in ref[part]
                           if not torch.equal(first[part][n], ref[part][n])]
                    for part in ("grads", "params", "stats")}
            row["tensors_not_bit_equal"] = {k: len(v)
                                            for k, v in mism.items()}
            if not torch.equal(first["loss"], ref["loss"]):
                raise SystemExit(f"knobs {name}: step-1 loss "
                                 f"{float(first['loss'])} is not "
                                 f"{baseline}'s {float(ref['loss'])}")
            if any(mism.values()):
                diff = max(float((first["params"][n] - ref["params"][n])
                                 .abs().max()) for n in ref["params"])
                emit({"phase": "knobs_mismatch", "knob": name,
                      "max_param_diff": diff, "refused_ops": refused,
                      "first_mismatches": {k: v[:5]
                                           for k, v in mism.items()}})
                row["max_param_diff"] = diff
                if not refused or mism["stats"] or (
                        diff > 2 * cfg0.train.learning_rate):
                    raise SystemExit(
                        f"knobs {name}: not bit-equal to {baseline} "
                        f"under deterministic algorithms: "
                        f"{row['tensors_not_bit_equal']}")
        elif name.startswith("dot_1x1"):
            row["loss_rel_diff"] = abs(
                row["loss_step_1"] - row["baseline_loss_step_1"]) / abs(
                row["baseline_loss_step_1"])
            dots = [f"{n}.weight" for n, m in train.model.named_modules()
                    if isinstance(m, tresnet.DotConv1x1)]
            row["dot_conv_modules"] = len(dots)
            row["worst_dot_grad_share_of_max"] = max(
                float((first["grads"][n] - ref["grads"][n]).abs().max()
                      / ref["grads"][n].abs().max()) for n in dots)
            if (row["loss_rel_diff"] > 1e-2
                    or row["worst_dot_grad_share_of_max"] > KNOB_BAR_DOT):
                raise SystemExit(f"knobs {name}: past the bars: {row}")
        elif not np.isfinite(row["loss_step_1"]):
            raise SystemExit(f"knobs {name}: the loss is not finite")
        del first
    del baselines
    torch.cuda.empty_cache()

    # 2. ms a step in turns; the peak of a config alone; launches a step
    for train in trains.values():
        detjax_torch.train_step(train, batch)
    torch.cuda.synchronize()
    counts = {name: dict.fromkeys(("steps", "match", "match_kernels", "fwd",
                                   "fwd_kernels", "bwd", "bwd_kernels"), 0)
              for name in trains}
    windows = {name: [] for name in trains}
    peaks = {name: 0 for name in trains}
    for _ in range(KNOB_WINDOWS):
        for name, train in trains.items():
            km.match_launches = km.match_kernel_launches = 0
            kb.bottleneck_launches = kb.bottleneck_kernel_launches = 0
            kb.bottleneck_bwd_launches = kb.bottleneck_bwd_kernel_launches = 0
            torch.cuda.synchronize()
            resident = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            for _ in range(KNOB_WINDOW_STEPS):
                detjax_torch.train_step(train, batch)
            torch.cuda.synchronize()
            windows[name].append((time.perf_counter() - t0)
                                 / KNOB_WINDOW_STEPS * 1e3)
            peaks[name] = max(peaks[name],
                              torch.cuda.max_memory_allocated() - resident)
            c = counts[name]
            c["steps"] += KNOB_WINDOW_STEPS
            c["match"] += km.match_launches
            c["match_kernels"] += km.match_kernel_launches
            c["fwd"] += kb.bottleneck_launches
            c["fwd_kernels"] += kb.bottleneck_kernel_launches
            c["bwd"] += kb.bottleneck_bwd_launches
            c["bwd_kernels"] += kb.bottleneck_bwd_kernel_launches
    for name, train in trains.items():
        c = counts[name]
        fused = name == "on" or name.endswith("+on")
        want = {"match": 1, "match_kernels": 1,
                "fwd": 10 if name == "remat_early=3+on" else 5 * fused,
                "bwd": 5 * fused}
        traced = kernel_launches_traced(
            lambda: detjax_torch.train_step(train, batch),
            {"match_kernel": 1.0, "fwd_tile_kernel": float(want["fwd"]),
             "dc1_kernel": float(want["bwd"])}, f"knobs {name}", calls=2)
        own = state_bytes(train) + batch_bytes
        rows[name].update(
            ms_per_step_windows=windows[name],
            ms_per_step=float(np.median(windows[name])),
            img_per_s=b / float(np.median(windows[name])) * 1e3,
            state_gib=own / 2**30,
            step_adds_gib=peaks[name] / 2**30,
            peak_memory_gib=(own + peaks[name]) / 2**30,
            launches_a_step={k: v / c["steps"] for k, v in c.items()
                             if k != "steps"},
            profiler_launches_a_step=traced)
        got = rows[name]["launches_a_step"]
        if any(got[k] != v for k, v in want.items()) or (
                traced is not None and (
                    traced["match_kernel"] != 1.0
                    or traced["fwd_tile_kernel"] != want["fwd"]
                    or traced["dc1_kernel"] != want["bwd"])):
            raise SystemExit(f"knobs {name}: launches a step {got}, by the "
                             f"profiler {traced}; want {want}")
    del trains
    torch.cuda.empty_cache()

    # 4. detect with f8_remat_stages=1: the rounding applies at inference
    cfg8 = detjax_torch.get_config("retinanet_r50_640",
                                   **{"model.f8_remat_stages": 1})
    model = detjax_torch.build_model(cfg8, seed=0)
    model.load_state_dict(weights, strict=True)
    canvases = seeded_canvases(1, cfg8.eval.batch_size,
                               cfg8.model.image_size)
    detjax_torch.detect_u8(model, canvases, cfg8)
    torch.cuda.synchronize()
    pp.nms_launches = pp.nms_kernel_launches = 0
    det = detjax_torch.detect_u8(model, canvases, cfg8)
    torch.cuda.synchronize()
    nms = (pp.nms_launches, pp.nms_kernel_launches)
    traced_nms = kernel_launches_traced(
        lambda: detjax_torch.detect_u8(model, canvases, cfg8),
        {k: 1.0 for k in NMS_KERNEL_NAMES}, "knobs f8 detect_u8")
    f8_detect = {"num_valid": det.num_valid.tolist(),
                 "scores_finite": bool(torch.isfinite(det.scores).all()),
                 "nms_launches": nms[0], "nms_cuda_kernels": nms[1],
                 "profiler_nms_a_batch": traced_nms}
    del model
    if nms != (1, 1) or (traced_nms is not None
                         and traced_nms != {"nms_kernel": 1.0}) or (
            not f8_detect["scores_finite"]):
        raise SystemExit(f"knobs f8 detect_u8: {f8_detect}")

    # 5. the float8 cast on the card against the CPU's rule
    bf = torch.from_numpy(np.arange(2 ** 16, dtype=np.uint16).view(
        np.int16)).view(torch.bfloat16)
    edge = torch.tensor([448, 460, 464, 465, 480, 1000, float("inf"),
                         float("nan"), 2.0 ** -10, 1.5 * 2.0 ** -10])
    edge = torch.cat([edge, -edge])
    cast = {
        "bf16_patterns_equal": torch.equal(
            tresnet.to_e4m3(bf.to(dev)).view(torch.uint8).cpu(),
            tresnet.to_e4m3(bf).view(torch.uint8)),
        "fp32_edges_equal": torch.equal(
            tresnet.to_e4m3(edge.to(dev)).view(torch.uint8).cpu(),
            tresnet.to_e4m3(edge).view(torch.uint8)),
        "torch_cast_of_edges_on_card": edge.to(dev).to(
            torch.float8_e4m3fn).to(torch.float32).cpu().tolist()}

    emit({"phase": "knobs", "preset": cfg0.model.name, "batch": b,
          "dtype": cfg0.model.dtype, "output_scales": scales,
          "configs": rows, "f8_detect_u8": f8_detect, "e4m3_cast": cast,
          "rows_view_vs_copy_ms": rows_copy_ms(state),
          "deterministic_refused_ops": refused_all,
          "tolerance": "remat_early: loss, gradients, parameters, running "
                       "statistics bit-equal to the baseline under "
                       "deterministic algorithms (else parameters within "
                       "2 x lr, printed); dot_1x1: loss 1e-2 relative, "
                       "DotConv1x1 gradients 0.05 x max; f8: loss finite",
          "card": state["card"]})
    if not (cast["bf16_patterns_equal"] and cast["fp32_edges_equal"]):
        raise SystemExit(f"knobs: the float8 cast on the card is not the "
                         f"CPU's: {cast}")
    report["match_iou_cuda"]["launches_knobs_a_step"] = {
        name: row["launches_a_step"]["match"] for name, row in rows.items()}
    report["bottleneck_identity_cuda"]["launches_remat_early_3_on_a_step"] = (
        rows["remat_early=3+on"]["launches_a_step"]["fwd"])
    report["bottleneck_identity_bwd_cuda"][
        "launches_remat_early_3_on_a_step"] = (
        rows["remat_early=3+on"]["launches_a_step"]["bwd"])
    report["nms_cuda"]["launches_f8_detect_u8"] = nms[0]
    state["knobs"] = rows


BENCH_TIMEOUT_S = 600


def phase_bench(state: dict) -> None:
    """``python -m detjax_torch.cli.bench`` in a fresh process: its last
    line parses, every engine's min <= median <= max over at least 5
    windows, and the card it names is this one; the line is echoed."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "detjax_torch.cli.bench"],
                          cwd=str(Path(__file__).resolve().parent),
                          capture_output=True, text=True,
                          timeout=BENCH_TIMEOUT_S)
    wall_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise SystemExit(f"bench exited {proc.returncode}: "
                         f"{proc.stderr[-4000:]}")
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    spreads = {"int8": line["int8"]}
    for engine in ("train", "infer"):
        for fused in ("off", "on"):
            spreads[f"{engine}_{fused}"] = line[engine][fused]
    bad = {k: v for k, v in spreads.items()
           if not (len(v["windows"]) >= 5
                   and 0 < v["min"] <= v["median"] <= v["max"])}
    emit({"phase": "bench", "wall_s": wall_s, "line": line})
    card = ", ".join([line["device"]["name"], line["device"]["power_limit"]])
    if bad or line["value"] != line["train"]["off"]["median"]:
        raise SystemExit(f"bench: spreads out of order or too few windows: "
                         f"{bad}")
    if card != state["card"]:
        raise SystemExit(f"bench names {card!r}, not {state['card']!r}")
    state["bench"] = line




def ssd_gate(steps: int = 1500) -> int:
    """detjax's SSD gate on the card (scripts/e2e_gate.py:269-297): fit the
    recipe for ``steps`` steps on its 8 scenes, then AP50 on them through
    ``evaluate``; detjax's floor: AP50 > 0.5. Not called by main; run as
    ``python3 -c "import chip_smoke as cs; cs.ssd_gate()"``."""
    import detjax_torch
    from detjax_torch.data import make_train_iterator

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    card = print_card()
    cfg = ssd_gate_config(**{"train.checkpoint_every_steps": 10**9,
                             "train.eval_every_steps": 10**9})
    ds = ssd_gate_data()
    t0 = time.perf_counter()
    res = detjax_torch.fit(cfg, make_train_iterator(ds, cfg), steps,
                           log_every=max(steps // 6, 1))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    stats = detjax_torch.evaluate(res.state.model, ds, cfg).stats
    ok = stats["AP50"] > SSD_GATE_AP50
    emit({"phase": "ssd_gate", "preset": cfg.model.name, "steps": steps,
          "batch": cfg.train.batch_size, "fit_s": fit_s,
          "img_per_s": res.images_per_sec,
          "logged_losses": [h["loss"] for h in res.history],
          "stats": stats, "detjax_floor_AP50": SSD_GATE_AP50, "card": card})
    print(json.dumps({"ssd_gate_passed": ok}), flush=True)
    return 0 if ok else 1


def r101_multiscale_gate(steps: int = 2500) -> int:
    """detjax's R101 multi-scale gate on the card
    (scripts/e2e_gate.py:424-477): ``steps`` multi-scale steps at 512 and
    640 of the recipe on its 12 scenes, then AP50 at both resolutions
    through ``evaluate``; detjax's floor: AP50 > 0.5 at both. Not called by
    main; run as ``python3 -c "import chip_smoke as cs;
    cs.r101_multiscale_gate()"``."""
    import dataclasses

    import detjax_torch
    from detjax_torch.train.multiscale import (MultiScaleIterator,
                                               make_multiscale_train_step)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    card = print_card()
    cfg = r101_multiscale_config()
    ds = r101_multiscale_data()
    train = detjax_torch.make_train_state(cfg, seed=0)
    step = make_multiscale_train_step(cfg, MULTISCALE)
    it = iter(MultiScaleIterator(ds, cfg, MULTISCALE, seed=0))
    losses = []
    t0 = time.perf_counter()
    for i in range(steps):
        _, m = step(train, next(it))
        if (i + 1) % 500 == 0 or i + 1 == steps:
            losses.append({"step": i + 1, "loss": float(m["loss"]),
                           "s": time.perf_counter() - t0})
            print(json.dumps(losses[-1]), flush=True)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    stats = {}
    for hw in MULTISCALE:
        cfg_e = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, image_size=hw))
        stats["x".join(map(str, hw))] = detjax_torch.evaluate(
            train.model, ds, cfg_e).stats
    ok = all(s["AP50"] > R101_GATE_AP50 for s in stats.values())
    emit({"phase": "r101_multiscale_gate", "preset": cfg.model.name,
          "steps": steps, "batch": cfg.train.batch_size, "fit_s": fit_s,
          "img_per_s": steps * cfg.train.batch_size / fit_s,
          "logged_losses": losses, "stats": stats,
          "detjax_floor_AP50": R101_GATE_AP50, "card": card})
    print(json.dumps({"r101_multiscale_gate_passed": ok}), flush=True)
    return 0 if ok else 1


# -- data parallel (detjax_torch.parallel) -----------------------------------

DP_STEPS = 20  # fit steps of the NCCL world-1 run and of its plain twin
DP_TIMED_STEPS = 8  # each timed window, world-1 fit and plain fit in turns
DP_PROFILED_STEPS = 3  # steps under torch.profiler for the all-reduce
DP_BATCHES = 4  # distinct batches, cycled
GLOO_SGD_LR = 1e-3
# (name, steps, config overrides): frozen BN and batch statistics, both
# as configured (bf16, Adam, the clip on); batch statistics in fp32 with
# TF32 off, sgd and the clip off, where the reductions' own rounding is
# all that separates the pair from the single-process step, and each
# gradient after step 1 is the averaged one (sgd's first step moves a
# parameter by -lr x g: a sum without the division, a lost rank's share
# or a wrong sign shows, where Adam's first step moves every parameter
# by about lr whatever its gradient)
GLOO_CASES = (("frozen", 3, {}),
              ("bn", 2, {"model.frozen_backbone_bn": False}),
              ("bn_fp32_sgd", 2, {"model.frozen_backbone_bn": False,
                                  "model.dtype": "float32",
                                  "train.optimizer": "sgd",
                                  "train.learning_rate": GLOO_SGD_LR,
                                  "train.grad_clip_norm": 1e9,
                                  "data.hflip_prob": 0.0}))
# the single-process bf16 batch-statistics step against the same step in
# fp32 (TF32 off): the precision gap that bounds the bf16 pair's running
# statistics (computed in the parent only)
GLOO_YARDSTICK = ("bn_fp32", {"model.frozen_backbone_bn": False,
                              "model.dtype": "float32"})
GLOO_EVAL_IMAGES = 16
# relative bars of the pair against the single-process step: bf16
GLOO_LOSS_BAR = 1e-3  # step 1's loss
GLOO_LATER_LOSS_BAR = 2e-3  # the later steps' losses
GLOO_NORM_BAR = 2e-2  # step 1's global gradient norm (before the clip)
GLOO_STATS_BAR = 1e-3  # running statistics: ||a - b|| / ||b||, a tensor
# fp32 with TF32 off
GLOO_FP32_BAR = 1e-5  # step 1's loss, gradient norm and statistics
GLOO_FP32_LATER_BAR = 2e-4  # the later steps' losses and statistics
# step 1's gradients, ||a - b|| / ||b|| over all of them and over each
# tensor, and their global norm: each within the larger of its bar
# (GLOO_GRAD_BAR; the norm GLOO_FP32_BAR) and GLOO_GRAD_ROUNDING x the gap
# that the same single-process step shows with the batch's halves swapped
# (the same sums in another order; no flips, so that it is the same
# function): a BatchNorm scale's or shift's gradient sums 1.6M products
# that nearly cancel, and their fp32 rounding alone reaches 2e-2 a tensor
# and 1e-3 over all gradients (an H100 80GB HBM3 at 700 W). A sum without
# the division, a lost rank's share or a wrong sign reads 0.5 or more
GLOO_GRAD_BAR = 1e-3
GLOO_GRAD_ROUNDING = 4.0
GLOO_DET_SCORE_BAR = 1e-6  # sharded evaluation, a detection's score
GLOO_DET_BOX_BAR = 1e-3  # and its box, px
DP_CLI_STEPS = 4
DP_TIMEOUT_S = 300


def dp_config(**extra):
    """Config 5 (``coco_v5e8``: R50-640, frozen BN, bf16) at its per-chip
    batch of 16 (128 over 8 chips), the smoke's prior, prefetch on (no
    calibration steps), no evaluation or save."""
    import detjax_torch

    return detjax_torch.get_config("coco_v5e8", **{
        "model.prior_prob": PRIOR_PROB, "train.batch_size": 16,
        "data.device_prefetch": True,
        "train.checkpoint_every_steps": 10**9,
        "train.eval_every_steps": 10**9, **extra})


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dp_state(cfg, sd):
    """A fresh train state of ``cfg`` holding the weights ``sd``."""
    import detjax_torch

    train = detjax_torch.make_train_state(cfg, seed=0)
    train.model.load_state_dict(sd, strict=True)
    return train


def max_gap(a: dict, b: dict) -> float:
    """The largest |a - b| over the tensors of ``b``."""
    return max(float((a[k].float() - b[k].float()).abs().max()) for k in b)


def max_rel_gap(a: dict, b: dict, atol: float) -> float:
    """The largest (|a - b| - atol) / |b| over every tensor of ``b``."""
    return max(float(((a[k].float() - b[k].float()).abs() - atol).clamp(
        min=0).div(b[k].float().abs().clamp(min=1e-30)).max()) for k in b)


def dp_steps(step, train, batches) -> dict:
    """``step(batch)`` over ``batches``: the losses and global gradient
    norms, each step's host-clock ms (synchronized), the model's tensors
    on the host after step 1 and after the last, and the gradients after
    step 1 (clipped, where the clip acted)."""
    losses, norms, ms, after = [], [], [], {}
    for i, batch in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, m = step(batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        ms.append((time.perf_counter() - t0) * 1e3)
        if i in (0, len(batches) - 1):
            after[i + 1] = {k: v.detach().to("cpu", copy=True)
                            for k, v in train.model.state_dict().items()}
        if i == 0:
            grads = {n: p.grad.to("cpu", copy=True)
                     for n, p in train.model.named_parameters()
                     if p.grad is not None}
    return {"losses": losses, "grad_norms": norms, "ms": ms, "after": after,
            "grads_step_1": grads}


def scale_gap(a: dict, b: dict) -> tuple:
    """The largest max|a - b| / max|b| over the tensors of ``b``, and the
    tensor that has it."""
    gaps = {k: float((a[k].float() - b[k].float()).abs().max()
                     / b[k].float().abs().max().clamp(min=1e-30))
            for k in b}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def precision_of(cfg):
    """TF32 off for an fp32 model, so that it computes in fp32."""
    return (tf32_off() if cfg.model.dtype == "float32"
            else contextlib.nullcontext())


def dp_gloo_rank(rank: int, port: int, root: str) -> None:
    """One of two gloo ranks on cuda:0 (``devices=[cuda:0]``): the
    data-parallel steps of GLOO_CASES on the parent's global batches of
    16, 8 rows a rank, then one sharded evaluation of GLOO_EVAL_IMAGES
    images (its stats and its detections, image by image); writes
    ``rank<r>.pt``."""
    import torch.distributed as dist

    import detjax_torch
    from detjax_torch.data.synthetic import SyntheticDetectionDataset
    from detjax_torch.evaluation.evaluator import iter_detections
    from detjax_torch.kernels import postprocess as pp
    from detjax_torch.parallel import (make_mesh, make_parallel_train_step,
                                       shard_batch)

    root = Path(root)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2)
    try:
        inputs = torch.load(root / "inputs.pt", weights_only=False)
        mesh = make_mesh(["cuda:0"])
        out = {"mesh": [mesh.rank, mesh.world_size, str(mesh.device)]}
        for name, steps, extra in GLOO_CASES:
            cfg = dp_config(**extra)
            train = dp_state(cfg, inputs["sd"])
            run = make_parallel_train_step(cfg, mesh)
            run.warmup(train, inputs["batches"][0])
            accum = cfg.train.grad_accum_steps
            with precision_of(cfg):
                out[name] = dp_steps(
                    lambda b: run(train, shard_batch(b, mesh, accum)),
                    train, inputs["batches"][:steps])
            del train, run
        cfg = dp_config()
        model = detjax_torch.build_model(cfg, seed=0)
        model.load_state_dict(inputs["sd"], strict=True)
        ds = SyntheticDetectionDataset(GLOO_EVAL_IMAGES, (640, 640), 80,
                                       max_objects=20, seed=7)
        torch.cuda.synchronize()
        pp.nms_launches = 0
        out["eval"] = detjax_torch.evaluate(model, ds, cfg, mesh=mesh).stats
        torch.cuda.synchronize()
        out["eval_nms_launches"] = pp.nms_launches
        out["dets"] = list(iter_detections(model, ds, cfg, mesh=mesh))
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(out, root / f"rank{rank}.pt")


def dp_world_1(cfg, sd, batches, before_timing=lambda: None) -> dict:
    """detjax_torch.fit on a world-1 NCCL mesh (the group initialised in
    this process, rank 0 of 1) against fit without a mesh, DP_STEPS steps
    each on the same batches under deterministic(): every tensor
    bit-equal, one matching launch a step; then both timed in turns
    (host clock, DP_TIMED_STEPS-step windows) and the all-reduce's device
    ms a step from torch.profiler. ``before_timing`` runs before the
    timed windows."""
    import torch.distributed as dist

    import detjax_torch
    from detjax_torch.kernels import matching as km
    from detjax_torch.parallel import (global_batch_from_local, make_mesh,
                                       make_parallel_train_step)
    from detjax_torch.train.step import average_gradients

    def stream(n):
        return [batches[i % len(batches)] for i in range(n)]

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        mesh = make_mesh()
        if not (mesh.multi_process and mesh.world_size == 1):
            raise SystemExit(f"parallel: the NCCL mesh is {mesh}")
        runs, launches = {}, {}
        with deterministic() as refused:
            for name in ("plain", "dp"):
                train = dp_state(cfg, sd)
                torch.cuda.synchronize()
                km.match_launches = 0
                runs[name] = detjax_torch.fit(
                    cfg, stream(DP_STEPS), DP_STEPS, state=train,
                    log_every=DP_STEPS, mesh=mesh if name == "dp" else None)
                torch.cuda.synchronize()
                launches[name] = km.match_launches
        plain, dp = (state_tensors(runs[k].state) for k in ("plain", "dp"))
        diffs = [k for k in plain if not torch.equal(plain[k], dp[k])]
        before_timing()
        windows = {"plain": [], "dp": []}
        # an untimed window of each first: cuDNN chooses its algorithms
        # anew outside the deterministic mode
        for name in ("plain", "dp", "dp", "plain", "plain", "dp"):
            train = runs[name].state
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            detjax_torch.fit(cfg, stream(DP_TIMED_STEPS),
                             train.step + DP_TIMED_STEPS, state=train,
                             log_every=DP_TIMED_STEPS,
                             mesh=mesh if name == "dp" else None)
            torch.cuda.synchronize()
            windows[name].append((time.perf_counter() - t0) * 1e3
                                 / DP_TIMED_STEPS)
        windows = {k: v[1:] for k, v in windows.items()}
        run = make_parallel_train_step(cfg, mesh)
        local = global_batch_from_local(batches[0], mesh)
        prof = profile_calls(lambda: run(runs["dp"].state, local),
                             DP_PROFILED_STEPS)
        # the gradients' sum, division and copy back, the step's own
        # share of data parallelism, after the step left its gradients:
        # CUDA events around 10 calls, the host's time to issue them, and
        # their kernels' device ms from the profiler
        def average():
            average_gradients(runs["dp"].state, mesh)

        average_ms = cuda_ms(average, iters=10)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            average()
        average_host_ms = (time.perf_counter() - t0) * 1e3 / 10
        torch.cuda.synchronize()
        average_prof = profile_calls(average, 10)
    finally:
        dist.destroy_process_group()
    nccl = ([(n, t) for n, t in device_events(prof) if "nccl" in n.lower()]
            if prof is not None else None)
    average_kernels = (None if average_prof is None else
                       [(n, t) for n, t in device_events(average_prof)
                        if "spin_kernel" not in n])
    out = {"steps": DP_STEPS, "device": str(mesh.device),
           "launches": launches,
           "tensors": len(plain), "tensors_differing": diffs,
           "refused_deterministic": refused,
           "ms_per_step_in_turns": windows,
           "dp_overhead_ms_per_step": (np.mean(windows["dp"])
                                       - np.mean(windows["plain"])),
           "allreduce_device_ms_per_step": (
               None if nccl is None
               else sum(t for _, t in nccl) / DP_PROFILED_STEPS),
           "allreduce_kernels_per_step": (
               None if nccl is None else len(nccl) / DP_PROFILED_STEPS),
           "allreduce_kernel_names": sorted({n for n, _ in nccl or ()}),
           "average_gradients_ms": average_ms,
           "average_gradients_host_ms": average_host_ms,
           "average_gradients_kernel_ms": (
               None if average_kernels is None else
               sum(t for _, t in average_kernels) / 10),
           "average_gradients_kernels": (
               None if average_kernels is None else
               sorted({n for n, _ in average_kernels})),
           "gradient_mib": sum(p.numel() for p in runs["dp"].state.model
                               .parameters()) * 4 / 2**20}
    out["failures"] = (
        (["world 1: tensors differ"] if diffs else [])
        + (["world 1: matching launches"]
           if launches != {"plain": DP_STEPS, "dp": DP_STEPS} else []))
    emit({"phase": "parallel_world_1", **out})
    return out


def param_excess(a: dict, b: dict) -> float:
    """The largest |a - b| over the tensors of ``b``, less two fp32
    spacings of ``b``'s element: two parameters that took opposite Adam
    steps of lr from the same value differ by 2 x lr plus their
    rounding (at 1.0, lr 1e-5 rounds to 1.00136e-5 up and 1.0013e-5
    down)."""
    inf = torch.tensor(float("inf"))
    return max(float(((a[k] - b[k]).abs() - 2 * (torch.nextafter(
        b[k].abs(), inf) - b[k].abs())).max()) for k in b)


def rel_norm_gaps(a: dict, b: dict) -> dict:
    """||a - b|| / ||b|| for each tensor of ``b``."""
    return {k: float((a[k].double() - b[k].double()).norm()
                     / b[k].double().norm().clamp(min=1e-300)) for k in b}


def rel_norm_gap(a: dict, b: dict) -> tuple:
    """The largest ||a - b|| / ||b|| over the tensors of ``b``, and the
    tensor that has it."""
    gaps = rel_norm_gaps(a, b)
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def swap_halves(batch: dict) -> dict:
    """``batch`` with its second half of rows first."""
    half = len(batch["images"]) // 2
    return {k: np.concatenate([v[half:], v[:half]]) for k, v in batch.items()}


@contextlib.contextmanager
def split_channel_sums(parts: int):
    """Every ``F.conv2d`` with groups 1 computed as the sum of ``parts``
    convolutions over consecutive slices of its input channels: the same
    function, each convolution's sums (forward and backward) in another
    order and through cuDNN's algorithms for other shapes, as a layout
    that runs the convolutions on other shapes does."""
    import torch.nn.functional as F

    plain = F.conv2d

    def split(x, w, b=None, stride=1, padding=0, dilation=1, groups=1):
        c = x.shape[1]
        if groups != 1 or c < parts:
            return plain(x, w, b, stride, padding, dilation, groups)
        cuts = [c * i // parts for i in range(parts + 1)]
        out = plain(x[:, :cuts[1]], w[:, :cuts[1]], b, stride, padding,
                    dilation)
        for lo, hi in zip(cuts[1:-1], cuts[2:]):
            out = out + plain(x[:, lo:hi], w[:, lo:hi], None, stride,
                              padding, dilation)
        return out

    F.conv2d = split
    try:
        yield
    finally:
        F.conv2d = plain


def _flat_grads(g: dict, keys) -> dict:
    """``g`` and, under "(all)", every tensor of ``keys`` in one."""
    return {"(all)": torch.cat([g[k].double().reshape(-1) for k in keys]),
            **g}


def grad_bars(single: dict, reordered) -> tuple:
    """The single step's gradients (with "(all)") and each one's bar: the
    larger of GLOO_GRAD_BAR and GLOO_GRAD_ROUNDING x the largest gap that
    the same step shows with its sums in another order (``reordered``:
    dp_steps records of such steps), with those gaps."""
    keys = list(single["grads_step_1"])
    want = _flat_grads(single["grads_step_1"], keys)
    gaps = [rel_norm_gaps(_flat_grads(r["grads_step_1"], keys), want)
            for r in reordered]
    rounding = {k: max(g[k] for g in gaps) for k in want}
    return want, {k: max(GLOO_GRAD_BAR, GLOO_GRAD_ROUNDING * rounding[k])
                  for k in want}, rounding


def grad_excess(grads: dict, single: dict, reordered) -> float:
    """The largest ratio of a gradient's 2-norm gap to its grad_bars bar."""
    want, bars, _ = grad_bars(single, reordered)
    gaps = rel_norm_gaps(_flat_grads(grads, single["grads_step_1"]), want)
    return max(gaps[k] / bars[k] for k in want)


def grad_check(pair: dict, single: dict, reordered) -> dict:
    """The pair's step 1 against the single-process step's (dp_steps
    records): the gradients' 2-norm ratio over all of them and over each
    tensor, each within its grad_bars bar (``reordered``: the single
    step's twins with their sums in another order),
    ``grad_excess_step_1`` being the largest ratio of a gap to its bar;
    the bar of the global norm's gap, likewise from GLOO_FP32_BAR. The
    five largest gaps are listed beside their rounding and bar."""
    want, bars, rounding = grad_bars(single, reordered)
    gaps = rel_norm_gaps(_flat_grads(pair["grads_step_1"],
                                     single["grads_step_1"]), want)
    norm = single["grad_norms"][0]
    top = sorted(gaps, key=gaps.get, reverse=True)[:5]
    return {"grad_excess_step_1": max(gaps[k] / bars[k] for k in want),
            "grad_gap_global_step_1": gaps["(all)"],
            "grad_gap_global_reordered": rounding["(all)"],
            "grad_tensors_over_1e-3": sum(g > GLOO_GRAD_BAR
                                          for g in gaps.values()),
            "grad_largest_gaps": [[k, gaps[k], rounding[k], bars[k]]
                                  for k in top],
            "grad_norm_bar": max(GLOO_FP32_BAR, GLOO_GRAD_ROUNDING * max(
                abs(r["grad_norms"][0] - norm) / norm for r in reordered))}


def step_gaps(got: dict, want: dict, stats: bool) -> dict:
    """``got``'s losses, gradient norms and tensors after each recorded
    step against ``want``'s (dp_steps records)."""
    def rel(x, y):
        return abs(x - y) / abs(y)

    out = {"loss_gap_rel": rel(got["losses"][0], want["losses"][0]),
           "later_loss_gap_rel": max(
               (rel(x, y) for x, y in zip(got["losses"][1:],
                                          want["losses"][1:])), default=0.0),
           "grad_norm_gap_rel_step_1": rel(got["grad_norms"][0],
                                           want["grad_norms"][0])}
    for i, w in want["after"].items():
        params = {k: v for k, v in w.items() if "running" not in k}
        out[f"param_gap_step_{i}"] = max_gap(got["after"][i], params)
        out[f"param_excess_step_{i}"] = param_excess(got["after"][i], params)
        if stats:
            st = {k: v for k, v in w.items() if "running" in k}
            (out[f"stats_gap_step_{i}"],
             out[f"stats_worst_step_{i}"]) = rel_norm_gap(got["after"][i], st)
            out[f"stats_max_over_max_step_{i}"] = scale_gap(
                got["after"][i], st)[0]
            out[f"stats_elementwise_step_{i}"] = max_rel_gap(
                got["after"][i], st, 1e-6)
    return out


def detections_gap(got: list, want: list) -> dict:
    """Two ``iter_detections`` lists, image by image: whether the image
    ids (in order) and each image's labels are equal, the largest score
    and box (px) differences, the detections on each side, and whether
    every array is bit-equal."""
    same_ids = [g[0] for g in got] == [w[0] for w in want]
    pairs = list(zip(got, want)) if same_ids else []
    labels = same_ids and all(np.array_equal(g[3], w[3]) for g, w in pairs)
    out = {"images": len(got), "same_ids_in_order": same_ids,
           "labels_equal": labels,
           "detections": int(sum(len(w[3]) for w in want)),
           "detections_got": int(sum(len(g[3]) for g in got)),
           "max_score_gap": None, "max_box_gap_px": None, "bit_equal": False}
    if labels:
        kept = [(g, w) for g, w in pairs if len(w[3])]
        out["max_score_gap"] = max(
            (float(np.abs(g[2] - w[2]).max()) for g, w in kept), default=0.0)
        out["max_box_gap_px"] = max(
            (float(np.abs(g[1] - w[1]).max()) for g, w in kept), default=0.0)
        out["bit_equal"] = all(np.array_equal(g[j], w[j])
                               for g, w in pairs for j in (1, 2, 3))
    return out


def gloo_row(name: str, g0: dict, g1: dict, w: dict, yardstick: dict,
             reordered: list) -> tuple:
    """The pair's row for case ``name`` against the single-process step
    ``w``, and whether it missed a bar. The ranks bit-equal after every
    recorded step; in bf16 (Adam, clip on): the losses within
    GLOO_LOSS_BAR (step 1) and GLOO_LATER_LOSS_BAR, step 1's gradient norm
    within GLOO_NORM_BAR; in fp32 (TF32 off, sgd, clip off): step 1's loss
    within GLOO_FP32_BAR, the later losses within GLOO_FP32_LATER_BAR, and
    step 1's gradients and their norm as grad_check holds them against
    the single step's and its reordered twins' (``reordered``: that step
    with the batch's halves swapped, and in the spatial phase with its
    convolutions' sums split); the parameters after step 1 within 2 x lr
    plus their own rounding (param_excess: the train_routes bar). Batch
    statistics: each running statistics tensor (2-norm of the difference
    over the tensor's) in fp32 within GLOO_FP32_BAR after step 1 and
    GLOO_FP32_LATER_BAR after the last, which checks the reduction; in
    bf16 within the larger of GLOO_STATS_BAR and the single-process bf16
    step's own distance from fp32 (``yardstick``), a precision gap that
    checks no reduction: bf16 convolutions over 8 rows and over 16 may
    take other cuDNN algorithms, whose rounding reaches the statistics
    beyond 1e-3."""
    bn = name.startswith("bn")
    fp32 = "fp32" in name
    bars = {"loss_gap_rel": GLOO_FP32_BAR if fp32 else GLOO_LOSS_BAR,
            "later_loss_gap_rel": (GLOO_FP32_LATER_BAR if fp32
                                   else GLOO_LATER_LOSS_BAR),
            "grad_norm_gap_rel_step_1": (GLOO_FP32_BAR if fp32
                                         else GLOO_NORM_BAR),
            "param_excess_step_1": 2 * w["lr"]}
    grads = {}
    if fp32:
        grads = grad_check(g0, w, reordered)
        bars["grad_excess_step_1"] = 1.0
        bars["grad_norm_gap_rel_step_1"] = grads.pop("grad_norm_bar")
    if bn:
        for i in w["after"]:
            bars[f"stats_gap_step_{i}"] = (
                (GLOO_FP32_BAR if i == 1 else GLOO_FP32_LATER_BAR) if fp32
                else max(GLOO_STATS_BAR, yardstick[f"stats_gap_step_{i}"]))
    row = {"steps": len(w["losses"]),
           "ranks_bit_equal": all(
               torch.equal(a[k], g1["after"][i][k])
               for i, a in g0["after"].items() for k in a) and all(
               torch.equal(v, g1["grads_step_1"][k])
               for k, v in g0["grads_step_1"].items()),
           "losses": g0["losses"], "losses_single": w["losses"],
           "grad_norms": g0["grad_norms"],
           "grad_norms_single": w["grad_norms"], "bars": bars,
           **step_gaps(g0, w, bn), **grads,
           "ms_per_step_rank0": g0["ms"], "ms_per_step_rank1": g1["ms"],
           "ms_per_step_single": w["ms"]}
    missed = [k for k, bar in bars.items() if not row[k] <= bar]
    if not row["ranks_bit_equal"]:
        missed.append("ranks_bit_equal")
    row["missed"] = missed
    return row, bool(missed)


def dp_gloo_pair(cfg, sd, batches) -> dict:
    """Two gloo ranks on cuda:0 (dp_gloo_rank), against the
    single-process batch-16 steps and the unsharded evaluation computed
    here meanwhile: each of GLOO_CASES held to gloo_row's bars; the
    sharded evaluation's 12 stats within 1e-6 of the unsharded run's, one
    NMS launch a rank a batch, and each rank's detections, image by
    image, against the unsharded run at the ranks' own batch (half the
    eval batch, so that both sides run the same shapes): the same image
    ids in order and labels, scores within GLOO_DET_SCORE_BAR, boxes
    within GLOO_DET_BOX_BAR px, and detections to compare; an all-gather
    that dropped, repeated or reordered a rank's rows fails (at the whole
    eval batch of 8, bf16 convolutions may take other cuDNN algorithms,
    and on an H100 80GB HBM3 at 700 W some labels differ there). Returns
    the failures under "failures"."""
    import dataclasses
    import tempfile

    import torch.multiprocessing as mp

    import detjax_torch
    from detjax_torch.data.synthetic import SyntheticDetectionDataset
    from detjax_torch.evaluation.evaluator import iter_detections

    tmp = tempfile.TemporaryDirectory(prefix="detjax_dp_")
    root = Path(tmp.name)
    n = max(steps for _, steps, _ in GLOO_CASES)
    torch.save({"sd": {k: v.cpu() for k, v in sd.items()},
                "batches": batches[:n]}, root / "inputs.pt")
    t0 = time.perf_counter()
    ranks = mp.start_processes(dp_gloo_rank, args=(free_port(), str(root)),
                               nprocs=2, join=False, start_method="spawn")
    try:
        want = {}
        for name, steps, extra in GLOO_CASES + ((GLOO_YARDSTICK[0], 2,
                                                 GLOO_YARDSTICK[1]),):
            c = dp_config(**extra)
            train = dp_state(c, sd)
            with precision_of(c):
                want[name] = dp_steps(
                    lambda b: detjax_torch.train_step(train, b), train,
                    batches[:steps])
            want[name]["lr"] = c.train.learning_rate
            if name == "bn_fp32_sgd":  # its sums in another order
                train = dp_state(c, sd)
                with precision_of(c):
                    reordered = dp_steps(
                        lambda b: detjax_torch.train_step(train, b), train,
                        [swap_halves(batches[0])])
            del train
        model = detjax_torch.build_model(cfg, seed=0)
        model.load_state_dict(sd, strict=True)
        ds = SyntheticDetectionDataset(GLOO_EVAL_IMAGES, (640, 640), 80,
                                       max_objects=20, seed=7)
        plain_eval = detjax_torch.evaluate(model, ds, cfg).stats
        rank_cfg = dataclasses.replace(cfg, eval=dataclasses.replace(
            cfg.eval, batch_size=cfg.eval.batch_size // 2))
        plain_dets = list(iter_detections(model, ds, rank_cfg))
        deadline = time.monotonic() + DP_TIMEOUT_S
        while not ranks.join(timeout=max(deadline - time.monotonic(), 1)):
            if time.monotonic() > deadline:
                raise SystemExit("parallel: the gloo ranks did not finish")
    finally:
        for proc in ranks.processes:
            if proc.is_alive():
                proc.kill()
    wall_s = time.perf_counter() - t0
    got = [torch.load(root / f"rank{r}.pt", weights_only=False)
           for r in range(2)]
    tmp.cleanup()
    out = {"wall_s": wall_s, "meshes": [g["mesh"] for g in got],
           "failures": []}
    yardstick = step_gaps(want["bn"], want.pop(GLOO_YARDSTICK[0]), True)
    for name, w in want.items():
        out[name], missed = gloo_row(name, got[0][name], got[1][name], w,
                                     yardstick, [reordered])
        if missed:
            out["failures"].append(f"gloo pair, {name}")
    out["bn"]["yardstick_single_bf16_vs_fp32"] = yardstick
    eval_gap = max(abs(g["eval"][k] - plain_eval[k])
                   for g in got for k in plain_eval)
    batches_per_rank = -(-GLOO_EVAL_IMAGES // cfg.eval.batch_size)
    dets = [detections_gap(g["dets"], plain_dets) for g in got]
    out["eval"] = {"images": GLOO_EVAL_IMAGES, "stats": got[0]["eval"],
                   "stats_unsharded": plain_eval, "max_gap": eval_gap,
                   "nms_launches_per_rank": [g["eval_nms_launches"]
                                             for g in got],
                   "batches": batches_per_rank,
                   "detections_vs_unsharded_rank_batch": dets,
                   "bars": {"stats": 1e-6, "score": GLOO_DET_SCORE_BAR,
                            "box_px": GLOO_DET_BOX_BAR}}
    dets_ok = all(d["images"] == GLOO_EVAL_IMAGES and d["labels_equal"]
                  and d["detections"] > 0
                  and d["max_score_gap"] <= GLOO_DET_SCORE_BAR
                  and d["max_box_gap_px"] <= GLOO_DET_BOX_BAR for d in dets)
    if not (eval_gap < 1e-6 and dets_ok
            and out["eval"]["nms_launches_per_rank"]
            == [batches_per_rank] * 2):
        out["failures"].append("gloo pair, sharded evaluation")
    emit({"phase": "parallel_gloo_pair", **out})
    return out


def dp_serve(cfg, sd, canvases) -> dict:
    """DetectionServer over a one-device mesh answers as without one, bit
    for bit; ``cli/serve.py --mesh 2`` is refused on one card."""
    import detjax_torch
    from detjax_torch.cli import serve as cli_serve
    from detjax_torch.parallel import make_mesh
    from detjax_torch.serve import DetectionServer

    model = detjax_torch.build_model(cfg, seed=0)
    model.load_state_dict(sd, strict=True)
    mesh = make_mesh(["cuda:0"])
    servers = [DetectionServer(model, cfg, batch_size=8, mesh=m)
               for m in (None, mesh)]
    try:
        want, got = (s._runs[0](canvases) for s in servers)
    finally:
        for srv in servers:
            srv.shutdown()
    mismatched = sum(
        not (np.array_equal(g[0], w[0]) and np.array_equal(g[1], w[1])
             and np.array_equal(g[2], w[2]) and g[3] == w[3])
        for g, w in zip(got, want))
    ap = cli_serve.build_parser()
    args = ap.parse_args(["--ckpt-dir", "unused", "--mesh", "2"])
    try:
        cli_serve.make_server(args, ap)
        refused = False
    except SystemExit:
        refused = True
    out = {"serve_slots_mismatched": mismatched,
           "serve_detections": int(sum(w[3] for w in want)),
           "cli_serve_mesh_2_refused": refused,
           "failures": ["mesh serving"] if mismatched or not refused else []}
    emit({"phase": "parallel_serve", **out})
    return out


def dp_cli_start():
    """Start ``python -m torch.distributed.run --nproc_per_node 1 -m
    detjax_torch.cli.train --dp --synthetic`` at config 5's model and
    per-chip batch for DP_CLI_STEPS steps."""
    repo = Path(__file__).resolve().parent
    return time.perf_counter(), subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
         "1", "--master_addr", "127.0.0.1", "--master_port",
         str(free_port()), "-m", "detjax_torch.cli.train", "--dp",
         "--synthetic", "--preset", "coco_v5e8", "--steps",
         str(DP_CLI_STEPS), "--set", "train.batch_size=16"],
        cwd=str(repo), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def dp_cli_finish(cli) -> dict:
    """Wait for dp_cli_start's run: exit 0 and one "done" line, at step
    DP_CLI_STEPS, with its img/s."""
    t0, proc = cli
    try:
        stdout, stderr = proc.communicate(timeout=DP_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
    done = re.findall(r"done: step=(\d+) throughput=([0-9.]+) img/s",
                      stdout)
    out = {"cli_train_rc": proc.returncode,
           "cli_train_s": time.perf_counter() - t0, "cli_train_done": done,
           "failures": ([] if proc.returncode == 0 and len(done) == 1
                        and done[0][0] == str(DP_CLI_STEPS)
                        else ["the train CLI"])}
    emit({"phase": "parallel_cli_train", **out})
    if out["failures"]:
        print(stdout[-3000:], stderr[-3000:], file=sys.stderr)
    return out


def phase_parallel(report: dict, state: dict) -> None:
    """detjax_torch.parallel at config 5's model (coco_v5e8: R50-640,
    frozen BN, bf16) and per-chip batch 16: a world-1 NCCL fit against the
    plain fit (dp_world_1), two gloo ranks on the one card against the
    single-process steps and a sharded evaluation (dp_gloo_pair; NCCL
    refuses two ranks on one device), the train CLI under
    torch.distributed.run (dp_cli_start / dp_cli_finish), mesh serving and
    the serve CLI's refusal (dp_serve). Config 5's scaling over 8 cards
    cannot be measured on one card."""
    import detjax_torch

    t0 = time.perf_counter()
    # the CLI's run overlaps the set-up and the untimed bit-equality runs
    # below (its img/s is read with them on the card); it is waited for
    # before the timed windows
    cli = dp_cli_start()
    cfg = dp_config()
    batches = [train_batch(cfg, seed=s) for s in range(DP_BATCHES)]
    train = detjax_torch.make_train_state(cfg, seed=0)
    scales = desaturate_(train.model, batches[0]["images"][:4], cfg)
    sd = {k: v.detach().clone() for k, v in train.model.state_dict().items()}
    del train
    outs = {}
    world_1 = dp_world_1(cfg, sd, batches, before_timing=lambda: outs.update(
        cli=dp_cli_finish(cli)))
    pair = dp_gloo_pair(cfg, sd, batches)
    serve = dp_serve(cfg, sd, batches[0]["images"][:8])
    wall_s = time.perf_counter() - t0
    failures = (world_1["failures"] + outs["cli"]["failures"]
                + pair["failures"] + serve["failures"])
    emit({"phase": "parallel", "preset": cfg.model.name,
          "batch": cfg.train.batch_size, "output_scales": scales,
          "wall_s": wall_s, "card": state["card"], "failures": failures,
          "note": "config 5's scaling over 8 cards is not measured: one "
                  "card"})
    if failures:
        raise SystemExit(f"parallel: {failures}")
    report["match_iou_cuda"]["launches_dp_world_1"] = world_1["launches"][
        "dp"]
    report["nms_cuda"]["launches_dp_gloo_eval_per_rank"] = pair["eval"][
        "nms_launches_per_rank"]
    state["parallel"] = {"world_1": world_1, "gloo_pair": pair,
                         "cli_train": outs["cli"], "serve": serve,
                         "wall_s": wall_s}


# -- spatial partitioning (detjax_torch/models/spatial.py) -------------------

# (cell, preset, overrides): R50-1024, whose pyramid stays row-sharded (P7
# is 8 rows, 4 a rank: the heads run on the ranks' rows), and config 5's
# R50-640, whose pyramid the layout rule gathers (P7 is 5 rows)
SPATIAL_CELLS = (("r50_1024", "retinanet_r50_1024", {}),
                 ("r50_640", "coco_v5e8", {}))
SPATIAL_BATCH = 8
SPATIAL_ON_STEPS = 2
SPATIAL_TRACE_WINDOWS = 3  # traced steps a cell, the first complete one kept
SPATIAL_FP32 = {"model.dtype": "float32", "train.optimizer": "sgd",
                "train.learning_rate": GLOO_SGD_LR,
                "train.grad_clip_norm": 1e9, "data.hflip_prob": 0.0}
SPATIAL_EVAL_IMAGES = 8
# the sharded evaluation against the unsharded one (fp32, TF32 off): the
# detect bars of the CPU tests
SPATIAL_DET_SCORE_BAR = 2e-5
SPATIAL_DET_BOX_BAR = 5e-3  # px
# the fp32 step's yardsticks, beside the batch's halves swapped: the single
# step with every convolution's channel sum split in this many parts. The
# pair runs its convolutions on other shapes, whose other sums move the
# forward by about 5e-6 of each output's largest value and flip a few ReLU
# masks; the swap keeps every shape and flips none (PERF.md)
SPATIAL_SPLITS = (2, 4)
# the gradient check must fail a wrong divisor (the world size in place of
# the data axis's) and a missing sum over the space group by this much
SPATIAL_FAULT_EXCESS = 10.0
SPATIAL_TIMEOUT_S = 600
FUSED_CUDA_KERNEL_NAMES = tuple(dict.fromkeys(FWD_KERNEL_NAMES
                                              + BWD_KERNEL_NAMES))


def spatial_config(preset: str, **extra):
    """``preset`` at train batch SPATIAL_BATCH, the smoke's prior, no
    evaluation or save."""
    import detjax_torch

    return detjax_torch.get_config(preset, **{
        "model.prior_prob": PRIOR_PROB, "train.batch_size": SPATIAL_BATCH,
        "train.checkpoint_every_steps": 10**9,
        "train.eval_every_steps": 10**9, **extra})


def spatial_traced_step(step) -> dict:
    """``step()`` under torch.profiler (CUDA activity), as profile_calls
    opens a window; the launches of the matching kernel and of the fused
    blocks' kernels it recorded, or None. The step runs whatever the
    profiler does, so that both ranks take the same steps."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CUDA])
    try:
        prof.__enter__()
    except (AssertionError, RuntimeError):
        prof = None
    for _ in range(PROFILER_WARMUP_LAUNCHES):
        torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    time.sleep(PROFILER_PAD_S)
    step()
    torch.cuda.synchronize()
    time.sleep(PROFILER_PAD_S)
    if prof is None:
        return None
    try:
        prof.__exit__(None, None, None)
        names = [n for n, _ in device_events(prof)]
    except (AssertionError, RuntimeError):
        return None
    return {"match_kernel": sum("match_kernel" in n for n in names),
            "fused_kernels": sum(any(k in n for k in FUSED_CUDA_KERNEL_NAMES)
                                 for n in names)}


def spatial_rank_cell(preset: str, extra: dict, inputs: dict, mesh) -> dict:
    """One cell on this rank of the (1, 2) mesh: one fp32 step (TF32 off,
    sgd, clip off), SPATIAL_ON_STEPS bf16 steps with "on" (launches by the
    launcher, halo exchanges and gathers, peak memory, ms a step), the
    same step traced (spatial_traced_step), and the sharded evaluation in
    fp32 (stats, NMS launches, detections)."""
    import detjax_torch
    from detjax_torch.data.synthetic import SyntheticDetectionDataset
    from detjax_torch.evaluation.evaluator import iter_detections
    from detjax_torch.kernels import bottleneck as kb
    from detjax_torch.kernels import matching as km
    from detjax_torch.kernels import postprocess as pp
    from detjax_torch.models import spatial
    from detjax_torch.parallel import make_parallel_train_step, shard_batch
    from detjax_torch.train import step as tstep

    out = {}
    batches = inputs["batches"]
    cfg = spatial_config(preset, **{**extra, **SPATIAL_FP32})
    train = dp_state(cfg, inputs["sd"])
    run = make_parallel_train_step(cfg, mesh)
    run.warmup(train, batches[0])
    km.match_launches = 0
    with precision_of(cfg):
        out["fp32_sgd"] = dp_steps(lambda b: run(train, shard_batch(b, mesh)),
                                   train, batches[:1])
    out["fp32_sgd"]["match_launches"] = km.match_launches
    del train, run
    # the rank's own gradients, before the sum over the space group: what
    # a step without that sum would keep
    train = dp_state(cfg, inputs["sd"])
    with precision_of(cfg):
        tstep.compute_gradients(train, shard_batch(batches[0], mesh),
                                mesh=mesh)
    out["fp32_local_grads"] = {n: p.grad.to("cpu", copy=True)
                               for n, p in train.model.named_parameters()
                               if p.grad is not None}
    del train
    torch.cuda.empty_cache()

    cfg = spatial_config(preset, **{**extra, "model.fused_backbone": "on"})
    train = dp_state(cfg, inputs["sd"])
    run = make_parallel_train_step(cfg, mesh)
    local = [shard_batch(b, mesh) for b in batches]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kb.bottleneck_launches = kb.bottleneck_bwd_launches = 0
    kb.bottleneck_kernel_launches = kb.bottleneck_bwd_kernel_launches = 0
    km.match_launches = km.match_kernel_launches = 0
    spatial.exchanges.update(dict.fromkeys(spatial.exchanges, 0))
    rec = dp_steps(lambda b: run(train, b), train, local)
    n = len(local)
    rec["launches_per_step"] = {
        "match": km.match_launches / n,
        "bottleneck_fwd": kb.bottleneck_launches / n,
        "bottleneck_bwd": kb.bottleneck_bwd_launches / n}
    rec["exchanges_per_step"] = {k: v / n
                                 for k, v in spatial.exchanges.items()}
    rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    windows = []
    for _ in range(SPATIAL_TRACE_WINDOWS):
        kb.bottleneck_kernel_launches = kb.bottleneck_bwd_kernel_launches = 0
        km.match_kernel_launches = 0
        traced = spatial_traced_step(lambda: run(train, local[0]))
        windows.append({"launcher": {
            "match_kernel": km.match_kernel_launches,
            "fused_kernels": (kb.bottleneck_kernel_launches
                              + kb.bottleneck_bwd_kernel_launches)},
            "profiler": traced})
    rec["traced_windows"] = windows
    out["on_bf16"] = rec
    del train, run, local
    torch.cuda.empty_cache()

    cfg = spatial_config(preset, **{**extra, "model.dtype": "float32"})
    model = detjax_torch.build_model(cfg, seed=0)
    model.load_state_dict(inputs["sd"], strict=True)
    ds = SyntheticDetectionDataset(SPATIAL_EVAL_IMAGES, cfg.model.image_size,
                                   cfg.model.num_classes, max_objects=20,
                                   seed=7)
    with tf32_off():
        torch.cuda.synchronize()
        pp.nms_launches = 0
        out["eval"] = detjax_torch.evaluate(model, ds, cfg, mesh=mesh).stats
        torch.cuda.synchronize()
        out["eval_nms_launches"] = pp.nms_launches
        out["dets"] = list(iter_detections(model, ds, cfg, mesh=mesh))
    del model
    torch.cuda.empty_cache()
    return out


def spatial_rank(rank: int, port: int, root: str) -> None:
    """One of two gloo ranks on cuda:0 on a (1 data x 2 space) mesh
    (``make_mesh(["cuda:0"], spatial=2)``): every SPATIAL_CELLS cell
    (spatial_rank_cell) on the parent's weights and batches; writes
    ``rank<r>.pt``."""
    import torch.distributed as dist

    from detjax_torch.parallel import make_mesh

    root = Path(root)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2)
    try:
        mesh = make_mesh(["cuda:0"], spatial=2)
        out = {"mesh": [list(mesh.axis_names), mesh.rank, mesh.data_rank,
                        mesh.space_rank, str(mesh.device)]}
        for cell, preset, extra in SPATIAL_CELLS:
            t0 = time.perf_counter()
            out[cell] = spatial_rank_cell(
                preset, extra, torch.load(root / f"{cell}.pt",
                                          weights_only=False), mesh)
            out[cell]["wall_s"] = time.perf_counter() - t0
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(out, root / f"rank{rank}.pt")


def spatial_references(cell: str, preset: str, extra: dict,
                       root: Path) -> dict:
    """The cell's seeded, desaturated weights and SPATIAL_ON_STEPS
    batches of SPATIAL_BATCH (written for the ranks), and the
    single-process references on them: the fp32 step and its reordered
    twins (the batch's halves swapped; SPATIAL_SPLITS), the bf16 steps
    with "on" (peak memory, ms a step) and the
    unsharded fp32 evaluation."""
    import detjax_torch
    from detjax_torch.data.synthetic import SyntheticDetectionDataset
    from detjax_torch.evaluation.evaluator import iter_detections

    cfg = spatial_config(preset, **extra)
    batches = [train_batch(cfg, seed=s) for s in range(SPATIAL_ON_STEPS)]
    train = detjax_torch.make_train_state(cfg, seed=0)
    scales = desaturate_(train.model, batches[0]["images"][:4], cfg)
    sd = {k: v.detach().to("cpu", copy=True)
          for k, v in train.model.state_dict().items()}
    del train
    torch.save({"sd": sd, "batches": batches}, root / f"{cell}.pt")
    want = {"output_scales": scales}
    c = spatial_config(preset, **{**extra, **SPATIAL_FP32})
    for name, batch, scope in (
            ("fp32_sgd", batches[0], contextlib.nullcontext()),
            ("reordered", swap_halves(batches[0]), contextlib.nullcontext()),
            *((f"split_{k}", batches[0], split_channel_sums(k))
              for k in SPATIAL_SPLITS)):
        train = dp_state(c, sd)
        with precision_of(c), scope:
            want[name] = dp_steps(
                lambda b: detjax_torch.train_step(train, b), train, [batch])
        want[name]["lr"] = c.train.learning_rate
        del train
    c = spatial_config(preset, **{**extra, "model.fused_backbone": "on"})
    train = dp_state(c, sd)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    want["on_bf16"] = dp_steps(lambda b: detjax_torch.train_step(train, b),
                               train, batches)
    want["on_bf16"]["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    want["on_bf16"]["lr"] = c.train.learning_rate
    del train
    c = spatial_config(preset, **{**extra, "model.dtype": "float32"})
    model = detjax_torch.build_model(c, seed=0)
    model.load_state_dict(sd, strict=True)
    ds = SyntheticDetectionDataset(SPATIAL_EVAL_IMAGES, c.model.image_size,
                                   c.model.num_classes, max_objects=20,
                                   seed=7)
    with tf32_off():
        want["eval"] = detjax_torch.evaluate(model, ds, c).stats
        want["dets"] = list(iter_detections(model, ds, c))
    want["eval_batches"] = -(-SPATIAL_EVAL_IMAGES // c.eval.batch_size)
    want["canvas"] = list(c.model.image_size)
    del model
    torch.cuda.empty_cache()
    return want


def spatial_cell_row(cell: str, g0: dict, g1: dict, w: dict) -> dict:
    """A cell's row: the fp32 step and the "on" steps held to gloo_row's
    bars against the single-process steps, the launches a rank, the
    traced counts, the exchanges, the memory and the times, the sharded
    evaluation against the unsharded one; its failures under
    "failures"."""
    from detjax_torch.models import spatial

    failures = []
    row = {"canvas": w["canvas"], "output_scales": w["output_scales"],
           "pyramid_row_sharded": spatial.pyramid_sharded(
               w["canvas"][0], range(3, 8), 2)}
    reordered = [w["reordered"], *(w[f"split_{k}"] for k in SPATIAL_SPLITS)]
    for name in ("fp32_sgd", "on_bf16"):
        row[name], missed = gloo_row(name, g0[name], g1[name], w[name], {},
                                     reordered)
        if missed:
            failures.append(f"{cell} {name}: {row[name]['missed']}")
    # the gradient check's readings of each yardstick alone and of two
    # faults; a fault must read SPATIAL_FAULT_EXCESS times its bar
    single = w["fp32_sgd"]
    fp32 = row["fp32_sgd"]
    keys = list(single["grads_step_1"])
    want = _flat_grads(single["grads_step_1"], keys)
    gaps = {n: rel_norm_gaps(_flat_grads(w[n]["grads_step_1"], keys), want)
            for n in ("reordered", *(f"split_{k}" for k in SPATIAL_SPLITS))}
    fp32["yardstick_gaps"] = {
        "largest": {n: max(g.values()) for n, g in gaps.items()},
        "at_the_pairs_largest": {t: {n: g[t] for n, g in gaps.items()}
                                 for t, *_ in fp32["grad_largest_gaps"]}}
    fp32["fault_excess"] = {
        "world_divisor": grad_excess(
            {k: v / 2 for k, v in g0["fp32_sgd"]["grads_step_1"].items()},
            single, reordered),
        "no_space_sum": grad_excess(g0["fp32_local_grads"], single,
                                    reordered)}
    if min(fp32["fault_excess"].values()) < SPATIAL_FAULT_EXCESS:
        failures.append(f"{cell} fp32_sgd: a fault reads less than "
                        f"{SPATIAL_FAULT_EXCESS} bars: "
                        f"{fp32['fault_excess']}")
    on = g0["on_bf16"]
    want_launches = {"match": 1.0, "bottleneck_fwd": 5.0,
                     "bottleneck_bwd": 5.0}
    launches = [g["on_bf16"]["launches_per_step"] for g in (g0, g1)]
    traced = next((t for t in on["traced_windows"]
                   if t["profiler"] == t["launcher"]), None)
    row.update({
        "launches_per_rank_step": launches,
        "fp32_match_launches_per_rank": [g["fp32_sgd"]["match_launches"]
                                         for g in (g0, g1)],
        "traced_windows_rank0": on["traced_windows"],
        "profiler_equals_launcher": traced is not None,
        "exchanges_per_rank_step": on["exchanges_per_step"],
        "peak_gib_per_rank": [g["on_bf16"]["peak_gib"] for g in (g0, g1)],
        "peak_gib_single_process": w["on_bf16"]["peak_gib"],
        "ms_per_step_rank0": on["ms"],
        "ms_per_step_single": w["on_bf16"]["ms"],
        "rank_wall_s": [g["wall_s"] for g in (g0, g1)]})
    if any(x != want_launches for x in launches) or any(
            g["fp32_sgd"]["match_launches"] != 1 for g in (g0, g1)):
        failures.append(f"{cell}: launches a rank {launches}, expected "
                        f"{want_launches}")
    if traced is None:
        failures.append(f"{cell}: no traced window's counts equal the "
                        f"launcher's")
    eval_gap = max(abs(g["eval"][k] - w["eval"][k])
                   for g in (g0, g1) for k in w["eval"])
    dets = [detections_gap(g["dets"], w["dets"]) for g in (g0, g1)]
    row["eval"] = {"images": SPATIAL_EVAL_IMAGES, "stats": g0["eval"],
                   "stats_unsharded": w["eval"], "max_gap": eval_gap,
                   "nms_launches_per_rank": [g["eval_nms_launches"]
                                             for g in (g0, g1)],
                   "batches": w["eval_batches"], "detections": dets,
                   "bars": {"stats": 1e-6, "score": SPATIAL_DET_SCORE_BAR,
                            "box_px": SPATIAL_DET_BOX_BAR}}
    if not (eval_gap < 1e-6 and all(
            d["images"] == SPATIAL_EVAL_IMAGES and d["labels_equal"]
            and d["detections"] > 0
            and d["max_score_gap"] <= SPATIAL_DET_SCORE_BAR
            and d["max_box_gap_px"] <= SPATIAL_DET_BOX_BAR for d in dets)
            and row["eval"]["nms_launches_per_rank"]
            == [w["eval_batches"]] * 2):
        failures.append(f"{cell}: sharded evaluation")
    row["failures"] = failures
    return row


def phase_spatial(report: dict, state: dict) -> None:
    """Spatial partitioning (``detjax_torch/models/spatial.py``, the
    ``(data, space)`` mesh) at full width: two gloo ranks sharing cuda:0
    (NCCL refuses two ranks on one device) split each image's rows on a
    (1, 2) mesh, at retinanet_r50_1024 (the row-sharded pyramid) and at
    config 5's R50-640 (the gathered one), 8 images, frozen BN. Against
    the single-process steps on the same batch, computed here first (the
    card then holds one side at a time): one fp32 step (TF32 off, sgd,
    clip off) and two bf16 steps with "on" at gloo_row's bars, 1 matching
    launch and 5 + 5 fused calls a rank a step by the launcher and by
    torch.profiler, the halo exchanges and gathers a step, each rank's
    peak memory beside the single process's, ms a step; the sharded fp32
    evaluation against the unsharded one (12 stats within 1e-6, each
    image's detections at the detect bars, 1 NMS launch a rank a batch).
    Two processes share one card, so their ms a step shows function, not
    the speed of two cards."""
    import tempfile

    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    tmp = tempfile.TemporaryDirectory(prefix="detjax_sp_")
    root = Path(tmp.name)
    want = {cell: spatial_references(cell, preset, extra, root)
            for cell, preset, extra in SPATIAL_CELLS}
    refs_s = time.perf_counter() - t0
    ranks = mp.start_processes(spatial_rank, args=(free_port(), str(root)),
                               nprocs=2, join=False, start_method="spawn")
    try:
        deadline = time.monotonic() + SPATIAL_TIMEOUT_S
        while not ranks.join(timeout=max(deadline - time.monotonic(), 1)):
            if time.monotonic() > deadline:
                raise SystemExit("spatial: the gloo ranks did not finish")
    finally:
        for proc in ranks.processes:
            if proc.is_alive():
                proc.kill()
    got = [torch.load(root / f"rank{r}.pt", weights_only=False)
           for r in range(2)]
    tmp.cleanup()
    rows = {cell: spatial_cell_row(cell, got[0][cell], got[1][cell],
                                   want[cell])
            for cell, _, _ in SPATIAL_CELLS}
    failures = [f for r in rows.values() for f in r["failures"]]
    wall_s = time.perf_counter() - t0
    for cell, row in rows.items():
        emit({"phase": f"spatial_{cell}", **row, "card": state["card"]})
    emit({"phase": "spatial", "meshes": [g["mesh"] for g in got],
          "references_s": refs_s, "wall_s": wall_s,
          "failures": failures, "card": state["card"],
          "note": "two ranks share one card: ms a step and peak memory "
                  "show the layout's function, not two cards' speed"})
    if failures:
        raise SystemExit(f"spatial: {failures}")
    report["match_iou_cuda"]["launches_spatial_per_rank_step"] = {
        c: r["launches_per_rank_step"][0]["match"] for c, r in rows.items()}
    report["nms_cuda"]["launches_spatial_eval_per_rank"] = {
        c: r["eval"]["nms_launches_per_rank"] for c, r in rows.items()}
    report["bottleneck_identity_cuda"]["launches_spatial_on_per_rank_step"] \
        = {c: r["launches_per_rank_step"][0]["bottleneck_fwd"]
           for c, r in rows.items()}
    report["bottleneck_identity_bwd_cuda"][
        "launches_spatial_on_per_rank_step"] = {
        c: r["launches_per_rank_step"][0]["bottleneck_bwd"]
        for c, r in rows.items()}
    state["spatial"] = {"wall_s": wall_s}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    import detjax_torch  # noqa: F401  (fails outside a checkout)
    card = print_card()
    emit({"python": sys.version.split()[0], "torch": torch.__version__,
          "cuda": torch.version.cuda})

    report: dict = {}
    state: dict = {"card": card}
    phase_build()
    phase_kernel(report)
    phase_decode_kernel(report)
    phase_match_kernel(report)
    phase_bottleneck_kernel(report)
    phase_bottleneck_bwd_kernel(report)
    phase_reference()
    phase_main(report, state)
    phase_eval_branch(report, state)
    phase_main_fused(report, state)
    phase_serve(state)
    phase_int8(report, state)
    phase_export(report, state)
    phase_serve_engines(state)
    state.pop("int8")
    phase_train(report, state)
    phase_train_fused(report, state)
    phase_data(state)
    phase_evaluate(report, state)
    phase_evaluate_protocol(state)
    phase_train_data(report, state)
    state.pop("eval_set")["tmp"].cleanup()
    phase_fit(report, state)
    phase_maxpool_bwd_kernel(report)
    phase_stem(report, state)
    phase_ssd(report, state)
    phase_r101(report, state)
    phase_knobs(report, state)
    phase_bench(state)
    phase_parallel(report, state)
    phase_spatial(report, state)
    emit({"kernels": list(report.values())})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
