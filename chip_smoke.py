"""Smoke run of the PyTorch port on one NVIDIA GPU.

Drives ``detjax_torch``'s serving path (RetinaNet-R50-FPN at 640, eval
batch 8, bf16, seeded random weights), its full-anchor-set eval branch
(decode + clip of every anchor, per-class NMS), the same serving path with
``model.fused_backbone="on"`` (layer1/layer2 identity bottlenecks as one
fused kernel each; also on a 608x832 canvas), and its training path (the
same model, train batch 16, bf16 autocast over fp32 parameters, Adam, clip
0.1, synthetic scenes; then with "on", and retinanet_r50_1024 with "on")
through the entry points a user calls, and the R50 stem (conv1 -> bn1 ->
ReLU -> 3x3/s2 max-pool) forward and backward at the 640 and 1024 training
shapes, with ATen's pool backward and with the max-pool backward kernel
(``kernels/stem.py::max_pool_3x3s2``, which no model path calls). Builds
every CUDA kernel of those paths from ``detjax_torch/csrc/`` (one nvcc per
source, all started together; also, from ``smoke_prior/``, the fused
backward as it stood at two earlier commits and with every product on
wmma, timed in turns against the current one),
holds each kernel against its plain
PyTorch twin on the card, and checks that each path really launched its
kernel. Prints JSON lines; the last line is ``{"ok": true, "device":
{...}}`` and appears only when every phase passed. Exits non-zero without
a CUDA device.

    python3 chip_smoke.py
"""

from __future__ import annotations

import contextlib
import copy
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
        "bf16_flops": 989e12}  # SXM data sheet, dense


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


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


def nms_bound_ms(b: int, n: int, max_det: int, steps: int) -> tuple:
    """Least time for the NMS at these shapes: bytes moved (inputs read
    once, outputs written once) over the memory rate, and the IoU work of
    the ``steps`` suppression passes this data needs (14 fp32 operations
    a candidate a pass) over the fp32 rate."""
    nbytes = b * n * (16 + 4 + 4) + b * max_det * (4 + 4)
    ops = 14.0 * n * steps
    t_bytes = nbytes / H100["bytes_per_s"] * 1e3
    t_ops = ops / H100["fp32_flops"] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# Timing references of the fused backward, in smoke_prior/ beside this
# script (no code path of detjax_torch calls them): the one-kernel design at
# two earlier commits (one C interface), and the current design with every
# product on wmma fragments (the current C interface).
PRIOR_DIR = Path(__file__).resolve().parent / "smoke_prior"
PRIOR_BWD = ("e8572c4", "82723fd")
WMMA = "wmma"


def prior_bwd_lib(commit: str):
    """The library of smoke_prior/bottleneck_bwd_<commit>.cu; ``commit`` is
    one of PRIOR_BWD or WMMA."""
    import ctypes

    from detjax_torch.kernels import bottleneck as kb
    from detjax_torch.kernels._build import load_library

    lib = load_library(f"detjax_bottleneck_bwd_{commit}",
                       [f"bottleneck_bwd_{commit}.cu"], src_dir=PRIOR_DIR)
    fn = lib.detjax_bottleneck_bwd_launch
    fn.restype = ctypes.c_int
    if commit == WMMA:
        fn.argtypes = kb._bwd_lib().detjax_bottleneck_bwd_launch.argtypes
        return lib
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    lib.detjax_bottleneck_bwd_slice_floats.argtypes = [ctypes.c_int]
    lib.detjax_bottleneck_bwd_slice_floats.restype = ctypes.c_int
    return lib


def prior_bwd_call(commit: str, x, dy, wts):
    """A no-argument call of that backward on (x, dy, wts). At PRIOR_BWD:
    its persistent grid of one block per SM (or per image row, if fewer),
    its workspace and outputs allocated once, outside the call. At
    WMMA: the port's own wrapper with that library in place of the
    current one for the call."""
    from detjax_torch.kernels import bottleneck as kb

    lib = prior_bwd_lib(commit)
    if commit == WMMA:
        def swapped():
            current, kb._BWD_LIB = kb._bwd_lib(), lib
            try:
                kb.bottleneck_identity_backward(x, dy, *wts)
            finally:
                kb._BWD_LIB = current
        return swapped
    b, h, w, c = x.shape
    m = c // 4
    parts = min(torch.cuda.get_device_properties(0).multi_processor_count,
                b * h)
    floats = lib.detjax_bottleneck_bwd_slice_floats(m)
    ws = torch.empty(parts, floats, device=x.device)
    flat = torch.empty(floats, device=x.device)
    dx = torch.empty_like(x)
    ptrs = [t.data_ptr() for t in (x, dy, *wts, dx, ws, flat)]

    def call():
        err = lib.detjax_bottleneck_bwd_launch(
            *ptrs, b, h, w, m, parts, 0,
            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise SystemExit(f"the backward at {commit} failed to launch: "
                             f"cudaError {err}")
    return call


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
    for commit in PRIOR_BWD + (WMMA,):
        libs[f"detjax_bottleneck_bwd_{commit}"] = (
            f"smoke_prior/bottleneck_bwd_{commit}.cu",
            lambda commit=commit: prior_bwd_lib(commit))
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


def phase_kernel(report: dict) -> None:
    from detjax_torch.kernels import postprocess as pp

    b, n, max_det, thr, offset = 8, 1000, 100, 0.5, 642.0
    boxes, scores, labels = (torch.from_numpy(a).cuda()
                             for a in hard_candidates(0, b, n))

    args = (boxes, scores, labels, thr, max_det, offset)
    ki, ks = pp.nms_cuda(*args)
    ri, rs = pp.nms_reference(*args)
    torch.cuda.synchronize()
    idx_equal = torch.equal(ki, ri)
    scores_equal = torch.equal(ks, rs)
    kept = (ki >= 0).sum(dim=1)
    steps = int(torch.clamp(kept + 1, max=max_det).sum())
    ms = cuda_ms(lambda: pp.nms_cuda(*args), iters=200, warmup=10)
    plain_ms = cuda_ms(lambda: pp.nms_reference(*args), iters=10)
    bound_ms, bound_by = nms_bound_ms(b, n, max_det, steps)
    emit({"phase": "kernel", "kernel": "nms_cuda", "B": b, "N": n,
          "max_det": max_det, "iou_threshold": thr,
          "keep_idx_bit_equal": idx_equal, "keep_scores_equal": scores_equal,
          "kept_per_image": kept.tolist(), "ms": ms, "plain_ms": plain_ms,
          "bound_ms": bound_ms, "bound_by": bound_by})
    if not (idx_equal and scores_equal):
        raise SystemExit("nms_cuda disagrees with its plain twin")
    if kept[-1].item() != 0 or kept[:-1].min().item() == 0:
        raise SystemExit("hard candidate set lost its empty / live images")
    report["nms_cuda"] = {
        "name": "nms_cuda", "route": "cuda",
        "source": "detjax_torch/csrc/nms.cu",
        "replaces": "detjax/kernels/postprocess.py:102",
        "launches": None, "match": idx_equal and scores_equal,
        "max_abs_err": float((ks - rs).abs().max()),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None}


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
            plain_ms = cuda_ms(lambda: pp.decode_boxes_reference(
                deltas, anchors, std, img), iters=50)
            bound_ms, bound_by = decode_bound_ms(b, n, deltas.element_size())
            row = {"deltas": str(dtype).split(".")[-1], "clip": clip,
                   "bit_equal_nan_equal": equal, "max_abs_err_finite": err,
                   **counts, "ms": ms, "plain_ms": plain_ms,
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
        "ms": main["ms"], "plain_ms": main["plain_ms"],
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


def match_bound_ms(b: int, a: int, g: int) -> tuple:
    """Least time for matching at these shapes: anchors [A,4] f32 and GT
    (box, valid, label) read once, the four outputs written once, over
    the memory rate; the pairwise IoU work over the fp32 rate."""
    nbytes = a * 16 + b * g * (16 + 1 + 4) + b * a * (4 + 4 + 16 + 4)
    ops = float(MATCH_OPS_PER_PAIR) * b * a * g
    t_bytes = nbytes / H100["bytes_per_s"] * 1e3
    t_ops = ops / H100["fp32_flops"] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_match_kernel(report: dict) -> None:
    """match_iou_cuda against its twin on the hard GT set, at the training
    shape of retinanet_r50_640: B=16, its 76,725 anchors, G=100."""
    from detjax_torch.kernels import matching as km
    from detjax_torch.modeling import anchor_config
    from detjax_torch.ops.anchors import anchors_for_shape

    cfg = smoke_config()
    anchors_np = anchors_for_shape(cfg.model.image_size, anchor_config(cfg))
    b, g = cfg.train.batch_size, cfg.train.max_gt
    anchors, boxes, labels = (torch.from_numpy(x).cuda() for x in
                              hard_gt(4, anchors_np, b, g))
    valid = labels >= 0
    args = (anchors, boxes, valid, labels)
    got = km.match_iou_cuda(*args)
    want = km.match_iou_reference(*args)
    torch.cuda.synchronize()
    names = ("max_iou", "argmax", "boxes", "labels")
    equal = {n: torch.equal(x, y) for n, x, y in zip(names, got, want)}
    max_iou = got[0]
    edges = {"iou_1": int((max_iou == 1.0).sum()),
             "iou_0.5": int((max_iou == 0.5).sum()),
             "iou_within_1e-6_of_0.4": int(((max_iou - 0.4).abs()
                                            < 1e-6).sum()),
             "images_without_gt": int((max_iou == -1).all(dim=1).sum()),
             "valid_gt_per_image": valid.sum(dim=1).tolist()}
    a = anchors.shape[0]
    ms = cuda_ms(lambda: km.match_iou_cuda(*args), iters=100, warmup=5)
    plain_ms = cuda_ms(lambda: km.match_iou_reference(*args), iters=5,
                       warmup=1)
    bound_ms, bound_by = match_bound_ms(b, a, g)
    emit({"phase": "match_kernel", "kernel": "match_iou_cuda", "B": b,
          "A": a, "G": g, "bit_equal": equal, "edges": edges, "ms": ms,
          "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
          "library_ms": None,
          "library_note": "no single PyTorch call computes it; "
                          "torchvision's box_iou is not installed and "
                          "would still need an argmax and gathers"})
    if not all(equal.values()):
        raise SystemExit(f"match_iou_cuda disagrees with its twin: {equal}")
    if not (edges["iou_1"] and edges["iou_0.5"]
            and edges["images_without_gt"] == 1):
        raise SystemExit(f"the hard GT set lost its edges: {edges}")
    report["match_iou_cuda"] = {
        "name": "match_iou_cuda", "route": "cuda",
        "source": "detjax_torch/csrc/matching.cu",
        "replaces": "detjax/kernels/matching.py:88",
        "launches": None, "match": True,
        "max_abs_err": float((got[0] - want[0]).abs().max()),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None}


# The identity bottlenecks that fuse in R50 at 640 px, eval batch 8:
# (name, B, H, W, M, launches per forward); C = 4 M.
FUSED_SHAPES = (("layer1", 8, 160, 160, 64, 2), ("layer2", 8, 80, 80, 128, 3))
# Held to the twin too, outside the per-forward totals: layer2 of a 608x832
# canvas (W = 104, a masked tail tile).
EXTRA_FUSED_SHAPES = (("tail_608x832_layer2", 2, 76, 104, 128, None),)


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
    """The fused-block kernel against its twin (fp32 convs, TF32 off) at
    the two shapes R50's fused blocks have at 640 px, eval batch 8, with
    detjax's bars (tests/test_kernels.py:175-177); times beside the bound,
    the twin and the port's own unfused block (cuDNN, bf16 autocast)."""
    from detjax_torch.kernels import bottleneck as kb

    per_shape, extra = [], []
    for i, (name, b, h, w, m, n_fwd) in enumerate(FUSED_SHAPES
                                                  + EXTRA_FUSED_SHAPES):
        x, block = kb.seeded_block(10 + i, b, h, w, m, "cuda")
        with torch.no_grad():
            wts = block.folded_weights()
        got = kb.bottleneck_identity(x, *wts)
        with tf32_off():
            want = kb.bottleneck_identity_reference(x, *wts)
        torch.cuda.synchronize()
        gf, wf = got.float(), want.float()
        err = float((gf - wf).abs().max())
        tol = 0.05 * max(float(wf.abs().max()), 1.0)
        frac = float((got != want).float().mean())
        ulps = bf16_ulps(got, want)
        # the same error in bf16 steps at the output's largest magnitude
        ulp_at_max = 2.0 ** (np.floor(np.log2(float(wf.abs().max()))) - 7)
        finite = bool(torch.isfinite(gf).all())
        ms = cuda_ms(lambda: kb.bottleneck_identity(x, *wts), iters=20)
        with tf32_off():
            plain_ms = cuda_ms(
                lambda: kb.bottleneck_identity_reference(x, *wts), iters=5,
                warmup=1)
        x_nchw = x.permute(0, 3, 1, 2)  # channels-last view, no copy

        def unfused():
            with torch.autocast(x.device.type, dtype=torch.bfloat16):
                return block(x_nchw)
        with torch.inference_mode():
            unfused_ms = cuda_ms(unfused, iters=20)
        bound_ms, bound_by = bottleneck_bound_ms(b, h, w, m)
        row = {"shape": name, "B": b, "H": h, "W": w, "C": 4 * m, "M": m,
               "launches_per_forward": n_fwd, "max_abs_err": err,
               "tolerance": tol, "frac_differ": frac, "max_bf16_ulps": ulps,
               "max_err_in_bf16_ulps_at_max_twin": err / ulp_at_max,
               "ms": ms, "plain_ms": plain_ms, "unfused_cudnn_ms": unfused_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "smem_bytes": kb.smem_bytes(w, m)}
        emit({"phase": "bottleneck_kernel", "kernel": "bottleneck_identity",
              **row, "library_ms": None,
              "bars": "max |kernel - twin| <= 0.05 * max(|twin|, 1) and "
                      "under 1 % of elements differ (detjax's own): the "
                      "kernel sums fp32 in another order than cuDNN"})
        if not (finite and err <= tol and frac < 0.01):
            raise SystemExit(f"the bottleneck kernel disagrees with its twin "
                             f"at {name}: {row}")
        (per_shape if i < len(FUSED_SHAPES) else extra).append(row)
        del x, block, wts, got, want, gf, wf
    total = {k: sum(r[k] * r["launches_per_forward"] for r in per_shape)
             for k in ("ms", "plain_ms", "unfused_cudnn_ms", "bound_ms")}
    report["bottleneck_identity_cuda"] = {
        "name": "bottleneck_identity_cuda", "route": "cuda",
        "source": "detjax_torch/csrc/bottleneck.cu",
        "replaces": "detjax/kernels/bottleneck.py:131",
        "launches": None, "match": True,
        "max_abs_err": max(r["max_abs_err"] for r in per_shape),
        "ms": total["ms"], "plain_ms": total["plain_ms"],
        "bound_ms": total["bound_ms"],
        "bound_by": "/".join(sorted({r["bound_by"] for r in per_shape})),
        "library_ms": None,
        "library_note": "no single PyTorch call computes the fused block; "
                        "the port's unfused cuDNN block is unfused_cudnn_ms",
        "unfused_cudnn_ms": total["unfused_cudnn_ms"],
        "per": "one R50 forward at 640 px, bs 8: 2 layer1 + 3 layer2 "
               "launches",
        "shapes": per_shape, "extra_shapes": extra}


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


def kernel_ms_by_name(fn, calls: int = 3):
    """Device ms a call of ``fn`` spends in each CUDA kernel, and how many
    times a call launches each, from torch.profiler over ``calls`` calls;
    None when the profiler cannot trace the card or records no device
    time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
    except (AssertionError, RuntimeError) as exc:
        emit({"profiler": "no device trace", "error": repr(exc)})
        return None
    ms, launches = {}, {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", 0.0)
        if t > 0:  # "void (anonymous namespace)::y1_kernel<64>(...)"
            name = re.sub(r"^void |\(anonymous namespace\)::", "", e.key)
            name = re.split(r"[<(]", name)[0]
            ms[name] = ms.get(name, 0.0) + t / calls / 1e3
            launches[name] = launches.get(name, 0) + e.count / calls
    return (ms, launches) if ms else None


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
    (cuDNN, bf16 autocast). At those two shapes the backward is also timed
    in turns against the one at commits e8572c4 and 82723fd (PRIOR_BWD)
    and the one with every product on wmma (WMMA), and split
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
        timed_turns, kernel_split, traced = None, None, None
        if i < len(FUSED_TRAIN_SHAPES):
            # the current backward and each reference in turns, in one
            # call: e8572c4 and the all-wmma version each before and
            # after the current one's two turns, then 82723fd
            refs = PRIOR_BWD + (WMMA,)
            calls = {c: prior_bwd_call(c, x, dy, wts) for c in refs}
            calls["current"] = lambda: kb.bottleneck_identity_backward(*args)
            timed_turns = [(c, cuda_ms(calls[c], iters=10)) for c in
                           (PRIOR_BWD[0], WMMA, "current", "current",
                            WMMA, PRIOR_BWD[0], PRIOR_BWD[1])]
            ms = sum(t for c, t in timed_turns if c == "current") / 2
            traced = kernel_ms_by_name(calls["current"])
            kernel_split = traced and {"ms": traced[0],
                                       "launches_a_call": traced[1]}
            wmma_split = kernel_ms_by_name(calls[WMMA])
            if wmma_split:
                kernel_split[f"ms_{WMMA}"] = wmma_split[0]
            del calls
        else:
            ms = cuda_ms(lambda: kb.bottleneck_identity_backward(*args),
                         iters=10)
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
               "ms": ms, "timed_in_turns": timed_turns,
               "ms_by_kernel": kernel_split,
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
        del x, dy, block, wts, args, x_nchw, dy_nchw
    total = {k: sum(r[k] * r["launches_per_step"] for r in per_shape)
             for k in ("ms", "plain_ms", "unfused_cudnn_ms", "bound_ms",
                       "forward_kernel_ms")}
    for commit in PRIOR_BWD + (WMMA,):
        total[f"ms_at_{commit}"] = sum(
            np.mean([t for c, t in r["timed_in_turns"] if c == commit])
            * r["launches_per_step"] for r in per_shape)
    report["bottleneck_identity_bwd_cuda"] = {
        "name": "bottleneck_identity_bwd_cuda", "route": "cuda",
        "source": "detjax_torch/csrc/bottleneck_bwd.cu",
        "replaces": "detjax/kernels/bottleneck.py:270",
        "launches": None, "match": True,
        "max_abs_err": max(e["max_abs_err"] for r in per_shape
                           for e in r["outputs"].values()),
        "max_abs_err_note": "dx at an element whose ReLU mask flips "
                            "between the kernel's and cuDNN's fp32 sums",
        "ms": total["ms"], "plain_ms": total["plain_ms"],
        "bound_ms": total["bound_ms"],
        "bound_by": "/".join(sorted({r["bound_by"] for r in per_shape})),
        "library_ms": None,
        "library_note": "no single PyTorch call computes the fused block's "
                        "backward; the port's unfused cuDNN block, forward "
                        "and backward, is unfused_cudnn_ms",
        "unfused_cudnn_ms": total["unfused_cudnn_ms"],
        "forward_kernel_ms": total["forward_kernel_ms"],
        **{f"ms_at_{c}": total[f"ms_at_{c}"]
           for c in PRIOR_BWD + (WMMA,)},
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


def desaturate_(model, canvases, cfg) -> dict:
    """Rescale the two output convs of a seeded model so that on these
    canvases the class logits spread with std 2 around the prior bias and
    the box deltas with std 0.5. Random towers over identity BatchNorm
    otherwise give logits with a std near 17: every score saturates to 1.0
    and every decoded box clips to the whole canvas."""
    with torch.inference_mode():
        cls, box = model(normalized_nchw(model, canvases, cfg))
    scales = {"cls": 2.0 / float(cls.float().std()),
              "box": 0.5 / float(box.float().std())}
    with torch.no_grad():
        model.classificationModel.output.weight.mul_(scales["cls"])
        model.regressionModel.output.weight.mul_(scales["box"])
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

    pp.nms_launches = 0
    det = detjax_torch.detect_u8(model, canvases, cfg)
    torch.cuda.synchronize()
    launches = pp.nms_launches
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
        nms_ms = cuda_ms(lambda: pp.nms_cuda(*nms_args), iters=200)

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
          "nms_launches": launches,
          "identical_to_twin_route": identical,
          "tolerance": "keep-sets, scores and boxes bit-equal",
          "card": state["card"],
          "ms_per_batch": batch_ms, "img_per_s": b / batch_ms * 1e3,
          "latency_preset_ms_bs1": latency_ms,
          "forward_ms": fwd_ms, "postprocess_ms": post_ms,
          "select_ms": select_ms, "nms_kernel_ms": nms_ms})
    if not (finite and shapes_ok):
        raise SystemExit("detect_u8 returned non-finite or misshapen output")
    if launches < 1:
        raise SystemExit("the main path never launched the NMS kernel")
    if not identical:
        raise SystemExit("detect_u8 through the kernel differs from the "
                         "same call through the plain twin")
    if int(live_cands.min()) == 0 or int(det.num_valid.min()) == 0:
        raise SystemExit("no live candidates: the NMS ran over sentinels")
    report["nms_cuda"]["launches"] = launches
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
    beside fused_detect_postprocess on the same deltas and logits."""
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

    def branch(backend: str):
        with torch.inference_mode():
            x = normalize_u8(canvases, cfg.data.mean, cfg.data.std,
                             model.compute_dtype)
            cls, box = model(x.permute(0, 3, 1, 2))
            boxes = decode_clip_boxes(box.to(torch.float32), anchors,
                                      m.image_size, m.box_std,
                                      backend=backend)
            return batched_detect_postprocess(
                boxes, torch.sigmoid(cls.to(torch.float32)),
                e.score_threshold, e.nms_iou_threshold, e.pre_nms_top_k,
                e.max_detections, backend=backend)

    branch("auto")  # warm-up
    torch.cuda.synchronize()
    pp.decode_launches = pp.nms_launches = 0
    det = branch("auto")
    torch.cuda.synchronize()
    launches = {"decode": pp.decode_launches, "nms": pp.nms_launches}
    twin = branch("torch")
    torch.cuda.synchronize()
    identical = same_detections(det, twin)
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
        nms_ms = cuda_ms(lambda: pp.nms_cuda(*nms_args), iters=50)
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
          "nms_kernel_ms_640_rows": nms_ms,
          "fused_detect_postprocess_ms": fused_ms,
          "fused_pairs_found_in_branch": [found, total],
          "card": state["card"]})
    if not (finite and shapes_ok):
        raise SystemExit("the eval branch returned non-finite or misshapen "
                         "detections")
    if launches != {"decode": 1, "nms": 1}:
        raise SystemExit(f"expected 1 decode and 1 NMS launch a batch, got "
                         f"{launches}")
    if not identical:
        raise SystemExit("the eval branch through the kernels differs from "
                         "its twin route")
    if int(det.num_valid.min()) == 0:
        raise SystemExit("the eval branch kept no detection")
    report["decode_boxes_cuda"]["launches"] = launches["decode"]


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
    from detjax_torch.modeling import _anchors, anchor_config
    from detjax_torch.ops import nms as ops_nms

    cfg = smoke_config(**{"model.fused_backbone": "on"})
    b, e = cfg.eval.batch_size, cfg.eval
    canvases = seeded_canvases(1, b)
    model = detjax_torch.build_model(cfg, seed=0)
    scales = desaturate_(model, canvases, cfg)
    n_fused = len(model.fused_blocks())
    detjax_torch.detect_u8(model, canvases, cfg)  # warm-up
    torch.cuda.synchronize()

    kb.bottleneck_launches = 0
    det = detjax_torch.detect_u8(model, canvases, cfg)
    torch.cuda.synchronize()
    launches = kb.bottleneck_launches
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
    batch_ms = host_ms(model, cfg, canvases)

    model.bottleneck_backend = "torch"
    with tf32_off():
        twin = detjax_torch.detect_u8(model, canvases, cfg)
        with torch.inference_mode():
            cls_t, box_t = model(x)
    model.bottleneck_backend = "auto"
    unfused_cfg = smoke_config()
    unfused = detjax_torch.build_model(unfused_cfg, seed=0)
    unfused.load_state_dict(model.state_dict())
    det_unfused = detjax_torch.detect_u8(unfused, canvases, unfused_cfg)
    del unfused
    torch.cuda.synchronize()

    errs = {}
    for key, got, want in (("cls", cls_k, cls_t), ("box", box_k, box_t)):
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
            "unfused_path": kept_pairs_found(twin, det_unfused,
                                             select=sel)[0]}
    total = pairs["0_steps"]["twin_pairs"]
    clear = pairs[f"{CLEAR_STEPS}_steps"]
    shapes_ok = (tuple(det.boxes.shape) == (b, cfg.eval.max_detections, 4)
                 and bool(torch.isfinite(det.boxes).all()))
    main = state["main"]
    emit({"phase": "main_fused", "preset": cfg.model.name,
          "fused_backbone": cfg.model.fused_backbone,
          "dtype": cfg.model.dtype, "batch": b, "model_seed": 0,
          "canvas_seed": 1,
          "fused_blocks": n_fused, "bottleneck_launches": launches,
          "output_scales": scales, "outputs_vs_twin_route": errs,
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
          "unfused_ms_per_batch": main["ms_per_batch"],
          "unfused_img_per_s": main["img_per_s"],
          "unfused_forward_ms": main["forward_ms"]})
    if launches != 5 or n_fused != 5:
        raise SystemExit(f"expected 5 fused-block launches in one forward "
                         f"of R50, got {launches} ({n_fused} fused blocks)")
    if not shapes_ok or not all(e["finite"] and e["max_abs_err"]
                                <= e["tolerance"] for e in errs.values()):
        raise SystemExit(f"the fused kernel route differs from the twin "
                         f"route: {errs}")
    if (clear["twin_pairs"] < 0.05 * total
            or clear["kernel_route"] < 0.95 * clear["twin_pairs"]):
        raise SystemExit(f"the kernel route found {clear['kernel_route']} "
                         f"of the twin route's {clear['twin_pairs']} clear "
                         f"kept pairs ({total} kept in all)")
    report["bottleneck_identity_cuda"]["launches"] = launches
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
    km.match_launches = 0
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
          "ms_per_step": step_ms, "img_per_s": b / step_ms * 1e3,
          "split_one_step": split, "peak_memory_gib": peak_gb,
          "card": state["card"]})
    if not finite:
        raise SystemExit("a training metric is not finite")
    if min(m["num_pos"] for m in per_step) <= 0:
        raise SystemExit("a training step had no positive anchor")
    if launches != len(steps):
        raise SystemExit(f"match kernel launched {launches} times in "
                         f"{len(steps)} steps")
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
    kb.bottleneck_bwd_kernel_launches = kb.bottleneck_bwd_grad_copies = 0
    km.match_launches = 0
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
    bwd_kernels = kb.bottleneck_bwd_kernel_launches
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    order = ["start", "forward", "loss", "backward", "update"]
    split = {f"{b_}_ms": events[a_].elapsed_time(events[b_])
             for a_, b_ in zip(order, order[1:])}
    split["step_ms"] = events["start"].elapsed_time(events["update"])
    per_step = [{k: float(v) for k, v in m.items()} for m in steps]
    finite = all(np.isfinite(list(m.values())).all() for m in per_step)
    unfused = state["train"]
    emit({"phase": "train_fused", "preset": cfg.model.name,
          "fused_backbone": cfg.model.fused_backbone,
          "dtype": cfg.model.dtype, "batch": b,
          "canvas": list(cfg.model.image_size),
          "output_scales": scales, "setup_s": setup_s,
          "steps_in_window": n, "launches_in_window": launches,
          "launches_per_step": {k: v / n for k, v in launches.items()},
          "bottleneck_bwd_cuda_kernels_per_step": bwd_kernels / n,
          "grad_out_copies_per_step": copies / n,
          "losses": [m["loss"] for m in per_step],
          "ms_per_step": step_ms, "img_per_s": b / step_ms * 1e3,
          "split_one_step": split, "peak_memory_gib": peak_gb,
          "unfused_ms_per_step": unfused["ms_per_step"],
          "unfused_img_per_s": unfused["img_per_s"],
          "unfused_split_one_step": unfused["split_one_step"],
          "unfused_peak_memory_gib": unfused["peak_memory_gib"],
          "card": state["card"]})
    if not finite:
        raise SystemExit("a fused training metric is not finite")
    if launches != {"bottleneck_fwd": 5 * n, "bottleneck_bwd": 5 * n,
                    "match": n}:
        raise SystemExit(f"expected 5 forward, 5 backward fused-block "
                         f"launches and 1 matching launch a step in {n} "
                         f"steps, got {launches}")
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
    the rest within 1 bf16 step. Times beside the bound, the twin and
    ATen's backward (the library yardstick)."""
    from detjax_torch.kernels import stem as ks

    rows = []
    for i, (name, b, hz, wz, c) in enumerate(STEM_SHAPES):
        z, dp = pool_inputs(40 + i, b, hz, wz, c, torch.bfloat16)
        zh, dph = pool_inputs(50 + i, b, hz, wz, c, torch.bfloat16,
                              hard=True)
        got = ks.maxpool_bwd_cuda(z, dp)
        again = ks.maxpool_bwd_cuda(z, dp)
        want = ks.maxpool_bwd_reference(z, dp)
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
        ms = cuda_ms(lambda: ks.maxpool_bwd_cuda(z, dp), iters=50, warmup=5)
        plain_ms = cuda_ms(lambda: ks.maxpool_bwd_reference(z, dp), iters=5,
                           warmup=1)
        aten_ms = cuda_ms(lambda: aten_pool_bwd(z, dp, idx), iters=50,
                          warmup=5)
        bound_ms, bound_by = maxpool_bwd_bound_ms(b, hz, wz, c, 2)
        row = {"shape": name, "z": [b, c, hz, wz], "dtype": "bfloat16",
               "bit_equal_post_relu": bit_equal, "bit_equal_hard": hard_equal,
               "hard_has_nan": hard_nan, "bit_equal_fp32": fp32_equal,
               "bit_equal_across_two_runs": twice,
               "max_abs_err_twin": twin_err, "aten_same_support": support,
               "aten_frac_bit_equal": frac_equal,
               "aten_max_bf16_ulps": ulps, "aten_max_abs_err": err,
               "ms": ms, "plain_ms": plain_ms, "aten_bwd_ms": aten_ms,
               "bound_ms": bound_ms, "bound_by": bound_by}
        emit({"phase": "maxpool_bwd_kernel", "kernel": "maxpool_bwd_cuda",
              **row, "bars": "bit-equal to the twin (post-ReLU, hard, fp32 "
                             "at 640), two runs bit-equal; against ATen "
                             "on post-ReLU z: same support, >= 99.9 % "
                             "bit-equal, the rest within 1 bf16 step"})
        ok = bit_equal and hard_equal and hard_nan and twice and \
            fp32_equal is not False
        ok = ok and support and frac_equal >= 0.999 and ulps <= 1
        if not ok:
            raise SystemExit(f"the max-pool backward kernel disagrees at "
                             f"{name}: {row}")
        rows.append(row)
        del z, dp, idx
    main = rows[0]
    report["maxpool_bwd_cuda"] = {
        "name": "maxpool_bwd_cuda", "route": "cuda",
        "source": "detjax_torch/csrc/maxpool_bwd.cu",
        "replaces": "detjax/kernels/stem.py:163",
        "launches": None, "match": True,
        "max_abs_err": max(r["max_abs_err_twin"] for r in rows),
        "max_abs_err_note": "against its twin, post-ReLU z; against ATen's "
                            "backward see aten_max_abs_err",
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": main["aten_bwd_ms"],
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
    grads_k = routes["kernel"]()
    torch.cuda.synchronize()
    launches, copies = ks.maxpool_bwd_launches, ks.maxpool_bwd_copies
    row = {"preset": preset, "x": [b, 3, hh, ww],
           "z": [b, 64, hh // 2, ww // 2], "launches_per_backward": launches,
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
    if launches != 1 or copies != 0:
        raise SystemExit(f"expected 1 max-pool backward launch and 0 copies "
                         f"in one stem backward at {preset}, got {launches} "
                         f"and {copies}")
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    import detjax_torch  # noqa: F401  (fails outside a checkout)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip()
    print(card, flush=True)
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
    phase_train(report, state)
    phase_train_fused(report, state)
    phase_maxpool_bwd_kernel(report)
    phase_stem(report, state)
    emit({"kernels": list(report.values())})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
