"""Smoke run of the PyTorch port on one NVIDIA GPU.

Drives ``detjax_torch``'s serving path (RetinaNet-R50-FPN at 640, eval
batch 8, bf16, seeded random weights) and its training path (the same
model, train batch 16, bf16 autocast over fp32 parameters, Adam, clip
0.1, synthetic scenes) through the entry points a user calls. Builds
every CUDA kernel of those paths from ``detjax_torch/csrc/`` (one nvcc per
source, all started together), holds each kernel against its plain
PyTorch twin on the card, and checks that each path really launched its
kernel. Prints JSON lines; the last line is ``{"ok": true, "device":
{...}}`` and appears only when every phase passed. Exits non-zero without
a CUDA device.

    python3 chip_smoke.py
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import threading
import time

import numpy as np
import torch

H100 = {"bytes_per_s": 3.35e12, "fp32_flops": 67e12}  # SXM data sheet


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


def phase_build() -> None:
    """Build every kernel library at once, one nvcc process per source."""
    from detjax_torch.kernels import matching as km
    from detjax_torch.kernels import postprocess as pp
    from detjax_torch.kernels._build import build_info

    libs = {"detjax_nms": ("nms.cu", pp._lib),
            "detjax_match": ("matching.cu", km._lib)}
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
              "source": f"detjax_torch/csrc/{source}", "target": "sm_90a",
              "nvcc_s": info["seconds"], "parallel_wall_s": wall_s,
              "ptxas": [ln for ln in info["log"].splitlines()
                        if "registers" in ln or "smem" in ln]})


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
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.inference_mode():
            want = cpu(normalized_nchw(cpu, canvases, cfg))
            got = [t.cpu() for t in gpu(normalized_nchw(gpu, canvases, cfg))]
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = flags
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

    def host_ms(cfg_run, batch, iters=20) -> float:
        """Host clock per detect_u8 call, results copied to the host."""
        def one():
            return [t.cpu() for t in detjax_torch.detect_u8(model, batch,
                                                            cfg_run)]
        one()
        t0 = time.perf_counter()
        for _ in range(iters):
            one()
        return (time.perf_counter() - t0) / iters * 1e3

    batch_ms = host_ms(cfg, canvases)
    latency_cfg = detjax_torch.get_config(
        "retinanet_r50_640_latency", **{"model.prior_prob": PRIOR_PROB})
    latency_ms = host_ms(latency_cfg, canvases[:1])

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
    state.update(model=model, cfg=cfg)


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
    phase_match_kernel(report)
    phase_reference()
    phase_main(report, state)
    phase_serve(state)
    phase_train(report, state)
    emit({"kernels": list(report.values())})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
