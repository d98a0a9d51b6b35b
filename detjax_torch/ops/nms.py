"""Greedy NMS, the per-class NMS of the eval branch, candidate selection
and the fused detect postprocess.

The counterpart of ``detjax/ops/nms.py``, batched over leading dims written
out (detjax vmaps one-image functions). Two paths, as in detjax:

- :func:`batched_detect_postprocess` / :func:`class_aware_nms`, the exact
  per-class path over fully decoded boxes: per class a threshold, a top
  ``pre_nms_top_k``, greedy NMS keeping ``per_class_max``
  (:func:`nms_single_class`), then the global top ``max_detections`` of
  the pooled survivors.
- :func:`fused_detect_postprocess`, the production path: per image the top
  ``num_candidates`` (anchor, class) pairs by score, decode and clip of
  only those, then ONE greedy NMS pass over class-offset boxes, which
  equals per-class NMS merged in score order.

Both greedy passes run on the card through the CUDA NMS kernel
(``detjax_torch.kernels.postprocess.nms_cuda``); the per-class pass gives
it one row per (image, class), labels 0 and a class offset of 0, which
leaves every box unchanged, so it equals :func:`_greedy_suppress` bit for
bit.

Semantics kept from detjax, each one a place where a port can drift:

- Ties go to the lowest index everywhere: ``lax.top_k`` promises it and
  ``torch.topk`` does not, so every top-k here is a stable descending
  ``torch.sort`` followed by a slice; ``torch.argmax`` returns the first
  maximum.
- Candidate selection can run in the logit domain: the probability
  threshold moves to logit space, with t <= 0 -> -inf (keep every pair) and
  t >= 1 -> +inf (keep none), and the sigmoid is applied only to the
  winners. The -1e10 sentinel survives the sigmoid step.
- The threshold is compared in the scores' own dtype. detjax compares a
  bf16 tensor with a weakly typed Python float, i.e. with the threshold
  rounded to bf16; ATen's CUDA comparison keeps a Python scalar in fp32,
  so the threshold is rounded to the scores' dtype here first.
- Scores are cast to fp32 after the threshold, never before.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from detjax_torch.ops.boxes import box_iou, clip_boxes, decode_boxes

NEG_INF = -1e10

# Below this many (anchor, class) pairs the exact global top-k is cheap
# enough to always use (tests monkeypatch this to force the two-stage path).
_EXACT_PAIRS_MAX = 1 << 16

_TOPK_MODES = ("auto", "exact", "partial")


_BACKENDS = ("auto", "cuda", "torch")


class NMSResult(NamedTuple):
    indices: torch.Tensor  # [..., max_output] int32 into the input, -1 pad
    scores: torch.Tensor  # [..., max_output] f32, 0 padding
    num_valid: torch.Tensor  # [...] int32


class Detections(NamedTuple):
    """Final static-shape detections for a batch."""

    boxes: torch.Tensor  # [B, D, 4] xyxy
    scores: torch.Tensor  # [B, D]
    labels: torch.Tensor  # [B, D] int32, -1 padding
    num_valid: torch.Tensor  # [B] int32


def _greedy_suppress(boxes: torch.Tensor, scores: torch.Tensor,
                     iou_threshold: float,
                     max_output: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """THE greedy-NMS oracle, the plain twin of the CUDA NMS kernel.

    boxes [..., N, 4], scores [..., N] (entries <= NEG_INF/2 are
    pre-suppressed). ``max_output`` sequential steps; each takes the best
    live score (lowest index on ties), keeps it while it is above
    NEG_INF/2, and suppresses itself and every box with IoU > threshold.
    Returns ``(keep_idx [..., max_output] int32 with -1 padding,
    keep_scores [..., max_output] f32 with 0 padding)``.
    """
    lead, n = scores.shape[:-1], scores.shape[-1]
    boxes = boxes.to(torch.float32).reshape(-1, n, 4)
    live = scores.to(torch.float32).reshape(-1, n)
    b, dev = live.shape[0], live.device
    col = torch.arange(n, device=dev)[None, :]
    keep_idx = torch.full((b, max_output), -1, dtype=torch.int32, device=dev)
    keep_scores = torch.zeros((b, max_output), dtype=torch.float32, device=dev)
    for i in range(max_output):
        best = torch.argmax(live, dim=1)  # first maximum: lowest index
        best_score = live.gather(1, best[:, None])[:, 0]
        valid = best_score > NEG_INF / 2
        best_box = boxes.gather(1, best[:, None, None].expand(b, 1, 4))
        iou = box_iou(best_box, boxes)[:, 0]  # [b, N]
        suppress = (iou > iou_threshold) | (col == best[:, None])
        live = torch.where(valid[:, None] & suppress, NEG_INF, live)
        keep_idx[:, i] = torch.where(valid, best.to(torch.int32), -1)
        keep_scores[:, i] = torch.where(valid, best_score, 0.0)
    return (keep_idx.reshape(*lead, max_output),
            keep_scores.reshape(*lead, max_output))


def _resolve_backend(backend: str, t: torch.Tensor) -> str:
    if backend not in _BACKENDS:
        raise ValueError(f"backend must be one of {_BACKENDS}, got "
                         f"{backend!r}")
    if backend == "auto":
        return "cuda" if t.is_cuda else "torch"
    return backend


def nms_single_class(boxes: torch.Tensor, scores: torch.Tensor,
                     iou_threshold: float = 0.5, max_output: int = 100, *,
                     backend: str = "auto") -> NMSResult:
    """Greedy NMS with a static output size over boxes [..., N, 4] and
    scores [..., N] (entries <= NEG_INF/2 are pre-suppressed); each
    leading index is one independent set.

    ``backend``: "cuda" runs the NMS kernel (one row per set, labels 0,
    class offset 0; its plain twin for CPU tensors), "torch" the plain
    twin :func:`_greedy_suppress`; "auto" is "cuda" for a CUDA tensor.
    """
    lead, n = scores.shape[:-1], scores.shape[-1]
    if _resolve_backend(backend, scores) == "cuda":
        from detjax_torch.kernels.postprocess import nms_cuda

        flat_scores = scores.to(torch.float32).reshape(-1, n).contiguous()
        keep_idx, keep_scores = nms_cuda(
            boxes.to(torch.float32).reshape(-1, n, 4).contiguous(),
            flat_scores, torch.zeros_like(flat_scores, dtype=torch.int32),
            iou_threshold=iou_threshold, max_det=max_output,
            class_offset=0.0)
        keep_idx = keep_idx.reshape(*lead, max_output)
        keep_scores = keep_scores.reshape(*lead, max_output)
    else:
        keep_idx, keep_scores = _greedy_suppress(boxes, scores,
                                                 iou_threshold, max_output)
    return NMSResult(keep_idx, keep_scores,
                     (keep_idx >= 0).sum(dim=-1).to(torch.int32))


def _per_class_candidates(boxes: torch.Tensor, scores: torch.Tensor,
                         score_threshold: float, pre_nms_top_k: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-class NMS inputs of :func:`class_aware_nms`: per image and
    class, scores above the threshold (compared in fp32, the rest set to
    NEG_INF) and their top ``pre_nms_top_k`` by score, ties to the lowest
    anchor index, with their boxes. boxes [..., A, 4], scores [..., A, K]
    -> ``(boxes [B, K, pre_k, 4] f32, scores [B, K, pre_k] f32)`` with the
    leading dims flattened to B."""
    a, k = scores.shape[-2:]
    bsz = math.prod(scores.shape[:-2])
    boxes = boxes.to(torch.float32).reshape(bsz, a, 4)
    pre_k = min(pre_nms_top_k, a)
    scores_t = scores.reshape(bsz, a, k).transpose(1, 2).to(torch.float32)
    thr = _threshold(score_threshold, False, torch.float32)
    scores_t = torch.where(scores_t > thr, scores_t, NEG_INF)  # [bsz, K, A]
    top_scores, top_idx = _top_n(scores_t, pre_k)  # [bsz, K, pre_k]
    top_boxes = boxes.gather(
        1, top_idx.reshape(bsz, k * pre_k, 1).expand(bsz, k * pre_k, 4)
    ).reshape(bsz, k, pre_k, 4)
    return top_boxes, top_scores


def class_aware_nms(boxes: torch.Tensor, scores: torch.Tensor,
                    score_threshold: float = 0.05,
                    iou_threshold: float = 0.5, pre_nms_top_k: int = 1000,
                    max_detections: int = 100, per_class_max: int = 100, *,
                    backend: str = "auto") -> Detections:
    """Class-aware NMS over class-agnostic decoded boxes [..., A, 4] and
    per-class probabilities [..., A, K]; each leading index is one image.

    Per class: scores above ``score_threshold`` (compared in fp32), the top
    ``pre_nms_top_k`` (ties to the lowest anchor index), greedy NMS keeping
    ``per_class_max`` (:func:`nms_single_class`, all classes of all images
    in one pass) -> pool the classes -> the global top ``max_detections``
    by score. Returns :class:`Detections` with the leading dims.
    """
    lead, k = scores.shape[:-2], scores.shape[-1]
    bsz = math.prod(lead)
    top_boxes, top_scores = _per_class_candidates(boxes, scores,
                                                  score_threshold,
                                                  pre_nms_top_k)
    res = nms_single_class(top_boxes, top_scores, iou_threshold,
                           per_class_max, backend=backend)
    # pool the per-class survivors, then the global top-k by score
    valid = res.indices >= 0  # [bsz, K, per_class_max]
    safe = res.indices.clamp(min=0).to(torch.int64)
    pooled_scores = torch.where(valid, res.scores, NEG_INF).reshape(bsz, -1)
    pooled_boxes = top_boxes.gather(
        2, safe[..., None].expand(*safe.shape, 4)).reshape(bsz, -1, 4)
    pooled_labels = torch.arange(k, dtype=torch.int32, device=scores.device
                                 )[:, None].expand(k, safe.shape[-1])
    pooled_labels = pooled_labels.reshape(-1)

    d = min(max_detections, pooled_scores.shape[1])
    final_scores, sel = _top_n(pooled_scores, d)
    keep = final_scores > NEG_INF / 2
    out_boxes = pooled_boxes.gather(1, sel[..., None].expand(bsz, d, 4))
    return Detections(
        boxes=torch.where(keep[..., None], out_boxes, 0.0).reshape(
            *lead, d, 4),
        scores=torch.where(keep, final_scores, 0.0).reshape(*lead, d),
        labels=torch.where(keep, pooled_labels[sel], -1).to(
            torch.int32).reshape(*lead, d),
        num_valid=keep.sum(dim=-1).to(torch.int32).reshape(lead),
    )


def batched_detect_postprocess(boxes: torch.Tensor, scores: torch.Tensor,
                               score_threshold: float = 0.05,
                               iou_threshold: float = 0.5,
                               pre_nms_top_k: int = 1000,
                               max_detections: int = 100, *,
                               backend: str = "auto") -> Detections:
    """:func:`class_aware_nms` over a batch: decoded and clipped boxes
    [B, A, 4], per-class probabilities [B, A, K]. The exact per-class
    reference path; :func:`fused_detect_postprocess` is the production
    path (the same detections on the shared candidate set)."""
    return class_aware_nms(boxes, scores, score_threshold, iou_threshold,
                           pre_nms_top_k, max_detections, backend=backend)


def _top_n(values: torch.Tensor, n: int):
    """Top ``n`` along the last dim, descending, ties to the lowest index
    (``lax.top_k`` order)."""
    vals, idx = torch.sort(values, dim=-1, descending=True, stable=True)
    return vals[..., :n], idx[..., :n]


def _threshold(score_threshold: float, scores_are_logits: bool,
               dtype: torch.dtype) -> float:
    """The score threshold in the domain and dtype the scores are in."""
    t = float(score_threshold)
    if scores_are_logits:
        # exact transport of the probability threshold into logit space,
        # including the extremes: t<=0 keeps every pair, t>=1 keeps none
        if t <= 0.0:
            t = -math.inf
        elif t >= 1.0:
            t = math.inf
        else:
            t = math.log(t) - math.log1p(-t)
    return float(torch.tensor(t, dtype=dtype))


def _select_candidates(
    deltas: torch.Tensor,  # [B, A, 4] raw box regression
    anchors: torch.Tensor,  # [A, 4]
    scores: torch.Tensor,  # [B, A, K] probabilities, or raw logits
    box_std,
    image_size,
    score_threshold: float,
    num_candidates: int,
    exact: bool,
    scores_are_logits: bool = False,
):
    """Candidate (anchor, class) pairs by score -> decoded, clipped boxes.

    ``exact`` (or A*K <= ``_EXACT_PAIRS_MAX``): one global top-n over all
    A*K pairs, the oracle. Otherwise two-stage: max over classes, the top
    n anchors, then the top n pairs over the gathered [n, K] slab.
    Returns ``(boxes [B, n, 4] f32, scores [B, n] f32, labels [B, n] int64)``.
    """
    bsz, a, k = scores.shape
    n = min(num_candidates, a * k)
    thr = _threshold(score_threshold, scores_are_logits, scores.dtype)
    if exact or a * k <= _EXACT_PAIRS_MAX:
        flat = torch.where(scores > thr, scores, NEG_INF)
        flat = flat.to(torch.float32).reshape(bsz, a * k)
        cand_scores, cand_flat = _top_n(flat, n)
        cand_anchor = cand_flat // k
        cand_label = cand_flat % k
    else:
        n_anchor = min(n, a)
        best_per_anchor = scores.amax(dim=-1)  # [B, A]
        _, top_anchor = _top_n(best_per_anchor.to(torch.float32), n_anchor)
        slab = scores.gather(1, top_anchor[..., None].expand(bsz, n_anchor, k))
        slab = torch.where(slab > thr, slab, NEG_INF).to(torch.float32)
        cand_scores, flat_idx = _top_n(slab.reshape(bsz, n_anchor * k), n)
        cand_anchor = top_anchor.gather(1, flat_idx // k)
        cand_label = flat_idx % k
    if scores_are_logits:  # sigmoid on the n winners only; keep the sentinel
        cand_scores = torch.where(cand_scores > NEG_INF / 2,
                                  torch.sigmoid(cand_scores), NEG_INF)
    cand_deltas = deltas.gather(1, cand_anchor[..., None].expand(bsz, n, 4))
    cand_boxes = decode_boxes(cand_deltas, anchors[cand_anchor], box_std)
    cand_boxes = clip_boxes(cand_boxes, image_size)
    return cand_boxes, cand_scores.contiguous(), cand_label


def fused_detect_postprocess(
    deltas: torch.Tensor,  # [B, A, 4] raw box regression output, fp32
    anchors: torch.Tensor,  # [A, 4]
    scores: torch.Tensor,  # [B, A, K] probabilities or logits
    box_std=(0.1, 0.1, 0.2, 0.2),
    image_size=(640, 640),
    score_threshold: float = 0.05,
    iou_threshold: float = 0.5,
    num_candidates: int = 1000,
    max_detections: int = 100,
    exact: bool = False,
    backend: str = "auto",  # "auto" | "cuda" | "torch"
    scores_are_logits: bool = False,
    topk: str = "auto",  # "auto" | "exact" | "partial"
) -> Detections:
    """Candidate selection -> decode/clip -> one class-offset greedy NMS.

    ``backend="auto"`` is "cuda" for a CUDA tensor (the hand-written NMS
    kernel, ``detjax_torch.kernels.postprocess.nms_cuda``, called through
    the custom op ``detjax_torch::nms``) and "torch" for
    a CPU tensor (the plain twin :func:`_greedy_suppress`). "torch" on a
    CUDA tensor runs the twin on the card, the comparison route.

    ``topk``: every mode takes the exact stable sort here. "auto" resolves
    to it off the TPU in detjax too, and "partial" only permits a different
    order within exact-score ties, so the sort is a valid lowering of it.
    """
    if topk not in _TOPK_MODES:
        raise ValueError(f"topk must be one of {_TOPK_MODES}, got {topk!r}")
    backend = _resolve_backend(backend, deltas)
    cand_boxes, cand_scores, cand_label = _select_candidates(
        deltas, anchors, scores, box_std, image_size, score_threshold,
        num_candidates, exact, scores_are_logits)

    offset = float(max(image_size) + 2)
    if backend == "cuda":
        # through the custom op, so that an exported program takes the
        # same route (detjax_torch/kernels/ops.py)
        from detjax_torch.kernels import ops

        keep_idx, keep_scores = ops.nms(
            cand_boxes, cand_scores, cand_label.to(torch.int32),
            float(iou_threshold), int(max_detections), offset)
    else:
        off_boxes = cand_boxes + (
            cand_label.to(torch.float32) * offset)[..., None]
        keep_idx, keep_scores = _greedy_suppress(
            off_boxes, cand_scores, iou_threshold, max_detections)

    valid = keep_idx >= 0
    safe = keep_idx.clamp(min=0).to(torch.int64)
    boxes = cand_boxes.gather(1, safe[..., None].expand(*safe.shape, 4))
    labels = cand_label.gather(1, safe)
    return Detections(
        boxes=torch.where(valid[..., None], boxes, 0.0),
        scores=keep_scores,
        labels=torch.where(valid, labels, -1).to(torch.int32),
        num_valid=valid.sum(dim=-1).to(torch.int32),
    )

