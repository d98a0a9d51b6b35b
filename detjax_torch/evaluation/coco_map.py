"""COCOeval-compatible bbox mAP in numpy (``detjax/evaluation/coco_map.py``).

A copy of detjax's re-implementation of the pycocotools ``COCOeval`` bbox
protocol:

  * IoU thresholds T = 0.50:0.05:0.95 (10)
  * recall thresholds R = 0:0.01:1 (101-point interpolation)
  * area ranges: all / small(<32²) / medium(32²–96²) / large(>96²)
  * maxDets = (1, 10, 100)
  * crowd GTs: IoU = inter / det_area; matchable many times; never count
    as FN; matches to them are ignored
  * GT "ignore": iscrowd or area outside range; ignored GTs sorted last in
    matching; detections matched to ignored GTs are ignored
  * unmatched detections outside the area range are ignored (not FPs)
  * detections sorted by score with stable mergesort (tie → input order);
    per-image detections truncated to maxDets *after* sorting
  * precision envelope: monotone non-increasing from the right

Inputs are plain Python/numpy structures — no pycocotools objects.

A C++ fast path for the per-image IoU and greedy matching lives in
``detjax_torch/native`` (same algorithm, same results); this numpy version
is the reference and always available (``DETJAX_NATIVE=0`` forces it).
"""

from __future__ import annotations

import dataclasses
import os
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}
MAX_DETS = (1, 10, 100)


@dataclasses.dataclass
class GroundTruth:
    """Per-image ground truth. boxes xyxy; area defaults to box area but COCO
    uses the annotation's segmentation area when available."""

    boxes: np.ndarray  # [G, 4] xyxy
    labels: np.ndarray  # [G] int
    iscrowd: Optional[np.ndarray] = None  # [G] bool
    areas: Optional[np.ndarray] = None  # [G] float

    def __post_init__(self):
        g = len(self.boxes)
        self.boxes = np.asarray(self.boxes, dtype=np.float64).reshape(g, 4)
        self.labels = np.asarray(self.labels, dtype=np.int64).reshape(g)
        if self.iscrowd is None:
            self.iscrowd = np.zeros(g, dtype=bool)
        else:
            self.iscrowd = np.asarray(self.iscrowd, dtype=bool).reshape(g)
        if self.areas is None:
            w = np.maximum(self.boxes[:, 2] - self.boxes[:, 0], 0)
            h = np.maximum(self.boxes[:, 3] - self.boxes[:, 1], 0)
            self.areas = w * h
        else:
            self.areas = np.asarray(self.areas, dtype=np.float64).reshape(g)


def _use_native() -> bool:
    if os.environ.get("DETJAX_NATIVE", "1") == "0":
        return False
    from detjax_torch import native

    return native.available()


def _iou_xyxy(det: np.ndarray, gt: np.ndarray, iscrowd: np.ndarray) -> np.ndarray:
    """[D,4] × [G,4] → [D,G]; crowd GT uses IoU = inter / det_area
    (pycocotools maskApi ``iou`` semantics)."""
    if len(det) == 0 or len(gt) == 0:
        return np.zeros((len(det), len(gt)))
    if _use_native():
        from detjax_torch import native

        return native.iou_xyxy(det, gt, iscrowd)
    lt = np.maximum(det[:, None, :2], gt[None, :, :2])
    rb = np.minimum(det[:, None, 2:], gt[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    det_area = np.maximum(det[:, 2] - det[:, 0], 0) * np.maximum(det[:, 3] - det[:, 1], 0)
    gt_area = np.maximum(gt[:, 2] - gt[:, 0], 0) * np.maximum(gt[:, 3] - gt[:, 1], 0)
    union = det_area[:, None] + gt_area[None, :] - inter
    denom = np.where(iscrowd[None, :], det_area[:, None], union)
    return inter / np.maximum(denom, 1e-12)


def _evaluate_img(
    det_boxes: np.ndarray,  # [D,4] already sorted by -score, capped at maxDet
    det_areas: np.ndarray,  # [D]
    gt: GroundTruth,
    gt_sel: np.ndarray,  # indices of GTs of this category
    area_rng: Tuple[float, float],
    ious: np.ndarray,  # [D, len(gt_sel)] precomputed (sorted-det × sorted-gt order)
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Greedy per-image matching for all IoU thresholds at once.

    Returns (dtm [T,D] matched-gt-flag∈{0,1}, dt_ignore [T,D], gt_ignore [G']).
    Mirrors COCOeval.evaluateImg.
    """
    t_n = len(IOU_THRS)
    d_n = len(det_boxes)
    g_areas = gt.areas[gt_sel]
    g_crowd = gt.iscrowd[gt_sel]
    gt_ig = g_crowd | (g_areas < area_rng[0]) | (g_areas > area_rng[1])
    # sort gts: non-ignored first (stable) — COCOeval's gtind ordering
    order = np.argsort(gt_ig, kind="stable")
    gt_ig = gt_ig[order]
    g_crowd = g_crowd[order]
    ious = ious[:, order] if ious.size else ious
    g_n = len(gt_sel)

    if _use_native():
        from detjax_torch import native

        dtm, dt_ig = native.match_image(
            ious if ious.size else np.zeros((d_n, g_n)),
            gt_ig, g_crowd, det_areas, area_rng, IOU_THRS)
        return dtm, dt_ig, gt_ig

    dtm = np.zeros((t_n, d_n), dtype=np.int64)  # 1 + matched gt slot, 0 = unmatched
    gtm = np.zeros((t_n, g_n), dtype=np.int64)
    dt_ig_m = np.zeros((t_n, d_n), dtype=bool)  # matched to an ignored gt
    for ti, t in enumerate(IOU_THRS):
        for d in range(d_n):
            best_iou = min(t, 1 - 1e-10)
            m = -1
            for g in range(g_n):
                if gtm[ti, g] > 0 and not g_crowd[g]:
                    continue
                if m > -1 and not gt_ig[m] and gt_ig[g]:
                    break  # remaining gts are all ignored; keep real match
                if ious[d, g] < best_iou:
                    continue
                best_iou = ious[d, g]
                m = g
            if m == -1:
                continue
            dtm[ti, d] = m + 1
            dt_ig_m[ti, d] = gt_ig[m]
            if not g_crowd[m]:
                gtm[ti, m] = d + 1
            elif not gt_ig[m]:
                gtm[ti, m] = d + 1  # unreachable (crowd ⇒ ignored); kept for parity
    out_rng = (det_areas < area_rng[0]) | (det_areas > area_rng[1])
    dt_ig = dt_ig_m | ((dtm == 0) & out_rng[None, :])
    return dtm, dt_ig, gt_ig


@dataclasses.dataclass
class EvalResult:
    stats: Dict[str, float]
    per_class_ap: Dict[int, float]

    def __getitem__(self, k):
        return self.stats[k]


def evaluate_detections(
    groundtruths: Dict[int, GroundTruth],
    detections: Dict[int, Dict[str, np.ndarray]],
    category_ids: Optional[Sequence[int]] = None,
) -> EvalResult:
    """Compute COCO bbox metrics.

    Args:
      groundtruths: image_id → GroundTruth.
      detections: image_id → {"boxes": [D,4] xyxy, "scores": [D],
        "labels": [D]}. Missing image = no detections.
      category_ids: category label space; defaults to union of GT labels.

    Returns EvalResult with the 12 standard COCO stats keyed
    AP, AP50, AP75, APs, APm, APl, AR1, AR10, AR100, ARs, ARm, ARl.
    """
    img_ids = sorted(groundtruths.keys())
    if category_ids is None:
        cats = set()
        for g in groundtruths.values():
            cats.update(np.unique(g.labels).tolist())
        category_ids = sorted(cats)
    category_ids = list(category_ids)
    t_n, r_n = len(IOU_THRS), len(REC_THRS)
    a_names = list(AREA_RANGES)
    max_det = max(MAX_DETS)

    # precision[t, r, k, a, m], recall[t, k, a, m]
    precision = -np.ones((t_n, r_n, len(category_ids), len(a_names), len(MAX_DETS)))
    recall = -np.ones((t_n, len(category_ids), len(a_names), len(MAX_DETS)))

    for ki, cat in enumerate(category_ids):
        # gather per-image per-cat evaluation
        per_img = []  # (scores, dtm, dt_ig, gt_ig) per area range
        for img_id in img_ids:
            gt = groundtruths[img_id]
            gt_sel = np.where(gt.labels == cat)[0]
            det = detections.get(img_id)
            if det is None:
                db = np.zeros((0, 4)); ds = np.zeros((0,))
            else:
                dl = np.asarray(det["labels"]).reshape(-1)
                m = dl == cat
                db = np.asarray(det["boxes"], dtype=np.float64).reshape(-1, 4)[m]
                ds = np.asarray(det["scores"], dtype=np.float64).reshape(-1)[m]
            if len(gt_sel) == 0 and len(ds) == 0:
                per_img.append(None)
                continue
            order = np.argsort(-ds, kind="mergesort")[:max_det]
            db, ds = db[order], ds[order]
            d_areas = (np.maximum(db[:, 2] - db[:, 0], 0)
                       * np.maximum(db[:, 3] - db[:, 1], 0))
            ious = _iou_xyxy(db, gt.boxes[gt_sel], gt.iscrowd[gt_sel])
            entry = {"scores": ds, "areas": d_areas}
            for a in a_names:
                entry[a] = _evaluate_img(db, d_areas, gt, gt_sel,
                                         AREA_RANGES[a], ious)
            per_img.append(entry)

        for ai, a in enumerate(a_names):
            for mi, mdet in enumerate(MAX_DETS):
                scores_all, dtm_all, dtig_all = [], [], []
                npig = 0
                for entry in per_img:
                    if entry is None:
                        continue
                    dtm, dt_ig, gt_ig = entry[a]
                    scores_all.append(entry["scores"][:mdet])
                    dtm_all.append(dtm[:, :mdet])
                    dtig_all.append(dt_ig[:, :mdet])
                    npig += int((~gt_ig).sum())
                if npig == 0:
                    continue
                scores = np.concatenate(scores_all) if scores_all else np.zeros(0)
                order = np.argsort(-scores, kind="mergesort")
                dtm = np.concatenate(dtm_all, axis=1)[:, order] if scores_all else np.zeros((t_n, 0))
                dtig = np.concatenate(dtig_all, axis=1)[:, order] if scores_all else np.zeros((t_n, 0), bool)
                tps = (dtm > 0) & ~dtig
                fps = (dtm == 0) & ~dtig
                tp_sum = np.cumsum(tps, axis=1).astype(np.float64)
                fp_sum = np.cumsum(fps, axis=1).astype(np.float64)
                for ti in range(t_n):
                    tp, fp = tp_sum[ti], fp_sum[ti]
                    nd = len(tp)
                    rc = tp / npig
                    pr = tp / np.maximum(tp + fp, np.spacing(1))
                    recall[ti, ki, ai, mi] = rc[-1] if nd else 0.0
                    # precision envelope (monotone from right)
                    q = np.zeros(r_n)
                    pr = pr.tolist()
                    for i in range(nd - 1, 0, -1):
                        if pr[i] > pr[i - 1]:
                            pr[i - 1] = pr[i]
                    inds = np.searchsorted(rc, REC_THRS, side="left")
                    for ri, pi in enumerate(inds):
                        if pi < nd:
                            q[ri] = pr[pi]
                    precision[ti, :, ki, ai, mi] = q

    def _summ(ap: bool, iou: Optional[float], area: str, mdet: int) -> float:
        ai = a_names.index(area)
        mi = MAX_DETS.index(mdet)
        if ap:
            s = precision[:, :, :, ai, mi]
            if iou is not None:
                s = s[np.where(np.isclose(IOU_THRS, iou))[0]]
        else:
            s = recall[:, :, ai, mi]
            if iou is not None:
                s = s[np.where(np.isclose(IOU_THRS, iou))[0]]
        s = s[s > -1]
        return float(np.mean(s)) if s.size else -1.0

    stats = {
        "AP": _summ(True, None, "all", 100),
        "AP50": _summ(True, 0.5, "all", 100),
        "AP75": _summ(True, 0.75, "all", 100),
        "APs": _summ(True, None, "small", 100),
        "APm": _summ(True, None, "medium", 100),
        "APl": _summ(True, None, "large", 100),
        "AR1": _summ(False, None, "all", 1),
        "AR10": _summ(False, None, "all", 10),
        "AR100": _summ(False, None, "all", 100),
        "ARs": _summ(False, None, "small", 100),
        "ARm": _summ(False, None, "medium", 100),
        "ARl": _summ(False, None, "large", 100),
    }
    ai, mi = a_names.index("all"), MAX_DETS.index(100)
    per_class = {}
    for ki, cat in enumerate(category_ids):
        s = precision[:, :, ki, ai, mi]
        s = s[s > -1]
        per_class[cat] = float(np.mean(s)) if s.size else -1.0
    return EvalResult(stats=stats, per_class_ap=per_class)


class COCOMetric:
    """Streaming accumulator: add per-image (gt, det) pairs, then compute."""

    def __init__(self, category_ids: Optional[Sequence[int]] = None):
        self._gts: Dict[int, GroundTruth] = {}
        self._dets: Dict[int, Dict[str, np.ndarray]] = {}
        self._cats = category_ids

    def add(self, image_id: int, gt: GroundTruth,
            boxes: np.ndarray, scores: np.ndarray, labels: np.ndarray,
            num_valid: Optional[int] = None):
        if num_valid is not None:
            boxes, scores, labels = boxes[:num_valid], scores[:num_valid], labels[:num_valid]
        keep = np.asarray(labels).reshape(-1) >= 0
        self._gts[image_id] = gt
        self._dets[image_id] = {
            "boxes": np.asarray(boxes).reshape(-1, 4)[keep],
            "scores": np.asarray(scores).reshape(-1)[keep],
            "labels": np.asarray(labels).reshape(-1)[keep],
        }

    def compute(self) -> EvalResult:
        return evaluate_detections(self._gts, self._dets, self._cats)
