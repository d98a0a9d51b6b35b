"""VOC-style per-class AP evaluation (``detjax/evaluation/voc.py``).

The reference lineage ships a standalone CSV/VOC evaluator alongside the
COCO one: per-class average precision at a single IoU threshold (0.5),
continuous (every-point) interpolation, greedy score-ordered matching with
one-GT-one-detection. This is that evaluator, numpy only.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import numpy as np


def _ap_from_pr(recall: np.ndarray, precision: np.ndarray) -> float:
    """Every-point interpolated AP (VOC2010+ / lineage csv_eval method)."""
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[0.0], precision, [0.0]])
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def _iou(det: np.ndarray, gt: np.ndarray) -> np.ndarray:
    lt = np.maximum(det[:, None, :2], gt[None, :, :2])
    rb = np.minimum(det[:, None, 2:], gt[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    a = np.clip(det[:, 2] - det[:, 0], 0, None) * np.clip(
        det[:, 3] - det[:, 1], 0, None)
    b = np.clip(gt[:, 2] - gt[:, 0], 0, None) * np.clip(
        gt[:, 3] - gt[:, 1], 0, None)
    return inter / np.maximum(a[:, None] + b[None, :] - inter, 1e-12)


def evaluate_voc(
    groundtruths: Mapping[int, Dict[str, np.ndarray]],
    detections: Mapping[int, Dict[str, np.ndarray]],
    num_classes: int,
    iou_threshold: float = 0.5,
    class_names: Optional[Sequence[str]] = None,
) -> Dict[str, float]:
    """Per-class AP@``iou_threshold`` and mAP.

    groundtruths: image_id → {"boxes" [G,4] xyxy, "labels" [G]}
    detections:   image_id → {"boxes" [D,4], "scores" [D], "labels" [D]}

    Returns {"mAP": float, "AP/<class>": float per class}.
    """
    aps = {}
    for c in range(num_classes):
        recs = []  # (score, is_tp)
        n_gt = 0
        for img_id, gt in groundtruths.items():
            g_mask = np.asarray(gt["labels"]).reshape(-1) == c
            g_boxes = np.asarray(gt["boxes"], np.float64).reshape(-1, 4)[g_mask]
            n_gt += len(g_boxes)
            det = detections.get(img_id)
            if det is None:
                continue
            d_lab = np.asarray(det["labels"]).reshape(-1)
            d_mask = d_lab == c
            d_boxes = np.asarray(det["boxes"], np.float64).reshape(-1, 4)[d_mask]
            d_scores = np.asarray(det["scores"], np.float64).reshape(-1)[d_mask]
            order = np.argsort(-d_scores, kind="mergesort")
            d_boxes, d_scores = d_boxes[order], d_scores[order]
            taken = np.zeros(len(g_boxes), bool)
            ious = _iou(d_boxes, g_boxes) if len(g_boxes) and len(d_boxes) \
                else np.zeros((len(d_boxes), 0))
            for i in range(len(d_boxes)):
                tp = False
                if ious.shape[1]:
                    j = int(np.argmax(ious[i]))
                    if ious[i, j] >= iou_threshold and not taken[j]:
                        taken[j] = True
                        tp = True
                recs.append((d_scores[i], tp))
        if n_gt == 0:
            continue
        if not recs:
            aps[c] = 0.0
            continue
        recs.sort(key=lambda r: -r[0])
        tps = np.asarray([r[1] for r in recs], np.float64)
        tp_cum = np.cumsum(tps)
        fp_cum = np.cumsum(1.0 - tps)
        recall = tp_cum / n_gt
        precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-12)
        aps[c] = _ap_from_pr(recall, precision)

    out: Dict[str, float] = {
        "mAP": float(np.mean(list(aps.values()))) if aps else 0.0}
    for c, ap in aps.items():
        name = (class_names[c] if class_names is not None
                and c < len(class_names) and class_names[c] else str(c))
        out[f"AP/{name}"] = ap
    return out
