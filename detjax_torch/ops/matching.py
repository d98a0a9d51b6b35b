"""Batched anchor <-> GT matching / target assignment.

The counterpart of ``detjax/ops/matching.py``. GT is padded to ``max_gt``
with label -1 marking padding; padded GTs get IoU -1 so they never win.

Assignment rule (RetinaNet, lineage thresholds):
  - an anchor's GT is the argmax IoU over valid GTs, the lowest GT index
    among equal IoUs;
  - positive if its best IoU >= fg_iou_threshold (0.5) and the image has
    a valid GT;
  - negative if its best IoU < bg_iou_threshold (0.4), which covers the
    image with no GT (best IoU -1, GT index 0);
  - ignored otherwise (no loss).

Assignment is a decision, not a function to differentiate: every output
is detached.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from detjax_torch.kernels.matching import match_iou_cuda, match_iou_reference


class MatchResult(NamedTuple):
    """Per-anchor assignment; leading batch dims follow the inputs."""

    matched_gt: torch.Tensor  # [..., A] int32, argmax GT index
    matched_labels: torch.Tensor  # [..., A] int32, class for positives, -1 else
    matched_boxes: torch.Tensor  # [..., A, 4] f32, GT box for positives, 0 else
    positive: torch.Tensor  # [..., A] bool
    negative: torch.Tensor  # [..., A] bool (ignore = ~positive & ~negative)
    max_iou: torch.Tensor  # [..., A] f32


def match_anchors(anchors: torch.Tensor, gt_boxes: torch.Tensor,
                  gt_labels: torch.Tensor, fg_iou_threshold: float = 0.5,
                  bg_iou_threshold: float = 0.4,
                  backend: str = "auto") -> MatchResult:
    """Batched matching.

    anchors [A, 4] xyxy, shared by the batch; gt_boxes [B, G, 4] xyxy,
    padded; gt_labels [B, G] int class ids, -1 for padding. A single image
    (``[G, 4]`` and ``[G]``) is matched as a batch of one.

    ``backend``: "auto" runs the CUDA kernel (``kernels/matching.py``) on
    CUDA tensors and its plain twin on CPU tensors; "torch" runs the plain
    twin on any device.
    """
    if backend not in ("auto", "torch"):
        raise ValueError(f"backend must be 'auto' or 'torch', got {backend!r}")
    if gt_boxes.dim() == 2:
        m = match_anchors(anchors, gt_boxes[None], gt_labels[None],
                          fg_iou_threshold, bg_iou_threshold, backend)
        return MatchResult(*(t[0] for t in m))
    with torch.no_grad():
        valid = gt_labels >= 0
        fn = match_iou_cuda if backend == "auto" else match_iou_reference
        max_iou, matched_gt, boxes, labels_raw = fn(
            anchors.detach().to(torch.float32).contiguous(),
            gt_boxes.detach().to(torch.float32).contiguous(),
            valid.contiguous(), gt_labels.to(torch.int32).contiguous())
        any_valid = valid.any(dim=-1, keepdim=True)
        # thresholds rounded to fp32 first, as jax does with a python float
        fg, bg = (float(np.float32(t))
                  for t in (fg_iou_threshold, bg_iou_threshold))
        positive = (max_iou >= fg) & any_valid
        negative = max_iou < bg
        matched_labels = torch.where(positive, labels_raw, -1).to(torch.int32)
        matched_boxes = torch.where(positive[..., None], boxes, 0.0)
    return MatchResult(matched_gt, matched_labels, matched_boxes, positive,
                       negative, max_iou)
