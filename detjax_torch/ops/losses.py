"""Focal + smooth-L1 detection losses over the static ``[B, A]`` grid.

The counterpart of ``detjax/ops/losses.py``; plain PyTorch, as detjax
computes them outside Pallas.

  - focal: sigmoid per class, alpha 0.25, gamma 2; background is an
    all-zero one-hot row; ignored anchors contribute 0; per-image sum
    normalised by max(#positives, 1); mean over the batch.
  - smooth-L1: on std-normalised deltas of positive anchors, beta 1/9;
    per-image mean over positive anchor coordinates (0 without
    positives); mean over the batch.

Every loss casts its inputs to fp32 at entry, so bf16 head outputs are
reduced in fp32. The focal loss has detjax's analytic backward
(:class:`FocalSum`), which needs only the original logits, labels and
weights and returns the gradient in the logits' dtype.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Sequence, Tuple

import torch

from detjax_torch.ops.boxes import DEFAULT_BOX_STD, encode_boxes
from detjax_torch.ops.matching import MatchResult, match_anchors


def _sigmoid_softplus_pair(x: torch.Tensor):
    """(sigmoid(x), softplus(x), softplus(-x)) from one exp and one log1p,
    with detjax's branch structure."""
    nonneg = x >= 0
    e = torch.exp(-torch.abs(x))
    l = torch.log1p(e)
    sig = torch.where(nonneg, 1.0, e) / (1.0 + e)
    sp_pos = torch.where(nonneg, x + l, l)  # softplus(x)
    return sig, sp_pos, sp_pos - x  # softplus(-x) = softplus(x) - x


def _one_hot(labels: torch.Tensor, k: int) -> torch.Tensor:
    """fp32 one-hot over the last dim; label -1 gives an all-zero row."""
    classes = torch.arange(k, device=labels.device)
    return (labels[..., None] == classes).to(torch.float32)


def _focal_weight(one_minus_pt: torch.Tensor, gamma: float) -> torch.Tensor:
    if gamma == 2.0:
        return one_minus_pt * one_minus_pt
    if gamma == 1.0:
        return one_minus_pt
    return torch.pow(one_minus_pt, gamma)


def _focal_elem(logits, matched_labels, weight, alpha, gamma):
    """Elementwise focal loss -> per-image sum over (A, K); fp32."""
    k = logits.shape[-1]
    logits = logits.to(torch.float32)
    targets = _one_hot(matched_labels, k)
    p, sp_pos, sp_neg = _sigmoid_softplus_pair(logits)
    ce = targets * sp_neg + (1.0 - targets) * sp_pos
    p_t = targets * p + (1.0 - targets) * (1.0 - p)
    alpha_t = targets * alpha + (1.0 - targets) * (1.0 - alpha)
    loss = alpha_t * _focal_weight(1.0 - p_t, gamma) * ce
    return torch.sum(loss * weight[..., None], dim=(-2, -1))


class FocalSum(torch.autograd.Function):
    """Per-image focal sum with detjax's closed-form backward::

        dL/dx = alpha_t (2t - 1) [gamma p_t (1 - p_t)^gamma log p_t
                                  - (1 - p_t)^(gamma + 1)]

    Only ``logits`` is differentiated; the gradient comes back in the
    logits' dtype (bf16 head outputs get a bf16 gradient)."""

    @staticmethod
    def forward(ctx, logits, matched_labels, weight, alpha: float,
                gamma: float):
        ctx.save_for_backward(logits, matched_labels, weight)
        ctx.alpha, ctx.gamma = alpha, gamma
        return _focal_elem(logits, matched_labels, weight, alpha, gamma)

    @staticmethod
    def backward(ctx, g):
        logits, matched_labels, weight = ctx.saved_tensors
        alpha, gamma = ctx.alpha, ctx.gamma
        x = logits.to(torch.float32)
        targets = _one_hot(matched_labels, x.shape[-1])
        sign = 2.0 * targets - 1.0
        p, sp_pos, sp_neg = _sigmoid_softplus_pair(x)
        p_t = targets * p + (1.0 - targets) * (1.0 - p)
        log_pt = -(targets * sp_neg + (1.0 - targets) * sp_pos)
        alpha_t = targets * alpha + (1.0 - targets) * (1.0 - alpha)
        one_minus = 1.0 - p_t
        pow_g = _focal_weight(one_minus, gamma)
        dldx = alpha_t * sign * (gamma * p_t * pow_g * log_pt
                                 - pow_g * one_minus)
        dlogits = (dldx * weight[..., None] * g[..., None, None]
                   ).to(logits.dtype)
        return dlogits, None, None, None, None


def focal_sum(logits, matched_labels, weight, alpha: float = 0.25,
              gamma: float = 2.0) -> torch.Tensor:
    """Per-image focal sum over the trailing (A, K) dims."""
    return FocalSum.apply(logits, matched_labels, weight, alpha, gamma)


def focal_loss(logits: torch.Tensor, matched_labels: torch.Tensor,
               positive: torch.Tensor, negative: torch.Tensor,
               alpha: float = 0.25, gamma: float = 2.0) -> torch.Tensor:
    """Per-image focal loss normalised by #positives. logits [..., A, K];
    labels, positive, negative [..., A]. Returns [...] fp32."""
    weight = (positive | negative).to(torch.float32)
    total = focal_sum(logits, matched_labels, weight, alpha, gamma)
    num_pos = torch.clamp(positive.to(torch.float32).sum(dim=-1), min=1.0)
    return total / num_pos


def _smooth_l1(diff: torch.Tensor, beta: float) -> torch.Tensor:
    return torch.where(diff < beta, 0.5 * diff * diff / beta,
                       diff - 0.5 * beta)


def smooth_l1_loss(reg: torch.Tensor, reg_targets: torch.Tensor,
                   positive: torch.Tensor, beta: float = 1.0 / 9.0
                   ) -> torch.Tensor:
    """Per-image smooth-L1 over positive anchors. reg, reg_targets
    [..., A, 4]; positive [..., A]. Returns [...] fp32."""
    diff = torch.abs(reg.to(torch.float32) - reg_targets.to(torch.float32))
    pos = positive.to(torch.float32)[..., None]
    num = torch.sum(_smooth_l1(diff, beta) * pos, dim=(-2, -1))
    den = torch.clamp(torch.sum(pos, dim=(-2, -1)) * 4.0, min=1.0)
    return num / den


class DetectionLossOutput(NamedTuple):
    cls_loss: torch.Tensor  # scalar
    reg_loss: torch.Tensor  # scalar
    metrics: Dict[str, torch.Tensor]


def _metrics(m: MatchResult, cls: torch.Tensor, reg: torch.Tensor
             ) -> Dict[str, torch.Tensor]:
    return {"num_pos": m.positive.to(torch.float32).sum() / cls.shape[0],
            "cls_loss": cls.mean().detach(),
            "reg_loss": reg.mean().detach()}


def detection_loss(cls_logits: torch.Tensor, reg_preds: torch.Tensor,
                   anchors: torch.Tensor, gt_boxes: torch.Tensor,
                   gt_labels: torch.Tensor, fg_iou_threshold: float = 0.5,
                   bg_iou_threshold: float = 0.4, alpha: float = 0.25,
                   gamma: float = 2.0, beta: float = 1.0 / 9.0,
                   box_std: Sequence[float] = DEFAULT_BOX_STD,
                   match_backend: str = "auto") -> DetectionLossOutput:
    """The training loss: match, then focal + smooth-L1, batched.

    cls_logits [B, A, K] and reg_preds [B, A, 4] in any float dtype;
    anchors [A, 4]; gt_boxes [B, G, 4]; gt_labels [B, G] (-1 padding).
    ``match_backend`` is :func:`match_anchors`' ``backend``.
    """
    m = match_anchors(anchors, gt_boxes, gt_labels, fg_iou_threshold,
                      bg_iou_threshold, match_backend)
    cls = focal_loss(cls_logits, m.matched_labels, m.positive, m.negative,
                     alpha, gamma)
    reg_targets = encode_boxes(m.matched_boxes, anchors[None], box_std)
    reg = smooth_l1_loss(reg_preds, reg_targets, m.positive, beta)
    return DetectionLossOutput(cls.mean(), reg.mean(), _metrics(m, cls, reg))


def detection_loss_per_level(
        outputs: Dict[int, Tuple[torch.Tensor, torch.Tensor]],
        anchors: torch.Tensor, level_sizes: Dict[int, int],
        gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
        fg_iou_threshold: float = 0.5, bg_iou_threshold: float = 0.4,
        alpha: float = 0.25, gamma: float = 2.0, beta: float = 1.0 / 9.0,
        box_std: Sequence[float] = DEFAULT_BOX_STD,
        match_backend: str = "auto") -> DetectionLossOutput:
    """:func:`detection_loss` computed per level on the heads' NHWC
    layouts, ``{level: (cls [B, H, W, A*K], box [B, H, W, A*4])}``, with
    ``level_sizes[level] = H*W*A`` and ``anchors`` concatenated in
    ascending level order. Matching runs once on all anchors; the
    per-anchor targets are sliced per level."""
    m = match_anchors(anchors, gt_boxes, gt_labels, fg_iou_threshold,
                      bg_iou_threshold, match_backend)
    pos_count = m.positive.to(torch.float32).sum(dim=-1)
    reg_targets = encode_boxes(m.matched_boxes, anchors[None], box_std)
    cls_sum = 0.0
    reg_sum = 0.0
    off = 0
    for level in sorted(outputs):
        cls4, box4 = outputs[level]
        b, h, w, _ = cls4.shape
        n = level_sizes[level]
        a = n // (h * w)
        k = cls4.shape[-1] // a
        lab = m.matched_labels[:, off:off + n].reshape(b, h, w, a)
        pos = m.positive[:, off:off + n].reshape(b, h, w, a)
        neg = m.negative[:, off:off + n].reshape(b, h, w, a)
        weight = (pos | neg).to(torch.float32)
        cls_sum = cls_sum + focal_sum(cls4.reshape(b, h, w, a, k), lab,
                                      weight, alpha, gamma).sum(dim=(-2, -1))
        tgt = reg_targets[:, off:off + n].reshape(b, h, w, a * 4)
        diff = torch.abs(box4.to(torch.float32) - tgt)
        wpos = torch.repeat_interleave(pos.to(torch.float32), 4, dim=-1)
        reg_sum = reg_sum + torch.sum(_smooth_l1(diff, beta) * wpos,
                                      dim=(1, 2, 3))
        off += n
    cls = cls_sum / torch.clamp(pos_count, min=1.0)
    reg = reg_sum / torch.clamp(pos_count * 4.0, min=1.0)
    return DetectionLossOutput(cls.mean(), reg.mean(), _metrics(m, cls, reg))
