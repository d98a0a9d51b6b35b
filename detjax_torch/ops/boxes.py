"""Box ops on tensors: area, pairwise IoU, delta encode/decode, clipping,
and the full-anchor-set decode + clip of the eval branch.

The counterpart of ``detjax/ops/boxes.py``. All boxes are xyxy floats;
every function broadcasts over leading dims. Each op is written in the
same order of floating-point operations as detjax's, so that the NMS
twin's IoU decisions agree bit for bit (tests/test_torch_port_ops.py).

Encoding and decoding follow the lineage convention (Faster-RCNN deltas
with std normalisation (0.1, 0.1, 0.2, 0.2) and zero mean)::

    dx = (gx_c - ax_c) / aw / std_x    dw = log(max(gw, 1) / aw) / std_w
    dy = (gy_c - ay_c) / ah / std_y    dh = log(max(gh, 1) / ah) / std_h

    px = dx * std_x * aw + ax_c        pw = exp(dw * std_w) * aw
    py = dy * std_y * ah + ay_c        ph = exp(dh * std_h) * ah
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from detjax_torch.utils.device import device_constant

DEFAULT_BOX_STD = (0.1, 0.1, 0.2, 0.2)


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    """[..., 4] xyxy -> [...] area (width and height clamped at 0)."""
    w = torch.clamp(boxes[..., 2] - boxes[..., 0], min=0.0)
    h = torch.clamp(boxes[..., 3] - boxes[..., 1], min=0.0)
    return w * h


def box_iou(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU. boxes_a [..., N, 4], boxes_b [..., M, 4] -> [..., N, M].

    ``inter / max(area_a + area_b - inter, 1e-8)``, as detjax computes it.
    """
    a = boxes_a[..., :, None, :]
    b = boxes_b[..., None, :, :]
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = box_area(boxes_a)[..., :, None]
    area_b = box_area(boxes_b)[..., None, :]
    union = area_a + area_b - inter
    return inter / torch.clamp(union, min=1e-8)


def _to_cxcywh(boxes: torch.Tensor):
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    cx = boxes[..., 0] + 0.5 * w
    cy = boxes[..., 1] + 0.5 * h
    return cx, cy, w, h


def encode_boxes(gt_boxes: torch.Tensor, anchors: torch.Tensor,
                 std: Sequence[float] = DEFAULT_BOX_STD) -> torch.Tensor:
    """GT boxes -> regression targets against anchors; shapes broadcast.
    GT width and height are clamped at 1 px before the log, as the lineage
    does."""
    gx, gy, gw, gh = _to_cxcywh(gt_boxes)
    ax, ay, aw, ah = _to_cxcywh(anchors)
    gw = torch.clamp(gw, min=1.0)
    gh = torch.clamp(gh, min=1.0)
    deltas = torch.stack([(gx - ax) / aw, (gy - ay) / ah,
                          torch.log(gw / aw), torch.log(gh / ah)], dim=-1)
    return deltas / device_constant(tuple(std), deltas.dtype, deltas.device)


def decode_boxes(deltas: torch.Tensor, anchors: torch.Tensor,
                 std: Sequence[float] = DEFAULT_BOX_STD) -> torch.Tensor:
    """Regression deltas + anchors -> xyxy boxes; shapes broadcast."""
    deltas = deltas * device_constant(tuple(std), deltas.dtype,
                                      deltas.device)
    ax, ay, aw, ah = _to_cxcywh(anchors)
    px = deltas[..., 0] * aw + ax
    py = deltas[..., 1] * ah + ay
    pw = torch.exp(deltas[..., 2]) * aw
    ph = torch.exp(deltas[..., 3]) * ah
    return torch.stack(
        [px - 0.5 * pw, py - 0.5 * ph, px + 0.5 * pw, py + 0.5 * ph], dim=-1)


def clip_boxes(boxes: torch.Tensor,
               image_size: Tuple[int, int]) -> torch.Tensor:
    """Clamp xyxy boxes to [0, W] x [0, H]."""
    h, w = image_size
    hi = device_constant((w, h, w, h), boxes.dtype, boxes.device)
    return torch.minimum(torch.clamp(boxes, min=0.0), hi)


def decode_clip_boxes(deltas: torch.Tensor, anchors: torch.Tensor,
                      image_size: Tuple[int, int],
                      std: Sequence[float] = DEFAULT_BOX_STD,
                      backend: str = "auto") -> torch.Tensor:
    """Decode and clip every anchor's box: the lineage's ``BBoxTransform``
    -> ``ClipBoxes`` pair over the full anchor set. deltas [B, A, 4],
    anchors [A, 4] -> [B, A, 4].

    ``backend``: "cuda" runs the hand-written kernel
    (``detjax_torch.kernels.postprocess.decode_boxes_cuda``; its plain twin
    for CPU tensors) and always computes in fp32, as detjax's "pallas";
    "torch" is detjax's "jnp" branch, ``clip_boxes(decode_boxes(...))`` in
    the deltas' dtype; "auto" is "cuda" for a CUDA tensor and "torch"
    otherwise. The detect path does not decode the full set: it decodes
    only the selected candidates (``ops/nms._select_candidates``).
    """
    if backend == "auto":
        backend = "cuda" if deltas.is_cuda else "torch"
    if backend == "cuda":
        from detjax_torch.kernels.postprocess import decode_boxes_cuda

        return decode_boxes_cuda(deltas, anchors, std, image_size)
    if backend != "torch":
        raise ValueError(f"backend must be auto/cuda/torch, got {backend!r}")
    return clip_boxes(decode_boxes(deltas, anchors, std), image_size)
