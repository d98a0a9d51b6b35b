"""The kernels of the serving paths as ``torch.library`` custom ops.

``detjax_torch::nms`` (batched class-aware greedy NMS, the kernel of
``csrc/nms.cu``) and ``detjax_torch::bottleneck_identity`` (the fused
identity bottleneck's forward, ``csrc/bottleneck.cu``). The wrappers
launch their kernels through ctypes with raw device pointers, which
``torch.export`` cannot trace; as ops they are opaque nodes of a graph
with a shape function each (``register_fake``), so an exported detect
program (:mod:`detjax_torch.export`) calls the same kernels as the eager
detect path, which also calls them through these ops.

Each op's CUDA implementation calls the existing wrapper
(:func:`detjax_torch.kernels.postprocess.nms_cuda`,
:func:`detjax_torch.kernels.bottleneck.bottleneck_identity`), looked up
when called, so the wrappers' launch counters keep counting and a failed
build or launch raises; it never falls back to the twin. The CPU
implementation is the plain twin. The bottleneck op is forward only:
training differentiates through ``bottleneck_identity``'s autograd
function, not through the op.

Loading a saved artifact needs this module imported (it registers the
ops), and no model code.
"""

from __future__ import annotations

from typing import Tuple

import torch

from detjax_torch.kernels import bottleneck as _bottleneck
from detjax_torch.kernels import postprocess as _postprocess


@torch.library.custom_op("detjax_torch::nms", mutates_args=(),
                         device_types="cuda")
def nms(boxes: torch.Tensor, scores: torch.Tensor, labels: torch.Tensor,
        iou_threshold: float, max_det: int, class_offset: float
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`detjax_torch.kernels.postprocess.nms_cuda` as an op: boxes
    [B, N, 4] f32, scores [B, N] f32, labels [B, N] int32 -> (keep_idx
    [B, max_det] int32, keep_scores [B, max_det] f32)."""
    return _postprocess.nms_cuda(boxes, scores, labels, iou_threshold,
                                 max_det, class_offset)


@nms.register_kernel("cpu")
def _nms_cpu(boxes, scores, labels, iou_threshold, max_det, class_offset):
    return _postprocess.nms_reference(boxes, scores, labels, iou_threshold,
                                      max_det, class_offset)


@nms.register_fake
def _nms_fake(boxes, scores, labels, iou_threshold, max_det, class_offset):
    b = boxes.shape[0]
    return (boxes.new_empty((b, max_det), dtype=torch.int32),
            boxes.new_empty((b, max_det), dtype=torch.float32))


@torch.library.custom_op("detjax_torch::bottleneck_identity",
                         mutates_args=(), device_types="cuda")
def bottleneck_identity(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                        w2: torch.Tensor, b2: torch.Tensor, w3: torch.Tensor,
                        b3: torch.Tensor) -> torch.Tensor:
    """The fused identity bottleneck's forward as an op: x [B, H, W, C]
    bf16 NHWC and the folded weights of
    :func:`detjax_torch.kernels.bottleneck.bottleneck_identity` -> [B, H,
    W, C] bf16."""
    return _bottleneck.bottleneck_identity(x, w1, b1, w2, b2, w3, b3)


@bottleneck_identity.register_kernel("cpu")
def _bottleneck_identity_cpu(x, w1, b1, w2, b2, w3, b3):
    return _bottleneck.bottleneck_identity_reference(
        x, w1, b1, w2, b2, w3, b3).contiguous()


@bottleneck_identity.register_fake
def _bottleneck_identity_fake(x, w1, b1, w2, b2, w3, b3):
    return torch.empty_like(x, dtype=torch.bfloat16,
                            memory_format=torch.contiguous_format)
