"""Fused anchor <-> GT IoU matching: the CUDA kernel's wrapper and its twin.

``match_iou_cuda`` replaces the TPU kernel ``detjax/kernels/matching.py::
match_iou_pallas`` (body ``_match_kernel``) with the hand-written kernel
in ``detjax_torch/csrc/matching.cu``. It never stores the ``[B, A, G]``
IoU tensor. A block of 128 consecutive anchors (one strip of one level)
of one image builds its anchors' union box and lists the valid GTs that
can overlap it; each thread divides only against the listed GTs and merges
with (0, the first dropped valid GT) and (-1, the first invalid one),
which is the full scan's result bit for bit: a dropped GT has IoU exactly 0
against every anchor of the block. Past ``ONE_LIST_GT`` slots the list
does not fit in shared memory: the kernel's chunked instance lists and
scans ``GT_CHUNK`` slots at a time, in order, carrying each thread's
(best, index) from chunk to chunk, which is the one list's scan bit for
bit.

What bounds it on an H100: its floor is bytes once the culling leaves few
pairs (the training batches hold 1-20 objects padded to 100 slots): the
four ``[B, A]`` outputs are 28 bytes an anchor. Above that floor, each
block's fixed latency (union box, GT list, barriers) holds it. The scan
over all G slots with an IEEE division each, which the previous design
ran, was issue-bound.

Routing: a CPU tensor goes to the plain twin :func:`match_iou_reference`;
a CUDA tensor goes to the kernel or raises. ``match_launches`` counts
calls that launched the kernel, and nothing else;
``match_kernel_launches`` the CUDA kernels they launched, as the C
launcher reports them (1 a call).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from detjax_torch.ops.boxes import box_iou

# Dynamic shared memory: 24 bytes a listed GT (box, area, index), within
# the 227 KB a Hopper block may use (1 KB kept for static shared memory):
# up to ONE_LIST_GT slots the kernel lists them all at once, past it
# GT_CHUNK at a time (``csrc/matching.cu``'s ``kMaxListed`` and ``kChunk``).
ONE_LIST_GT = (227 * 1024 - 1024) // 24
GT_CHUNK = 4096
# Anchors a block of the kernel (one a thread, one image a block): their
# union box culls the GTs (``csrc/matching.cu``'s ``kThreads``).
ANCHORS_PER_BLOCK = 128

match_launches = 0
match_kernel_launches = 0  # CUDA kernels those calls launched

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from detjax_torch.kernels._build import load_library

        lib = load_library("detjax_match", ["matching.cu"])
        fn = lib.detjax_match_launch
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def match_iou_reference(anchors: torch.Tensor, gt_boxes: torch.Tensor,
                        gt_valid: torch.Tensor,
                        gt_labels: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                   torch.Tensor]:
    """Plain PyTorch version of :func:`match_iou_cuda`: the broadcast
    ``[B, A, G]`` IoU with invalid GTs at -1, the max, and the lowest GT
    index where the IoU equals it (``torch.argmax`` promises no tie
    order), then gathers of the winner's box and label."""
    b, g = gt_valid.shape
    if gt_labels is None:
        gt_labels = torch.zeros((b, g), dtype=torch.int32,
                                device=gt_boxes.device)
    iou = box_iou(anchors.to(torch.float32), gt_boxes.to(torch.float32))
    iou = torch.where(gt_valid[:, None, :], iou, -1.0)  # [B, A, G]
    best = iou.max(dim=-1).values
    rows = torch.arange(g, dtype=torch.int32, device=iou.device)
    idx = torch.where(iou == best[..., None], rows,
                      torch.iinfo(torch.int32).max).min(dim=-1).values
    boxes = torch.gather(gt_boxes.to(torch.float32), 1,
                         idx.long()[..., None].expand(-1, -1, 4))
    labels = torch.gather(gt_labels.to(torch.int32), 1, idx.long())
    return best, idx, boxes, labels


def match_iou_cuda(anchors: torch.Tensor, gt_boxes: torch.Tensor,
                   gt_valid: torch.Tensor,
                   gt_labels: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                              torch.Tensor]:
    """Fused matching.

    anchors [A, 4] f32 xyxy, gt_boxes [B, G, 4] f32, gt_valid [B, G] bool,
    gt_labels [B, G] int32 (zeros when None). Returns ``(max_iou [B, A]
    f32, argmax_gt [B, A] int32, matched_boxes [B, A, 4] f32,
    matched_labels_raw [B, A] int32)``: the best IoU over valid GTs (-1
    with none), its GT index (the lowest among equal IoUs), and that GT's
    box and label whatever the thresholds.
    """
    global match_launches, match_kernel_launches
    if anchors.dim() != 2 or anchors.shape[-1] != 4:
        raise ValueError(f"anchors must be [A, 4], got {tuple(anchors.shape)}")
    if gt_boxes.dim() != 3 or gt_boxes.shape[-1] != 4:
        raise ValueError(
            f"gt_boxes must be [B, G, 4], got {tuple(gt_boxes.shape)}")
    b, g = gt_boxes.shape[:2]
    if gt_labels is None:
        gt_labels = torch.zeros((b, g), dtype=torch.int32,
                                device=gt_boxes.device)
    if gt_valid.shape != (b, g) or gt_labels.shape != (b, g):
        raise ValueError(
            f"gt_valid and gt_labels must be [B, G] = {(b, g)}, got "
            f"{tuple(gt_valid.shape)} and {tuple(gt_labels.shape)}")
    if g == 0:
        raise ValueError("G=0: matching needs at least one (padded) GT slot")
    if not anchors.device == gt_boxes.device == gt_valid.device \
            == gt_labels.device:
        raise ValueError("anchors and GT tensors must be on one device")
    if anchors.device.type == "cpu":
        return match_iou_reference(anchors, gt_boxes, gt_valid, gt_labels)
    if anchors.device.type != "cuda":
        raise ValueError(f"match_iou_cuda takes CPU or CUDA tensors, got "
                         f"{anchors.device}")
    if anchors.dtype != torch.float32 or gt_boxes.dtype != torch.float32:
        raise TypeError(f"anchors and gt_boxes must be float32, got "
                        f"{anchors.dtype} and {gt_boxes.dtype}")
    if gt_valid.dtype != torch.bool:
        raise TypeError(f"gt_valid must be bool, got {gt_valid.dtype}")
    if gt_labels.dtype != torch.int32:
        raise TypeError(f"gt_labels must be int32, got {gt_labels.dtype}")
    for name, t in (("anchors", anchors), ("gt_boxes", gt_boxes),
                    ("gt_valid", gt_valid), ("gt_labels", gt_labels)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if anchors.data_ptr() % 16 or gt_boxes.data_ptr() % 16:
        raise ValueError("anchors and gt_boxes must be 16-byte aligned "
                         "(read as float4)")
    a = anchors.shape[0]
    dev = anchors.device
    max_iou = torch.empty((b, a), dtype=torch.float32, device=dev)
    argmax = torch.empty((b, a), dtype=torch.int32, device=dev)
    boxes = torch.empty((b, a, 4), dtype=torch.float32, device=dev)
    labels = torch.empty((b, a), dtype=torch.int32, device=dev)
    if b == 0 or a == 0:
        return max_iou, argmax, boxes, labels
    lib = _lib()
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(index).cuda_stream
    launched = ctypes.c_int(0)
    err = lib.detjax_match_launch(
        anchors.data_ptr(), gt_boxes.data_ptr(), gt_valid.data_ptr(),
        gt_labels.data_ptr(), max_iou.data_ptr(), argmax.data_ptr(),
        boxes.data_ptr(), labels.data_ptr(), b, a, g, index, stream,
        ctypes.byref(launched))
    match_kernel_launches += launched.value
    if err != 0:
        raise RuntimeError(f"matching kernel launch failed: cudaError {err}")
    match_launches += 1
    return max_iou, argmax, boxes, labels
