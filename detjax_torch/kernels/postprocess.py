"""Class-aware greedy NMS and full-set box decode: the CUDA kernels'
wrappers and their plain twins.

``nms_cuda`` replaces the TPU kernel ``detjax/kernels/postprocess.py::
nms_pallas`` (body ``_nms_kernel``) with the hand-written kernel in
``detjax_torch/csrc/nms.cu``. The greedy loop equals one sweep over the
live candidates in (score desc, index asc) order, so one block per row
checks the row's order in parallel (sorting, in shared memory, only a row
out of order: the port's callers pass sorted rows; a row of more than
``SHARED_SORT_CANDIDATES`` that is out of order is radix-selected into
shared memory a batch of its order at a time, 1,024 keys first and twice
as many at each refill up to 16,384, and sorted there, the next batch only
when the rounds run out of one before ``max_det`` keeps), then walks its
live prefix 64 candidates a round: each candidate against the keeps so far,
the round's own IoU > thr bits in one 64-bit word a row, and the round's
keeps as the one fixed point of "open minus what the keeps remove",
found in a few warp-wide OR-reductions; it stops at ``max_det`` keeps, so
it compares only the pairs the greedy loop needs. Each decision is the twin's
``RN(inter / union) > thr`` taken without the division (against thr's
upper midpoint in fp64, exactly). What bounds it on an H100 is latency:
one launch, and a row's rounds in order. Scratch: none up to 512 keeps
a row (:func:`nms_scratch_bytes`).

``decode_boxes_cuda`` replaces ``decode_boxes_pallas`` (body
``_decode_kernel``) with ``detjax_torch/csrc/decode.cu``: one thread per
(image, anchor), fp32 arithmetic in ``_decode_kernel``'s order, NaN kept
by the clip. It is bound by bytes (deltas and anchors read once, boxes
written once: 6.2 us at R50-640, B=8), less than a launch costs.

Routing: a CPU tensor goes to the plain twin (:func:`nms_reference`,
:func:`decode_boxes_reference`); a CUDA tensor goes to the kernel or raises.
``nms_launches`` and ``decode_launches`` count calls that launched their
kernels, and nothing else; ``nms_kernel_launches`` counts the CUDA kernels
those NMS calls launched, as the C launcher reports them (1 a call).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from detjax_torch.ops.boxes import DEFAULT_BOX_STD, clip_boxes, decode_boxes
from detjax_torch.ops.nms import _greedy_suppress

# The kernel sorts an unsorted row as 64-bit keys in shared memory, padded
# to a power of two: 16384 keys are 128 KB of the 227 KB a Hopper block may
# use, beside about 13 KB of its own. A longer row takes the kernel's large
# instance, which selects and sorts that many keys at a time
# (``csrc/nms.cu``'s ``kSelect``): the split point between the two.
SHARED_SORT_CANDIDATES = 16384

nms_launches = 0
nms_kernel_launches = 0  # CUDA kernels those calls launched
decode_launches = 0

_LIB = None
_DECODE_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from detjax_torch.kernels._build import load_library

        lib = load_library("detjax_nms", ["nms.cu"])
        fn = lib.detjax_nms_launch
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
            ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        size = lib.detjax_nms_scratch_bytes
        size.argtypes = [ctypes.c_int, ctypes.c_int]
        size.restype = ctypes.c_longlong
        for shape in ((1, 1), (8, 100), (640, 100), (2, 300), (3, 2000)):
            if size(*shape) != nms_scratch_bytes(*shape):
                raise RuntimeError(f"nms.cu and nms_scratch_bytes disagree "
                                   f"on the scratch of {shape}")
        _LIB = lib
    return _LIB


# keeps a row whose boxes the kernel holds in shared memory
NMS_KEPT_IN_SHARED = 512


def nms_scratch_bytes(b: int, max_det: int) -> int:
    """Bytes of scratch a call of :func:`nms_cuda` takes for B rows: the
    boxes of the keeps past the first NMS_KEPT_IN_SHARED of a row, 4 fp32
    each (none at the port's max_det of 100);
    ``csrc/nms.cu::detjax_nms_scratch_bytes``, which the library is held
    to when it loads."""
    return 16 * b * max(max_det - NMS_KEPT_IN_SHARED, 0)


def nms_reference(boxes: torch.Tensor, scores: torch.Tensor,
                  labels: torch.Tensor, iou_threshold: float = 0.5,
                  max_det: int = 100, class_offset: float = 1e4
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`nms_cuda`: class offset, then the
    greedy twin ``detjax_torch.ops.nms._greedy_suppress``."""
    off = boxes.to(torch.float32) + (
        labels.to(torch.float32) * class_offset)[..., None]
    return _greedy_suppress(off, scores, iou_threshold, max_det)


def nms_cuda(boxes: torch.Tensor, scores: torch.Tensor, labels: torch.Tensor,
             iou_threshold: float = 0.5, max_det: int = 100,
             class_offset: float = 1e4) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched class-aware greedy NMS.

    boxes [B, N, 4] f32 xyxy (un-offset), scores [B, N] f32 (entries <=
    -5e9 are pre-suppressed), labels [B, N] int32. Returns ``(keep_idx
    [B, max_det] int32 into N, -1 pad; keep_scores [B, max_det] f32,
    0 pad)`` in descending score order, ties by the lower index.
    """
    global nms_launches, nms_kernel_launches
    if boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"boxes must be [B, N, 4], got {tuple(boxes.shape)}")
    if scores.shape != boxes.shape[:2] or labels.shape != boxes.shape[:2]:
        raise ValueError(
            f"scores and labels must be [B, N] = {tuple(boxes.shape[:2])}, "
            f"got {tuple(scores.shape)} and {tuple(labels.shape)}")
    if max_det < 0:
        raise ValueError(f"max_det must be >= 0, got {max_det}")
    if not boxes.device == scores.device == labels.device:
        raise ValueError("boxes, scores and labels must be on one device")
    if boxes.device.type == "cpu":
        return nms_reference(boxes, scores, labels, iou_threshold, max_det,
                             class_offset)
    if boxes.device.type != "cuda":
        raise ValueError(f"nms_cuda takes CPU or CUDA tensors, got "
                         f"{boxes.device}")
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32:
        raise TypeError(f"boxes and scores must be float32, got "
                        f"{boxes.dtype} and {scores.dtype}")
    if labels.dtype != torch.int32:
        raise TypeError(f"labels must be int32, got {labels.dtype}")
    for name, t in (("boxes", boxes), ("scores", scores), ("labels", labels)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if boxes.data_ptr() % 16:
        raise ValueError("boxes must be 16-byte aligned (read as float4)")
    b, n = scores.shape
    if n >= 2**31:
        raise ValueError(f"N={n} candidates: keep indices are int32")
    if b == 0 or n == 0 or max_det == 0:
        return (torch.full((b, max_det), -1, dtype=torch.int32,
                           device=boxes.device),
                torch.zeros((b, max_det), device=boxes.device))
    dev = boxes.device
    # the sweep writes every slot: keeps, then -1 / 0 padding
    keep_idx = torch.empty((b, max_det), dtype=torch.int32, device=dev)
    keep_scores = torch.empty((b, max_det), dtype=torch.float32, device=dev)
    scratch = torch.empty((nms_scratch_bytes(b, max_det),),
                          dtype=torch.uint8, device=dev)
    lib = _lib()
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(index).cuda_stream
    launched = ctypes.c_int(0)
    err = lib.detjax_nms_launch(
        boxes.data_ptr(), scores.data_ptr(), labels.data_ptr(),
        keep_idx.data_ptr(), keep_scores.data_ptr(), scratch.data_ptr(), b,
        n, max_det, float(iou_threshold), float(class_offset), index, stream,
        ctypes.byref(launched))
    nms_kernel_launches += launched.value
    if err != 0 or launched.value != 1:
        raise RuntimeError(f"NMS kernel launch failed: cudaError {err}")
    nms_launches += 1
    return keep_idx, keep_scores


def _decode_lib():
    global _DECODE_LIB
    if _DECODE_LIB is None:
        from detjax_torch.kernels._build import load_library

        lib = load_library("detjax_decode", ["decode.cu"])
        fn = lib.detjax_decode_launch
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_float,
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _DECODE_LIB = lib
    return _DECODE_LIB


def decode_boxes_reference(deltas: torch.Tensor, anchors: torch.Tensor,
                           std: Sequence[float] = DEFAULT_BOX_STD,
                           image_size: Optional[Tuple[int, int]] = None
                           ) -> torch.Tensor:
    """Plain PyTorch version of :func:`decode_boxes_cuda`: deltas cast to
    fp32 (as ``decode_boxes_pallas`` casts them), then ``decode_boxes``
    and, given ``image_size``, ``clip_boxes``."""
    boxes = decode_boxes(deltas.to(torch.float32), anchors.to(torch.float32),
                         std)
    return boxes if image_size is None else clip_boxes(boxes, image_size)


def decode_boxes_cuda(deltas: torch.Tensor, anchors: torch.Tensor,
                      std: Sequence[float] = DEFAULT_BOX_STD,
                      image_size: Optional[Tuple[int, int]] = None
                      ) -> torch.Tensor:
    """Decode (and clip to ``image_size`` = (H, W), when given) every
    anchor's box.

    deltas [B, N, 4] fp32 or bf16, anchors [N, 4] fp32 xyxy, ``std`` four
    floats. Returns [B, N, 4] fp32 xyxy, computed in fp32 whatever the
    deltas' dtype (bf16 converts exactly).
    """
    global decode_launches
    if deltas.dim() != 3 or deltas.shape[-1] != 4:
        raise ValueError(f"deltas must be [B, N, 4], got "
                         f"{tuple(deltas.shape)}")
    if tuple(anchors.shape) != (deltas.shape[1], 4):
        raise ValueError(f"anchors must be [N, 4] = ({deltas.shape[1]}, 4), "
                         f"got {tuple(anchors.shape)}")
    if len(tuple(std)) != 4:
        raise ValueError(f"std must hold 4 floats, got {std}")
    if deltas.device != anchors.device:
        raise ValueError("deltas and anchors must be on one device")
    if deltas.device.type == "cpu":
        return decode_boxes_reference(deltas, anchors, std, image_size)
    if deltas.device.type != "cuda":
        raise ValueError(f"decode_boxes_cuda takes CPU or CUDA tensors, got "
                         f"{deltas.device}")
    if deltas.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"deltas must be float32 or bfloat16, got "
                        f"{deltas.dtype}")
    if anchors.dtype != torch.float32:
        raise TypeError(f"anchors must be float32, got {anchors.dtype}")
    for name, t in (("deltas", deltas), ("anchors", anchors)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if deltas.data_ptr() % (4 * deltas.element_size()) or \
            anchors.data_ptr() % 16:
        raise ValueError("deltas and anchors must be aligned to one box "
                         "(read as one vector a box)")
    b, n, _ = deltas.shape
    out = torch.empty((b, n, 4), dtype=torch.float32, device=deltas.device)
    if b == 0 or n == 0:
        return out
    h, w = (0.0, 0.0) if image_size is None else map(float, image_size)
    lib = _decode_lib()
    dev = deltas.device.index if deltas.device.index is not None \
        else torch.cuda.current_device()
    stream = torch.cuda.current_stream(dev).cuda_stream
    std_c = (ctypes.c_float * 4)(*(float(v) for v in std))
    err = lib.detjax_decode_launch(
        deltas.data_ptr(), anchors.data_ptr(), out.data_ptr(), b, n,
        int(deltas.dtype == torch.bfloat16), std_c,
        int(image_size is not None), w, h, dev, stream)
    if err != 0:
        raise RuntimeError(f"decode kernel launch failed: cudaError {err}")
    decode_launches += 1
    return out
