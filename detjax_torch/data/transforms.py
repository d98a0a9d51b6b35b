"""Letterbox onto a fixed canvas, and GT padding
(``detjax/data/transforms.py``).

Every image is scaled (aspect preserved) and placed top-left on a fixed
(H, W) uint8 canvas, so every batch has one shape. The resize is PIL's
bilinear, which detjax's in-repo C++ resize reproduces bit for bit; that
C++ resize and the JPEG decoder (``detjax/native/``) come with the data
slice of the port.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def protocol_scale(h: int, w: int, min_side: int = 608,
                   max_side: int = 1024) -> float:
    """The reference Resizer's scale rule: the short side to ``min_side``,
    capped so the long side never exceeds ``max_side``."""
    return min(min_side / min(h, w), max_side / max(h, w))


def _resize_u8(image: np.ndarray, nh: int, nw: int) -> np.ndarray:
    """Bilinear uint8 resize (PIL ``BILINEAR``)."""
    if (nh, nw) == image.shape[:2]:
        return image
    from PIL import Image

    return np.asarray(
        Image.fromarray(image).resize((nw, nh), Image.BILINEAR), np.uint8)


def letterbox(
    image: np.ndarray,  # [h, w, 3] uint8
    boxes: np.ndarray,  # [n, 4] xyxy in source coords
    target_hw: Tuple[int, int],
    scale_minmax: Optional[Tuple[int, int]] = None,
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Aspect-preserving resize onto a fixed canvas. Returns
    ``(canvas uint8 [H,W,3], boxes in canvas coords, scale)``.

    The scale is canvas-fit, ``min(th/h, tw/w)``; with ``scale_minmax`` it
    is further capped by :func:`protocol_scale`.
    """
    th, tw = target_hw
    h, w = image.shape[:2]
    scale = min(th / h, tw / w)
    if scale_minmax is not None:
        scale = min(scale, protocol_scale(h, w, *scale_minmax))
    nh, nw = max(1, int(round(h * scale))), max(1, int(round(w * scale)))
    canvas = np.zeros((th, tw, 3), np.uint8)
    canvas[:nh, :nw] = _resize_u8(image, nh, nw)
    out_boxes = boxes.astype(np.float32) * scale
    np.clip(out_boxes[:, 0::2], 0, nw, out=out_boxes[:, 0::2])
    np.clip(out_boxes[:, 1::2], 0, nh, out=out_boxes[:, 1::2])
    return canvas, out_boxes, scale


def pad_annotations(boxes: np.ndarray, labels: np.ndarray, max_gt: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Pad or truncate to ``max_gt`` rows: boxes [max_gt, 4] f32 (zeros
    pad), labels [max_gt] int32 (-1 pad), so every batch has one shape."""
    n = min(len(boxes), max_gt)
    out_boxes = np.zeros((max_gt, 4), np.float32)
    out_labels = np.full((max_gt,), -1, np.int32)
    out_boxes[:n] = boxes[:n]
    out_labels[:n] = labels[:n]
    return out_boxes, out_labels
