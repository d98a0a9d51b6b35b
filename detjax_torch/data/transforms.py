"""Host-side geometric transforms (``detjax/data/transforms.py``).

Every image is scaled (aspect preserved) and placed top-left on a fixed
(H, W) uint8 canvas, so every batch has one shape; the protocol evaluator
instead puts each image on its own reference-protocol canvas
(:func:`protocol_canvas`). The resize runs through the in-repo C++
bilinear resize (``detjax_torch.native``), which is PIL's ``BILINEAR`` bit
for bit, and through PIL where the library cannot be built. The host-side
crop, flip and normalisation serve pipelines that augment on the host;
training flips and normalises on the device (``pipeline.device_augment``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


def protocol_scale(h: int, w: int, min_side: int = 608,
                   max_side: int = 1024) -> float:
    """The reference Resizer's scale rule: the short side to ``min_side``,
    capped so the long side never exceeds ``max_side``."""
    return min(min_side / min(h, w), max_side / max(h, w))


def protocol_canvas(h: int, w: int, min_side: int = 608,
                    max_side: int = 1024, pad_stride: int = 32
                    ) -> Tuple[Tuple[int, int], float]:
    """The reference Resizer's output geometry for an (h, w) source:
    :func:`protocol_scale`, the rounded resized size, then zero padding at
    the bottom and right to a multiple of ``pad_stride``. Returns
    ``((canvas_h, canvas_w), scale)``; the protocol evaluator runs one
    batch shape per distinct canvas."""
    scale = protocol_scale(h, w, min_side, max_side)
    nh, nw = max(1, int(round(h * scale))), max(1, int(round(w * scale)))
    ph = -(-nh // pad_stride) * pad_stride
    pw = -(-nw // pad_stride) * pad_stride
    return (ph, pw), scale


def _resize_u8(image: np.ndarray, nh: int, nw: int) -> np.ndarray:
    """Bilinear uint8 resize through the native library (bit for bit PIL's
    ``BILINEAR``), PIL where the library is unavailable."""
    if (nh, nw) == image.shape[:2]:
        return image
    from detjax_torch import native

    if native.available():
        return native.resize_bilinear(image, nh, nw)
    from PIL import Image

    return np.asarray(
        Image.fromarray(image).resize((nw, nh), Image.BILINEAR), np.uint8)


def letterbox_protocol(
    image: np.ndarray,  # [h, w, 3] uint8
    boxes: np.ndarray,  # [n, 4] xyxy in source coords
    canvas_hw: Tuple[int, int],
    min_side: int = 608,
    max_side: int = 1024,
) -> Tuple[np.ndarray, np.ndarray, float]:
    """The reference Resizer's content on a given protocol canvas
    (normally :func:`protocol_canvas`'s for this image): the protocol
    scale, not canvas-fit, so the resized size is the reference's
    ``round(h*scale) x round(w*scale)``; top-left, zero pad. Returns
    ``(canvas uint8 [H,W,3], boxes in canvas coords, scale)``; raises when
    the content does not fit the canvas."""
    th, tw = canvas_hw
    h, w = image.shape[:2]
    scale = protocol_scale(h, w, min_side, max_side)
    nh, nw = max(1, int(round(h * scale))), max(1, int(round(w * scale)))
    if nh > th or nw > tw:
        raise ValueError(
            f"protocol content {nh}x{nw} exceeds canvas {th}x{tw} "
            f"(source {h}x{w}, min/max {min_side}/{max_side})")
    canvas = np.zeros((th, tw, 3), np.uint8)
    canvas[:nh, :nw] = _resize_u8(image, nh, nw)
    out_boxes = boxes.astype(np.float32) * scale
    np.clip(out_boxes[:, 0::2], 0, nw, out=out_boxes[:, 0::2])
    np.clip(out_boxes[:, 1::2], 0, nh, out=out_boxes[:, 1::2])
    return canvas, out_boxes, scale


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


def hflip_boxes(boxes: np.ndarray, width: float) -> np.ndarray:
    """Mirror xyxy boxes horizontally inside [0, width]."""
    out = boxes.copy()
    out[:, 0] = width - boxes[:, 2]
    out[:, 2] = width - boxes[:, 0]
    return out


def random_crop(
    image: np.ndarray,
    boxes: np.ndarray,
    labels: np.ndarray,
    rng: np.random.Generator,
    min_scale: float = 0.3,
    max_scale: float = 1.0,
    min_box_coverage: float = 0.5,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A random sub-window of ``uniform(min_scale, max_scale)`` of each
    side, drawn from ``rng``; boxes are clipped to the window and kept
    where at least ``min_box_coverage`` of their area (and more than one
    pixel) survives."""
    h, w = image.shape[:2]
    s = rng.uniform(min_scale, max_scale)
    ch, cw = max(1, int(h * s)), max(1, int(w * s))
    y0 = int(rng.integers(0, h - ch + 1))
    x0 = int(rng.integers(0, w - cw + 1))
    crop = image[y0:y0 + ch, x0:x0 + cw]
    if len(boxes) == 0:
        return crop, boxes.reshape(0, 4), labels
    shifted = boxes - np.asarray([x0, y0, x0, y0], np.float32)
    clipped = shifted.copy()
    np.clip(clipped[:, 0::2], 0, cw, out=clipped[:, 0::2])
    np.clip(clipped[:, 1::2], 0, ch, out=clipped[:, 1::2])
    area = np.maximum(boxes[:, 2] - boxes[:, 0], 0) * np.maximum(
        boxes[:, 3] - boxes[:, 1], 0)
    new_area = np.maximum(clipped[:, 2] - clipped[:, 0], 0) * np.maximum(
        clipped[:, 3] - clipped[:, 1], 0)
    keep = new_area >= min_box_coverage * np.maximum(area, 1e-6)
    keep &= new_area > 1.0
    return crop, clipped[keep], labels[keep]


def normalize_image(image: np.ndarray, mean=None, std=None) -> np.ndarray:
    """uint8 [0, 255] -> float32 normalised on the host; ``mean`` and
    ``std`` default to ImageNet's."""
    x = image.astype(np.float32) / 255.0
    mean = IMAGENET_MEAN if mean is None else np.asarray(mean, np.float32)
    std = IMAGENET_STD if std is None else np.asarray(std, np.float32)
    return (x - mean) / std


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
