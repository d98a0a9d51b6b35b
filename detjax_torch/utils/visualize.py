"""Detection visualization (``detjax/utils/visualize.py``): boxes and
``name score`` captions drawn with PIL, the colors of detjax's."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def _color(label: int):
    rng = np.random.default_rng(9176 + int(label))
    return tuple(int(c) for c in rng.integers(64, 255, 3))


def draw_detections(
    image: np.ndarray,  # [H, W, 3] uint8
    boxes: np.ndarray,  # [N, 4] xyxy in image coords
    scores: np.ndarray,
    labels: np.ndarray,
    class_names: Optional[Sequence[str]] = None,
    score_threshold: float = 0.3,
) -> np.ndarray:
    """Returns a copy of ``image`` with boxes + ``name score`` captions."""
    from PIL import Image, ImageDraw

    im = Image.fromarray(np.ascontiguousarray(image))
    draw = ImageDraw.Draw(im)
    for box, score, label in zip(np.asarray(boxes), np.asarray(scores),
                                 np.asarray(labels)):
        if label < 0 or score < score_threshold:
            continue
        x1, y1, x2, y2 = [float(v) for v in box]
        color = _color(int(label))
        draw.rectangle([x1, y1, x2, y2], outline=color, width=2)
        name = (class_names[int(label)] if class_names is not None
                and 0 <= int(label) < len(class_names) else str(int(label)))
        caption = f"{name} {float(score):.2f}"
        th = 11
        draw.rectangle([x1, max(y1 - th - 2, 0), x1 + 6 * len(caption),
                        max(y1, th + 2)], fill=color)
        draw.text((x1 + 1, max(y1 - th - 1, 1)), caption, fill=(0, 0, 0))
    return np.asarray(im)
