"""Synthetic detection dataset: deterministic scenes with exact GT.

A copy of ``detjax/data/synthetic.py`` (numpy only; the port keeps its own
copy because it never imports detjax). The same seed gives the same
scenes in both packages. Scenes are coloured axis-aligned rectangles on
noise backgrounds; each class has its own colour, so a detector can learn
the task.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _class_color(label: int, num_classes: int) -> np.ndarray:
    rng = np.random.default_rng(1234 + label)
    return rng.integers(40, 255, size=3).astype(np.uint8)


class SyntheticDetectionDataset:
    """Records with ``image`` (uint8 HWC), ``boxes`` (xyxy f32),
    ``labels`` (int32), ``iscrowd``, ``areas``, ``image_id``,
    ``file_name`` and ``size``."""

    def __init__(self, num_images: int = 64,
                 image_size: Tuple[int, int] = (256, 256),
                 num_classes: int = 8, max_objects: int = 4, seed: int = 0,
                 noise: float = 0.05,
                 size_range: Tuple[float, float] = (0.125, 0.5),
                 crowd_prob: float = 0.0,
                 image_sizes: Optional[Tuple[Tuple[int, int], ...]] = None):
        """``size_range``: object side as a fraction of the image side.
        ``crowd_prob``: probability that an object is marked iscrowd.
        ``image_sizes``: a cycle of per-image (H, W) source shapes; image
        ``i`` gets ``image_sizes[i % len]``, overriding ``image_size``."""
        self.num_images = num_images
        self.image_size = image_size
        self.image_sizes = (tuple(map(tuple, image_sizes)) if image_sizes
                            else None)
        self.num_classes = num_classes
        self.max_objects = max_objects
        self.seed = seed
        self.noise = noise
        self.size_range = size_range
        self.crowd_prob = crowd_prob
        self.class_names = [f"class_{i}" for i in range(num_classes)]
        self.label_to_cat_id = {i: i for i in range(num_classes)}

    def __len__(self) -> int:
        return self.num_images

    def __getitem__(self, idx: int) -> dict:
        if not 0 <= idx < self.num_images:
            raise IndexError(idx)
        rng = np.random.default_rng(self.seed * 100003 + idx)
        h, w = (self.image_sizes[idx % len(self.image_sizes)]
                if self.image_sizes else self.image_size)
        img = (rng.normal(0.2, self.noise, (h, w, 3)).clip(0, 1)
               * 255).astype(np.uint8)
        n = int(rng.integers(1, self.max_objects + 1))
        lo, hi = self.size_range
        boxes, labels, crowds = [], [], []
        for _ in range(n):
            bw = int(rng.integers(max(int(w * lo), 4), max(int(w * hi), 5)))
            bh = int(rng.integers(max(int(h * lo), 4), max(int(h * hi), 5)))
            x0 = int(rng.integers(0, w - bw))
            y0 = int(rng.integers(0, h - bh))
            label = int(rng.integers(0, self.num_classes))
            img[y0:y0 + bh, x0:x0 + bw] = _class_color(label,
                                                       self.num_classes)
            boxes.append([x0, y0, x0 + bw, y0 + bh])
            labels.append(label)
            crowds.append(bool(rng.random() < self.crowd_prob))
        boxes = np.asarray(boxes, np.float32)
        labels = np.asarray(labels, np.int32)
        # later rectangles may occlude earlier ones; their GT stays
        return {
            "image": img,
            "boxes": boxes,
            "labels": labels,
            "iscrowd": np.asarray(crowds, bool),
            "areas": ((boxes[:, 2] - boxes[:, 0])
                      * (boxes[:, 3] - boxes[:, 1])),
            "image_id": idx,
            "file_name": f"synthetic_{idx}.png",
            "size": (h, w),
        }
