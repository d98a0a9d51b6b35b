"""Seeded canvases and ground truth, the one generator every mix reads.

Canvases are uint8 [N, H, W, 3], made on the run's device from a
``torch.Generator`` in a few bulk calls: a coarse normal field (one value
every 32 px a channel) upsampled bilinearly, plus fine noise, so that
neighbouring pixels correlate as in photographs. A mix's ``content_hw``
lists the letterboxed content sizes; each canvas holds its content
top-left and zeros elsewhere, as the program's letterbox pads.

Ground truth follows COCO's shape: the number of boxes an image is drawn
from a fixed multiset (quantiles of a lognormal with the mix's mean,
clipped to [1, max]) permuted by the seed, so every seed sends the same
amount of work in another order; box sizes fall into COCO's small /
medium / large shares (sqrt(area) under 32, 32-96, over 96 px),
log-uniform inside each, aspect ratios log-uniform within the mix's
range, classes uniform, centres uniform with the box inside the canvas.
Slots past an image's count hold label -1 and a zero box.
"""

from __future__ import annotations

import math
from statistics import NormalDist
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

COARSE_PX = 32


def canvases(n: int, canvas_hw: Sequence[int],
             content_hw: Sequence[Sequence[int]], gen: torch.Generator,
             device) -> torch.Tensor:
    """n canvases; canvas i holds content ``content_hw[i % len]``."""
    h, w = canvas_hw
    out = torch.zeros((n, h, w, 3), dtype=torch.uint8, device=device)
    shapes = [tuple(content_hw[i % len(content_hw)]) for i in range(n)]
    for shape in sorted(set(shapes)):
        idx = [i for i, s in enumerate(shapes) if s == shape]
        ch, cw = shape
        coarse = torch.randn((len(idx), 3, -(-ch // COARSE_PX) + 1,
                              -(-cw // COARSE_PX) + 1), generator=gen,
                             device=device)
        img = F.interpolate(coarse, size=(ch, cw), mode="bilinear",
                            align_corners=False)
        img = img + 0.25 * torch.randn(img.shape, generator=gen,
                                       device=device)
        img = (img * 50.0 + 128.0).clamp(0, 255).to(torch.uint8)
        out[idx, :ch, :cw] = img.permute(0, 2, 3, 1)
    return out


def gt_counts(n: int, mean: float, sigma: float, max_gt: int,
              rng: np.random.Generator) -> np.ndarray:
    """n box counts: the same multiset for every seed, in the seed's
    order."""
    mu = math.log(mean) - sigma * sigma / 2
    q = (np.arange(n) + 0.5) / n
    z = np.array([NormalDist().inv_cdf(float(p)) for p in q])
    counts = np.clip(np.round(np.exp(mu + sigma * z)), 1, max_gt)
    return rng.permutation(counts.astype(np.int64))


def gt_boxes(counts: np.ndarray, canvas_hw: Sequence[int], max_gt: int,
             num_classes: int, size_shares: Sequence[float],
             size_edges: Sequence[float], aspect_log2_max: float,
             rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
    """(boxes [N, max_gt, 4] f32 xyxy, labels [N, max_gt] int32, -1 pad)."""
    h, w = canvas_hw
    n = len(counts)
    boxes = np.zeros((n, max_gt, 4), np.float32)
    labels = np.full((n, max_gt), -1, np.int32)
    total = int(counts.sum())
    kind = rng.choice(len(size_shares), size=total, p=np.asarray(size_shares))
    lo = np.log(np.asarray(size_edges[:-1], np.float64))[kind]
    hi = np.log(np.asarray(size_edges[1:], np.float64))[kind]
    side = np.exp(lo + (hi - lo) * rng.random(total))
    ratio = 2.0 ** (aspect_log2_max * (2 * rng.random(total) - 1))
    bw = np.minimum(side / np.sqrt(ratio), w - 1.0)
    bh = np.minimum(side * np.sqrt(ratio), h - 1.0)
    x0 = rng.random(total) * (w - bw)
    y0 = rng.random(total) * (h - bh)
    cls = rng.integers(0, num_classes, total)
    o = 0
    for i, c in enumerate(counts):
        sl = slice(o, o + c)
        boxes[i, :c] = np.stack([x0[sl], y0[sl], x0[sl] + bw[sl],
                                 y0[sl] + bh[sl]], -1)
        labels[i, :c] = cls[sl]
        o += c
    return boxes, labels
