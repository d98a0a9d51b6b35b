"""Anchor generation, in numpy: a copy of ``detjax/ops/anchors.py``.

Anchors are a pure function of (image_size, levels, scales, ratios),
computed once per config; ``detjax_torch.modeling`` keeps them on the
device. The order is the one the heads emit: levels ascending, per level
row-major over (y, x), anchor-minor.

Canonical anchor math (standard RetinaNet, adopted by the lineage):
  - level l in {3..7}: stride = 2^l, base size = anchor_base_scale * stride
    = 2^(l+2) for base_scale 4.
  - per cell: ratios x scales anchors, **ratio-major, scale-minor** order
    (index = ratio_idx * n_scales + scale_idx).
  - anchor for (ratio r, scale s): area = (base*s)^2, w = sqrt(area / r),
    h = w * r, centered on ((x+0.5)*stride, (y+0.5)*stride).
  - grid flattening is **row-major over (y, x), anchor-minor**:
    flat_index = (y * W_l + x) * A_cell + a.
Boxes are xyxy float32.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class AnchorConfig:
    min_level: int = 3
    max_level: int = 7
    scales: Tuple[float, ...] = (2 ** 0, 2 ** (1.0 / 3.0), 2 ** (2.0 / 3.0))
    ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    base_scale: float = 4.0
    # SSD-style per-level ABSOLUTE anchor sizes (pixels): one tuple per
    # level, all the same length. When set, replaces the RetinaNet rule
    # (base_scale × stride × scales) — sizes are chosen per level rather
    # than growing proportionally to the stride (SURVEY.md §2 #5).
    per_level_sizes: Tuple[Tuple[float, ...], ...] = ()

    @property
    def num_per_cell(self) -> int:
        n_scales = (len(self.per_level_sizes[0]) if self.per_level_sizes
                    else len(self.scales))
        return n_scales * len(self.ratios)

    @property
    def levels(self) -> Tuple[int, ...]:
        return tuple(range(self.min_level, self.max_level + 1))


def generate_cell_anchors(
    base_size: float,
    scales: Sequence[float],
    ratios: Sequence[float],
) -> np.ndarray:
    """Zero-centered anchors for one level: [n_ratios * n_scales, 4] xyxy.

    Ratio-major, scale-minor ordering (see module docstring).
    """
    scales = np.asarray(scales, dtype=np.float64)
    ratios = np.asarray(ratios, dtype=np.float64)
    # [R, S] grids
    s = np.tile(scales[None, :], (len(ratios), 1)).reshape(-1)
    r = np.repeat(ratios, len(scales))
    area = (base_size * s) ** 2
    w = np.sqrt(area / r)
    h = w * r
    anchors = np.stack([-w / 2, -h / 2, w / 2, h / 2], axis=-1)
    return anchors.astype(np.float32)


def level_anchors(
    level: int,
    image_size: Tuple[int, int],
    cfg: AnchorConfig,
) -> np.ndarray:
    """All anchors for one pyramid level: [H_l * W_l * A_cell, 4] xyxy."""
    stride = 2 ** level
    h, w = image_size
    fh, fw = -(-h // stride), -(-w // stride)  # ceil-div: feature-map size
    if cfg.per_level_sizes:
        sizes = cfg.per_level_sizes[level - cfg.min_level]
        cell = generate_cell_anchors(1.0, sizes, cfg.ratios)
    else:
        cell = generate_cell_anchors(cfg.base_scale * stride, cfg.scales,
                                     cfg.ratios)
    cy = (np.arange(fh, dtype=np.float32) + 0.5) * stride
    cx = (np.arange(fw, dtype=np.float32) + 0.5) * stride
    # [fh, fw, 4] shifts, row-major (y outer, x inner)
    shift = np.stack(
        np.broadcast_arrays(
            cx[None, :], cy[:, None], cx[None, :], cy[:, None]
        ),
        axis=-1,
    ).astype(np.float32)
    out = shift[:, :, None, :] + cell[None, None, :, :]
    return out.reshape(-1, 4)


@functools.lru_cache(maxsize=32)
def anchors_for_shape(
    image_size: Tuple[int, int],
    cfg: AnchorConfig = AnchorConfig(),
) -> np.ndarray:
    """Concatenated anchors over all levels: [ΣA, 4] xyxy float32.

    Cached: this is the trace-time constant that replaces the reference's
    per-step numpy anchor recomputation.
    """
    return np.concatenate(
        [level_anchors(l, image_size, cfg) for l in cfg.levels], axis=0
    )


def anchors_per_level(
    image_size: Tuple[int, int],
    cfg: AnchorConfig = AnchorConfig(),
) -> Dict[int, np.ndarray]:
    return {l: level_anchors(l, image_size, cfg) for l in cfg.levels}


def num_anchors(image_size: Tuple[int, int], cfg: AnchorConfig = AnchorConfig()) -> int:
    total = 0
    h, w = image_size
    for l in cfg.levels:
        stride = 2 ** l
        total += (-(-h // stride)) * (-(-w // stride)) * cfg.num_per_cell
    return total


# Backwards-friendly alias matching the lineage's public name.
generate_anchors = generate_cell_anchors


# The lineage's public name, as detjax keeps it.
generate_anchors = generate_cell_anchors
