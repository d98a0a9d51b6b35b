"""Detection heads: RetinaNet's shared towers and the SSD-style head.

``RetinaNetHead`` is the counterpart of detjax's, with the lineage's
module names ``classificationModel.conv1..4/output`` and
``regressionModel.conv1..4/output``: two 4-conv towers shared across the
pyramid levels. ``SSDHead`` is the counterpart of detjax's ``SSDHead``
(benchmark config 2): one independent 3x3 predictor pair per level,
``cls_p{l}`` (A*K) and ``box_p{l}`` (A*4), no tower, named as detjax's
lineage-format layout for the family (``ssdHead.cls_p{l}`` /
``ssdHead.box_p{l}``). In both the classification output bias is the
prior -log((1-pi)/pi). Outputs are ``(cls_logits [B, sum A, K],
box_deltas [B, sum A, 4])`` in the anchor order of
``detjax_torch.ops.anchors``: levels ascending, per level row-major over
(y, x), anchor-minor. That order needs the NCHW head output permuted to
NHWC before the reshape; otherwise rows no longer line up with anchors.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
from torch import nn
import torch.nn.functional as F


class Tower(nn.Module):
    """``conv1..conv{n}`` (3x3 + ReLU) then the 3x3 ``output`` conv."""

    def __init__(self, cin: int, channels: int, num_convs: int, cout: int):
        super().__init__()
        self.num_convs = num_convs
        for i in range(num_convs):
            setattr(self, f"conv{i + 1}",
                    nn.Conv2d(cin if i == 0 else channels, channels, 3,
                              padding=1))
        self.output = nn.Conv2d(channels if num_convs else cin, cout, 3,
                                padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_convs):
            x = F.relu(getattr(self, f"conv{i + 1}")(x))
        return self.output(x)


def flatten_level(x: torch.Tensor, channels_out: int) -> torch.Tensor:
    """[B, A*C, H, W] -> [B, H*W*A, C] in (y, x, anchor) order."""
    b = x.shape[0]
    return x.permute(0, 2, 3, 1).reshape(b, -1, channels_out)


def prior_bias(prior_prob: float) -> float:
    return -math.log((1.0 - prior_prob) / prior_prob)


class RetinaNetHead(nn.Module):
    def __init__(self, in_channels: int = 256, num_classes: int = 80,
                 anchors_per_cell: int = 9, channels: int = 256,
                 num_convs: int = 4, prior_prob: float = 0.01):
        super().__init__()
        self.num_classes = num_classes
        self.prior_prob = prior_prob
        self.classificationModel = Tower(in_channels, channels, num_convs,
                                         anchors_per_cell * num_classes)
        self.regressionModel = Tower(in_channels, channels, num_convs,
                                     anchors_per_cell * 4)

    def init_weights(self, generator: torch.Generator) -> None:
        init_towers_(self.classificationModel, self.regressionModel,
                     self.prior_prob, generator)

    def forward(self, feats: Dict[int, torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        return head_outputs(self.classificationModel, self.regressionModel,
                            feats, self.num_classes)


def init_towers_(cls_tower: Tower, box_tower: Tower, prior_prob: float,
                 generator: torch.Generator) -> None:
    """N(0, 0.01) kernels, zero biases, the prior bias on the class output."""
    with torch.no_grad():
        for tower in (cls_tower, box_tower):
            for m in tower.modules():
                if isinstance(m, nn.Conv2d):
                    m.weight.normal_(0.0, 0.01, generator=generator)
                    m.bias.zero_()
        cls_tower.output.bias.fill_(prior_bias(prior_prob))


def head_outputs(cls_tower: Tower, box_tower: Tower,
                 feats: Dict[int, torch.Tensor], num_classes: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both towers over every level, flattened and concatenated."""
    cls_all, box_all = [], []
    for lvl in sorted(feats):
        cls_all.append(flatten_level(cls_tower(feats[lvl]), num_classes))
        box_all.append(flatten_level(box_tower(feats[lvl]), 4))
    return torch.cat(cls_all, dim=1), torch.cat(box_all, dim=1)


class SSDHead(nn.Module):
    """Per level ``l`` of ``levels``: ``cls_p{l}`` (3x3, A*K outputs,
    prior bias) and ``box_p{l}`` (3x3, A*4) over that level's FPN
    output."""

    def __init__(self, in_channels: int = 256, num_classes: int = 80,
                 anchors_per_cell: int = 6, levels=range(3, 8),
                 prior_prob: float = 0.01):
        super().__init__()
        self.num_classes = num_classes
        self.prior_prob = prior_prob
        self.levels = tuple(levels)
        for lvl in self.levels:
            setattr(self, f"cls_p{lvl}",
                    nn.Conv2d(in_channels, anchors_per_cell * num_classes,
                              3, padding=1))
            setattr(self, f"box_p{lvl}",
                    nn.Conv2d(in_channels, anchors_per_cell * 4, 3,
                              padding=1))

    def output_convs(self) -> Tuple[List[nn.Conv2d], List[nn.Conv2d]]:
        """The class and the box predictors, in level order."""
        return ([getattr(self, f"cls_p{lvl}") for lvl in self.levels],
                [getattr(self, f"box_p{lvl}") for lvl in self.levels])

    def init_weights(self, generator: torch.Generator) -> None:
        """detjax's initialisers: N(0, 0.01) kernels, zero biases, the
        prior bias on the class predictors."""
        cls_convs, box_convs = self.output_convs()
        with torch.no_grad():
            for m in cls_convs + box_convs:
                m.weight.normal_(0.0, 0.01, generator=generator)
                m.bias.zero_()
            for m in cls_convs:
                m.bias.fill_(prior_bias(self.prior_prob))

    def forward(self, feats: Dict[int, torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        cls_all, box_all = [], []
        for lvl in sorted(feats):
            x = feats[lvl]
            cls_all.append(flatten_level(getattr(self, f"cls_p{lvl}")(x),
                                         self.num_classes))
            box_all.append(flatten_level(getattr(self, f"box_p{lvl}")(x), 4))
        return torch.cat(cls_all, dim=1), torch.cat(box_all, dim=1)
