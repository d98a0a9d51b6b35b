"""FPN neck producing P3-P7, NCHW, with the lineage's module names.

The counterpart of ``detjax/models/fpn.py``: lateral 1x1 convs on the
backbone levels (``fpn.P{l}_1``), nearest 2x top-down upsample cropped to
the lateral's size and added, 3x3 output convs (``fpn.P{l}_2``); P6 is a
3x3 stride-2 conv on **C5** (not on P5, ``fpn.P6``), and P7 = a 3x3
stride-2 conv on ReLU(P6) (``fpn.P7_2``).

Under an active space group (``models/spatial.py``) the laterals and the
upsample work on the rank's rows and the ``P{l}_2`` convs exchange halo
rows. The outputs follow detjax's layout rule, which the detector decides
once from the canvas (``spatial.pyramid_sharded``, as
``detjax/models/fpn.py:66-69`` applies ``unshard_tiny_levels``): a
row-sharded pyramid runs P6 and P7 on the rank's rows too; a gathered one
gathers P3-P5 and C5 (P6's input) and runs P6 and P7 on whole rows, since
their strides would not split its shards evenly.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Sequence

import torch
from torch import nn
import torch.nn.functional as F

from detjax_torch.models import spatial


def stride2_conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv(x)`` for P6 and P7. On the CPU under bf16 autocast, with a 1x1
    input, the same product computed as an fp32 convolution of the
    bf16-rounded input, weight and bias, rounded to bf16: what autocast
    computes (bf16 operands, fp32 sums, bf16 out)."""
    if (x.device.type == "cpu" and tuple(x.shape[-2:]) == (1, 1)
            and torch.is_autocast_enabled("cpu")
            and torch.get_autocast_dtype("cpu") == torch.bfloat16):
        # PyTorch's CPU bf16 conv kernel computes this conv's weight
        # gradient from uninitialised memory when its input is 1x1
        with torch.autocast("cpu", enabled=False):
            def bf(t):
                return t.to(torch.bfloat16).float()
            y = F.conv2d(bf(x), bf(conv.weight), bf(conv.bias), conv.stride,
                         conv.padding)
        return y.to(torch.bfloat16)
    return spatial.conv2d(conv, x)


def upsample_nearest_2x(x: torch.Tensor, out_hw) -> torch.Tensor:
    """[B,C,H,W] -> [B,C,2H,2W], cropped to ``out_hw`` for odd targets, in
    ``x``'s dtype. CUDA's autocast runs the upsample in fp32: its bf16
    copy then carried the top-down sum in fp32 down to P3, where detjax
    (and a traced program) round each level's sum to bf16."""
    y = F.interpolate(x, scale_factor=2.0, mode="nearest")
    return y[:, :, : out_hw[0], : out_hw[1]].to(x.dtype)


class FPN(nn.Module):
    def __init__(self, backbone_channels: Sequence[int], min_level: int = 3,
                 max_level: int = 7, channels: int = 256):
        """``backbone_channels``: channels of C2..C5."""
        super().__init__()
        if max_level != 7 or not 3 <= min_level <= 5:
            raise ValueError(
                f"the lineage FPN covers P{min_level}..P7 with min_level in "
                f"3..5 only; got min_level={min_level}, max_level={max_level}")
        self.min_level, self.max_level = min_level, max_level
        for lvl in range(min_level, 6):
            cin = backbone_channels[lvl - 2]
            setattr(self, f"P{lvl}_1", nn.Conv2d(cin, channels, 1))
            setattr(self, f"P{lvl}_2",
                    nn.Conv2d(channels, channels, 3, padding=1))
        self.P6 = nn.Conv2d(backbone_channels[3], channels, 3, stride=2,
                            padding=1)
        self.P7_2 = nn.Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, feats: Dict[int, torch.Tensor],
                row_sharded: bool = True) -> Dict[int, torch.Tensor]:
        """P{min_level}..P7 of the backbone's C2..C5. Under an active space
        group, ``row_sharded`` is detjax's layout rule's decision for this
        canvas (``spatial.pyramid_sharded``): True, every level on the
        rank's rows; False, every level whole (``spatial.
        unshard_tiny_levels``), P6 and P7 on C5's rows gathered up front."""
        laterals = {lvl: getattr(self, f"P{lvl}_1")(feats[lvl])
                    for lvl in range(self.min_level, 6)}
        merged = {5: laterals[5]}
        for lvl in range(4, self.min_level - 1, -1):
            merged[lvl] = laterals[lvl] + upsample_nearest_2x(
                merged[lvl + 1], laterals[lvl].shape[-2:])
        out = spatial.unshard_tiny_levels(
            {lvl: spatial.conv2d(getattr(self, f"P{lvl}_2"), merged[lvl])
             for lvl in merged}, row_sharded)
        whole = spatial.active() is not None and not row_sharded
        c5 = spatial.gather_rows(feats[5]) if whole else feats[5]
        with spatial.replicated() if whole else contextlib.nullcontext():
            out[6] = stride2_conv(self.P6, c5)
            out[7] = stride2_conv(self.P7_2, F.relu(out[6]))
        return {lvl: out[lvl] for lvl in range(self.min_level,
                                               self.max_level + 1)}
