"""RetinaNet in plain PyTorch: ResNet-50/101 (torchvision v1.5, stride on
the 3x3, frozen BatchNorm), FPN P3-P7 (P6 from C5, P7 from ReLU(P6)) and
the two shared four-conv towers.

Module names are the lineage's (``layer1.0.conv1``, ``fpn.P3_1``,
``classificationModel.output``, ...), so one ``state_dict`` loads into
this model and into the program's detector. The forward computes in fp32;
``precision(net, "fp8")`` rounds both operands of every convolution to
float8 e4m3 with a per-tensor scale (gradients pass straight through the
rounding), the lower-precision control of the correctness check.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}
E4M3_MAX = 448.0
BN_EPS = 1e-5


def _fp8_operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to e4m3 after scaling its largest magnitude to 448,
    scaled back; the gradient is the identity."""
    d = t.detach()
    scale = E4M3_MAX / d.abs().amax().clamp(min=1e-30)
    q = (d * scale).to(torch.float8_e4m3fn).to(d.dtype) / scale
    return t + (q - d)


@contextlib.contextmanager
def precision(net: nn.Module, kind: str):
    """Every convolution of ``net`` computes in ``kind`` inside: "fp32" or
    "fp8"."""
    if kind not in ("fp32", "fp8"):
        raise ValueError(f"precision is fp32 or fp8, not {kind!r}")
    convs = [m for m in net.modules() if isinstance(m, Conv)]
    for m in convs:
        m.fp8 = kind == "fp8"
    try:
        yield
    finally:
        for m in convs:
            m.fp8 = False


@contextlib.contextmanager
def tf32_off():
    """cuDNN convolutions and matmuls in full fp32."""
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags


class Conv(nn.Conv2d):
    fp8 = False  # both operands rounded to e4m3 (``precision``)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fp8:
            x, w = _fp8_operand(x), _fp8_operand(self.weight)
        else:
            w = self.weight
        return F.conv2d(x, w, self.bias, self.stride, self.padding)


class FrozenBN(nn.Module):
    """y = (x - mean) / sqrt(var + eps) * weight + bias, statistics fixed,
    weight and bias trained."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = self.weight / torch.sqrt(self.running_var + BN_EPS)
        shift = self.bias - self.running_mean * scale
        return x * scale[None, :, None, None] + shift[None, :, None, None]


class Bottleneck(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int):
        super().__init__()
        cout = 4 * planes
        self.conv1 = Conv(cin, planes, 1, bias=False)
        self.bn1 = FrozenBN(planes)
        self.conv2 = Conv(planes, planes, 3, stride=stride, padding=1,
                          bias=False)
        self.bn2 = FrozenBN(planes)
        self.conv3 = Conv(planes, cout, 1, bias=False)
        self.bn3 = FrozenBN(cout)
        self.downsample = (nn.Sequential(
            Conv(cin, cout, 1, stride=stride, bias=False), FrozenBN(cout))
            if stride != 1 or cin != cout else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        short = x if self.downsample is None else self.downsample(x)
        return F.relu(y + short)


class FPN(nn.Module):
    def __init__(self, c3: int, c4: int, c5: int, ch: int):
        super().__init__()
        for lvl, cin in ((3, c3), (4, c4), (5, c5)):
            setattr(self, f"P{lvl}_1", Conv(cin, ch, 1))
            setattr(self, f"P{lvl}_2", Conv(ch, ch, 3, padding=1))
        self.P6 = Conv(c5, ch, 3, stride=2, padding=1)
        self.P7_2 = Conv(ch, ch, 3, stride=2, padding=1)

    def forward(self, c3, c4, c5) -> Dict[int, torch.Tensor]:
        m5 = self.P5_1(c5)
        m4 = self.P4_1(c4)
        m4 = m4 + _up2(m5, m4.shape[-2:])
        m3 = self.P3_1(c3)
        m3 = m3 + _up2(m4, m3.shape[-2:])
        p6 = self.P6(c5)
        return {3: self.P3_2(m3), 4: self.P4_2(m4), 5: self.P5_2(m5),
                6: p6, 7: self.P7_2(F.relu(p6))}


def _up2(x: torch.Tensor, hw) -> torch.Tensor:
    """Nearest 2x upsample, cropped to ``hw``."""
    y = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    return y[:, :, :hw[0], :hw[1]]


class Tower(nn.Module):
    def __init__(self, cin: int, ch: int, n: int, cout: int):
        super().__init__()
        self.n = n
        for i in range(n):
            setattr(self, f"conv{i + 1}",
                    Conv(cin if i == 0 else ch, ch, 3, padding=1))
        self.output = Conv(ch if n else cin, cout, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            x = F.relu(getattr(self, f"conv{i + 1}")(x))
        return self.output(x)


class RetinaNet(nn.Module):
    """images [B, 3, H, W] normalized fp32 -> (class logits [B, sum A, K],
    box deltas [B, sum A, 4]), anchors ordered by level, then (y, x), then
    the cell's anchor."""

    def __init__(self, depth: int, num_classes: int = 80,
                 anchors_per_cell: int = 9, fpn_channels: int = 256,
                 head_channels: int = 256, head_convs: int = 4):
        super().__init__()
        self.num_classes = num_classes
        self.conv1 = Conv(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBN(64)
        cin = 64
        for s, n in enumerate(BLOCKS[depth]):
            planes = 64 * 2 ** s
            blocks = []
            for b in range(n):
                blocks.append(Bottleneck(cin, planes,
                                         2 if b == 0 and s > 0 else 1))
                cin = 4 * planes
            setattr(self, f"layer{s + 1}", nn.Sequential(*blocks))
        self.fpn = FPN(512, 1024, 2048, fpn_channels)
        self.classificationModel = Tower(fpn_channels, head_channels,
                                         head_convs,
                                         anchors_per_cell * num_classes)
        self.regressionModel = Tower(fpn_channels, head_channels, head_convs,
                                     anchors_per_cell * 4)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        c2 = self.layer1(x)
        c3 = self.layer2(c2)
        c4 = self.layer3(c3)
        c5 = self.layer4(c4)
        pyramid = self.fpn(c3, c4, c5)
        cls, box = [], []
        b = x.shape[0]
        for lvl in sorted(pyramid):
            p = pyramid[lvl]
            cls.append(self.classificationModel(p).permute(0, 2, 3, 1)
                       .reshape(b, -1, self.num_classes))
            box.append(self.regressionModel(p).permute(0, 2, 3, 1)
                       .reshape(b, -1, 4))
        return torch.cat(cls, 1), torch.cat(box, 1)


def build(model_cfg: dict, device) -> RetinaNet:
    """The reference for a configuration file's ``model`` section."""
    m = model_cfg
    net = RetinaNet(m["backbone_depth"], m["num_classes"],
                    len(m["anchor_scales"]) * len(m["anchor_ratios"]),
                    m["fpn_channels"], m["head_channels"],
                    m["num_head_convs"])
    return net.to(device)
