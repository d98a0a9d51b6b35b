"""ResNet backbones, torchvision v1.5 (stride on the 3x3), in NCHW.

The counterpart of ``detjax/models/resnet.py``: basic blocks (R18/34) and
bottleneck blocks (R50/101/152), frozen BatchNorm, and the lineage's
parameter names (``conv1``, ``bn1``, ``layer{s}.{b}.conv1``,
``layer{s}.{b}.downsample.0/1``), so that ``load_state_dict(strict=True)``
takes the weights carried over by ``detjax_torch.utils.weights.from_jax``
or a torchvision-format checkpoint directly.

Padding is symmetric, torch's default: stride-2 3x3 convs pad 1 on every
side and the 7x7 stem pads 3, as detjax pads explicitly; the stem max-pool
pads with -inf.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn
import torch.nn.functional as F

# depth -> (block type, stage sizes), the lineage's --depth family
RESNET_SPECS = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}

# detjax ModelConfig knobs that serve training or the TPU; only their
# defaults exist in the port so far. Each is queued in ROADMAP.md.
_TPU_OR_TRAIN_KNOBS = {
    "fused_backbone": ("off", "the fused-bottleneck kernel slice"),
    "dot_1x1": ("off", "a later slice (ROADMAP.md Queue 1, training knobs)"),
    "remat_early": (0, "a later slice (ROADMAP.md Queue 1, training knobs)"),
    "f8_remat_stages": (0, "a later slice (ROADMAP.md Queue 1, training "
                           "knobs)"),
}


def check_backbone_knobs(**knobs) -> None:
    """Raise NotImplementedError for a non-default TPU or training knob."""
    for name, value in knobs.items():
        default, slice_name = _TPU_OR_TRAIN_KNOBS[name]
        if value != default:
            raise NotImplementedError(
                f"model.{name}={value!r} is not ported yet; only "
                f"{default!r} runs here (it comes with {slice_name})")


class FrozenBatchNorm2d(nn.Module):
    """BatchNorm with frozen statistics and a trainable affine, eps 1e-5.

    As in detjax (flax ``BatchNorm(use_running_average=True)``), ``weight``
    and ``bias`` are parameters that the optimizer updates, while
    ``running_mean`` and ``running_var`` are buffers that nothing updates.
    Computed as one scale and shift in fp32, applied in the activation's
    dtype."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * scale
        return (x * scale.to(x.dtype)[None, :, None, None]
                + shift.to(x.dtype)[None, :, None, None])


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False)


def _projection(cin: int, cout: int, stride: int) -> nn.Sequential:
    return nn.Sequential(_conv(cin, cout, 1, stride), FrozenBatchNorm2d(cout))


class BasicBlock(nn.Module):
    """3x3(stride) -> 3x3, expansion 1 (R18/34)."""

    expansion = 1

    def __init__(self, cin: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv(cin, planes, 3, stride)
        self.bn1 = FrozenBatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3)
        self.bn2 = FrozenBatchNorm2d(planes)
        self.downsample = (_projection(cin, planes, stride)
                           if stride != 1 or cin != planes else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        idn = x if self.downsample is None else self.downsample(x)
        return F.relu(y + idn)


class Bottleneck(nn.Module):
    """1x1 -> 3x3(stride) -> 1x1(x4), projection shortcut when the shape
    changes (R50/101/152)."""

    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int = 1):
        super().__init__()
        cout = planes * self.expansion
        self.conv1 = _conv(cin, planes, 1)
        self.bn1 = FrozenBatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3, stride)
        self.bn2 = FrozenBatchNorm2d(planes)
        self.conv3 = _conv(planes, cout, 1)
        self.bn3 = FrozenBatchNorm2d(cout)
        self.downsample = (_projection(cin, cout, stride)
                           if stride != 1 or cin != cout else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        idn = x if self.downsample is None else self.downsample(x)
        return F.relu(y + idn)


class ResNet(nn.Module):
    """Stem + four stages; returns {2: C2, 3: C3, 4: C4, 5: C5}."""

    def __init__(self, depth: int = 50):
        super().__init__()
        if depth not in RESNET_SPECS:
            raise ValueError(
                f"unsupported backbone depth {depth}; "
                f"have {sorted(RESNET_SPECS)}")
        kind, sizes = RESNET_SPECS[depth]
        block = BasicBlock if kind == "basic" else Bottleneck
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm2d(64)
        cin = 64
        self.stage_channels = []
        for s, n_blocks in enumerate(sizes):
            planes = (64, 128, 256, 512)[s]
            blocks = []
            for b in range(n_blocks):
                stride = 2 if b == 0 and s > 0 else 1
                blocks.append(block(cin, planes, stride))
                cin = planes * block.expansion
            setattr(self, f"layer{s + 1}", nn.Sequential(*blocks))
            self.stage_channels.append(cin)

    def forward(self, x: torch.Tensor) -> Dict[int, torch.Tensor]:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)  # pads with -inf
        feats = {}
        for s in range(4):
            x = getattr(self, f"layer{s + 1}")(x)
            feats[s + 2] = x
        return feats


def he_normal_(module: nn.Module, generator: torch.Generator) -> None:
    """He-normal (fan-in) weights for every conv of ``module``, zero biases,
    drawn from ``generator`` in module order."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
            with torch.no_grad():
                m.weight.normal_(0.0, (2.0 / fan_in) ** 0.5,
                                 generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
