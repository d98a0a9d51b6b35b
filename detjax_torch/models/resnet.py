"""ResNet backbones, torchvision v1.5 (stride on the 3x3), in NCHW.

The counterpart of ``detjax/models/resnet.py``: basic blocks (R18/34) and
bottleneck blocks (R50/101/152), frozen or batch-statistics BatchNorm, and
the lineage's parameter names (``conv1``, ``bn1``, ``layer{s}.{b}.conv1``,
``layer{s}.{b}.downsample.0/1``), so that ``load_state_dict(strict=True)``
takes the weights carried over by ``detjax_torch.utils.weights.from_jax``
or a torchvision-format checkpoint directly.

Padding is symmetric, torch's default: stride-2 3x3 convs pad 1 on every
side and the 7x7 stem pads 3, as detjax pads explicitly; the stem max-pool
pads with -inf.

``fused_blocks=True`` sends the stride-1 identity bottlenecks of layer1 and
layer2 through the fused-block kernel (``kernels/bottleneck.py``), with
each BatchNorm's running statistics folded into its conv by
:func:`fold_frozen_bn`, as detjax's ``BottleneckBlock(fused=True)`` does.
With batch-statistics BatchNorm a block fuses only in eval mode, detjax's
rule ``fused_blocks and (frozen_bn or not train)``
(``detjax/models/resnet.py:298``). The parameters and their names do not
change.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from detjax_torch.kernels import ops as kernel_ops
from detjax_torch.kernels.bottleneck import (
    bottleneck_identity,
    bottleneck_identity_reference,
)

# depth -> (block type, stage sizes), the lineage's --depth family
RESNET_SPECS = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}

FUSED_BACKBONE_VALUES = ("off", "on", "auto")
# stages whose identity blocks fuse: layer1 and layer2, as in detjax
# (detjax/models/resnet.py:315, measured there on the TPU)
FUSED_STAGES = 2

# detjax ModelConfig knobs that serve training or the TPU; only their
# defaults exist in the port so far. Each is queued in ROADMAP.md.
_TPU_OR_TRAIN_KNOBS = {
    "dot_1x1": ("off", "a later slice (ROADMAP.md Queue 1, training knobs)"),
    "remat_early": (0, "a later slice (ROADMAP.md Queue 1, training knobs)"),
    "f8_remat_stages": (0, "a later slice (ROADMAP.md Queue 1, training "
                           "knobs)"),
}


def check_backbone_knobs(fused_backbone: str = "off", **knobs) -> None:
    """Raise ValueError for an unknown ``fused_backbone`` and
    NotImplementedError for a non-default TPU or training knob."""
    if fused_backbone not in FUSED_BACKBONE_VALUES:
        raise ValueError(f"model.fused_backbone must be one of "
                         f"{FUSED_BACKBONE_VALUES}, got {fused_backbone!r}")
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


class BatchNorm2d(nn.Module):
    """flax's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)``, which detjax
    trains with when ``model.frozen_backbone_bn=False``
    (``detjax/models/resnet.py:287-294``).

    In training the statistics are those of the batch, over (N, H, W),
    computed in fp32 from the activation (a bf16 conv output under
    autocast is upcast first, as flax's ``force_float32_reductions``
    does): the mean, and flax's fast variance ``E[x^2] - E[x]^2`` clipped
    at 0, which is the biased variance. The running statistics move as
    ``ra = 0.9 * ra + 0.1 * batch``, in place, so that each write bumps
    the buffers' version counters (``Bottleneck.folded_weights`` keys its
    fold on them). Autograd differentiates through the mean and the
    variance, as ``jax.grad`` does. In eval mode the running statistics
    take their place. Either way the output is ``(x - mean) * (weight *
    rsqrt(var + eps)) + bias`` in fp32, cast to the activation's dtype.

    ``nn.BatchNorm2d`` is not used: it stores the unbiased variance,
    computes the variance another way and keeps a ``num_batches_tracked``
    buffer that detjax's variables do not have."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.9):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        if self.training:
            mean = xf.mean((0, 2, 3))
            var = torch.clamp((xf * xf).mean((0, 2, 3)) - mean * mean,
                              min=0.0)
            with torch.no_grad():
                keep = 1.0 - self.momentum
                self.running_mean.mul_(self.momentum).add_(mean * keep)
                self.running_var.mul_(self.momentum).add_(var * keep)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = ((xf - mean[None, :, None, None]) * mul[None, :, None, None]
             + self.bias[None, :, None, None])
        return y.to(x.dtype)


def batch_norm(num_features: int, frozen: bool) -> nn.Module:
    """The backbone's BatchNorm: frozen, or with batch statistics."""
    return (FrozenBatchNorm2d(num_features) if frozen
            else BatchNorm2d(num_features))


def fold_frozen_bn(conv_weight: torch.Tensor, bn: nn.Module
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold a BatchNorm's running statistics (a :class:`FrozenBatchNorm2d`,
    or a :class:`BatchNorm2d` in eval mode) into the conv before it, in
    detjax's order of operations (``detjax/models/resnet.py::_fold_bn``):
    ``s = scale / sqrt(var + eps)`` in fp32, ``w' = bf16(fp32(w) * s)``,
    ``b' = fp32(bias - mean * s)[None]``.

    ``conv_weight`` is the port's OIHW weight. Returns the fused kernel's
    layout: ``w'`` as [I, O] for a 1x1 conv and [3, 3, I, O] (HWIO) for a
    3x3, contiguous bf16, and ``b'`` [1, O] fp32.

    The square root is taken in fp64 and rounded once to fp32, which is
    the correctly rounded fp32 square root (numpy's and XLA's) on every
    backend: a CPU build of torch may return an fp32 ``sqrt`` an ulp off
    it, which moves ``s`` and the folded bias off detjax's."""
    v = (bn.running_var + bn.eps).to(torch.float32)
    s = (bn.weight / torch.sqrt(v.double()).to(torch.float32)).to(
        torch.float32)
    hwio = conv_weight.to(torch.float32).permute(2, 3, 1, 0)
    w_eff = (hwio * s).to(torch.bfloat16)
    if w_eff.shape[:2] == (1, 1):
        w_eff = w_eff[0, 0]
    b_eff = (bn.bias - bn.running_mean * s).to(torch.float32)[None, :]
    return w_eff.contiguous(), b_eff


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False)


def _projection(cin: int, cout: int, stride: int,
                frozen_bn: bool) -> nn.Sequential:
    return nn.Sequential(_conv(cin, cout, 1, stride),
                         batch_norm(cout, frozen_bn))


class BasicBlock(nn.Module):
    """3x3(stride) -> 3x3, expansion 1 (R18/34)."""

    expansion = 1

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 frozen_bn: bool = True):
        super().__init__()
        self.conv1 = _conv(cin, planes, 3, stride)
        self.bn1 = batch_norm(planes, frozen_bn)
        self.conv2 = _conv(planes, planes, 3)
        self.bn2 = batch_norm(planes, frozen_bn)
        self.downsample = (_projection(cin, planes, stride, frozen_bn)
                           if stride != 1 or cin != planes else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        idn = x if self.downsample is None else self.downsample(x)
        return F.relu(y + idn)


class Bottleneck(nn.Module):
    """1x1 -> 3x3(stride) -> 1x1(x4), projection shortcut when the shape
    changes (R50/101/152).

    With ``fused=True`` a stride-1 identity block (``cin == 4 * planes``)
    runs as one fused kernel on bf16 input, its BatchNorms folded by
    :func:`fold_frozen_bn`; ``fused_backend="torch"`` (set through
    ``Detector.bottleneck_backend``) runs the kernel's plain twin instead.
    With batch-statistics BatchNorm (``frozen_bn=False``) the block fuses
    only in eval mode: in training its statistics come from the batch,
    which the fold cannot know. Any other block ignores ``fused``."""

    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 fused: bool = False, frozen_bn: bool = True):
        super().__init__()
        cout = planes * self.expansion
        self.fused = fused and stride == 1 and cin == cout
        self.frozen_bn = frozen_bn
        self.fused_backend = "auto"
        self._folded = None  # (key, folded weights) of the last fold
        self.conv1 = _conv(cin, planes, 1)
        self.bn1 = batch_norm(planes, frozen_bn)
        self.conv2 = _conv(planes, planes, 3, stride)
        self.bn2 = batch_norm(planes, frozen_bn)
        self.conv3 = _conv(planes, cout, 1)
        self.bn3 = batch_norm(cout, frozen_bn)
        self.downsample = (_projection(cin, cout, stride, frozen_bn)
                           if stride != 1 or cin != cout else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # detjax's rule: fused and (frozen_bn or not train)
        if self.fused and (self.frozen_bn or not self.training):
            return self.fused_forward(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        idn = x if self.downsample is None else self.downsample(x)
        return F.relu(y + idn)

    def folded_weights(self) -> List[torch.Tensor]:
        """``[w1, b1, w2, b2, w3, b3]``: the three convs with their
        BatchNorms' running statistics folded in by :func:`fold_frozen_bn`,
        the fused kernel's arguments.

        The fold is kept between calls and made anew once a weight or a
        statistic is written in place or moved (``load_state_dict``, an
        optimizer step, ``.to``): its key is each tensor's storage and
        version counter. A write through ``.data`` bypasses the counter and
        is not seen. While autograd records (grad mode on and a weight that
        requires grad) the fold runs on every call, inside the graph."""
        pairs = ((self.conv1, self.bn1), (self.conv2, self.bn2),
                 (self.conv3, self.bn3))
        tensors = [t for conv, bn in pairs
                   for t in (conv.weight, bn.weight, bn.bias,
                             bn.running_mean, bn.running_var)]

        def fold():
            return [t for conv, bn in pairs
                    for t in fold_frozen_bn(conv.weight, bn)]
        if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
            return fold()
        if torch.compiler.is_compiling():
            # a traced program (torch.export) takes the fold made before
            # the trace as constants; a fake tensor has no storage to key
            return self._folded[1] if self._folded is not None else fold()
        key = [(t.data_ptr(), t._version) for t in tensors]
        if self._folded is None or self._folded[0] != key:
            # plain tensors even under inference_mode, so that the cached
            # fold may also serve calls made outside it
            with torch.inference_mode(False), torch.no_grad():
                self._folded = (key, fold())
        return self._folded[1]

    def fused_forward(self, x: torch.Tensor) -> torch.Tensor:
        """The block through the fused kernel: x [B, C, H, W] (any dtype;
        rounded to bf16) -> bf16. For a ``channels_last`` x the NHWC view
        and the result's NCHW view are both free of copies. Where autograd
        records, through ``bottleneck_identity``'s autograd function (the
        backward kernel); otherwise through the custom op
        ``detjax_torch::bottleneck_identity``, the route an exported
        program takes too."""
        xh = x.to(torch.bfloat16).permute(0, 2, 3, 1).contiguous()
        wts = self.folded_weights()
        if self.fused_backend == "torch":
            y = bottleneck_identity_reference(xh, *wts)
        elif torch.is_grad_enabled() and any(
                t.requires_grad for t in (xh, *wts)):
            y = bottleneck_identity(xh, *wts)
        else:
            y = kernel_ops.bottleneck_identity(xh, *wts)
        return y.permute(0, 3, 1, 2)


class ResNet(nn.Module):
    """Stem + four stages; returns {2: C2, 3: C3, 4: C4, 5: C5}.

    ``fused_blocks=True`` fuses the stride-1 identity bottlenecks of the
    first :data:`FUSED_STAGES` stages (layer1 and layer2); basic blocks
    never fuse. ``frozen_bn=False`` makes every BatchNorm a
    :class:`BatchNorm2d` (batch statistics in training)."""

    def __init__(self, depth: int = 50, fused_blocks: bool = False,
                 frozen_bn: bool = True):
        super().__init__()
        if depth not in RESNET_SPECS:
            raise ValueError(
                f"unsupported backbone depth {depth}; "
                f"have {sorted(RESNET_SPECS)}")
        kind, sizes = RESNET_SPECS[depth]
        block = BasicBlock if kind == "basic" else Bottleneck
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = batch_norm(64, frozen_bn)
        cin = 64
        self.stage_channels = []
        for s, n_blocks in enumerate(sizes):
            planes = (64, 128, 256, 512)[s]
            blocks = []
            for b in range(n_blocks):
                stride = 2 if b == 0 and s > 0 else 1
                if block is Bottleneck:
                    blocks.append(block(cin, planes, stride, fused=(
                        fused_blocks and s < FUSED_STAGES),
                        frozen_bn=frozen_bn))
                else:
                    blocks.append(block(cin, planes, stride,
                                        frozen_bn=frozen_bn))
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
