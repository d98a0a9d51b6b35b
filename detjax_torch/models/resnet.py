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

detjax's backward A/B knobs ``dot_1x1``, ``remat_early`` and
``f8_remat_stages`` are :class:`ResNet` arguments (:class:`DotConv1x1`,
:func:`checkpointed`, :func:`f8_block`); none changes a parameter either.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, List, Tuple

import torch
import torch.distributed as dist
from torch import nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from detjax_torch.kernels import ops as kernel_ops
from detjax_torch.models import spatial
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

DOT_1X1_VALUES = ("off", "on", "auto", "full", "dw")


def check_backbone_knobs(fused_backbone: str = "off",
                         dot_1x1: str = "off") -> str:
    """Raise ValueError for an unknown ``fused_backbone`` or ``dot_1x1``;
    return the :class:`DotConv1x1` mode ``dot_1x1`` selects, by detjax's
    mapping (``detjax/models/detector.py:43-48``): "on" is "full", "auto"
    is "off" (the measured best there), "off", "full" and "dw" stand for
    themselves."""
    if fused_backbone not in FUSED_BACKBONE_VALUES:
        raise ValueError(f"model.fused_backbone must be one of "
                         f"{FUSED_BACKBONE_VALUES}, got {fused_backbone!r}")
    if dot_1x1 not in DOT_1X1_VALUES:
        raise ValueError(f"model.dot_1x1 must be one of off/on/auto/full/dw, "
                         f"got {dot_1x1!r}")
    return {"on": "full", "auto": "off"}.get(dot_1x1, dot_1x1)


def _records_grad(module: nn.Module, x: torch.Tensor) -> bool:
    """Whether autograd records a call of ``module`` on ``x``: grad mode is
    on and x or one of its parameters requires grad. Only then does a
    checkpoint save anything (``detect``, the int8 engine and traced
    programs never take one)."""
    return torch.is_grad_enabled() and (
        x.requires_grad or any(p.requires_grad for p in module.parameters()))


_RECOMPUTE = threading.local()


def _recomputing() -> bool:
    """True while a checkpoint of this module recomputes its forward in the
    backward (on the thread that runs the backward)."""
    return getattr(_RECOMPUTE, "on", False)


def _stats_group():
    """The process group that batch-statistics BatchNorm reduces over on
    this thread, or None (local statistics)."""
    return getattr(_RECOMPUTE, "group", None)


@contextlib.contextmanager
def batch_stats_group(group):
    """Inside, every batch-statistics :class:`BatchNorm2d` in training
    takes its statistics over ``group``'s ranks: Sigma x, Sigma x^2 and
    the count are summed across the group before the mean and variance,
    as flax's BatchNorm under pjit normalises over the global batch. None
    keeps each process's own statistics (one process, or world size 1)."""
    before = _stats_group()
    _RECOMPUTE.group = group
    try:
        yield
    finally:
        _RECOMPUTE.group = before


@contextlib.contextmanager
def _recompute_context(group, space):
    before = _recomputing(), _stats_group()
    _RECOMPUTE.on, _RECOMPUTE.group = True, group
    try:
        with spatial.space_group(space):
            yield
    finally:
        _RECOMPUTE.on, _RECOMPUTE.group = before


def _checkpoint_contexts():
    # the recompute runs on the backward's thread: it takes the groups the
    # forward saw, read here, when the checkpoint's forward runs
    return contextlib.nullcontext(), _recompute_context(_stats_group(),
                                                        spatial.active())


def checkpointed(fn, *args):
    """``fn(*args)`` under ``torch.utils.checkpoint`` (non-reentrant): its
    saved activations are dropped and recomputed in the backward, as
    flax's ``nn.remat``. The recompute runs with ``_recomputing()`` true,
    so that a batch-statistics :class:`BatchNorm2d` moves its running
    statistics once a step, as flax's remat does. No RNG state is kept:
    the backbone draws no random numbers."""
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False,
                      context_fn=_checkpoint_contexts)


# float8_e4m3fn's largest finite value is 448; XLA's convert (and
# ml_dtypes') rounds to nearest even and gives NaN once the rounding
# passes it, i.e. for |x| > 464 (the midpoint to the next binade's 480),
# for infinities and for NaN. torch's cast does so on CUDA, but saturates
# to +-448 on the CPU.
E4M3_NAN_ABOVE = 464.0


def to_e4m3(x: torch.Tensor) -> torch.Tensor:
    """``x.astype(jnp.float8_e4m3fn)`` as detjax computes it, on any
    device: torch's cast (round to nearest even), then e4m3fn's NaN, of
    x's sign, where |x| > 464, x is infinite or NaN. The NaN is set on the
    cast's bits (``| 0x7F`` keeps its sign bit), because a NaN made in
    bf16 on CUDA loses its sign."""
    bits = x.to(torch.float8_e4m3fn).view(torch.uint8)
    return torch.where(x.abs() <= E4M3_NAN_ABOVE, bits, bits | 0x7F).view(
        torch.float8_e4m3fn)


class _ToE4M3(torch.autograd.Function):
    """x -> float8_e4m3fn by :func:`to_e4m3`; the cotangent, already
    float8 (the widening cast's backward rounded it), widens back to x's
    dtype, exactly, as jax.grad of the convert does."""

    @staticmethod
    def forward(ctx, x):
        ctx.dtype = x.dtype
        return to_e4m3(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype)


class _FromE4M3(torch.autograd.Function):
    """float8_e4m3fn -> ``dtype``, exact; its backward rounds the cotangent
    to float8_e4m3fn by :func:`to_e4m3` (NaN past 464), as jax.grad of the
    widening convert does. So a cotangent crossing the pair is rounded to
    e4m3 once, small ones flush to 0, large ones become NaN, as in
    detjax."""

    @staticmethod
    def forward(ctx, x8, dtype):
        return x8.to(dtype)

    @staticmethod
    def backward(ctx, g):
        return to_e4m3(g), None


def _block_from_f8(block: nn.Module, x8: torch.Tensor,
                   dtype: torch.dtype) -> torch.Tensor:
    return block(_FromE4M3.apply(x8, dtype))


def f8_block(block: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """One block of an ``f8_remat_stages`` stage (detjax's ``_stage`` with
    ``_block_from_f8``, ``detjax/models/resnet.py:137-149,319-321``): the
    block's input is rounded to float8_e4m3fn and widened back to its
    dtype before the block runs. While autograd records, the block runs
    under its own checkpoint whose saved input is the 1-byte tensor, so its
    inner activations are recomputed in the backward; otherwise (detect,
    traced programs) the input is rounded all the same, as detjax rounds
    it whatever ``train`` is, and nothing is checkpointed."""
    if _records_grad(block, x):
        return checkpointed(_block_from_f8, block, _ToE4M3.apply(x), x.dtype)
    return block(to_e4m3(x).to(x.dtype))


def _mm_fp32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b summed in fp32 with an fp32 result, as
    ``preferred_element_type=float32``: on CUDA a bf16/fp16 GEMM with an
    fp32 output; elsewhere the product of the operands widened to fp32."""
    if a.is_cuda and a.dtype in (torch.bfloat16, torch.float16):
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.to(torch.float32), b.to(torch.float32))


def _rows(t: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] -> the [B*H*W, C] matrix of its pixels: a view for a
    channels_last tensor (the model's layout), a copy otherwise."""
    return t.permute(0, 2, 3, 1).reshape(-1, t.shape[1])


class _Conv1x1DotDW(torch.autograd.Function):
    """detjax's ``conv1x1_dotdw`` (``detjax/models/resnet.py:61-98``): a
    stride-1 1x1 conv whose forward and dX are convolutions and whose dW
    is the x^T dy product over the fused batch-space dimension, summed in
    fp32 and rounded to the weight's compute dtype."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return F.conv2d(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = F.conv2d(dy, w.transpose(0, 1))
        if ctx.needs_input_grad[1]:
            dw = _mm_fp32(_rows(dy).t(), _rows(x)).to(w.dtype)
            dw = dw.reshape(w.shape)
        return dx, dw


class DotConv1x1(nn.Conv2d):
    """A stride-1 1x1 conv without bias with detjax's dot-form lowerings
    (``detjax/models/resnet.py:101-134``). A subclass of ``nn.Conv2d``, so
    its parameter is ``weight`` [Cout, Cin, 1, 1], as the conv it
    replaces: ``state_dict`` keys, ``from_jax``, the int8 engine's
    traversal and exports see no difference.

    The operands are cast to the compute dtype first (autocast's, where it
    is on, else the weight's), as detjax casts them to the module's dtype;
    the weight's cast is differentiable, so its gradient reaches the fp32
    parameter as the cast's backward. ``mode="full"``: the forward is the
    [B*H*W, Cin] x [Cin, Cout] product (a PyTorch matmul; detjax computes
    it outside any Pallas kernel) over the pixels' rows, a view of a
    channels_last input, and returns a channels_last view; autograd's dX
    and dW are products too. ``mode="dw"``: the forward and dX are
    convolutions, bit-equal to ``nn.Conv2d``'s, and only dW is the
    product, through :class:`_Conv1x1DotDW` while autograd records."""

    def __init__(self, cin: int, cout: int, mode: str = "dw"):
        if mode not in ("full", "dw"):
            raise ValueError(f"DotConv1x1 mode must be 'full' or 'dw', "
                             f"got {mode!r}")
        super().__init__(cin, cout, 1, bias=False)
        self.mode = mode

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dev = x.device.type
        dtype = (torch.get_autocast_dtype(dev)
                 if torch.is_autocast_enabled(dev) else self.weight.dtype)
        xc, wc = x.to(dtype), self.weight.to(dtype)
        if self.mode == "full":
            b, _, h, w = x.shape
            y = _rows(xc) @ wc.reshape(self.out_channels, -1).t()
            return y.view(b, h, w, self.out_channels).permute(0, 3, 1, 2)
        if _records_grad(self, x):
            return _Conv1x1DotDW.apply(xc, wc)
        return F.conv2d(xc, wc)


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
    fold on them), and not again when a checkpoint (``remat_early``,
    ``f8_remat_stages``) recomputes the forward in the backward. Autograd
    differentiates through the mean and the variance, as ``jax.grad``
    does. In eval mode the running statistics
    take their place. Either way the output is ``(x - mean) * (weight *
    rsqrt(var + eps)) + bias`` in fp32, cast to the activation's dtype.

    Inside :func:`batch_stats_group` (a data-parallel step over more than
    one rank) the statistics are the global batch's, as under detjax's
    pjit: Sigma x, Sigma x^2 and the count are summed across the ranks
    (:func:`_group_moments`), inside autograd.

    ``nn.BatchNorm2d`` is not used: it stores the unbiased variance,
    computes the variance another way and keeps a ``num_batches_tracked``
    buffer that detjax's variables do not have; ``nn.SyncBatchNorm``
    likewise."""

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
            group = _stats_group()
            if group is None:
                mean = xf.mean((0, 2, 3))
                var = torch.clamp((xf * xf).mean((0, 2, 3)) - mean * mean,
                                  min=0.0)
            else:
                mean, var = _group_moments(xf, group)
            if not _recomputing():  # a checkpoint's recompute: moved once
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


class _AllReduceSum(torch.autograd.Function):
    """``all_reduce(x, SUM)`` over ``group`` inside autograd: the gradient
    of a sum over the ranks is the cotangent summed over the ranks."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, dy: torch.Tensor):
        dx = dy.contiguous().clone()
        dist.all_reduce(dx, group=ctx.group)
        return dx, None


def _group_moments(xf: torch.Tensor, group
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The mean and flax's fast variance over (N, H, W) of every rank's
    ``xf``: Sigma x, Sigma x^2 (fp32, per channel) and the count, summed
    across ``group`` in one all-reduce."""
    c = xf.shape[1]
    sums = torch.cat([xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3)),
                      xf.new_full((1,), float(xf.numel() // c))])
    sums = _AllReduceSum.apply(sums, group)
    count = sums[2 * c]
    mean = sums[:c] / count
    var = torch.clamp(sums[c:2 * c] / count - mean * mean, min=0.0)
    return mean, var


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


def _conv1x1(cin: int, cout: int, dot_1x1: str = "off") -> nn.Conv2d:
    """A stride-1 1x1 conv: ``nn.Conv2d``, or :class:`DotConv1x1` in mode
    ``dot_1x1`` unless it is "off"."""
    return _conv(cin, cout, 1) if dot_1x1 == "off" else DotConv1x1(
        cin, cout, dot_1x1)


def _projection(cin: int, cout: int, stride: int,
                frozen_bn: bool, dot_1x1: str = "off") -> nn.Sequential:
    """The shortcut's conv and BatchNorm; the conv is a
    :class:`DotConv1x1` only at stride 1, as detjax's
    ``downsample_conv``."""
    conv = (_conv1x1(cin, cout, dot_1x1) if stride == 1
            else _conv(cin, cout, 1, stride))
    return nn.Sequential(conv, batch_norm(cout, frozen_bn))


def _shortcut(downsample, x: torch.Tensor) -> torch.Tensor:
    """A block's shortcut: x, or its projection (conv, then BatchNorm),
    the conv on the rank's rows under an active space group."""
    if downsample is None:
        return x
    return downsample[1](spatial.conv2d(downsample[0], x))


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
        y = F.relu(self.bn1(spatial.conv2d(self.conv1, x)))
        y = self.bn2(spatial.conv2d(self.conv2, y))
        return F.relu(y + _shortcut(self.downsample, x))


class Bottleneck(nn.Module):
    """1x1 -> 3x3(stride) -> 1x1(x4), projection shortcut when the shape
    changes (R50/101/152).

    With ``fused=True`` a stride-1 identity block (``cin == 4 * planes``)
    runs as one fused kernel on bf16 input, its BatchNorms folded by
    :func:`fold_frozen_bn`; ``fused_backend="torch"`` (set through
    ``Detector.bottleneck_backend``) runs the kernel's plain twin instead.
    With batch-statistics BatchNorm (``frozen_bn=False``) the block fuses
    only in eval mode: in training its statistics come from the batch,
    which the fold cannot know. Any other block ignores ``fused``.

    ``dot_1x1`` ("off", "full" or "dw") makes ``conv1``, ``conv3`` and a
    stride-1 ``downsample.0`` :class:`DotConv1x1` s, as detjax's
    ``BottleneckBlock(dot_1x1=...)``; a block that takes the fused route
    runs the kernel all the same (detjax tests ``fused`` first)."""

    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 fused: bool = False, frozen_bn: bool = True,
                 dot_1x1: str = "off"):
        super().__init__()
        cout = planes * self.expansion
        self.fused = fused and stride == 1 and cin == cout
        self.frozen_bn = frozen_bn
        self.fused_backend = "auto"
        self._folded = None  # (key, folded weights) of the last fold
        self.conv1 = _conv1x1(cin, planes, dot_1x1)
        self.bn1 = batch_norm(planes, frozen_bn)
        self.conv2 = _conv(planes, planes, 3, stride)
        self.bn2 = batch_norm(planes, frozen_bn)
        self.conv3 = _conv1x1(planes, cout, dot_1x1)
        self.bn3 = batch_norm(cout, frozen_bn)
        self.downsample = (_projection(cin, cout, stride, frozen_bn, dot_1x1)
                           if stride != 1 or cin != cout else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # detjax's rule: fused and (frozen_bn or not train)
        if self.fused and (self.frozen_bn or not self.training):
            return self.fused_forward(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(spatial.conv2d(self.conv2, y)))
        y = self.bn3(self.conv3(y))
        return F.relu(y + _shortcut(self.downsample, x))

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
        program takes too.

        Under an active space group the kernel runs on the rank's rows
        with one row of each neighbour on the inner edges
        (``spatial.with_row_halo``) and the halo rows of its output are
        dropped. At the image's own top and bottom no row is added: there
        the kernel's zero padding of y1 is the 3x3 conv's padding, where a
        zero row of x would give y1 = relu(b1), not 0."""
        return spatial.with_row_halo(self._fused_rows, x, 1)

    def _fused_rows(self, x: torch.Tensor) -> torch.Tensor:
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
    :class:`BatchNorm2d` (batch statistics in training).

    detjax's three backward A/B knobs (``detjax/models/resnet.py:270-357``),
    none of which changes a parameter or its name:

    - ``dot_1x1`` ("off", "full", "dw"): the bottlenecks' stride-1 1x1
      convs as :class:`DotConv1x1` (basic blocks have none).
    - ``remat_early`` (0 = off, 1 = the stem, 2 = + layer1, 3 = + layer2,
      4 = + layer3, 5 = + layer4): the stem and the first ``remat_early - 1``
      stages run as one checkpointed segment (:func:`checkpointed`) while
      autograd records, so the backward recomputes them instead of keeping
      their activations; the same operations on the same inputs, so the
      loss, the gradients and the running statistics are those of 0, bit
      for bit.
    - ``f8_remat_stages`` (N): each block of the first N stages runs from
      its input rounded to float8_e4m3fn (:func:`f8_block`), under its own
      checkpoint while autograd records, nested inside ``remat_early``'s
      segment as in detjax; the rounding also applies in eval mode."""

    def __init__(self, depth: int = 50, fused_blocks: bool = False,
                 frozen_bn: bool = True, dot_1x1: str = "off",
                 remat_early: int = 0, f8_remat_stages: int = 0):
        super().__init__()
        if depth not in RESNET_SPECS:
            raise ValueError(
                f"unsupported backbone depth {depth}; "
                f"have {sorted(RESNET_SPECS)}")
        kind, sizes = RESNET_SPECS[depth]
        block = BasicBlock if kind == "basic" else Bottleneck
        self.remat_early = int(remat_early)
        self.f8_remat_stages = int(f8_remat_stages)
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
                        frozen_bn=frozen_bn, dot_1x1=dot_1x1))
                else:
                    blocks.append(block(cin, planes, stride,
                                        frozen_bn=frozen_bn))
                cin = planes * block.expansion
            setattr(self, f"layer{s + 1}", nn.Sequential(*blocks))
            self.stage_channels.append(cin)

    def _stage(self, s: int, x: torch.Tensor) -> torch.Tensor:
        layer = getattr(self, f"layer{s + 1}")
        if s >= self.f8_remat_stages:
            return layer(x)
        for block in layer:
            x = f8_block(block, x)
        return x

    def _early_segment(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """The stem and the first ``remat_early - 1`` stages (detjax's
        ``_early_segment``): (x, C2, ...) of the stages it ran."""
        x = F.relu(self.bn1(spatial.conv2d(self.conv1, x)))
        x = spatial.max_pool_3x3s2(x)  # pads with -inf
        feats = []
        for s in range(max(0, self.remat_early - 1)):
            x = self._stage(s, x)
            feats.append(x)
        return (x, *feats)

    def forward(self, x: torch.Tensor) -> Dict[int, torch.Tensor]:
        if self.remat_early > 0 and _records_grad(self, x):
            x, *early = checkpointed(self._early_segment, x)
        else:
            x, *early = self._early_segment(x)
        feats = {s + 2: f for s, f in enumerate(early)}
        for s in range(len(early), 4):
            x = self._stage(s, x)
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
