"""Post-training int8 quantized inference (``detjax/quant.py``).

A second serving engine for a trained detector, built the way detjax
builds it:

1. :func:`forward_fp` restates ``Detector.forward`` as one traversal over
   the port's modules (``_backbone_forward``, ``_fpn_forward``,
   ``_head_forward``), in NHWC, frozen BatchNorm applied in the compute
   dtype as detjax's ``_bn`` applies it. :func:`calibrate` runs it once
   in bf16 over calibration images and records each conv site's input
   range: ``absmax``, or ``p999``, the 99.9th percentile of |x| (numpy's
   "linear" rule, from ``torch.topk``: ``torch.quantile`` refuses more than
   2**24 elements, and one layer1 activation of 8 canvases at 640 has
   about 52 M).
2. :func:`quantize` folds every BatchNorm (frozen or the running
   statistics of a ``BatchNorm2d``) into its conv in numpy fp32, with
   detjax's own arithmetic (``scale / np.sqrt(var + eps)``), so the int8
   weights, their per-output-channel scales ``ws``, the biases ``b`` and
   the stem's ``w16`` are bit-equal to detjax's. The stem stays a bf16
   conv (a C=3 conv gains nothing from int8).
3. :func:`forward_int8` runs the same traversal with every other conv as
   quantize -> int8 conv with int32 sums (:func:`conv_int8`) -> dequantize
   ``(y * (sx * ws) + b)`` to bf16. Backbone activations travel between
   blocks as :class:`QTensor` (int8 and a scale); residual adds, upsample
   and the stem's max-pool stay bf16.
4. :func:`detect_int8` / :func:`detect_int8_u8`: that forward, then the
   detect path's postprocess, whose NMS is the CUDA kernel on a GPU
   (through the custom op ``detjax_torch::nms``).

Under an active space group (``models/spatial.py``: a row shard of a
``(data, space)`` mesh) the traversal runs on the shard's rows: each k x k
conv and each pool takes its halo rows by ``spatial.rows_for_op`` (the
fill the op's padding: int8 zero, ``int8(-128)``, ``-inf``) and pads no
rows itself, and the FPN and heads follow the layout rule of
``models/detector.py`` (a gathered pyramid, or each head level gathered
before the flatten). Calibration runs on whole images, outside the mesh,
as detjax's.

The qtree is ``{"weights": {path: {"w", "ws", "b"} or {"w16", "b"}},
"act_scales": {site: sx}}`` of tensors on the model's device, keyed by
detjax's own path and site names (``"backbone/layer1_block0/conv1"``,
``"head/cls_conv0@p3"``, ``"backbone/conv1@out"``); the names map to the
port's modules through the key maps of
:mod:`detjax_torch.utils.weights`.

:func:`conv_int8` is detjax's ``lax.conv`` on int8 operands, which detjax
runs outside any Pallas kernel: here a patch matrix sliced from a
zero-padded NHWC int8 tensor (one strided view of its k*k windows),
multiplied by ``torch._int_mm`` (cuBLASLt on
a GPU), which wants M > 16 and K and N multiples of 8, so M and N are
padded with zeros and the result sliced. ``F.unfold`` and
``F.max_pool2d`` do not take int8.
"""

from __future__ import annotations

import contextlib
from typing import Dict, NamedTuple, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from detjax_torch.config import Config, get_config
from detjax_torch.models import spatial
from detjax_torch.models.resnet import RESNET_SPECS
from detjax_torch.utils.weights import _head_key_map, _resnet_key_map

CALIB_MODES = ("absmax", "p999")

_BN_OF = {"conv1": "bn1", "conv2": "bn2", "conv3": "bn3",
          "downsample_conv": "downsample_bn"}


def _config(cfg) -> Config:
    return cfg if isinstance(cfg, Config) else get_config(cfg)


def module_names(model_cfg) -> Dict[str, str]:
    """detjax's module path of every conv and BatchNorm (``"backbone/
    layer1_block0/conv1"``, ``"fpn/lateral_p3"``, ``"head/cls_out"``) ->
    the port's module name (``"layer1.0.conv1"``, ``"fpn.P3_1"``,
    ``"classificationModel.output"``; ``"head/cls_p3"`` -> ``"ssdHead.cls_p3"``
    for the SSD family)."""
    block, sizes = RESNET_SPECS[model_cfg.backbone_depth]
    names = {"backbone/" + "/".join(path): key
             for key, path in _resnet_key_map(sizes, block).items()}
    names.update({"/".join(path): key for key, path in _head_key_map(
        model_cfg.family, model_cfg.num_head_convs, model_cfg.min_level,
        model_cfg.max_level).items()})
    return names


def _conv(x: torch.Tensor, w_oihw: torch.Tensor, stride: int = 1
          ) -> torch.Tensor:
    """NHWC conv with symmetric k//2 padding, in x's dtype; under an
    active space group on this rank's rows (``spatial.rows_for_op``)."""
    k = w_oihw.shape[-1]
    x, pad_rows = spatial.rows_for_op(x, k, stride, k // 2, 0.0)
    x = x.permute(0, 3, 1, 2)
    one_column = (x.shape[3] + 2 * (k // 2) - k) // stride == 0
    if (x.device.type == "cpu" and x.dtype == torch.bfloat16 and stride == 2
            and one_column):
        # PyTorch's CPU bf16 conv reads uninitialised memory for a stride-2
        # conv whose output is one column wide (P6 and P7 of a narrow
        # canvas): an fp32 conv of the bf16 operands, rounded to bf16, as
        # models/fpn.py::stride2_conv computes it
        return F.conv2d(x.float(), w_oihw.float(), stride=stride,
                        padding=(pad_rows, k // 2)).to(
            torch.bfloat16).permute(0, 2, 3, 1)
    y = F.conv2d(x, w_oihw, stride=stride, padding=(pad_rows, k // 2))
    return y.permute(0, 2, 3, 1)


def _bn(x, scale, bias, mean, var, dtype, eps: float = 1e-5):
    """detjax's frozen BatchNorm: ``(x - mean) * (scale * rsqrt(var +
    eps)) + bias``, the multiplier in fp32, the rest in ``dtype``."""
    mul = (scale * torch.rsqrt(var + eps)).to(dtype)
    return (x - mean.to(dtype)) * mul + bias.to(dtype)


def _upsample_nearest_2x(x: torch.Tensor, out_hw) -> torch.Tensor:
    b, h, w, c = x.shape
    y = x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c)
    y = y.reshape(b, h * 2, w * 2, c)
    return y[:, : out_hw[0], : out_hw[1], :]


def _pool_windows(xp: torch.Tensor, k: int, stride: int, ho: int, wo: int):
    """The k*k strided windows of a padded NHWC tensor, (dy, dx) order."""
    return [xp[:, dy:dy + stride * (ho - 1) + 1:stride,
               dx:dx + stride * (wo - 1) + 1:stride, :]
            for dy in range(k) for dx in range(k)]


def _out_hw(h: int, w: int, k: int, stride: int, pad_rows: int
            ) -> Tuple[int, int]:
    p = k // 2
    return ((h + 2 * pad_rows - k) // stride + 1,
            (w + 2 * p - k) // stride + 1)


def conv_int8(xq: torch.Tensor, w: torch.Tensor, stride: int = 1
              ) -> torch.Tensor:
    """int8 NHWC ``xq`` [B, H, W, C] conv int8 HWIO ``w`` [k, k, C, N],
    symmetric k//2 zero padding -> int32 [B, Ho, Wo, N], the sums exact:
    detjax's ``_conv(xq, w, stride, preferred_element_type=jnp.int32)``.
    A patch matrix [B*Ho*Wo, k*k*C] (rows of (dy, dx, c), HWIO's order)
    times ``w`` as [k*k*C, N] through ``torch._int_mm``. Under an active
    space group on this rank's rows: int8 zero halo rows, no row
    padding (``spatial.rows_for_op``)."""
    if xq.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"conv_int8 takes int8 operands, got {xq.dtype} and "
                        f"{w.dtype}")
    k, c, n = w.shape[0], w.shape[2], w.shape[3]
    if xq.shape[3] != c or w.shape[1] != k:
        raise ValueError(f"x [.., {xq.shape[3]}] and w {tuple(w.shape)} "
                         f"disagree")
    p = k // 2
    xq, pad_rows = spatial.rows_for_op(xq, k, stride, p, 0)
    b, h, wd, _ = xq.shape
    ho, wo = _out_hw(h, wd, k, stride, pad_rows)
    if k == 1 and stride == 1:
        patches = xq.reshape(-1, c)
    else:
        # the k*k windows as one strided view of the padded tensor,
        # [B, Ho, Wo, k, k, C], copied out as rows of (dy, dx, c)
        xp = (F.pad(xq, (0, 0, p, p, pad_rows, pad_rows))
              if p or pad_rows else xq)
        if not xp.is_contiguous():
            xp = xp.contiguous()
        sb, sh, sw, sc = xp.stride()
        patches = xp.as_strided(
            (b, ho, wo, k, k, c),
            (sb, stride * sh, stride * sw, sh, sw, sc)).reshape(-1, k * k * c)
    wm = w.reshape(k * k * c, n)
    m, kk = patches.shape
    pad_m, pad_k, pad_n = max(0, 17 - m), -kk % 8, -n % 8
    if pad_m or pad_k:
        patches = F.pad(patches, (0, pad_k, 0, pad_m))
    if pad_k or pad_n:
        wm = F.pad(wm, (0, pad_n, 0, pad_k))
    y = torch._int_mm(patches, wm)
    if pad_m or pad_n:
        y = y[:m, :n]
    return y.reshape(b, ho, wo, n)


def conv_int8_reference(xq: torch.Tensor, w: torch.Tensor, stride: int = 1
                        ) -> torch.Tensor:
    """Plain version of :func:`conv_int8`: an fp64 conv of the integer
    values, exact (every sum stays below 127**2 * 9 * 512 < 2**53),
    rounded back to int32; on this rank's rows as :func:`conv_int8`."""
    k = w.shape[0]
    xq, pad_rows = spatial.rows_for_op(xq, k, stride, k // 2, 0)
    y = F.conv2d(xq.to(torch.float64).permute(0, 3, 1, 2),
                 w.to(torch.float64).permute(3, 2, 0, 1), stride=stride,
                 padding=(pad_rows, k // 2))
    return torch.round(y).to(torch.int32).permute(0, 2, 3, 1)


def max_pool_int8(q: torch.Tensor) -> torch.Tensor:
    """3x3 / stride 2 / pad 1 max-pool of int8 NHWC ``q``, padded with
    -128: detjax's ``reduce_window(q, int8(-128), max, ...)`` as a max over
    nine strided slices; under an active space group on this rank's rows
    (a halo row above, -128 at the image's top)."""
    q, pad_rows = spatial.rows_for_op(q, 3, 2, 1, -128)
    b, h, w, c = q.shape
    ho, wo = _out_hw(h, w, 3, 2, pad_rows)
    out = None
    for win in _pool_windows(F.pad(q, (0, 0, 1, 1, pad_rows, pad_rows),
                                   value=-128), 3, 2, ho, wo):
        out = win if out is None else torch.maximum(out, win)
    return out


def _max_pool_fp(x: torch.Tensor) -> torch.Tensor:
    """3x3 / stride 2 max-pool of NHWC ``x``, padded with -inf (on this
    rank's rows under an active space group)."""
    return spatial.max_pool_3x3s2(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def _relu(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, min=0)


def _as(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x.to(dtype)``, and no op at all when x has it already (a traced
    program then records no cast)."""
    return x if x.dtype == dtype else x.to(dtype)


def _quantize_act(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(_as(x, torch.float32) / s), -127,
                       127).to(torch.int8)


def percentile_999(a: torch.Tensor) -> torch.Tensor:
    """99.9th percentile of a flat tensor, numpy's "linear" rule: the
    order statistics at floor and ceil of 0.999 * (n - 1), interpolated
    in fp32."""
    n = a.numel()
    pos = 0.999 * (n - 1)
    lo, hi = int(np.floor(pos)), int(np.ceil(pos))
    top = torch.topk(a.reshape(-1), n - lo, sorted=True).values
    lo_v, hi_v = top[n - 1 - lo], top[n - 1 - hi]
    frac = float(np.float32(pos - lo))
    return lo_v * (1.0 - frac) + hi_v * frac


class QTensor(NamedTuple):
    """An int8-quantized activation and its symmetric scale: x ~ q * s."""

    q: torch.Tensor  # int8, NHWC
    s: torch.Tensor  # [] fp32


class _FpMode:
    """The traversal over the port's modules in ``dtype``, convs and frozen
    BatchNorm as detjax's ``_FpMode`` applies them. ``record=True``
    collects each site's input range for calibration."""

    def __init__(self, model, dtype=torch.bfloat16, record: bool = False,
                 calib_mode: str = "absmax"):
        if calib_mode not in CALIB_MODES:
            raise ValueError(f"calib_mode must be one of "
                             f"{sorted(CALIB_MODES)}, got {calib_mode!r}")
        self.model = model
        self.names = module_names(model.cfg)
        self.dtype = dtype
        self.record = record
        self.calib_mode = calib_mode
        self.stats: Dict[str, torch.Tensor] = {}

    def _rec(self, site: str, x: torch.Tensor) -> None:
        if self.record:
            a = x.to(torch.float32).abs()
            m = (a.max() if self.calib_mode == "absmax"
                 else percentile_999(a))
            prev = self.stats.get(site)
            self.stats[site] = m if prev is None else torch.maximum(prev, m)

    def _module(self, path: str):
        return self.model.get_submodule(self.names[path])

    def cbr(self, path, site, x, stride=1, relu=True):
        self._rec(site, x)
        mod, leaf = path.rsplit("/", 1)
        conv = self._module(path)
        bn = self._module(f"{mod}/{_BN_OF[leaf]}")
        y = _conv(x, conv.weight.to(self.dtype), stride)
        y = _bn(y, bn.weight, bn.bias, bn.running_mean, bn.running_var,
                self.dtype)
        return _relu(y) if relu else y

    def conv(self, path, site, x, stride=1):
        self._rec(site, x)
        conv = self._module(path)
        y = _conv(x, conv.weight.to(self.dtype), stride)
        return y + conv.bias.to(self.dtype)

    def requant(self, site, x):
        self._rec(site, x)
        return x

    def dequant(self, x):
        return x

    def maxpool(self, x):
        return _max_pool_fp(x)


class _Int8Mode:
    """The traversal over a qtree: int8 convs, backbone activations as
    :class:`QTensor`, FPN and head inputs quantized at the consumer with
    their site's scale."""

    def __init__(self, qtree, dtype=torch.bfloat16):
        self.q = qtree
        self.dtype = dtype

    def _apply(self, path, site, x: Union[torch.Tensor, QTensor], stride):
        node = self.q["weights"][path]
        if "w16" in node:  # the stem: a bf16 conv, BN folded
            x = self.dequant(x)
            y = _conv(_as(x, self.dtype),
                      _as(node["w16"], self.dtype).permute(3, 2, 0, 1),
                      stride)
            return y + _as(node["b"], self.dtype)
        if isinstance(x, QTensor):
            xq, sx = x.q, x.s
        else:
            sx = self.q["act_scales"][site]
            xq = _quantize_act(x, sx)
        y = conv_int8(xq, node["w"], stride)
        return _as(y.to(torch.float32) * (sx * node["ws"]) + node["b"],
                   self.dtype)

    def cbr(self, path, site, x, stride=1, relu=True):
        y = self._apply(path, site, x, stride)  # BN folded at quantize time
        return _relu(y) if relu else y

    def conv(self, path, site, x, stride=1):
        return self._apply(path, site, x, stride)

    def requant(self, site, x) -> QTensor:
        s = self.q["act_scales"][site]
        return QTensor(_quantize_act(x, s), s)

    def dequant(self, x):
        if isinstance(x, QTensor):
            return _as(x.q.to(torch.float32) * x.s, self.dtype)
        return x

    def maxpool(self, x):
        if isinstance(x, QTensor):  # int8 max is the fp max (s > 0)
            return QTensor(max_pool_int8(x.q), x.s)
        return _max_pool_fp(x)


def _backbone_forward(mode, cfg: Config, images: torch.Tensor):
    """detjax's ``_backbone_forward``: the ResNet, frozen BatchNorm."""
    block, stage_sizes = RESNET_SPECS[cfg.model.backbone_depth]
    x = _as(images, mode.dtype)
    x = mode.cbr("backbone/conv1", "backbone/conv1", x, stride=2)
    # pool before the requant: ReLU and max-pool keep the global abs-max,
    # and the requant then touches 4x fewer elements
    x = mode.maxpool(x)
    x = mode.requant("backbone/conv1@out", x)
    feats = {}
    for stage, (size, f) in enumerate(zip(stage_sizes, (64, 128, 256, 512))):
        for bidx in range(size):
            stride = 2 if bidx == 0 and stage > 0 else 1
            base = f"backbone/layer{stage + 1}_block{bidx}"
            expansion = 4 if block == "bottleneck" else 1
            width = (x.q if isinstance(x, QTensor) else x).shape[-1]
            has_proj = width != f * expansion or stride != 1
            res = x
            if block == "bottleneck":
                y = mode.cbr(f"{base}/conv1", f"{base}/conv1", x)
                y = mode.requant(f"{base}/conv1@out", y)
                y = mode.cbr(f"{base}/conv2", f"{base}/conv2", y, stride)
                y = mode.requant(f"{base}/conv2@out", y)
                y = mode.cbr(f"{base}/conv3", f"{base}/conv3", y, relu=False)
            else:
                y = mode.cbr(f"{base}/conv1", f"{base}/conv1", x, stride)
                y = mode.requant(f"{base}/conv1@out", y)
                y = mode.cbr(f"{base}/conv2", f"{base}/conv2", y, relu=False)
            if has_proj:
                res = mode.cbr(f"{base}/downsample_conv",
                               f"{base}/downsample_conv", x, stride,
                               relu=False)
            else:
                res = mode.dequant(res)
            x = _relu(y + res)
            x = mode.requant(f"{base}@out", x)
        feats[stage + 2] = x
    return feats


def _gather_rows(x: Union[torch.Tensor, QTensor]
                 ) -> Union[torch.Tensor, QTensor]:
    """The whole image's rows of a row-sharded NHWC activation (a
    QTensor's int8 values, its scale kept)."""
    if isinstance(x, QTensor):
        return QTensor(spatial.gather_rows_nhwc(x.q), x.s)
    return spatial.gather_rows_nhwc(x)


def _fpn_forward(mode, cfg: Config, feats, row_sharded: bool = True):
    """detjax's ``_fpn_forward``: laterals, top-down sum, outputs, P6 on
    C5, P7 on ReLU(P6). Under an active space group, ``row_sharded`` is
    the layout rule's decision (``models/fpn.py``): False gathers the
    outputs and C5 and runs P6 and P7 on whole rows."""
    m = cfg.model
    feats = {lvl: f for lvl, f in feats.items() if lvl >= m.min_level}
    levels = sorted(feats)
    laterals = {lvl: mode.conv(f"fpn/lateral_p{lvl}", f"fpn/lateral_p{lvl}",
                               feats[lvl]) for lvl in levels}
    top = max(levels)
    merged = {top: laterals[top]}
    for lvl in range(top - 1, m.min_level - 1, -1):
        up = _upsample_nearest_2x(merged[lvl + 1], laterals[lvl].shape[1:3])
        merged[lvl] = laterals[lvl] + up
    out = {lvl: mode.conv(f"fpn/output_p{lvl}", f"fpn/output_p{lvl}",
                          merged[lvl]) for lvl in merged}
    c5 = feats[top]
    whole = spatial.active() is not None and not row_sharded
    if whole:
        out = {lvl: _gather_rows(x) for lvl, x in out.items()}
        c5 = _gather_rows(c5)
    with spatial.replicated() if whole else contextlib.nullcontext():
        if m.max_level >= top + 1:
            out[top + 1] = mode.conv(f"fpn/output_p{top + 1}",
                                     f"fpn/output_p{top + 1}", c5, stride=2)
        for lvl in range(top + 2, m.max_level + 1):
            out[lvl] = mode.conv(f"fpn/output_p{lvl}", f"fpn/output_p{lvl}",
                                 _relu(out[lvl - 1]), stride=2)
    return {lvl: out[lvl] for lvl in range(m.min_level, m.max_level + 1)}


def _flatten_level(x: torch.Tensor, c: int) -> torch.Tensor:
    return x.reshape(x.shape[0], -1, c)


def _head_forward(mode, cfg: Config, pyramid, full_rows=None):
    """detjax's ``_head_forward``. SSD: one predictor pair a level, each
    its own site. RetinaNet: the towers' weights are shared over the
    levels, each (conv, level) site has its own scale. ``full_rows``
    (:func:`_gather_rows` on a row-sharded pyramid) is applied to each
    level's outputs before the flatten."""
    m = cfg.model
    rows = full_rows or (lambda t: t)
    cls_all, box_all = [], []
    if m.family == "ssd":
        for level in sorted(pyramid):
            x = pyramid[level]
            cls = mode.conv(f"head/cls_p{level}", f"head/cls_p{level}", x)
            box = mode.conv(f"head/box_p{level}", f"head/box_p{level}", x)
            cls_all.append(_flatten_level(rows(cls), m.num_classes))
            box_all.append(_flatten_level(rows(box), 4))
        return torch.cat(cls_all, dim=1), torch.cat(box_all, dim=1)
    for level in sorted(pyramid):
        x = pyramid[level]
        c = x
        for i in range(m.num_head_convs):
            c = _relu(mode.conv(f"head/cls_conv{i}",
                                f"head/cls_conv{i}@p{level}", c))
        cls = mode.conv("head/cls_out", f"head/cls_out@p{level}", c)
        cls_all.append(_flatten_level(rows(cls), m.num_classes))
        b = x
        for i in range(m.num_head_convs):
            b = _relu(mode.conv(f"head/box_conv{i}",
                                f"head/box_conv{i}@p{level}", b))
        box = mode.conv("head/box_out", f"head/box_out@p{level}", b)
        box_all.append(_flatten_level(rows(box), 4))
    return torch.cat(cls_all, dim=1), torch.cat(box_all, dim=1)


def _forward(mode, cfg: Config, images: torch.Tensor):
    """The traversal; under an active space group on this rank's rows of
    ``images`` with the layout rule of ``models/detector.py``, decided
    once from the canvas, and outputs over the whole canvas."""
    m = cfg.model
    sg = spatial.active()
    row_sharded = True
    if sg is not None:
        canvas = images.shape[1] * sg.size
        spatial.check_canvas_rows(canvas, sg.size)
        row_sharded = spatial.pyramid_sharded(
            canvas, range(m.min_level, m.max_level + 1), sg.size)
    feats = _backbone_forward(mode, cfg, images)
    pyramid = _fpn_forward(mode, cfg, feats, row_sharded)
    whole = sg is not None and not row_sharded
    with spatial.replicated() if whole else contextlib.nullcontext():
        return _head_forward(mode, cfg, pyramid,
                             _gather_rows if sg is not None and row_sharded
                             else None)


def _images(images, device) -> torch.Tensor:
    x = torch.as_tensor(images)
    return (x[None] if x.ndim == 3 else x).to(device)


def forward_fp(model, cfg, images, dtype=torch.bfloat16
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The traversal in ``dtype`` over ``model``'s weights: normalized NHWC
    images -> (cls_logits [B, A, K], box_deltas [B, A, 4]); tested to
    match the model's own forward."""
    cfg = _config(cfg)
    dev = next(model.parameters()).device
    with torch.inference_mode():
        return _forward(_FpMode(model, dtype), cfg, _images(images, dev))


def calibrate(model, cfg, images, calib_mode: str = "absmax"
              ) -> Dict[str, np.float32]:
    """One bf16 pass of the traversal over normalized calibration
    ``images`` [N, H, W, 3] -> each site's activation scale
    ``max(range, 1e-6) / 127`` (np.float32), the range per
    ``calib_mode``."""
    cfg = _config(cfg)
    mode = _FpMode(model, torch.bfloat16, record=True, calib_mode=calib_mode)
    dev = next(model.parameters()).device
    with torch.inference_mode():
        _forward(mode, cfg, _images(images, dev))
    return {site: np.float32(max(np.float32(m.item()), 1e-6) / 127.0)
            for site, m in mode.stats.items()}


def _fold_bn_fp32(kernel, bn, eps: float = 1e-5):
    """detjax's ``_fold_bn_fp32``, in numpy fp32: (w_eff, b_eff)."""
    def f32(t):
        return t.detach().cpu().numpy().astype(np.float32)
    s = f32(bn.weight) / np.sqrt(f32(bn.running_var) + eps)
    w = np.asarray(kernel, np.float32) * s
    b = f32(bn.bias) - f32(bn.running_mean) * s
    return w, b


def quantize(model, cfg, act_scales: Dict[str, np.float32], device=None
             ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Fold BN and quantize every conv per output channel, symmetric int8,
    with detjax's numpy arithmetic -> the qtree, on ``device`` (default:
    the model's)."""
    cfg = _config(cfg)
    dev = next(model.parameters()).device if device is None else \
        torch.device(device)
    names = module_names(model.cfg)
    weights: Dict[str, Dict[str, torch.Tensor]] = {}
    for path, name in names.items():
        conv = model.get_submodule(name)
        if not isinstance(conv, torch.nn.Conv2d):
            continue
        # OIHW -> detjax's HWIO, fp32 exactly
        k = np.transpose(conv.weight.detach().cpu().numpy().astype(
            np.float32), (2, 3, 1, 0))
        mod, leaf = path.rsplit("/", 1)
        bn_path = f"{mod}/{_BN_OF[leaf]}" if leaf in _BN_OF else None
        if bn_path is not None and bn_path in names:
            w, b = _fold_bn_fp32(k, model.get_submodule(names[bn_path]))
        elif conv.bias is not None:
            w, b = k, conv.bias.detach().cpu().numpy().astype(np.float32)
        else:
            w, b = k, np.zeros(k.shape[-1], np.float32)
        if path == "backbone/conv1":  # the stem: bf16, BN folded
            weights[path] = {
                "w16": torch.from_numpy(w).to(dev, torch.bfloat16),
                "b": torch.from_numpy(b).to(dev)}
            continue
        ws = np.maximum(np.abs(w).max(axis=(0, 1, 2)), 1e-8) / 127.0
        w_i8 = np.clip(np.round(w / ws), -127, 127).astype(np.int8)
        weights[path] = {"w": torch.from_numpy(w_i8).to(dev),
                         "ws": torch.from_numpy(
                             np.asarray(ws, np.float32)).to(dev),
                         "b": torch.from_numpy(b).to(dev)}
    return {"weights": weights,
            "act_scales": {k: torch.tensor(np.float32(v), device=dev)
                           for k, v in act_scales.items()}}


def forward_int8(qtree, cfg, images) -> Tuple[torch.Tensor, torch.Tensor]:
    """The int8 forward: normalized NHWC images -> (cls_logits, box_deltas)
    in bf16."""
    cfg = _config(cfg)
    with torch.inference_mode():
        return _forward(_Int8Mode(qtree), cfg,
                        _images(images, qtree_device(qtree)))


def quantize_model(model, cfg, calib_images, calib_mode: str = "absmax",
                   device=None):
    """:func:`calibrate` then :func:`quantize`; ``calib_mode`` one of
    :data:`CALIB_MODES`."""
    return quantize(model, cfg, calibrate(model, cfg, calib_images,
                                          calib_mode), device=device)


def qtree_device(qtree) -> torch.device:
    return next(iter(qtree["act_scales"].values())).device


def detect_int8(qtree, images, cfg):
    """Int8 inference on normalized NHWC images -> :class:`Detections`,
    the contract of :func:`detjax_torch.detect`."""
    from detjax_torch.modeling import _anchors, anchor_config, \
        postprocess_logits

    cfg = _config(cfg)
    dev = qtree_device(qtree)
    with torch.inference_mode():
        cls_logits, box_deltas = _forward(_Int8Mode(qtree), cfg,
                                          _images(images, dev))
        return postprocess_logits(
            cls_logits, box_deltas,
            _anchors(cfg.model.image_size, anchor_config(cfg), dev), cfg)


def detect_int8_u8(qtree, canvases_u8, cfg):
    """:func:`detect_int8` over raw uint8 letterboxed canvases; the
    normalization (``cfg.data.mean/std``, to the model dtype) runs on the
    qtree's device first."""
    from detjax_torch.data.pipeline import normalize_u8
    from detjax_torch.models.detector import _DTYPES

    cfg = _config(cfg)
    canvases = torch.as_tensor(canvases_u8)
    if canvases.dtype != torch.uint8:
        raise TypeError(f"canvases must be uint8, got {canvases.dtype}")
    x = normalize_u8(_images(canvases, qtree_device(qtree)), cfg.data.mean,
                     cfg.data.std, _DTYPES[cfg.model.dtype])
    return detect_int8(qtree, x, cfg)
