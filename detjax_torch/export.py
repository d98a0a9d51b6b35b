"""Serving export: the detect step as one saved ``torch.export`` program
(``detjax/export.py``).

detjax exports its fused detect step with the weights baked in as a
StableHLO artifact that needs only jax to run. The port's counterpart is a
``torch.export.ExportedProgram`` of the same step: weights (and, for the
int8 engine, the int8 weights and activation scales) as constants of the
program, the postprocess inside it, the CUDA kernels called through the
custom ops of :mod:`detjax_torch.kernels.ops` (NMS, and the fused
bottleneck's forward with ``model.fused_backbone="on"``). Loading one needs
torch and ``detjax_torch.kernels.ops`` (which registers the ops), and no
model code. One program has one input shape, ``(batch_size, H, W, 3)``.

Known differences from detjax:

- ``platforms`` names the one device the program is exported for,
  ``("cuda",)`` or ``("cpu",)``; the program runs only there. torch has no
  cross-lowering, so any other value raises.
- The program is traced in eval mode; a bf16 model's autocast region is
  decomposed to ATen (``run_decompositions``) into explicit casts.
- There is no compile cache: the program runs eagerly op by op.
"""

from __future__ import annotations

import copy
from typing import Callable, Optional, Sequence

import torch

from detjax_torch.config import Config, get_config
from detjax_torch.kernels import ops as _kernel_ops  # noqa: F401 (registers)
from detjax_torch.ops.nms import Detections

INPUT_FORMATS = ("fp32", "u8")
PLATFORMS = ("cuda", "cpu")


def _export_device(model, platforms) -> torch.device:
    if platforms is None:
        return next(model.parameters()).device
    platforms = tuple(platforms)
    if len(platforms) != 1 or platforms[0] not in PLATFORMS:
        raise ValueError(
            f"platforms must name one device of {PLATFORMS}, got "
            f"{platforms!r}: a torch.export program runs on the device it "
            "was exported for (there is no cross-lowering)")
    from detjax_torch.modeling import resolve_device

    return resolve_device(platforms[0])


def _normalized(images, cfg: Config, dtype: torch.dtype, u8: bool):
    """uint8 canvases -> normalized images in ``dtype``; fp32 input as
    it is."""
    from detjax_torch.data.pipeline import normalize_u8

    return (normalize_u8(images, cfg.data.mean, cfg.data.std, dtype) if u8
            else images)


class _DetectProgram(torch.nn.Module):
    """The fp engine: normalize (u8) -> forward -> postprocess."""

    def __init__(self, model, cfg: Config, anchors, u8: bool):
        super().__init__()
        self.cfg, self.u8 = cfg, u8
        self.model = model
        self.register_buffer("anchors", anchors)

    def forward(self, images):
        from detjax_torch.modeling import detect_graph

        x = _normalized(images, self.cfg, self.model.compute_dtype, self.u8)
        det = detect_graph(self.model, x, self.cfg, self.anchors,
                           nms_backend="cuda")
        return tuple(det)


class _Int8Program(torch.nn.Module):
    """The int8 engine over a qtree whose tensors are this module's
    buffers."""

    def __init__(self, qtree, cfg: Config, anchors, u8: bool, dtype):
        super().__init__()
        self.cfg, self.u8, self.dtype = cfg, u8, dtype
        self.register_buffer("anchors", anchors)
        self._weights, self._scales = {}, {}
        for i, (path, node) in enumerate(sorted(qtree["weights"].items())):
            self._weights[path] = {}
            for key, t in node.items():
                self.register_buffer(f"w{i}_{key}", t.clone())
                self._weights[path][key] = f"w{i}_{key}"
        for i, (site, t) in enumerate(sorted(qtree["act_scales"].items())):
            self.register_buffer(f"s{i}", t.clone())
            self._scales[site] = f"s{i}"

    def forward(self, images):
        from detjax_torch.modeling import postprocess_logits
        from detjax_torch.quant import _forward, _Int8Mode

        qtree = {"weights": {p: {k: getattr(self, n) for k, n in node.items()}
                             for p, node in self._weights.items()},
                 "act_scales": {s: getattr(self, n)
                                for s, n in self._scales.items()}}
        x = _normalized(images, self.cfg, self.dtype, self.u8)
        cls_logits, box_deltas = _forward(_Int8Mode(qtree), self.cfg, x)
        return tuple(postprocess_logits(cls_logits, box_deltas, self.anchors,
                                        self.cfg, nms_backend="cuda"))


def export_detect(model, cfg: Config | str = "retinanet_r50_640",
                  batch_size: int = 1,
                  platforms: Optional[Sequence[str]] = None,
                  calibration=None, input_format: str = "fp32",
                  calib_mode: str = "absmax", qtree=None,
                  **overrides) -> torch.export.ExportedProgram:
    """Export the detect step of ``model`` (a ``Detector``) with its
    weights baked in, for input ``(batch_size, H, W, 3)``.

    With ``calibration`` (normalized [N, H, W, 3] images) the model is
    PTQ-quantized first (:func:`detjax_torch.quant.quantize_model`) and the
    int8 engine's program is exported instead; ``qtree`` (from
    :func:`~detjax_torch.quant.quantize_model`) exports the int8 engine of
    a tree already quantized. ``input_format``: "fp32"
    takes normalized fp32 images; "u8" takes raw uint8 canvases and
    normalizes inside the program (``cfg.data.mean/std``).
    ``platforms``: None for the model's device, or ``("cuda",)`` /
    ``("cpu",)``. The program returns ``(boxes, scores, labels,
    num_valid)``; :func:`load_detect` wraps it in :class:`Detections`.
    """
    from detjax_torch.modeling import (_anchors, anchor_config, eval_mode,
                                       _model_device)

    cfg = cfg if isinstance(cfg, Config) else get_config(cfg, **overrides)
    if input_format not in INPUT_FORMATS:
        raise ValueError(f"input_format must be 'fp32' or 'u8', "
                         f"got {input_format!r}")
    _model_device(model, cfg)  # the config describes this model
    dev = _export_device(model, platforms)
    # a copy on the program's device, in eval mode, its fused blocks'
    # folds made before the trace (the trace takes them as constants)
    model = copy.deepcopy(model).to(dev).eval().requires_grad_(False)
    with torch.no_grad():
        for block in model.fused_blocks():
            block.folded_weights()
    anchors = _anchors(cfg.model.image_size, anchor_config(cfg), dev).clone()
    u8 = input_format == "u8"
    if calibration is not None and qtree is not None:
        raise ValueError("pass calibration or qtree, not both")
    if calibration is not None:
        from detjax_torch.quant import quantize_model

        with eval_mode(model):
            qtree = quantize_model(model, cfg, calibration,
                                   calib_mode=calib_mode)
    if qtree is not None:
        qtree = {"weights": {p: {k: t.to(dev) for k, t in node.items()}
                             for p, node in qtree["weights"].items()},
                 "act_scales": {k: t.to(dev)
                                for k, t in qtree["act_scales"].items()}}
        program = _Int8Program(qtree, cfg, anchors, u8, model.compute_dtype)
    else:
        program = _DetectProgram(model, cfg, anchors, u8)
    h, w = cfg.model.image_size
    example = torch.zeros((batch_size, h, w, 3), device=dev,
                          dtype=torch.uint8 if u8 else torch.float32)
    with torch.no_grad():
        exported = torch.export.export(program.eval(), (example,),
                                       strict=False)
    if any(isinstance(node.target, torch._ops.HigherOrderOperator)
           for node in exported.graph.nodes):
        # autocast regions (a bf16 model): decomposed to ATen, they become
        # explicit casts, which save and load as any other op
        exported = exported.run_decompositions({})
    return exported


def save_detect(path: str, model, cfg: Config | str = "retinanet_r50_640",
                batch_size: int = 1,
                platforms: Optional[Sequence[str]] = None,
                calibration=None, input_format: str = "fp32",
                calib_mode: str = "absmax", qtree=None,
                **overrides) -> None:
    """Export (:func:`export_detect`) and write the program to ``path``,
    one file (``torch.export.save``)."""
    torch.export.save(export_detect(
        model, cfg, batch_size, platforms, calibration=calibration,
        input_format=input_format, calib_mode=calib_mode, qtree=qtree,
        **overrides), path)


def _program_input(exported: torch.export.ExportedProgram):
    """``(shape, dtype, device)`` of a detect program's one input."""
    for node in exported.graph.nodes:
        if node.op == "placeholder" and node.name in {
                s.arg.name for s in exported.graph_signature.input_specs
                if s.kind == torch.export.graph_signature.InputKind.USER_INPUT}:
            val = node.meta["val"]
            return tuple(val.shape), val.dtype, val.device
    raise ValueError("the program has no user input")


def load_detect(path: str) -> Callable[..., Detections]:
    """Load a saved detect program -> callable ``images -> Detections`` on
    the device it was exported for, with ``in_dtype`` (``torch.uint8`` for
    an "u8" program: raw canvases, normalization inside) and ``in_shape``.

    detjax's casting rule: a float feed to an fp32 program is cast to fp32;
    any other dtype than the program's (a float feed to a uint8 program)
    raises, as does another shape."""
    exported = torch.export.load(path)
    shape, in_dtype, device = _program_input(exported)
    module = exported.module()

    def run(images) -> Detections:
        x = torch.as_tensor(images)
        if (x.dtype != in_dtype and in_dtype == torch.float32
                and x.is_floating_point()):
            x = x.to(torch.float32)
        if x.dtype != in_dtype:
            raise TypeError(f"the program at {path!r} takes {in_dtype}, got "
                            f"{x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"the program at {path!r} takes shape {shape}, "
                             f"got {tuple(x.shape)}")
        with torch.inference_mode():
            return Detections(*module(x.to(device)))

    run.in_dtype = in_dtype
    run.in_shape = shape
    run.device = device
    return run
