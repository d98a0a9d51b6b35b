"""Public API of the port: model build, train step, the training loop,
detect, the int8 engine and the detect export (``detjax/api.py``)."""

from __future__ import annotations


def build_model(preset, seed: int = 0, device=None, **overrides):
    """Build a detector with seeded random weights on ``device`` (default
    ``cuda``; raises without a GPU unless ``device="cpu"``). See
    :func:`detjax_torch.modeling.build_model`."""
    from detjax_torch.modeling import build_model as _impl

    return _impl(preset, seed, device, **overrides)


def make_train_state(preset, seed: int = 0, device=None, **overrides):
    """A fresh training state (model, optimizer, optional EMA) for
    ``preset`` on ``device`` (default ``cuda``; raises without a GPU unless
    ``device="cpu"``). See :func:`detjax_torch.train.step.make_train_state`.
    """
    from detjax_torch.train.step import make_train_state as _impl

    return _impl(preset, seed, device, **overrides)


def train_step(state, batch, **kwargs):
    """One optimization step, updating ``state`` in place: augment,
    forward, matching (the CUDA kernel on a GPU), focal + smooth-L1,
    backward, clip, optimizer. Returns ``(state, metrics)``. See
    :func:`detjax_torch.train.step.train_step`."""
    from detjax_torch.train.step import train_step as _impl

    return _impl(state, batch, **kwargs)


def detect(model, images, preset="retinanet_r50_640", **overrides):
    """End-to-end inference over normalized NHWC images: forward, then
    candidate selection, decode and the class-aware NMS kernel."""
    from detjax_torch.modeling import detect as _impl

    return _impl(model, images, preset, **overrides)


def detect_u8(model, canvases_u8, preset="retinanet_r50_640", **overrides):
    """:func:`detect` over raw uint8 letterboxed canvases; normalization
    (``cfg.data.mean/std``) runs on the model's device first."""
    from detjax_torch.modeling import detect_u8 as _impl

    return _impl(model, canvases_u8, preset, **overrides)


def fit(cfg, train_batches, num_steps, **kwargs):
    """Train for ``num_steps`` steps over ``train_batches`` with periodic
    logging, plateau control, checkpoints (and resume) and evaluation, on
    ``device`` (default ``cuda``), or data-parallel with ``mesh=``
    (:func:`detjax_torch.parallel.make_mesh`). See
    :func:`detjax_torch.train.loop.fit`.
    """
    from detjax_torch.train.loop import fit as _impl

    return _impl(cfg, train_batches, num_steps, **kwargs)


def quantize_model(model, cfg, calib_images, calib_mode: str = "absmax",
                   device=None):
    """Calibrate and PTQ-quantize ``model`` on normalized ``calib_images``
    -> the int8 engine's qtree, on the model's device unless ``device``
    names another. See :func:`detjax_torch.quant.quantize_model`."""
    from detjax_torch.quant import quantize_model as _impl

    return _impl(model, cfg, calib_images, calib_mode, device=device)


def detect_int8(qtree, images, cfg):
    """Int8 inference over normalized NHWC images -> Detections. See
    :func:`detjax_torch.quant.detect_int8`."""
    from detjax_torch.quant import detect_int8 as _impl

    return _impl(qtree, images, cfg)


def detect_int8_u8(qtree, canvases_u8, cfg):
    """The int8 engine over raw uint8 canvases (normalization first, on
    the qtree's device). See :func:`detjax_torch.quant.detect_int8_u8`."""
    from detjax_torch.quant import detect_int8_u8 as _impl

    return _impl(qtree, canvases_u8, cfg)


def export_detect(model, cfg="retinanet_r50_640", batch_size: int = 1,
                  platforms=None, calibration=None,
                  input_format: str = "fp32", calib_mode: str = "absmax",
                  qtree=None, **overrides):
    """The detect step with its weights baked in, as a
    ``torch.export.ExportedProgram`` (the int8 engine's with
    ``calibration`` or an already quantized ``qtree``). See
    :func:`detjax_torch.export.export_detect`."""
    from detjax_torch.export import export_detect as _impl

    return _impl(model, cfg, batch_size, platforms, calibration,
                 input_format, calib_mode, qtree=qtree, **overrides)
