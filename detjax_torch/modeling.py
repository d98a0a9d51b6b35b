"""Model build and the detect path (``detjax/modeling.py``).

``detect_u8``: uint8 NHWC canvases -> normalize on the model's device ->
NCHW forward in eval mode -> candidate selection in the logit domain ->
decode and clip of the candidates only -> class-aware greedy NMS (the CUDA
kernel on a GPU, its plain twin on the CPU) -> fixed-size
:class:`Detections`. Anchors are built once per config and device and
kept on the device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools

import torch

from detjax_torch.config import Config, get_config
from detjax_torch.data.pipeline import normalize_u8
from detjax_torch.models.detector import Detector
from detjax_torch.ops.anchors import AnchorConfig, anchors_for_shape
from detjax_torch.ops.nms import Detections, fused_detect_postprocess


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller names another device; raises when CUDA is
    asked for and there is none. There is no quiet CPU fallback."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "detjax_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run on the CPU")
    return dev


def anchor_config(cfg: Config) -> AnchorConfig:
    m = cfg.model
    return AnchorConfig(
        min_level=m.min_level, max_level=m.max_level,
        scales=m.anchor_scales, ratios=m.anchor_ratios,
        base_scale=m.anchor_base_scale,
        per_level_sizes=m.anchor_per_level_sizes)


@functools.lru_cache(maxsize=16)
def _anchors(image_size, acfg: AnchorConfig, device: torch.device
             ) -> torch.Tensor:
    return torch.from_numpy(anchors_for_shape(image_size, acfg)).to(device)


def _config(preset, overrides) -> Config:
    return preset if isinstance(preset, Config) else get_config(preset,
                                                               **overrides)


def build_model(preset, seed: int = 0, device=None, **overrides) -> Detector:
    """A :class:`Detector` for ``preset`` with weights drawn from
    ``torch.Generator().manual_seed(seed)``, in eval mode, on ``device``
    (default ``cuda``), channels-last. Load other weights with
    ``model.load_state_dict(...)``, e.g. from
    :func:`detjax_torch.utils.weights.from_jax`."""
    cfg = _config(preset, overrides)
    dev = resolve_device(device)
    model = Detector(cfg.model)
    model.init_weights(torch.Generator().manual_seed(int(seed)))
    model.eval().requires_grad_(False)
    return model.to(dev, memory_format=torch.channels_last)


def _model_device(model: Detector, cfg: Config) -> torch.device:
    """The model's device, once ``cfg`` is known to describe this model
    (its name and canvas size may differ: they change no weight)."""
    if dataclasses.replace(cfg.model, name=model.cfg.name,
                           image_size=model.cfg.image_size) != model.cfg:
        raise ValueError(
            "the config's model section differs from the one the model was "
            f"built with (beyond name and image_size): {cfg.model} vs "
            f"{model.cfg}")
    return next(model.parameters()).device


@contextlib.contextmanager
def eval_mode(model: torch.nn.Module):
    """The model in eval mode inside, the caller's mode restored after:
    detjax applies the model with ``train=False`` to detect, so a
    batch-statistics BatchNorm normalises with its running statistics and
    leaves them as they were, and fused blocks take their fused route."""
    was_training = model.training
    model.eval()
    try:
        yield model
    finally:
        model.train(was_training)


def postprocess_logits(cls_logits: torch.Tensor, box_deltas: torch.Tensor,
                       anchors: torch.Tensor, cfg: Config,
                       nms_backend: str = "auto") -> Detections:
    """The detect path after the forward: fp32 box deltas (bf16 would
    quantize decoded coords to ~2 px at 640), class scores kept as raw
    logits for logit-domain selection, then the fused postprocess."""
    e = cfg.eval
    return fused_detect_postprocess(
        box_deltas.to(torch.float32), anchors, cls_logits,
        box_std=cfg.model.box_std,
        image_size=cfg.model.image_size,
        score_threshold=e.score_threshold,
        iou_threshold=e.nms_iou_threshold,
        num_candidates=e.pre_nms_top_k,
        max_detections=e.max_detections,
        exact=e.exact_candidates,
        backend=nms_backend,
        scores_are_logits=True,
        topk=e.topk_mode)


def detect_graph(model: Detector, images_nhwc: torch.Tensor, cfg: Config,
                 anchors: torch.Tensor, nms_backend: str = "auto"
                 ) -> Detections:
    """Forward + postprocess on normalized NHWC images, with no mode or
    grad context of its own: :func:`detect` runs it in inference and eval
    mode, and :mod:`detjax_torch.export` traces it."""
    cls_logits, box_deltas = model(images_nhwc.permute(0, 3, 1, 2))
    return postprocess_logits(cls_logits, box_deltas, anchors, cfg,
                              nms_backend)


def _run(model: Detector, images_nhwc: torch.Tensor, cfg: Config,
         nms_backend: str) -> Detections:
    with torch.inference_mode(), eval_mode(model):
        return detect_graph(
            model, images_nhwc, cfg,
            _anchors(cfg.model.image_size, anchor_config(cfg),
                     images_nhwc.device), nms_backend)


def detect(model: Detector, images, preset="retinanet_r50_640",
           nms_backend: str = "auto", **overrides) -> Detections:
    """Batched inference on normalized NHWC images ``[B, H, W, 3]`` (numpy
    or tensor), on the model's device. ``nms_backend``: "auto" (the CUDA
    kernel for a CUDA model, the twin on the CPU), or "torch" to run the
    plain twin on any device."""
    cfg = _config(preset, overrides)
    dev = _model_device(model, cfg)
    images = torch.as_tensor(images)
    if images.ndim == 3:
        images = images[None]
    return _run(model, images.to(dev), cfg, nms_backend)


def detect_u8(model: Detector, canvases_u8, preset="retinanet_r50_640",
              nms_backend: str = "auto", **overrides) -> Detections:
    """:func:`detect` over raw uint8 letterboxed canvases ``[B, H, W, 3]``;
    normalization (``cfg.data.mean/std``, fp32 math, one cast to the model
    dtype) runs on the model's device."""
    cfg = _config(preset, overrides)
    dev = _model_device(model, cfg)
    canvases = torch.as_tensor(canvases_u8)
    if canvases.dtype != torch.uint8:
        raise TypeError(f"canvases must be uint8, got {canvases.dtype}")
    if canvases.ndim == 3:
        canvases = canvases[None]
    x = normalize_u8(canvases.to(dev), cfg.data.mean, cfg.data.std,
                     model.compute_dtype)
    return _run(model, x, cfg, nms_backend)
