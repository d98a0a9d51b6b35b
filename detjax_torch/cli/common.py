"""Shared CLI plumbing (``detjax/cli/common.py``): ``--set group.field=
value`` override parsing, PTQ calibration batches from image files, and
the inference model restored from the port's checkpoints (as
``cli/train.py`` / ``fit`` write them), for the detect, evaluate, export
and serve CLIs.

detjax's ``--compilation-cache`` flag points XLA's persistent compile
cache at a directory; the port compiles no XLA programs (its CUDA kernels
build once per checkout, into ``detjax_torch/_build``), so none of its
CLIs has the flag.
"""

from __future__ import annotations

import ast
from typing import Optional


def parse_overrides(pairs) -> dict:
    """['a.b=1', 'c.d=(2,3)'] -> {'a.b': 1, 'c.d': (2, 3)} (literals when
    they parse, raw strings otherwise)."""
    out = {}
    for p in pairs or []:
        key, _, val = p.partition("=")
        try:
            out[key] = ast.literal_eval(val)
        except (ValueError, SyntaxError):
            out[key] = val
    return out


def load_calibration_batch(image_paths, cfg, normalize: bool = True):
    """Decode and letterbox image files into an [N, H, W, 3] PTQ
    calibration batch: normalized fp32 (a CPU tensor; what
    ``quantize_model`` and ``export_detect(calibration=...)`` take) by
    default, or the raw uint8 canvases (numpy) with ``normalize=False``
    (what ``DetectionServer(calibration=...)`` takes)."""
    import numpy as np
    from PIL import Image

    from detjax_torch.data.transforms import letterbox

    canvases = []
    for p in image_paths:
        img = np.asarray(Image.open(p).convert("RGB"), np.uint8)
        canvas, _, _ = letterbox(img, np.zeros((0, 4), np.float32),
                                 cfg.model.image_size)
        canvases.append(canvas)
    stacked = np.stack(canvases)
    if not normalize:
        return stacked

    import torch

    from detjax_torch.data.pipeline import normalize_u8

    return normalize_u8(torch.from_numpy(stacked), cfg.data.mean,
                        cfg.data.std)


def load_model(preset: str, ckpt_dir: str,
               overrides: Optional[dict] = None, use_ema: bool = False,
               device=None):
    """Build the preset's config and model on ``device`` (default
    ``cuda``) and load the latest checkpoint's weights into it ->
    ``(cfg, model)`` in eval mode.

    ``use_ema``: the EMA shadow in place of the live parameters (a
    checkpoint written with ``train.ema_decay > 0``)."""
    import torch

    from detjax_torch.config import get_config
    from detjax_torch.modeling import build_model
    from detjax_torch.train.checkpoint import STATE_FILE, Checkpointer

    cfg = get_config(preset, **(overrides or {}))
    if use_ema and cfg.train.ema_decay <= 0:
        raise ValueError(
            "--ema needs train.ema_decay>0: pass the same "
            "--set train.ema_decay=... the checkpoint was trained with")
    ckpt = Checkpointer(ckpt_dir)
    step = ckpt.latest_step()
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt.directory}")
    import os

    saved = torch.load(os.path.join(ckpt.directory, str(step), STATE_FILE),
                       map_location="cpu", weights_only=True)
    state_dict = dict(saved["model"])
    if use_ema:
        if "ema" not in saved:
            raise ValueError(
                f"--ema: the checkpoint of step {step} in {ckpt_dir!r} has "
                "no EMA shadow (was it trained with train.ema_decay>0?)")
        state_dict.update(saved["ema"])
    model = build_model(cfg, seed=0, device=device)
    model.load_state_dict(state_dict, strict=True)
    return cfg, model.eval()
