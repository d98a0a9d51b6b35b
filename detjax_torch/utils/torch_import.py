"""Import torchvision-format and lineage checkpoints into the port
(the import side of ``detjax/utils/torch_import.py``).

Pretrained backbones arrive as a ``torch.save``'d ``state_dict`` (a
torchvision ResNet) and whole lineage detectors as the lineage's own
``state_dict`` (backbone keys at the top level, then ``fpn.*``,
``classificationModel.*``, ``regressionModel.*``). The port's modules use
those names, so where detjax maps each key onto its flax tree the port
only checks it: that the key is one the model expects, and its shape.
The expected keys come from ``utils/weights.py``'s key maps, in detjax's
order, so the ``report`` (``imported``, ``missing``, ``unused``) is
detjax's key for key.

Two forms, as in detjax: :func:`import_resnet_backbone` and
:func:`import_full_detector` load into a live :class:`Detector` or
``TrainState`` and return the report; :func:`import_into_variables` and
:func:`import_detector_into_variables` take a lineage-named state dict
(the port's ``variables``) and return a new one.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from detjax_torch.models.resnet import RESNET_SPECS
from detjax_torch.utils.weights import _head_key_map, _resnet_key_map

_BN_LEAVES = ("weight", "bias", "running_mean", "running_var")
Report = Dict[str, List[str]]


def load_state_dict_file(path: str,
                         allow_pickle: bool = False) -> Dict[str, np.ndarray]:
    """Load a ``torch.save``'d state_dict (or a module with
    ``.state_dict()``) into plain numpy arrays.

    Loads with ``weights_only=True`` (tensors only). Lineage checkpoints
    saved as whole pickled modules need ``allow_pickle=True``, which runs
    code from the file: only for trusted checkpoints (``--unsafe-pickle``
    in the CLI)."""
    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except Exception as e:  # a pickled module or another non-tensor payload
        if not allow_pickle:
            raise ValueError(
                f"{path} is not a plain state_dict loadable with "
                "weights_only=True (likely a whole pickled module, which "
                "the reference lineage's per-epoch torch.save produces). "
                "Unpickling it executes code from the file; pass "
                "allow_pickle=True / --unsafe-pickle if you trust it."
            ) from e
        obj = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    return {k: np.asarray(v.detach().cpu().numpy()) if hasattr(v, "detach")
            else np.asarray(v) for k, v in obj.items()}


def _backbone_keys(depth: int, stage_sizes=None, block=None) -> List[str]:
    """The backbone's state-dict keys in detjax's importer's order."""
    spec_block, spec_sizes = RESNET_SPECS[depth]
    key_map = _resnet_key_map(stage_sizes or spec_sizes, block or spec_block)
    keys = []
    for tkey, fpath in key_map.items():
        if "bn" in fpath[-1]:
            keys += [f"{tkey}.{leaf}" for leaf in _BN_LEAVES]
        else:
            keys.append(f"{tkey}.weight")
    return keys


def _copy_keys(variables: Dict[str, torch.Tensor], sd: Mapping, keys,
               report: Report, used: set) -> None:
    """Copy each of ``keys`` that ``sd`` has into ``variables`` (cast to
    the variable's dtype and device), checking its shape; list it as
    imported or missing."""
    for k in keys:
        if k not in sd:
            report["missing"].append(k)
            continue
        if k not in variables:
            raise KeyError(f"the model has no {k}")
        v = torch.as_tensor(np.asarray(sd[k]))
        want = variables[k]
        if tuple(v.shape) != tuple(want.shape):
            raise ValueError(f"shape mismatch at {k}: model "
                             f"{tuple(want.shape)} vs checkpoint "
                             f"{tuple(v.shape)}")
        variables[k] = v.to(device=want.device, dtype=want.dtype)
        used.add(k)
        report["imported"].append(k)


def _import_backbone(variables: Mapping[str, torch.Tensor], sd: Mapping,
                     depth: int, prefix: str = "", strict: bool = True,
                     stage_sizes=None, block=None
                     ) -> Tuple[Dict[str, torch.Tensor], Report]:
    out = dict(variables)
    sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    report: Report = {"imported": [], "missing": []}
    used: set = set()
    _copy_keys(out, sd, _backbone_keys(depth, stage_sizes, block), report,
               used)
    if strict and report["missing"]:
        raise KeyError(
            f"{len(report['missing'])} expected backbone weights missing, "
            f"e.g. {report['missing'][:5]} (pass strict=False to ignore)")
    report["unused"] = [
        k for k in sd if k not in used
        and not k.startswith(("fc.", "head", "fpn"))
        and not k.endswith("num_batches_tracked")]
    return out, report


def _import_detector(variables: Mapping[str, torch.Tensor], sd: Mapping,
                     depth: int, prefix: str = "", strict: bool = True,
                     stage_sizes=None, block=None, num_head_convs: int = 4,
                     min_level: int = 3, max_level: int = 7,
                     family: str = "retinanet"
                     ) -> Tuple[Dict[str, torch.Tensor], Report]:
    sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    if not any(k.startswith("conv1") for k in sd) and any(
            k.startswith("module.") for k in sd):
        sd = {k[len("module."):]: v for k, v in sd.items()
              if k.startswith("module.")}
    out, report = _import_backbone(variables, sd, depth, strict=strict,
                                   stage_sizes=stage_sizes, block=block)
    used = set(report["imported"])
    head = [f"{tkey}.{leaf}" for tkey in _head_key_map(
        family, num_head_convs, min_level, max_level)
        for leaf in ("weight", "bias")]
    _copy_keys(out, sd, head, report, used)
    if strict and report["missing"]:
        raise KeyError(
            f"{len(report['missing'])} expected detector weights missing, "
            f"e.g. {report['missing'][:5]} (pass strict=False to ignore)")
    report["unused"] = [
        k for k in sd if k not in used
        and not k.endswith("num_batches_tracked")
        # anchor and decode helpers the lineage registers as buffers
        and not k.startswith(("anchors.", "regressBoxes.", "clipBoxes."))]
    return out, report


def _model(target) -> torch.nn.Module:
    """The Detector of a Detector or a TrainState."""
    return getattr(target, "model", target)


def import_resnet_backbone(target, state_dict: Mapping, prefix: str = "",
                           strict: bool = True) -> Report:
    """Load torchvision-format ResNet weights into the backbone of
    ``target`` (a :class:`Detector` or a ``TrainState``), in place.
    ``prefix`` is stripped from the keys first (e.g. ``"module.backbone."``);
    ``strict`` raises if an expected backbone weight is missing. Returns
    the report: ``imported``, ``missing`` (expected, absent) and ``unused``
    keys (``fc.``, ``head``, ``fpn`` and ``num_batches_tracked`` aside)."""
    model = _model(target)
    sd, report = _import_backbone(model.state_dict(), state_dict,
                                  model.cfg.backbone_depth, prefix, strict)
    model.load_state_dict(sd, strict=True)
    return report


def import_full_detector(target, state_dict: Mapping, prefix: str = "",
                         strict: bool = True) -> Report:
    """Load a complete lineage detector checkpoint (backbone, FPN and
    heads) into ``target`` (a :class:`Detector` or a ``TrainState``), in
    place. ``prefix`` is stripped first; a ``module.`` DataParallel prefix
    is also handled. Returns the report, as detjax's."""
    model = _model(target)
    m = model.cfg
    sd, report = _import_detector(
        model.state_dict(), state_dict, m.backbone_depth, prefix, strict,
        num_head_convs=m.num_head_convs, min_level=m.min_level,
        max_level=m.max_level, family=m.family)
    model.load_state_dict(sd, strict=True)
    return report


def import_into_variables(variables: Mapping[str, torch.Tensor],
                          state_dict: Mapping, depth: int = 50,
                          prefix: str = "", strict: bool = True,
                          stage_sizes: Optional[Tuple[int, ...]] = None,
                          block: Optional[str] = None
                          ) -> Dict[str, torch.Tensor]:
    """Backbone import, a lineage-named state dict in and a new one out."""
    return _import_backbone(variables, state_dict, depth, prefix, strict,
                            stage_sizes, block)[0]


def import_detector_into_variables(variables: Mapping[str, torch.Tensor],
                                   state_dict: Mapping, depth: int = 50,
                                   **kw) -> Dict[str, torch.Tensor]:
    """Full-detector import, a lineage-named state dict in and a new one
    out; ``kw`` as :func:`_import_detector` (``prefix``, ``strict``,
    ``num_head_convs``, ``min_level``, ``max_level``, ``family``)."""
    return _import_detector(variables, state_dict, depth, **kw)[0]
