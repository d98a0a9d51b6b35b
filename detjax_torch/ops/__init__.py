"""Detection ops: anchors, box math, matching, losses, candidate selection
and NMS; the names ``detjax.ops`` exports.

The names load on first access: the kernel wrappers import the ops
modules they wrap, and the ops modules import the wrappers, so an eager
import here would be circular.
"""

import importlib

_SOURCES = {
    "AnchorConfig": "anchors",
    "generate_anchors": "anchors",
    "anchors_for_shape": "anchors",
    "box_iou": "boxes",
    "encode_boxes": "boxes",
    "decode_boxes": "boxes",
    "clip_boxes": "boxes",
    "decode_clip_boxes": "boxes",
    "match_anchors": "matching",
    "focal_loss": "losses",
    "smooth_l1_loss": "losses",
    "detection_loss": "losses",
    "class_aware_nms": "nms",
    "nms_single_class": "nms",
    "batched_detect_postprocess": "nms",
    "fused_detect_postprocess": "nms",
}

__all__ = list(_SOURCES)


def __getattr__(name):
    if name not in _SOURCES:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    module = importlib.import_module(f"{__name__}.{_SOURCES[name]}")
    return getattr(module, name)
