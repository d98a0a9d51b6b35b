"""detjax_torch: the PyTorch and CUDA port of detjax, for one NVIDIA H100.

detjax (the JAX package beside this one) is the reference. This package
carries its serving path (``build_model`` -> ``detect`` / ``detect_u8`` ->
the micro-batching ``DetectionServer``) and its training path
(``make_train_state`` -> ``train_step``), at the full width of every
RetinaNet preset, and serving and training with
``model.fused_backbone="on"``. detjax's Pallas kernels on those paths are
replaced by CUDA kernels written by hand for ``sm_90a``: NMS
(``detjax_torch/csrc/nms.cu``), anchor matching
(``detjax_torch/csrc/matching.cu``) and the fused identity bottleneck's
forward (``detjax_torch/csrc/bottleneck.cu``) and backward
(``detjax_torch/csrc/bottleneck_bwd.cu``).

Ground rules:

- **Imports.** This package imports ``torch``, ``numpy``, the standard
  library and, only where detjax itself does, PIL. It never imports
  ``jax``, ``flax`` or anything under ``detjax/``, not even detjax modules
  that use only numpy: it keeps its own copy of what it needs from them
  (``config.py``, ``ops/anchors.py``, the weight key maps, the letterbox).
  Only the tests import both packages.
- **The JAX package** stays as it is; it is the reference the tests
  compare against.
- **Devices.** Entry points run on ``cuda`` unless the caller passes
  ``device="cpu"``. Without a GPU and without ``device="cpu"`` they raise;
  there is no quiet CPU path. A kernel wrapper given a CPU tensor runs its
  plain PyTorch twin; given a CUDA tensor it launches the kernel or raises.
- **Layout.** The public functions keep detjax's layout: uint8 ``[B,H,W,3]``
  NHWC canvases in; ``Detections(boxes [B,D,4], scores [B,D], labels [B,D]
  (-1 pad), num_valid [B])`` out. Inside, modules are NCHW ``nn.Module``s
  with the lineage's parameter names.
- **Randomness.** Initialisation draws from an explicit
  ``torch.Generator`` seeded by the caller.

    >>> import detjax_torch
    >>> model = detjax_torch.build_model("retinanet_r50_640", seed=0)
    >>> dets = detjax_torch.detect_u8(model, canvases_u8)
    >>> state = detjax_torch.make_train_state("retinanet_r50_640", seed=0)
    >>> state, metrics = detjax_torch.train_step(state, batch)
"""

from detjax_torch.config import (
    PRESETS,
    Config,
    DataConfig,
    EvalConfig,
    ModelConfig,
    TrainConfig,
    get_config,
)
from detjax_torch.api import (
    build_model,
    detect,
    detect_u8,
    make_train_state,
    train_step,
)

__version__ = "0.1.0"


def serve(*args, **kwargs):
    """Micro-batching detection server: constructs
    :class:`detjax_torch.serve.DetectionServer`."""
    from detjax_torch.serve import DetectionServer

    return DetectionServer(*args, **kwargs)


__all__ = [
    "Config",
    "ModelConfig",
    "TrainConfig",
    "DataConfig",
    "EvalConfig",
    "get_config",
    "PRESETS",
    "build_model",
    "detect",
    "detect_u8",
    "make_train_state",
    "train_step",
    "serve",
]
