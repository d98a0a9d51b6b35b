"""detjax_torch: the PyTorch and CUDA port of detjax, for one NVIDIA H100.

detjax (the JAX package beside this one) is the reference. This package
carries its serving path (``build_model`` -> ``detect`` / ``detect_u8`` ->
the micro-batching ``DetectionServer``), its training path
(``make_train_state`` -> ``train_step``, and the loop around it,
``fit``: plateau control, checkpoints and resume, periodic evaluation,
batch-statistics BatchNorm; ``python -m detjax_torch.cli.train``), its
data parallelism (``detjax_torch.parallel``: ``make_mesh`` over
torch.distributed, the data-parallel step, ``fit(mesh=)``, sharded
``evaluate(mesh=)`` and multi-device serving) and spatial partitioning
(``make_mesh(spatial=K)``: each image's rows split over K ranks,
``detjax_torch/models/spatial.py``), its
data pipeline
(``detjax_torch.data``: COCO and CSV datasets, the threaded batch
iterator, prefetch to the device) and its evaluation (``evaluate``: COCO
and VOC metrics over a dataset, also at each image's protocol canvas,
``detjax_torch.evaluation``), at the full width of every
RetinaNet preset, and serving and training with
``model.fused_backbone="on"``, and its other two serving engines: the
int8 PTQ engine (``quantize_model`` -> ``detect_int8`` /
``detect_int8_u8``, ``detjax_torch.quant``) and saved detect programs
(``export_detect``; ``detjax_torch.export.save_detect`` /
``load_detect``), each behind the server too; detjax's backbone A/B
knobs (``model.dot_1x1``, ``model.remat_early``,
``model.f8_remat_stages``, ``models/resnet.py``); and the CLIs
(``python -m detjax_torch.cli.{train,export,serve,detect,evaluate,bench}``;
the bench is ``detjax_torch.bench``).
detjax's Pallas kernels on those paths are
replaced by CUDA kernels written by hand for ``sm_90a``: NMS
(``detjax_torch/csrc/nms.cu``), anchor matching
(``detjax_torch/csrc/matching.cu``), the fused identity bottleneck's
forward (``detjax_torch/csrc/bottleneck.cu``: y1, then the 3x3 and the
second 1x1 per 128-pixel tile) and backward
(``detjax_torch/csrc/bottleneck_bwd.cu``), both on Hopper's ``wgmma`` and
sharing ``csrc/bottleneck_common.cuh``, the full-anchor-set box decode of
the eval branch (``detjax_torch/csrc/decode.cu``, under
``ops.decode_clip_boxes``), and the stem max-pool's backward
(``detjax_torch/csrc/maxpool_bwd.cu``, which no model path calls, as in
detjax).

Ground rules:

- **Imports.** This package imports ``torch``, ``numpy``, the standard
  library and, only where detjax itself does, PIL. It never imports
  ``jax``, ``flax`` or anything under ``detjax/``, not even detjax modules
  that use only numpy: it keeps its own copy of what it needs from them
  (``config.py``, ``ops/anchors.py``, the weight key maps, the data
  pipeline, the COCO and VOC evaluators, the native C++ of
  ``detjax/native``).
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
    >>> result = detjax_torch.fit(cfg, make_train_iterator(ds, cfg), 1000)
    >>> result = detjax_torch.evaluate(model, dataset, cfg)
    >>> qtree = detjax_torch.quantize_model(model, cfg, calib_images)
    >>> dets = detjax_torch.detect_int8_u8(qtree, canvases_u8, cfg)
    >>> program = detjax_torch.export_detect(model, cfg, 8, input_format="u8")
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
    detect_int8,
    detect_int8_u8,
    detect_u8,
    export_detect,
    fit,
    make_train_state,
    quantize_model,
    train_step,
)

__version__ = "0.1.0"


def evaluate(*args, **kwargs):
    """COCO bbox evaluation of a model over a dataset: see
    :func:`detjax_torch.evaluation.evaluator.run_coco_eval`."""
    from detjax_torch.evaluation.evaluator import run_coco_eval

    return run_coco_eval(*args, **kwargs)


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
    "fit",
    "evaluate",
    "export_detect",
    "serve",
    "quantize_model",
    "detect_int8",
    "detect_int8_u8",
]
