"""Full detector: backbone -> FPN -> head, in the lineage layout.

The counterpart of ``detjax/models/detector.py``. Like the lineage's
detector, ``Detector`` IS the ResNet, with ``fpn`` and the head beside the
backbone's modules: ``classificationModel`` and ``regressionModel`` for
``model.family="retinanet"``, ``ssdHead`` for ``"ssd"``. So its
``state_dict`` keys are the lineage's and ``load_state_dict(strict=True)``
takes ``detjax_torch.utils.weights.from_jax`` output directly.

Precision policy: parameters and BatchNorm statistics stay fp32. With
``model.dtype="bfloat16"`` the forward runs under
``torch.autocast(dtype=torch.bfloat16)``: every conv casts its input and
weights to bf16 and returns bf16, ``FrozenBatchNorm2d`` applies its
fp32 scale and shift in bf16, and ``BatchNorm2d``
(``frozen_backbone_bn=False``) normalises in fp32 and returns bf16. With
``"float32"`` it runs in fp32 throughout; on a GPU an fp32 comparison with detjax also needs
``torch.backends.cudnn.allow_tf32 = False`` and
``torch.backends.cuda.matmul.allow_tf32 = False`` (cuDNN convolutions use
TF32 by default). The outputs stay in the compute dtype; detect casts the
box deltas to fp32 itself.

``model.fused_backbone``: "on" fuses the stride-1 identity bottlenecks of
layer1 and layer2 into one CUDA kernel each (5 blocks at R50 and R101, 9
at R152) when ``model.dtype="bfloat16"``, as detjax does; with
``"float32"`` it takes no fused route, as in detjax. "auto" resolves to
"off" here: in detjax it means "on a TPU backend only". Training with "on"
runs the fused blocks' backward through a second CUDA kernel, and trains
every parameter, the folded BatchNorms' affines included.

``model.frozen_backbone_bn=False`` makes every backbone BatchNorm (the
stem's ``bn1``, each block's, each ``downsample.1``) a ``BatchNorm2d``:
batch statistics in train mode, running statistics in eval mode; the FPN
and the head have no BatchNorm, as in detjax. With "on" such a model
fuses its blocks only in eval mode (detjax's rule, ``fused_blocks and
(frozen_bn or not train)``): training launches no fused kernel, and
evaluation folds the running statistics into the fused blocks. The
``bottleneck_backend`` attribute ("auto", or "torch" for the plain twin)
exists for tests and ``chip_smoke.py`` to compare whole paths.

``model.dot_1x1`` (off/on/auto/full/dw; "on" is "full" and "auto" is
"off", detjax's mapping), ``model.remat_early`` and
``model.f8_remat_stages`` go to the backbone as in detjax
(``models/resnet.py::ResNet``); the FPN and the head do not see them.

Under an active space group (``models/spatial.py``) ``images`` are the
rank's rows of each image: the backbone and the FPN run on them, the
heads run on the rank's rows of a pyramid that stays row-sharded and on
whole rows of one that the layout rule gathered, and the outputs cover
every anchor of the whole canvas on every rank of the space group.
"""

from __future__ import annotations

import contextlib
from typing import List, Tuple

import torch

from detjax_torch.config import ModelConfig
from detjax_torch.models import spatial
from detjax_torch.models.fpn import FPN
from detjax_torch.models.heads import (
    RetinaNetHead,
    SSDHead,
    head_outputs,
    init_towers_,
)
from detjax_torch.models.resnet import (
    Bottleneck,
    ResNet,
    check_backbone_knobs,
    he_normal_,
)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class Detector(ResNet):
    def __init__(self, cfg: ModelConfig):
        if cfg.family not in ("retinanet", "ssd"):
            raise ValueError(f"unknown model family {cfg.family!r}")
        if cfg.dtype not in _DTYPES:
            raise ValueError(f"model.dtype must be one of {sorted(_DTYPES)}, "
                             f"got {cfg.dtype!r}")
        dot_1x1 = check_backbone_knobs(fused_backbone=cfg.fused_backbone,
                                       dot_1x1=cfg.dot_1x1)
        super().__init__(cfg.backbone_depth, fused_blocks=(
            cfg.fused_backbone == "on" and cfg.dtype == "bfloat16"),
            frozen_bn=cfg.frozen_backbone_bn, dot_1x1=dot_1x1,
            remat_early=cfg.remat_early,
            f8_remat_stages=cfg.f8_remat_stages)
        self.cfg = cfg
        self.fpn = FPN(self.stage_channels, cfg.min_level, cfg.max_level,
                       cfg.fpn_channels)
        if cfg.family == "ssd":
            self.ssdHead = SSDHead(cfg.fpn_channels, cfg.num_classes,
                                   cfg.num_anchors_per_cell,
                                   range(cfg.min_level, cfg.max_level + 1),
                                   cfg.prior_prob)
        else:
            head = RetinaNetHead(cfg.fpn_channels, cfg.num_classes,
                                 cfg.num_anchors_per_cell, cfg.head_channels,
                                 cfg.num_head_convs, cfg.prior_prob)
            # the lineage keeps both towers at the detector's top level
            self.classificationModel = head.classificationModel
            self.regressionModel = head.regressionModel
        self.bottleneck_backend = "auto"

    @property
    def compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.cfg.dtype]

    def fused_blocks(self) -> List[Bottleneck]:
        """The blocks built for the fused route. With batch-statistics
        BatchNorm they take it only in eval mode."""
        return [m for m in self.modules()
                if isinstance(m, Bottleneck) and m.fused]

    @property
    def bottleneck_backend(self) -> str:
        """"auto" (the fused kernel on CUDA, its twin on the CPU) or
        "torch" (the plain twin on any device) for every fused block."""
        return self._bottleneck_backend

    @bottleneck_backend.setter
    def bottleneck_backend(self, backend: str) -> None:
        if backend not in ("auto", "torch"):
            raise ValueError(f"bottleneck_backend must be 'auto' or "
                             f"'torch', got {backend!r}")
        self._bottleneck_backend = backend
        for block in self.fused_blocks():
            block.fused_backend = backend

    def init_weights(self, generator: torch.Generator) -> "Detector":
        """detjax's initialisers, drawn from ``generator``: He-normal convs
        in the backbone and FPN, N(0, 0.01) head convs with the prior bias
        on the class outputs, identity BatchNorm (weight 1, bias 0, mean 0,
        variance 1)."""
        he_normal_(self, generator)
        if self.cfg.family == "ssd":
            self.ssdHead.init_weights(generator)
        else:
            init_towers_(self.classificationModel, self.regressionModel,
                         self.cfg.prior_prob, generator)
        return self

    def output_convs(self) -> Tuple[List[torch.nn.Conv2d],
                                    List[torch.nn.Conv2d]]:
        """The head's class and box output convs: RetinaNet's one pair,
        shared over the levels, or SSD's pair a level."""
        if self.cfg.family == "ssd":
            return self.ssdHead.output_convs()
        return ([self.classificationModel.output],
                [self.regressionModel.output])

    def forward(self, images: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """images [B, 3, H, W] normalized -> (cls_logits [B, sum A, K],
        box_deltas [B, sum A, 4]) in the compute dtype."""
        # no autocast region at all in fp32: a traced program then has none
        region = (torch.autocast(device_type=images.device.type,
                                 dtype=torch.bfloat16)
                  if self.compute_dtype == torch.bfloat16
                  else contextlib.nullcontext())
        sg = spatial.active()
        row_sharded = True
        if sg is not None:  # detjax's layout rule, decided once
            canvas = images.shape[2] * sg.size
            spatial.check_canvas_rows(canvas, sg.size)
            row_sharded = spatial.pyramid_sharded(canvas, range(
                self.cfg.min_level, self.cfg.max_level + 1), sg.size)
        full_rows = spatial.gather_rows if sg and row_sharded else None
        heads_scope = (spatial.replicated() if sg and not row_sharded
                       else contextlib.nullcontext())
        with region:
            feats = super().forward(images.to(self.compute_dtype))
            pyramid = self.fpn(feats, row_sharded)
            with heads_scope:
                if self.cfg.family == "ssd":
                    return self.ssdHead(pyramid, full_rows)
                return head_outputs(self.classificationModel,
                                    self.regressionModel, pyramid,
                                    self.cfg.num_classes, full_rows)
