"""Full detector: backbone -> FPN -> RetinaNet head, in the lineage layout.

The counterpart of ``detjax/models/detector.py``. Like the lineage's
detector, ``Detector`` IS the ResNet, with ``fpn``, ``classificationModel``
and ``regressionModel`` beside the backbone's modules, so its
``state_dict`` keys are the lineage's and ``load_state_dict(strict=True)``
takes ``detjax_torch.utils.weights.from_jax`` output directly.

Precision policy: parameters and BatchNorm statistics stay fp32. With
``model.dtype="bfloat16"`` the forward runs under
``torch.autocast(dtype=torch.bfloat16)``: every conv casts its input and
weights to bf16 and returns bf16, and ``FrozenBatchNorm2d`` applies its
fp32 scale and shift in bf16. With ``"float32"`` it runs in fp32
throughout; on a GPU an fp32 comparison with detjax also needs
``torch.backends.cudnn.allow_tf32 = False`` and
``torch.backends.cuda.matmul.allow_tf32 = False`` (cuDNN convolutions use
TF32 by default). The outputs stay in the compute dtype; detect casts the
box deltas to fp32 itself.
"""

from __future__ import annotations

from typing import Tuple

import torch

from detjax_torch.config import ModelConfig
from detjax_torch.models.fpn import FPN
from detjax_torch.models.heads import (
    RetinaNetHead,
    head_outputs,
    init_towers_,
)
from detjax_torch.models.resnet import ResNet, check_backbone_knobs, he_normal_

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class Detector(ResNet):
    def __init__(self, cfg: ModelConfig):
        if cfg.family != "retinanet":
            raise NotImplementedError(
                f"model.family={cfg.family!r} is not ported yet; the SSD head "
                "comes with a later slice of the port")
        if cfg.dtype not in _DTYPES:
            raise ValueError(f"model.dtype must be one of {sorted(_DTYPES)}, "
                             f"got {cfg.dtype!r}")
        if not cfg.frozen_backbone_bn:
            raise NotImplementedError(
                "model.frozen_backbone_bn=False (batch-statistics BatchNorm) "
                "is not ported yet; it waits for a later slice (ROADMAP.md "
                "Queue 1, training knobs)")
        check_backbone_knobs(
            fused_backbone=cfg.fused_backbone, dot_1x1=cfg.dot_1x1,
            remat_early=cfg.remat_early,
            f8_remat_stages=cfg.f8_remat_stages)
        super().__init__(cfg.backbone_depth)
        self.cfg = cfg
        self.fpn = FPN(self.stage_channels, cfg.min_level, cfg.max_level,
                       cfg.fpn_channels)
        head = RetinaNetHead(cfg.fpn_channels, cfg.num_classes,
                             cfg.num_anchors_per_cell, cfg.head_channels,
                             cfg.num_head_convs, cfg.prior_prob)
        # the lineage keeps both towers at the detector's top level
        self.classificationModel = head.classificationModel
        self.regressionModel = head.regressionModel

    @property
    def compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.cfg.dtype]

    def init_weights(self, generator: torch.Generator) -> "Detector":
        """detjax's initialisers, drawn from ``generator``: He-normal convs
        in the backbone and FPN, N(0, 0.01) head convs with the prior bias
        on the class output, identity frozen BatchNorm."""
        he_normal_(self, generator)
        init_towers_(self.classificationModel, self.regressionModel,
                     self.cfg.prior_prob, generator)
        return self

    def forward(self, images: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """images [B, 3, H, W] normalized -> (cls_logits [B, sum A, K],
        box_deltas [B, sum A, 4]) in the compute dtype."""
        bf16 = self.compute_dtype == torch.bfloat16
        with torch.autocast(device_type=images.device.type,
                            dtype=torch.bfloat16, enabled=bf16):
            feats = super().forward(images.to(self.compute_dtype))
            pyramid = self.fpn(feats)
            return head_outputs(self.classificationModel,
                                self.regressionModel, pyramid,
                                self.cfg.num_classes)
