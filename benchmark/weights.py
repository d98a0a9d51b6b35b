"""Seeded weights for a cell, made on the device by the benchmark.

One ``torch.Generator`` on the run's device, seeded by ``--seed``, draws
every convolution weight in one normal call and every BatchNorm number in
one uniform call: He-normal (fan-in) convs in the backbone and the FPN,
N(0, 0.01) in the head's towers, zero conv biases and the prior bias
-log((1 - 0.01) / 0.01) on the class output; BatchNorm scales in [0.5,
1.5] (each block's last one times 0.2, as a trained ResNet's residual
branches are small), shifts and means in [-0.1, 0.1], variances in [0.5,
2]. Then the reference's own fp32 forward on a few of the cell's canvases
rescales the two output convs so that the class logits spread with std 2
around the prior and the box deltas with std 0.5: random towers otherwise
saturate every score to 1 and clip every box to the canvas.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark.reference import detection as D
from benchmark.reference.model import Conv, FrozenBN, tf32_off

PRIOR_PROB = 0.01
CLS_STD, BOX_STD = 2.0, 0.5
RESIDUAL_SCALE = 0.2


def make(net: torch.nn.Module, seed: int, canvases_u8: torch.Tensor
         ) -> Dict[str, torch.Tensor]:
    """Fill the reference ``net`` (on its device) from ``seed``, desaturate
    it on ``canvases_u8`` [N, H, W, 3] and return its ``state_dict``."""
    dev = next(net.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    convs = [(n, m) for n, m in net.named_modules() if isinstance(m, Conv)]
    bns = [(n, m) for n, m in net.named_modules() if isinstance(m, FrozenBN)]
    with torch.no_grad():
        flat = torch.randn(sum(m.weight.numel() for _, m in convs),
                           generator=gen, device=dev)
        o = 0
        for name, m in convs:
            w = m.weight
            fan_in = w.shape[1] * w.shape[2] * w.shape[3]
            head = name.startswith(("classificationModel",
                                    "regressionModel"))
            std = 0.01 if head else math.sqrt(2.0 / fan_in)
            w.copy_(flat[o:o + w.numel()].view_as(w) * std)
            o += w.numel()
            if m.bias is not None:
                m.bias.zero_()
        net.classificationModel.output.bias.fill_(
            -math.log((1 - PRIOR_PROB) / PRIOR_PROB))
        u = torch.rand(4, sum(m.weight.numel() for _, m in bns),
                       generator=gen, device=dev)
        o = 0
        for name, m in bns:
            c = m.weight.numel()
            s = slice(o, o + c)
            scale = RESIDUAL_SCALE if name.endswith("bn3") else 1.0
            m.weight.copy_((0.5 + u[0, s]) * scale)
            m.bias.copy_(0.2 * (u[1, s] - 0.5))
            m.running_mean.copy_(0.2 * (u[2, s] - 0.5))
            m.running_var.copy_(0.5 + 1.5 * u[3, s])
            o += c
        with tf32_off():
            cls, box = net(D.normalize(canvases_u8))
        net.classificationModel.output.weight.mul_(
            CLS_STD / float(cls.std()))
        net.regressionModel.output.weight.mul_(BOX_STD / float(box.std()))
        del cls, box
    return {k: v.detach() for k, v in net.state_dict().items()}
