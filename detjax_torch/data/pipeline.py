"""uint8 canvas normalisation and the training augmentation on the device
(``detjax/data/pipeline.py::normalize_u8`` and ``device_augment``).

The threaded host pipeline and device prefetch come with the data slice
of the port.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_u8(images_u8: torch.Tensor, mean, std,
                 out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 -> normalized image, on the tensor's device: fp32 ``/255``,
    then ``-mean``, then ``/std`` over the last (channel) dim, then one
    cast to ``out_dtype``."""
    x = images_u8.to(torch.float32) / 255.0
    m = torch.tensor(tuple(mean), dtype=torch.float32, device=x.device)
    s = torch.tensor(tuple(std), dtype=torch.float32, device=x.device)
    return ((x - m) / s).to(out_dtype)


def device_augment(images_u8: torch.Tensor, gt_boxes: torch.Tensor,
                   flip: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None,
                   hflip_prob: float = 0.5,
                   mean: Sequence[float] = IMAGENET_MEAN,
                   std: Sequence[float] = IMAGENET_STD,
                   out_dtype: torch.dtype = torch.float32
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Normalize and randomly flip each image horizontally, on the tensor's
    device.

    images_u8 [B, H, W, 3] uint8 NHWC; gt_boxes [B, G, 4] xyxy. ``flip``
    [B] bool is the per-image mask; when None and ``hflip_prob > 0`` it is
    drawn as ``uniform < hflip_prob`` from ``generator`` (a CPU
    ``torch.Generator``; the global one when None). The math runs in fp32
    through the flip, with one cast to ``out_dtype`` at the end; a flipped
    image's boxes become ``(w - x2, y1, w - x1, y2)``.
    """
    b, _, w, _ = images_u8.shape
    x = normalize_u8(images_u8, mean, std)
    if flip is None and hflip_prob > 0:
        flip = torch.rand(b, generator=generator) < hflip_prob
    if flip is not None:
        flip = flip.to(device=x.device, dtype=torch.bool)
        x = torch.where(flip[:, None, None, None], x.flip(2), x)
        flipped = torch.stack([w - gt_boxes[..., 2], gt_boxes[..., 1],
                               w - gt_boxes[..., 0], gt_boxes[..., 3]], -1)
        gt_boxes = torch.where(flip[:, None, None], flipped, gt_boxes)
    return x.to(out_dtype), gt_boxes
