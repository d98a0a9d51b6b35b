"""Operations, bytes and peaks: the yardstick of the per-layer shares.

The peaks are NVIDIA's data sheet for one H100 SXM (dense, at its 700 W
limit); every share is printed beside the card's name and power limit.
The bound functions are those the port's smoke script measured against
(``chip_smoke.py``: ``nms_bound_ms``, ``match_bound_ms``,
``bottleneck_bound_ms``, ``bottleneck_bwd_bound_ms``), copied: bytes read
once and written once over the memory rate, and the operations the inputs
need over the compute rate; the larger is the least time the card could
take. A model's FLOPs are counted from the reference's convolution shapes,
so the count is the same whatever implements them.
"""

from __future__ import annotations

from typing import Tuple

import torch

H100 = {"bytes_per_s": 3.35e12, "fp32_flops": 67e12,
        "bf16_flops": 989e12, "int8_ops": 1979e12}

# about 15 fp32 operations and one division an (anchor, GT) IoU
MATCH_OPS_PER_PAIR = 16
# 14 fp32 operations a (keep, candidate) IoU and its decision
NMS_OPS_PER_PAIR = 14
MATCH_BLOCK_ANCHORS = 128  # anchors a block of the matching kernel culls for


def _bound(nbytes: float, ops: float, rate: float) -> Tuple[float, str]:
    t_bytes = nbytes / H100["bytes_per_s"] * 1e3
    t_ops = ops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nms_bound_ms(b: int, n: int, max_det: int, pairs: int):
    """Least ms of the NMS over b rows of n candidates that kept up to
    max_det each, needing ``pairs`` (keep, candidate) comparisons."""
    return _bound(b * n * (16 + 4 + 4) + b * max_det * (4 + 4),
                  float(NMS_OPS_PER_PAIR) * pairs, H100["fp32_flops"])


def match_bound_ms(b: int, a: int, g: int, pairs: int):
    """Least ms of matching b images of g GT slots to a anchors, dividing
    ``pairs`` (anchor, GT) pairs."""
    return _bound(a * 16 + b * g * (16 + 1 + 4) + b * a * (4 + 4 + 16 + 4),
                  float(MATCH_OPS_PER_PAIR) * pairs, H100["fp32_flops"])


def bottleneck_macs(b: int, h: int, w: int, m: int) -> float:
    c = 4 * m
    return float(c * m + 9 * m * m + m * c) * b * h * w


def bottleneck_bound_ms(b: int, h: int, w: int, m: int):
    """Least ms of one fused identity block forward (bf16 x in, out)."""
    return _bound(2 * b * h * w * 4 * m * 2, 2.0 * bottleneck_macs(b, h, w, m),
                  H100["bf16_flops"])


def bottleneck_bwd_bound_ms(b: int, h: int, w: int, m: int):
    """Least ms of one fused block's backward: x and dy read, dx written,
    three times the forward's multiply-adds."""
    return _bound(3 * b * h * w * 4 * m * 2,
                  3 * 2.0 * bottleneck_macs(b, h, w, m), H100["bf16_flops"])


def fused_block_shapes(depth: int, image_hw) -> list:
    """(h, w, m) of each fused identity block a forward runs: the stride-1
    identity blocks of layer1 and layer2."""
    h, w = image_hw
    blocks = {50: (3, 4), 101: (3, 4)}[depth]
    out = []
    for s, n in enumerate(blocks):
        stride = 4 * 2 ** s
        out += [(-(-h // stride), -(-w // stride), 64 * 2 ** s)] * (n - 1)
    return out


def forward_flops(model_cfg: dict) -> float:
    """FLOPs (2 x multiply-adds) of one image through the reference's
    convolutions, from their shapes on the meta device."""
    from benchmark.reference.model import build

    net = build(model_cfg, "meta")
    total = [0.0]

    def hook(mod, inp, out):
        k = mod.weight.shape
        total[0] += 2.0 * out.shape[2] * out.shape[3] * k.numel()
    for m in net.modules():
        if isinstance(m, torch.nn.Conv2d):
            m.register_forward_hook(hook)
    with torch.no_grad():
        net(torch.empty(1, 3, *model_cfg["image_size"], device="meta"))
    return total[0]


def match_listed_pairs(anchors: torch.Tensor, boxes: torch.Tensor,
                       valid: torch.Tensor,
                       per: int = MATCH_BLOCK_ANCHORS) -> int:
    """(anchor, GT) pairs left after culling, which the matching kernel
    divides: for each block of ``per`` consecutive anchors, its anchors
    times the valid GTs its union box does not cull."""
    a = anchors.shape[0]
    nb = -(-a // per)
    an = torch.cat([anchors, anchors[-1:].expand(nb * per - a, 4)])
    an = an.view(nb, per, 4)
    u = torch.stack([an[..., 0].amin(1), an[..., 1].amin(1),
                     an[..., 2].amax(1), an[..., 3].amax(1)], -1)[None, :,
                                                                 None]
    g = boxes[:, None]
    apart = ((torch.minimum(u[..., 2], g[..., 2])
              <= torch.maximum(u[..., 0], g[..., 0]))
             | (torch.minimum(u[..., 3], g[..., 3])
                <= torch.maximum(u[..., 1], g[..., 1])))
    listed = (valid[:, None] & ~apart).sum(-1)
    counts = torch.full((nb,), per, device=anchors.device)
    counts[-1] = a - (nb - 1) * per
    return int((listed * counts).sum())


def nms_pairs_lower(kept: int) -> int:
    """(keep, candidate) comparisons a row that kept ``kept`` detections
    needed at least: each kept one was compared with every keep before
    it. Suppressed candidates add more, which the served answers do not
    show, so the bound is a lower one."""
    return kept * (kept - 1) // 2


def shares(flops: float, seconds: float, peak: str = "bf16_flops") -> float:
    """Percent of the card's peak that ``flops`` in ``seconds`` reach."""
    return 100.0 * flops / seconds / H100[peak]
