"""The reference training step, and the numbers that compare a training
run with it.

A step: augment (normalise, flip), the forward, the per-image loss
averaged over the batch, the backward, the global-norm clip (g x max /
norm once the norm reaches max), then Adam (b1 0.9, b2 0.999, eps 1e-8,
bias-corrected) at the configured rate. Every parameter trains; the frozen
BatchNorm statistics do not move. The batch runs in blocks of rows: the
loss is a mean of per-image losses, so summing the blocks' gradients gives
the batch's gradient.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional, Sequence

import torch

from benchmark.reference import detection as D

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
# a leaf whose step-1 gradient norm in the reference is under this share
# of the median leaf's moves under Adam by round-off alone: left out of
# the change after three steps
STILL_LEAF = 1e-3


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = list(tensors)
    norms = torch.stack([tensors[n].detach().float().norm() for n in names])
    return dict(zip(names, norms.cpu().tolist()))


def run_steps(net: torch.nn.Module, batches: Sequence, flips: Sequence,
              anc: torch.Tensor, t: dict, std, rows: Optional[int] = None,
              block: int = 4) -> dict:
    """Train ``net`` in place for ``len(batches)`` steps. ``batches``: (u8
    images [B, H, W, 3], GT boxes [B, G, 4], GT labels [B, G]) on the
    device; ``flips``: each step's mask [B]. ``rows`` keeps only the first
    rows of every batch (the half-batch fault). Returns the losses, each
    leaf's gradient norm after the clip at step 1 (what the optimizer got)
    and each leaf's change over all the steps."""
    params = dict(net.named_parameters())
    p0 = {n: p.detach().clone() for n, p in params.items()}
    mu = {n: torch.zeros_like(p) for n, p in params.items()}
    nu = {n: torch.zeros_like(p) for n, p in params.items()}
    losses: List[float] = []
    grad1 = None
    for s, (images, gt_boxes, gt_labels) in enumerate(batches):
        b = images.shape[0] if rows is None else rows
        for p in params.values():
            p.grad = None
        total = torch.zeros((), device=anc.device)
        for r0 in range(0, b, block):
            r1 = min(b, r0 + block)
            x, boxes = D.flip(D.normalize(images[r0:r1]),
                              gt_boxes[r0:r1].float(), flips[s][r0:r1])
            cls, box = net(x)
            loss = sum(D.image_loss(cls[i], box[i], anc, boxes[i],
                                    gt_labels[r0 + i].long(), t, std)
                       for i in range(r1 - r0)) / b
            loss.backward()
            total += loss.detach()
        losses.append(float(total))
        with torch.no_grad():
            grads = {n: p.grad for n, p in params.items()}
            norm = torch.sqrt(sum((g.float() ** 2).sum()
                                  for g in grads.values()))
            clip = t["grad_clip_norm"]
            if float(norm) >= clip:
                for g in grads.values():
                    g.mul_(clip / norm)
            if s == 0:
                grad1 = leaf_norms(grads)
            k = s + 1
            for n, p in params.items():
                g = grads[n]
                mu[n].mul_(ADAM_B1).add_(g, alpha=1 - ADAM_B1)
                nu[n].mul_(ADAM_B2).addcmul_(g, g, value=1 - ADAM_B2)
                m_hat = mu[n] / (1 - ADAM_B1 ** k)
                v_hat = nu[n] / (1 - ADAM_B2 ** k)
                p.sub_(t["learning_rate"] * m_hat / (v_hat.sqrt() + ADAM_EPS))
    change = leaf_norms({n: params[n].detach() - p0[n] for n in params})
    return {"losses": losses, "grad": grad1, "change": change}


def compare(got: dict, ref: dict) -> Dict[str, float]:
    """The three numbers of a training run against the reference's:

    - loss_gap: the largest |loss - reference loss| / |reference loss|
      over the steps;
    - grad_gap: over leaves, |norm of the program's step-1 gradient - the
      reference's| / max(the reference's norm of that leaf, of the median
      leaf);
    - change_gap: the same of each leaf's change over the steps, over the
      leaves whose reference gradient is at least STILL_LEAF of the median
      leaf's.
    """
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                        ref["losses"]))

    def worst(key, names):
        med = statistics.median(ref[key][n] for n in names)
        return max(abs(got[key][n] - ref[key][n]) / max(ref[key][n], med)
                   for n in names)

    names = list(ref["grad"])
    med_g = statistics.median(ref["grad"].values())
    moving = [n for n in names if ref["grad"][n] >= STILL_LEAF * med_g]
    return {"loss_gap": loss_gap, "grad_gap": worst("grad", names),
            "change_gap": worst("change", moving),
            "still_leaves": float(len(names) - len(moving))}
