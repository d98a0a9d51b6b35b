"""The training step (``detjax/train/step.py``).

One step: uint8 canvases -> ``device_augment`` (normalize + random
horizontal flip on the device) -> forward under the model's bf16 autocast
-> ``detection_loss`` (matching through the CUDA kernel on a GPU) in fp32
-> backward -> global-norm clip in fp32 over every trainable tensor ->
the optimizer -> the EMA shadow, if any.

Where detjax's step is a pure function of a donated state, the port's
:class:`TrainState` holds a live model and optimizer and ``train_step``
updates them **in place**; it returns the same state object.

What matches detjax, by construction:

- the clip is optax's ``clip_by_global_norm``: with ``norm >= max_norm``
  every gradient becomes ``(g / norm) * max_norm``, with no epsilon
  (``torch.nn.utils.clip_grad_norm_`` divides by ``norm + 1e-6``);
- ``adam``, ``adamw`` (optax's default weight decay 1e-4; torch's is
  1e-2) and ``sgd`` (momentum 0.9) are optax's rules in optax's order of
  operations (``train/optim.py``, which says why torch's own optimizers
  are not used);
- ``lr_schedule="cosine"`` is ``optax.cosine_decay_schedule(lr,
  10_000_000)`` counted from the first update; "plateau" and "constant"
  keep the base rate, which :func:`set_learning_rate` changes;
- ``grad_accum_steps`` sums the micro-batches' gradients, then scales by
  1 / steps, as detjax's scan does; with batch-statistics BatchNorm each
  micro-batch normalises with its own statistics and moves the running
  statistics once;
- the flip mask is drawn per step from a ``torch.Generator`` seeded by
  ``(train.seed, step)``. detjax draws it from ``fold_in(PRNGKey(seed),
  step)``, which torch cannot reproduce, so the two packages flip
  different images; tests feed both the same mask.

Under a data-parallel ``mesh`` (``detjax_torch.parallel``) the step takes
the rank's share of the global batch and computes the single-process step
on the global batch: the flip mask is drawn for the global batch and the
rank takes its rows, batch-statistics BatchNorm sums its statistics over
the group, and between the backward and the clip the gradients are summed
across the group in one all-reduce and divided by the world size
(:func:`average_gradients`), the metrics likewise. Every rank then holds
the same gradients, so the clip, the optimizer and the EMA leave
bit-equal parameters on every rank.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from detjax_torch.config import Config
from detjax_torch.data.pipeline import device_augment
from detjax_torch.models.detector import Detector
from detjax_torch.models.resnet import batch_stats_group
from detjax_torch.modeling import (
    _anchors,
    _config,
    anchor_config,
    build_model,
)
from detjax_torch.ops.losses import detection_loss
from detjax_torch.train.optim import OptaxOptimizer

COSINE_DECAY_STEPS = 10_000_000
OPTAX_ADAMW_WEIGHT_DECAY = 1e-4  # optax.adamw's default


@dataclasses.dataclass
class TrainState:
    """The live training state, updated in place by :func:`train_step`.

    ``step`` counts the updates taken; ``model`` holds the fp32 parameters
    (the BatchNorm affine included) and, as buffers, the BatchNorm running
    statistics, detjax's ``batch_stats``: frozen with
    ``model.frozen_backbone_bn=True``, and otherwise moved by every
    training forward, once per micro-batch under ``grad_accum_steps``, as
    detjax's scan carries them; ``optimizer`` holds the moments; ``ema``
    maps each trainable parameter's name to its EMA shadow (parameters
    only, as in detjax), or is None when ``cfg.train.ema_decay`` is 0.
    """

    step: int
    model: Detector
    optimizer: torch.optim.Optimizer
    cfg: Config
    ema: Optional[Dict[str, torch.Tensor]] = None


def trainable_parameters(model: torch.nn.Module
                         ) -> List[Tuple[str, torch.nn.Parameter]]:
    return [(n, p) for n, p in model.named_parameters() if p.requires_grad]


def make_optimizer(cfg: Config, params) -> torch.optim.Optimizer:
    """The optimizer of ``cfg.train.optimizer`` at the base learning rate;
    the clip runs before it, in :func:`apply_gradients`."""
    t = cfg.train
    decay = OPTAX_ADAMW_WEIGHT_DECAY if t.optimizer == "adamw" else 0.0
    return OptaxOptimizer(params, t.optimizer, lr=float(t.learning_rate),
                          weight_decay=decay)


def _scheduled_lr(cfg: Config, count: int) -> Optional[float]:
    """The cosine schedule's rate for update ``count`` (0-based), or None
    when the schedule keeps the host-set rate."""
    t = cfg.train
    if t.lr_schedule != "cosine":
        return None
    frac = min(count, COSINE_DECAY_STEPS) / COSINE_DECAY_STEPS
    return t.learning_rate * 0.5 * (1.0 + math.cos(math.pi * frac))


def get_learning_rate(state: TrainState) -> float:
    return float(state.optimizer.param_groups[0]["lr"])


def set_learning_rate(state: TrainState, lr: float) -> TrainState:
    """Set the rate of every parameter group (the host-side plateau
    controller's knob). Under ``lr_schedule="cosine"`` the next step
    recomputes it from the schedule, as optax does."""
    for group in state.optimizer.param_groups:
        group["lr"] = float(lr)
    return state


def make_train_state(preset, seed: int = 0, device=None,
                     **overrides) -> TrainState:
    """A fresh :class:`TrainState` for ``preset``: the model of
    :func:`detjax_torch.modeling.build_model` with weights drawn from
    ``seed``, on ``device`` (default ``cuda``; raises without a GPU unless
    ``device="cpu"``), every parameter trainable. With
    ``model.fused_backbone="on"`` (bf16) the fused identity blocks train
    through the fused kernels' forward and backward, their frozen-BN
    affines included: autograd carries the kernel's gradients of the
    folded weights back through the fold, as in detjax."""
    cfg = _config(preset, overrides)
    model = build_model(cfg, seed, device)
    model.train().requires_grad_(True)
    params = [p for _, p in trainable_parameters(model)]
    ema = None
    if cfg.train.ema_decay > 0:
        ema = {n: p.detach().clone() for n, p in trainable_parameters(model)}
    return TrainState(step=0, model=model,
                      optimizer=make_optimizer(cfg, params), cfg=cfg, ema=ema)


def ema_variables(state: TrainState) -> Dict[str, torch.Tensor]:
    """A ``state_dict`` for inference: the EMA shadow in place of the live
    parameters (the live ones when EMA is off), with the model's buffers.
    ``Detector.load_state_dict(strict=True)`` takes it."""
    sd = dict(state.model.state_dict())
    if state.ema is not None:
        sd.update(state.ema)
    return sd


def flip_mask(cfg: Config, step: int, batch_size: int) -> torch.Tensor:
    """The step's per-image horizontal-flip mask [B] bool, on the CPU."""
    gen = torch.Generator().manual_seed((int(cfg.train.seed) << 32)
                                        + int(step))
    return torch.rand(batch_size, generator=gen) < cfg.data.hflip_prob


Record = Optional[Callable[[str], None]]


def compute_gradients(state: TrainState, batch: Dict,
                      match_backend: str = "auto", record: Record = None,
                      mesh=None
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Augment, forward, loss and backward over ``batch``, leaving the
    gradients (averaged over ``grad_accum_steps`` micro-batches) in each
    parameter's ``.grad``. Returns ``(loss, metrics)``, averaged likewise.

    ``batch``: ``images`` [B, H, W, 3] (uint8 canvases are normalized and
    flipped on the device; float images go to the model as they are),
    ``gt_boxes`` [B, G, 4] and ``gt_labels`` [B, G] (-1 padding), numpy
    arrays or tensors. ``record(name)``, when given, is called after the
    forward ("forward"), the loss ("loss") and the backward ("backward")
    of each micro-batch, e.g. to record CUDA events. With a multi-process
    ``mesh``, ``batch`` is this rank's share of the global batch
    (``Mesh.local_rows``): the flip mask is the global batch's rows, and
    batch-statistics BatchNorm reduces over the group. The gradients and
    metrics stay local (:func:`average_gradients`).
    """
    cfg, model = state.cfg, state.model
    t = cfg.train
    dev = next(model.parameters()).device
    images = torch.as_tensor(batch["images"]).to(dev, non_blocking=True)
    gt_boxes = torch.as_tensor(batch["gt_boxes"]).to(
        dev, torch.float32, non_blocking=True)
    gt_labels = torch.as_tensor(batch["gt_labels"]).to(
        dev, torch.int32, non_blocking=True)
    b = images.shape[0]
    accum = max(int(t.grad_accum_steps), 1)
    if b % accum:
        raise ValueError(f"train.grad_accum_steps={accum} must divide the "
                         f"batch size ({b})")
    augment = images.dtype == torch.uint8
    world = mesh.world_size if mesh is not None else 1
    flip = None
    if augment and cfg.data.hflip_prob > 0:
        flip = flip_mask(cfg, state.step, b * world)
        if mesh is not None:
            flip = flip[torch.as_tensor(mesh.local_rows(b * world, accum))]
    anchors = _anchors(cfg.model.image_size, anchor_config(cfg), dev)
    note = record or (lambda name: None)
    # the world-1 step stays the plain one, bit for bit
    group = mesh.group if world > 1 else None

    model.zero_grad(set_to_none=True)
    mb = b // accum
    loss_sum, metric_sums = None, None
    with batch_stats_group(group):
        for i in range(accum):
            sl = slice(i * mb, (i + 1) * mb)
            x, boxes = images[sl], gt_boxes[sl]
            if augment:
                x, boxes = device_augment(
                    x, boxes, flip=None if flip is None else flip[sl],
                    hflip_prob=0.0, mean=cfg.data.mean, std=cfg.data.std)
            cls, box = model(x.permute(0, 3, 1, 2))
            note("forward")
            out = detection_loss(
                cls, box, anchors, boxes, gt_labels[sl],
                fg_iou_threshold=t.fg_iou_threshold,
                bg_iou_threshold=t.bg_iou_threshold, alpha=t.focal_alpha,
                gamma=t.focal_gamma, beta=t.smooth_l1_beta,
                box_std=cfg.model.box_std, match_backend=match_backend)
            loss = out.cls_loss + out.reg_loss
            note("loss")
            loss.backward()
            note("backward")
            loss = loss.detach()
            loss_sum = loss if loss_sum is None else loss_sum + loss
            metric_sums = (dict(out.metrics) if metric_sums is None else
                           {k: v + out.metrics[k]
                            for k, v in metric_sums.items()})
    if accum == 1:
        return loss_sum, metric_sums
    inv = 1.0 / accum
    grads = [p.grad for _, p in trainable_parameters(model)
             if p.grad is not None]
    torch._foreach_mul_(grads, inv)
    return loss_sum * inv, {k: v * inv
                                       for k, v in metric_sums.items()}


def _gradients(state: TrainState) -> List[torch.Tensor]:
    """Every trainable parameter's gradient, in parameter order."""
    named = trainable_parameters(state.model)
    for name, p in named:
        if p.grad is None:
            raise RuntimeError(f"no gradient for trainable parameter {name}")
    return [p.grad for _, p in named]


def average_gradients(state: TrainState, mesh) -> None:
    """Sum every trainable gradient (fp32) across ``mesh``'s group in one
    coalesced all-reduce, then divide by the world size, in place: what
    the partitioner inserts into detjax's pjit step. gloo has no AVG op.
    Every rank then holds the same gradients (x / 1 = x at world 1)."""
    grads = _gradients(state)
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=mesh.group)
    flat.div_(mesh.world_size)
    torch._foreach_copy_(grads, [part.view_as(g) for g, part in zip(
        grads, flat.split([g.numel() for g in grads]))])


def average_metrics(metrics: Dict[str, torch.Tensor], mesh
                    ) -> Dict[str, torch.Tensor]:
    """``metrics`` (0-dim fp32 means over the rank's images) averaged over
    ``mesh``'s group in one all-reduce: the global batch's means, equal on
    every rank."""
    keys = list(metrics)  # the same order on every rank
    flat = torch.stack([metrics[k].to(torch.float32) for k in keys])
    dist.all_reduce(flat, group=mesh.group)
    flat.div_(mesh.world_size)
    return dict(zip(keys, flat.unbind()))


def apply_gradients(state: TrainState) -> torch.Tensor:
    """Clip the gradients by their global norm (fp32, no epsilon), step
    the optimizer, update the EMA shadow and count the step. Returns the
    global norm before the clip."""
    cfg = state.cfg
    grads = _gradients(state)
    named = trainable_parameters(state.model)
    params = [p for _, p in named]
    norm = torch.sqrt(torch.stack(
        [torch.sum(g.to(torch.float32) * g.to(torch.float32))
         for g in grads]).sum())
    max_norm = float(cfg.train.grad_clip_norm)
    keep = norm < max_norm
    # (g / norm) * max_norm past the limit, else g / 1 * 1 = g exactly
    one = torch.ones((), device=norm.device)
    torch._foreach_div_(grads, torch.where(keep, one, norm))
    torch._foreach_mul_(grads, torch.where(keep, one, max_norm))
    lr = _scheduled_lr(cfg, state.step)
    if lr is not None:
        set_learning_rate(state, lr)
    state.optimizer.step()
    if state.ema is not None:
        d = float(np.float32(cfg.train.ema_decay))
        one_minus_d = float(np.float32(1.0) - np.float32(d))
        ema = [state.ema[n] for n, _ in named]
        torch._foreach_mul_(ema, d)
        torch._foreach_add_(ema, torch._foreach_mul(
            [p.detach() for p in params], one_minus_d))
    state.step += 1
    return norm.detach()


def train_step(state: TrainState, batch: Dict, match_backend: str = "auto",
               record: Record = None, mesh=None
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One optimization step, in place. Returns ``(state, metrics)`` with
    ``loss``, ``cls_loss``, ``reg_loss``, ``num_pos`` and ``grad_norm`` as
    0-dim fp32 tensors on the model's device (read them with ``float``).
    ``match_backend="torch"`` routes matching through the plain twin;
    ``record`` is :func:`compute_gradients`' and is also called with
    "update" after the optimizer. With a multi-process ``mesh``
    (``detjax_torch.parallel``), ``batch`` is the rank's share of the
    global batch; the gradients and metrics are averaged over the group
    before the clip, so the metrics are the global batch's."""
    loss, metrics = compute_gradients(state, batch, match_backend, record,
                                      mesh)
    if mesh is not None and mesh.group is not None:
        average_gradients(state, mesh)
        metrics = average_metrics(dict(metrics, loss=loss), mesh)
        loss = metrics.pop("loss")
    grad_norm = apply_gradients(state)
    if record is not None:
        record("update")
    metrics = dict(metrics, loss=loss, grad_norm=grad_norm)
    return state, metrics
