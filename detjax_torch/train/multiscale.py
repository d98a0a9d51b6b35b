"""Multi-scale training (``detjax/train/multiscale.py``).

A fixed set of canvas resolutions, each with its own anchors, cycled in a
seeded round-robin order. One :class:`TrainState` is shared: the
detector's parameters do not depend on the resolution. The step takes
the resolution from the batch's (H, W) and runs
:func:`~detjax_torch.train.step.train_step` with that resolution's
config, whose anchors are built once a resolution and device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Sequence, Tuple

import numpy as np

from detjax_torch.config import Config
from detjax_torch.train.step import TrainState, train_step


def scale_configs(cfg: Config, scales: Sequence[Tuple[int, int]]):
    """One Config per resolution (same architecture and training
    hyperparameters)."""
    return tuple(
        dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, image_size=tuple(hw)))
        for hw in scales
    )


def make_multiscale_train_step(cfg: Config,
                               scales: Sequence[Tuple[int, int]]):
    """``step(state, batch) -> (state, metrics)`` that runs the training
    step of the batch's resolution on the shared state (in place); a
    resolution outside ``scales`` raises KeyError."""
    cfgs: Dict[Tuple[int, int], Config] = {
        tuple(c.model.image_size): c for c in scale_configs(cfg, scales)}

    def step(state: TrainState, batch):
        hw = tuple(int(s) for s in np.shape(batch["images"])[1:3])
        if hw not in cfgs:
            raise KeyError(f"batch resolution {hw} not in the set "
                           f"{sorted(cfgs)}")
        # the same model, optimizer and EMA under the resolution's config
        view = dataclasses.replace(state, cfg=cfgs[hw])
        view, metrics = train_step(view, batch)
        state.step = view.step
        return state, metrics

    return step


class MultiScaleIterator:
    """Cycles a fixed resolution schedule over per-resolution iterators.

    A seeded round-robin (a numpy shuffle of the schedule every cycle, as
    detjax draws it), so every resolution sees the same data
    distribution; each underlying iterator yields fixed-shape batches of
    its resolution."""

    def __init__(self, dataset, cfg: Config,
                 scales: Sequence[Tuple[int, int]], seed: int = 0):
        from detjax_torch.data.pipeline import make_train_iterator

        self.iters = [
            iter(make_train_iterator(dataset, c))
            for c in scale_configs(cfg, scales)
        ]
        self.scales = [tuple(s) for s in scales]
        self.seed = seed

    def __iter__(self) -> Iterator[dict]:
        step = 0
        n = len(self.iters)
        rng = np.random.default_rng(self.seed)
        order = np.arange(n)
        while True:
            if step % n == 0:
                rng.shuffle(order)
            yield next(self.iters[order[step % n]])
            step += 1
