"""Seeded request streams of the serving mixes.

An open loop's arrivals are Poisson at the mix's rate, with the same set
of gaps in every seed: the gaps are the exponential distribution's
quantiles at (i + 0.5) / n, in an order the seed permutes. A request's
canvas is drawn from the pool in the seed's order.
"""

from __future__ import annotations

import numpy as np


def poisson_offsets(n: int, rate: float, rng: np.random.Generator
                    ) -> np.ndarray:
    """Due times (s from the stream's start) of n requests at ``rate``/s."""
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q) / rate
    return np.cumsum(rng.permutation(gaps))


def canvas_order(n: int, pool: int, rng: np.random.Generator) -> np.ndarray:
    """Which pool canvas each of n requests sends: the pool's canvases in
    turn, each pass in a new order."""
    passes = -(-n // pool)
    return np.concatenate([rng.permutation(pool)
                           for _ in range(passes)])[:n]
