"""Small constant tensors kept on their device."""

from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=64)
def _cached_constant(values: tuple, dtype: torch.dtype,
                     device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):
        return torch.tensor(values, dtype=dtype, device=device)


def device_constant(values: tuple, dtype: torch.dtype,
                    device: torch.device) -> torch.Tensor:
    """``torch.tensor(values, dtype=dtype, device=device)``, made once per
    argument set. A tensor made anew from host memory on a CUDA device is
    a synchronous copy that waits for the device's queue to drain, so a
    caller that makes one per batch cannot dispatch batch N+1 while batch
    N computes. The tensor is made outside inference mode, so autograd may
    save it; it is shared, so no caller writes to it. Inside a trace
    (``torch.export``) it is made anew, a constant of the traced program,
    and never cached: a traced tensor is fake."""
    if torch.compiler.is_compiling():
        return torch.tensor(values, dtype=dtype, device=device)
    return _cached_constant(values, dtype, device)
