"""Profiling helpers (``detjax/utils/profiling.py``).

``trace_context`` wraps a region in a ``torch.profiler.record_function``
annotation and, given a directory, records it with ``torch.profiler`` (the
CPU and, on a GPU, the device's kernels) and writes a Chrome trace there,
viewable in Perfetto. ``StepTimer`` measures steady-state step wall time,
the images/s headline.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


@contextlib.contextmanager
def trace_context(name: str, trace_dir: Optional[str] = None,
                  host: bool = True):
    """Annotate a region as ``name``; with ``trace_dir``, also profile it
    and write ``<trace_dir>/<name>.trace.json``. Yields the
    ``torch.profiler.profile`` (for ``key_averages()``), or None without
    ``trace_dir``. ``host=False`` records the device's kernels and copies
    alone: tracing the host's ops slows the host, and with it the share of
    a window in which the device waits for it. It needs a GPU."""
    if not trace_dir:
        with torch.profiler.record_function(name):
            yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU] if host else []
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    elif not host:
        raise ValueError("trace_context(host=False) traces the device "
                         "alone, and no GPU is available")
    os.makedirs(trace_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        with torch.profiler.record_function(name):
            yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(trace_dir, f"{name}.trace.json"))


class StepTimer:
    """Throughput meter: call ``tick(batch_size)`` once per completed step.

    The first ``skip`` ticks (warm-up: cuDNN's algorithm search, the
    kernels' first builds) are excluded. Rates are per process."""

    def __init__(self, skip: int = 2):
        self.skip = skip
        self._n = 0
        self._images = 0
        self._t0 = None

    def tick(self, batch_size: int):
        self._n += 1
        if self._n == self.skip:
            self._t0 = time.perf_counter()
            self._images = 0
        elif self._n > self.skip:
            self._images += batch_size

    @property
    def images_per_sec(self) -> float:
        if self._t0 is None or self._images == 0:
            return 0.0
        return self._images / (time.perf_counter() - self._t0)
