"""Profiling helpers (``detjax/utils/profiling.py``).

``trace_context`` wraps a region in a ``torch.profiler.record_function``
annotation and, given a directory, records it with ``torch.profiler`` (the
CPU and, on a GPU, the device's kernels) and writes a Chrome trace there,
viewable in Perfetto. ``StepTimer`` measures steady-state step wall time,
the images/s headline.

Spans: the program records named intervals of its own host threads
(``span``, ``add_span``, and ``Phases`` for a thread whose phases
abut), each with its name, start and end on ``time.perf_counter_ns()``'s
clock, its thread, the span it ran inside and its ids (``request``,
``batch``, ``n``). They go into a bounded buffer in memory, read in
process with ``spans()``. Spans record only while a ``torch.profiler``
session runs in the process, or after ``enable_spans(True)``; otherwise a
span site costs one read of that flag.
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch
import torch.autograd.profiler


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


class Span(NamedTuple):
    """One recorded interval of a host thread."""

    name: str
    start_ns: int
    end_ns: int
    thread: int  # ``threading.get_ident()`` of the thread that recorded it
    parent: Optional[str]  # the span it ran inside, on that thread
    ids: Dict[str, int]


MAX_SPANS = 1 << 16
_SPANS: "collections.deque[Span]" = collections.deque(maxlen=MAX_SPANS)


class _Open(threading.local):
    def __init__(self):
        self.stack: list = []  # [name, start_ns, ids] open on this thread


_OPEN = _Open()


class _Always:
    _is_profiler_enabled = True


# whose ``_is_profiler_enabled`` says whether spans record: torch's own
# flag, set while a profiler session runs, or always after enable_spans()
_switch = torch.autograd.profiler


def enable_spans(on: bool = True) -> None:
    """Record spans whether or not a profiler runs (``on``), or only while
    one runs (the default)."""
    global _switch
    _switch = _Always if on else torch.autograd.profiler


def clock() -> int:
    """``time.perf_counter_ns()`` while spans record, else 0."""
    return time.perf_counter_ns() if _switch._is_profiler_enabled else 0


def _record(name, start_ns, end_ns, parent, ids) -> None:
    _SPANS.append(Span(name, start_ns, end_ns, threading.get_ident(),
                       parent, ids))


def open_span(name: str) -> int:
    """Open ``name`` on this thread, inside whatever is open there; its
    start, or 0 when spans do not record (nothing is opened then)."""
    t = clock()
    if t:
        _OPEN.stack.append([name, t, {}])
    return t


def close_span(start_ns: int, **ids) -> int:
    """Close the innermost span open on this thread, which opened at
    ``start_ns``, and record it with ``ids``; its end."""
    end = time.perf_counter_ns()
    stack = _OPEN.stack
    if stack and stack[-1][1] == start_ns:
        name = stack.pop()[0]
        _record(name, start_ns, end, stack[-1][0] if stack else None, ids)
    return end


@contextlib.contextmanager
def span(name: str, **ids):
    """Record the enclosed block as ``name`` with ``ids``."""
    t = open_span(name)
    try:
        yield
    finally:
        if t:
            close_span(t, **ids)


def add_span(name: str, start_ns: int, end_ns: int, **ids) -> None:
    """Record a span timed elsewhere, such as one that started in another
    thread, when spans record."""
    if _switch._is_profiler_enabled:
        _record(name, start_ns, end_ns, None, ids)


class Phases:
    """A thread's run of abutting phases: each ``enter`` ends the phase
    the thread was in, and everything still open inside it, and begins
    the next, so the phases cover the thread's time with no gap. Spans
    opened during a phase name it as their parent. Owned by the one
    thread that enters its phases."""

    def __init__(self):
        self._open = None  # [name, start_ns, ids] of the current phase

    def enter(self, name: Optional[str], batch: Optional[int] = None,
              n: Optional[int] = None) -> None:
        """Begin ``name`` (None: begin none), with ids ``batch`` and
        ``n``."""
        t = clock()
        if self._open is not None:
            phase, start, ids = self._open
            _record(phase, start, t or time.perf_counter_ns(), None, ids)
            self._open = None
            _OPEN.stack.clear()
        if t and name is not None:
            ids = {} if batch is None else {"batch": batch}
            if n is not None:
                ids["n"] = n
            self._open = [name, t, ids]
            _OPEN.stack.append(self._open)


def spans() -> List[Span]:
    """The recorded spans, oldest first (at most ``MAX_SPANS``)."""
    return list(_SPANS)


def clear_spans() -> None:
    _SPANS.clear()
