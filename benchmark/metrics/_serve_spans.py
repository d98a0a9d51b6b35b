"""The server's own spans (``detjax_torch.utils.profiling.spans()``) on
the device trace's clock, and the trace's idle time put down to what the
server's worker was doing.

The spans are on the host's ``perf_counter_ns`` clock, the trace on the
profiler's. The worker shares the default stream with the trace's marker
kernels, so a marker can queue behind a batch and the markers do not tie
the clocks. The blocking fetches do: a ``serve.fetch`` span ends just
after the last device-to-host copy of its batch, and nothing else on the
detect path copies to the host. The offset (host us minus device us) is
the one under which each fetch's end falls just after the latest copy
that ends before it and every copy falls inside a fetch, with the
residuals of the pairs spread least (``fit_offset``); it is their median. It is used only with at least
``MIN_PAIRS`` pairs and a median absolute deviation under
``MAX_SPREAD_US``; otherwise every reader returns None. A program without
spans gives None too.
"""

from __future__ import annotations

import bisect
import statistics
import sys
from typing import Dict, List, NamedTuple, Optional

MIN_PAIRS = 5
MAX_SPREAD_US = 200.0
EPS_US = 1e-3  # rounding of the clocks' difference
HOST_PAD_US = 1e6  # fetches this far outside the host's marks are left out
FETCH = "serve.fetch"
# the worker's phases, and what each counts as in the idle attribution
PHASES = {"serve.gather": "gather", "serve.assemble": "assemble",
          "serve.dispatch": "dispatch", "serve.finalize": "finalize",
          FETCH: "finalize"}


class Aligned(NamedTuple):
    offset_us: float  # host us minus device us
    spread_us: float  # median absolute deviation of the pairs' residuals
    pairs: int
    spans: list  # (name, start us, end us, ids) on the device clock
    window: tuple  # the traced window, device us


def program_spans() -> list:
    """The program's recorded spans; empty where it records none."""
    try:
        from detjax_torch.utils import profiling
    except ImportError:
        return []
    read = getattr(profiling, "spans", None)
    return list(read()) if read is not None else []


def _mad(values: List[float]) -> float:
    mid = statistics.median(values)
    return statistics.median(abs(v - mid) for v in values)


def fit_offset(fetches_us: List[tuple], copy_ends_us: List[float],
               window: tuple) -> Optional[tuple]:
    """(offset us, spread us, pairs) tying the host's fetches, (start, end)
    in us, to the device's copy ends, or None. Each candidate puts one
    fetch's end on one copy's. Its pairs are the fetches that then end in
    the window, each with the latest copy before its end; it counts only
    with at least MIN_PAIRS pairs spreading under MAX_SPREAD_US. Of those,
    the one that leaves the fewest copies outside every fetch wins (a
    copy back only happens inside a fetch), then the one with the most
    pairs, then the one spreading least: a steady loop shifted by a copy
    or by whole batches leaves copies outside and pairs fewer fetches."""
    copies = sorted(copy_ends_us)
    fetches = sorted(fetches_us)
    starts = [f[0] for f in fetches]
    best = None
    for _, h in fetches:
        for d in copies:
            cand = h - d
            res = []
            for _, h2 in fetches:
                m = h2 - cand
                if not window[0] <= m <= window[1]:
                    continue
                k = bisect.bisect_right(copies, m + EPS_US) - 1
                if k >= 0:
                    res.append(h2 - copies[k])
            if len(res) < MIN_PAIRS or _mad(res) >= MAX_SPREAD_US:
                continue
            outside = 0
            for c in copies:
                k = bisect.bisect_right(starts, c + cand + EPS_US) - 1
                if k < 0 or c + cand > fetches[k][1] + EPS_US:
                    outside += 1
            key = (outside, -len(res), _mad(res))
            if best is None or key < best[0]:
                best = (key, statistics.median(res))
    if best is None:
        return None
    return best[1], best[0][2], -best[0][1]


def align(rec: dict) -> Optional[Aligned]:
    """The program's spans on the trace's clock, or None; computed once a
    record, kept in it and shown on standard error."""
    if "serve_spans" in rec:
        return rec["serve_spans"]
    al = rec["serve_spans"] = _align(rec["trace"])
    print("serve spans on the trace's clock: " + (
        "not aligned" if al is None else
        f"offset {al.offset_us!r} us, residual spread {al.spread_us!r} us "
        f"over {al.pairs} fetches"), file=sys.stderr)
    return al


def _align(tr) -> Optional[Aligned]:
    if tr.window is None or len(tr.host) < 2:
        return None
    spans = program_spans()
    lo, hi = tr.host[0] * 1e6 - HOST_PAD_US, tr.host[-1] * 1e6 + HOST_PAD_US
    fetches = [(s.start_ns / 1e3, s.end_ns / 1e3) for s in spans
               if s.name == FETCH and lo <= s.end_ns / 1e3 <= hi]
    copies = [e for name, _, e in tr.events if "DtoH" in name]
    fit = fit_offset(fetches, copies, tr.window)
    if fit is None:
        return None
    off, spread, pairs = fit
    on_device = [(s.name, s.start_ns / 1e3 - off, s.end_ns / 1e3 - off,
                  s.ids) for s in spans]
    return Aligned(off, spread, pairs, on_device, tr.window)


def idle_intervals(events, window) -> List[tuple]:
    """The parts of ``window`` in which no event ran."""
    out, end = [], window[0]
    for _, s, e in sorted(events, key=lambda ev: ev[1]):
        if s > end:
            out.append((end, min(s, window[1])))
        end = max(end, e)
        if end >= window[1]:
            break
    if end < window[1]:
        out.append((end, window[1]))
    return [(a, b) for a, b in out if b > a]


def attribute(idle: List[tuple], spans: list) -> Dict[str, float]:
    """Microseconds of ``idle`` under each phase: each idle microsecond
    goes to the innermost phase span (the latest to start) covering it."""
    marks = []
    for k, (name, s, e, _) in enumerate(spans):
        if name in PHASES and e > s:
            marks += [(s, 1, k), (e, -1, k)]
    for a, b in idle:
        marks += [(a, 1, None), (b, -1, None)]
    marks.sort(key=lambda m: (m[0], m[1]))
    out = {c: 0.0 for c in set(PHASES.values())}
    active, idle_on, prev = set(), 0, None
    for t, step, k in marks:
        if prev is not None and t > prev and idle_on and active:
            inner = max(active, key=lambda j: spans[j][1])
            out[PHASES[spans[inner][0]]] += t - prev
        if k is None:
            idle_on += step
        elif step > 0:
            active.add(k)
        else:
            active.discard(k)
        prev = t
    return out


def idle_pct(rec: dict, phase: str) -> Optional[float]:
    """Percent of the traced window in which the device ran nothing and
    the worker was in ``phase``."""
    al = align(rec)
    if al is None:
        return None
    w0, w1 = al.window
    by = attribute(idle_intervals(rec["trace"].events, al.window), al.spans)
    return 100.0 * by[phase] / (w1 - w0)


def _inside(al: Aligned, name: str, at_end: bool) -> list:
    w0, w1 = al.window
    return [sp for sp in al.spans if sp[0] == name
            and w0 <= sp[2 if at_end else 1] <= w1]


def queue_wait_ms(rec: dict) -> Optional[float]:
    """Mean ms of the requests' queue waits that end in the window."""
    al = align(rec)
    waits = [] if al is None else _inside(al, "serve.queue_wait", True)
    return (sum(e - s for _, s, e, _ in waits) / len(waits) / 1e3
            if waits else None)


def dispatches(rec: dict) -> list:
    al = align(rec)
    return [] if al is None else _inside(al, "serve.dispatch", False)


def dispatch_ms(rec: dict) -> Optional[float]:
    """Mean host ms of the dispatches that start in the window."""
    d = dispatches(rec)
    return sum(e - s for _, s, e, _ in d) / len(d) / 1e3 if d else None


def dispatch_fill(rec: dict) -> Optional[float]:
    """Requests in the dispatches that start in the window over their
    count times the batch, percent."""
    d = dispatches(rec)
    return (100.0 * sum(ids["n"] for *_, ids in d) / (len(d) * rec["batch"])
            if d else None)
