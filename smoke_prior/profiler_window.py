"""Where torch.profiler loses kernel records of short calls.

Traces many windows of 10 short calls each (nms_cuda on the sorted hard
candidate set, B = 8, and a one-element ``add_``), under four guards:
nothing around the calls; a 2 ms spin kernel first, so that the calls'
kernels queue behind it and run back to back; 50 ms of host wait inside
the window before the first launch and after the last kernel has finished
(chip_smoke.py's ``PROFILER_PAD_S``); and the spin with that wait. For each
guard it counts the windows that miss a record of the calls' kernel or of
the spin, and it places the records on the host clock: the first record's
start against the host's clock just before its launch (a kernel cannot
start before it is launched), and the last record's end against the
host's clock when the synchronize after it returned (nor end after that),
both in µs. One JSON line a (call, guard), then a summary line.

With ``--smoke-phases``, it runs chip_smoke.py's phases instead, in its
order up to the eval branch, each call that chip_smoke.py's
``traced_counts`` holds traced in that many windows of chip_smoke.py's own
(``profile_calls``), opened with its spin-kernel warm-up and without it.
For each it counts the windows whose kernel records fall short of the
launcher's count, lists which of the window's ``cudaLaunchKernel``
records (in launch order) have no kernel record, gives the host time the
first launch took, and lists every event of the first short window.

    python3 smoke_prior/profiler_window.py [--windows 300]
    python3 smoke_prior/profiler_window.py --smoke-phases [--windows 30]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402

CALLS = 10
# guard -> (spin ms before the calls, host wait ms at both ends)
GUARDS = {"none": (0.0, 0.0), "spin_2ms": (2.0, 0.0),
          "pad_50ms": (0.0, 50.0), "spin_2ms_pad_50ms": (2.0, 50.0)}


def window(fn, name: str, spin_ms: float, pad_ms: float) -> dict:
    """One traced window of CALLS calls of ``fn``: its records of kernel
    ``name`` and of the spin, and the host clock at the first launch and
    after the synchronize, all in ns of the host's clock."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(pad_ms / 1e3)
        launch_ns = time.time_ns()
        if spin_ms:
            torch.cuda._sleep(int(spin_ms * cs.spin_cycles_per_ms()))
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
        synced_ns = time.time_ns()
        time.sleep(pad_ms / 1e3)
    events = prof.profiler.kineto_results.events()
    recs = sorted((e.start_ns(), e.end_ns()) for e in events
                  if name in e.name())
    spins = sorted((e.start_ns(), e.end_ns()) for e in events
                   if "spin_kernel" in e.name())
    first = min([r[0] for r in recs + spins], default=None)
    last = max([r[1] for r in recs + spins], default=None)
    return {"records": len(recs), "spins_missing": bool(spin_ms) - len(spins),
            "start_after_launch_us": None if first is None
            else (first - launch_ns) / 1e3,
            "end_after_sync_us": None if last is None
            else (last - synced_ns) / 1e3}


def _stats(xs) -> dict:
    xs = [x for x in xs if x is not None]
    if not xs:
        return {}
    a = np.asarray(xs)
    return {"min": float(a.min()), "median": float(np.median(a)),
            "max": float(a.max())}


def events_of(prof) -> list:
    """Every event of a window: name, device type, start in µs from the
    window's start, duration in µs, correlation ids."""
    res = prof.profiler.kineto_results
    t0 = res.trace_start_ns()
    return [(e.name()[:48], str(e.device_type()).split(".")[-1],
             round((e.start_ns() - t0) / 1e3, 3),
             round(e.duration_ns() / 1e3, 3), e.correlation_id(),
             e.linked_correlation_id()) for e in res.events()]


def smoke_phases(windows: int) -> None:
    """chip_smoke.py's phases, in its order up to the eval branch, with
    traced_counts replaced by ``windows`` traced windows of each call it
    holds."""
    def traced(fn, want: dict, what: str):
        for warmup in (0, cs.PROFILER_WARMUP_LAUNCHES):
            short, lost, first_launch_us = [], [], []
            for _ in range(windows):
                events = events_of(cs.profile_calls(fn, cs.TRACED_CALLS,
                                                    warmup))
                seen = {k: sum(k in e[0] and e[1] == "CUDA"
                               for e in events) for k in want}
                # the calls' launches: after the warm-up's synchronize
                sync = min(e[2] for e in events
                           if e[0] == "cudaDeviceSynchronize")
                launches = [e for e in events
                            if e[0] == "cudaLaunchKernel" and e[2] > sync]
                first_launch_us.append(launches[0][3])
                if any(seen[k] != want[k] * cs.TRACED_CALLS for k in want):
                    kernels = {e[4] for e in events if e[1] == "CUDA"}
                    lost.append([i for i, e in enumerate(launches)
                                 if e[4] not in kernels])
                    short.append({"seen": seen, "events": events})
            print(json.dumps({
                "traced": what, "want_a_call": want,
                "warmup_launches": warmup, "windows": windows,
                "windows_short": len(short),
                "launches_without_a_kernel_record": lost,
                "first_launch_host_us": _stats(first_launch_us),
                "first_short_window": short[0] if short else None}),
                flush=True)
        return None

    cs.traced_counts = traced
    report: dict = {}
    state: dict = {"card": torch.cuda.get_device_name(0)}
    cs.phase_build()
    cs.phase_kernel(report)
    cs.phase_decode_kernel(report)
    cs.phase_match_kernel(report)
    cs.phase_bottleneck_kernel(report)
    cs.phase_bottleneck_bwd_kernel(report)
    cs.phase_reference()
    cs.phase_main(report, state)
    cs.phase_eval_branch(report, state)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--windows", type=int, default=300)
    ap.add_argument("--smoke-phases", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    if args.smoke_phases:
        smoke_phases(args.windows)
        return 0
    from detjax_torch.kernels import postprocess as pp

    boxes, scores, labels = (torch.from_numpy(a).cuda()
                             for a in cs.hard_candidates(0))
    nms_args = (*cs.sorted_rows(boxes, scores, labels), 0.5, 100, 642.0)
    one = torch.zeros(1, device="cuda")
    calls = {"nms_cuda": (lambda: pp.nms_cuda(*nms_args), "nms_kernel"),
             "add_": (lambda: one.add_(1.0), "elementwise")}
    summary = {}
    for what, (fn, name) in calls.items():
        fn()
        torch.cuda.synchronize()
        for guard, shape in GUARDS.items():
            wins = [window(fn, name, *shape) for _ in range(args.windows)]
            missing = [w for w in wins if w["records"] < CALLS]
            row = {"call": what, "kernel": name, "guard": guard,
                   "windows": len(wins), "windows_missing": len(missing),
                   "records_missing": sum(CALLS - w["records"]
                                          for w in missing),
                   "windows_missing_a_spin": sum(w["spins_missing"] > 0
                                                 for w in wins),
                   "start_after_launch_us": _stats(
                       w["start_after_launch_us"] for w in wins),
                   "end_after_sync_us": _stats(
                       w["end_after_sync_us"] for w in wins),
                   "records_before_their_launch": sum(
                       (w["start_after_launch_us"] or 0) < 0 for w in wins),
                   "records_after_the_sync": sum(
                       (w["end_after_sync_us"] or 0) > 0 for w in wins)}
            print(json.dumps(row), flush=True)
            summary[f"{what}/{guard}"] = [len(missing),
                                          row["windows_missing_a_spin"],
                                          len(wins)]
    print(json.dumps({"windows_missing_a_record_or_a_spin_of": summary}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
