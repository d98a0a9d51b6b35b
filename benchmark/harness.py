"""What every cell shares: the manifest, a cell's files, the program's
config, the device trace, the per-layer readers and the result line.

A cell is found by name: ``BENCHMARK.json`` names its configuration and
its traffic mix; the configuration is ``configs/<config>.json`` and the
mix ``traffic/mixes/<traffic>.json``, whose ``driver`` names the module
under ``drivers/`` that runs it; each per-layer metric is read by
``metrics/<metric>.py``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "detjax")
MARK_CYCLES = 20_000  # a spin kernel of about 10 us marks a traced window
WARM_SPINS = 4  # the profiler can miss a window's first launches
PAD_S = 0.05


@dataclasses.dataclass
class Run:
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float  # host clock at process start


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def load_cell(name: str) -> Tuple[dict, dict, dict]:
    """(cell, config, traffic) of the cell ``name``."""
    man = manifest()
    cells = {w["name"]: w for w in man["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; have {sorted(cells)}")
    cell = cells[name]
    return (cell, *load_parts(cell["config"], cell["traffic"]))


def load_parts(config_name: str, traffic_name: str) -> Tuple[dict, dict]:
    """(config, traffic) files by name: ``configs/<config>.json`` and
    ``traffic/mixes/<traffic>.json``."""
    config = json.loads((HERE / "configs" / f"{config_name}.json")
                        .read_text())
    traffic = json.loads(
        (HERE / "traffic" / "mixes" / f"{traffic_name}.json").read_text())
    return config, traffic


def program_config(config: dict, **extra):
    """The program's ``Config`` for a configuration file: its preset and
    overrides, checked against every number the file states."""
    import detjax_torch

    overrides = {k: tuple(v) if isinstance(v, list) else v
                 for k, v in dict(config["overrides"], **extra).items()}
    cfg = detjax_torch.get_config(config["preset"], **overrides)
    for section in ("model", "train", "data", "eval"):
        for key, want in config.get(section, {}).items():
            got = getattr(getattr(cfg, section), key)
            same = (list(map(float, _flat(got))) == list(map(float, _flat(
                want))) if isinstance(want, (list, float, int))
                and not isinstance(want, bool) else got == want)
            if not same:
                raise SystemExit(f"{config['name']}: {section}.{key} is "
                                 f"{got!r} in the program, {want!r} in the "
                                 f"configuration file")
    return cfg


def _flat(v):
    if isinstance(v, (list, tuple)):
        return [x for item in v for x in _flat(item)]
    return [v]


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that the run may not hold."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def device_info(device: torch.device, peak_bytes: int) -> dict:
    return {"platform": "gpu" if device.type == "cuda" else device.type,
            "kind": (torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu"),
            "count": 1, "memory_peak_bytes": int(peak_bytes)}


def card_line() -> str:
    """The card's name, power limit, SM clock, power draw and temperature,
    as nvidia-smi gives them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "power.draw,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class DeviceTrace:
    """torch.profiler over the device's activity alone, its window marked
    by two spin kernels: the traced window runs from the end of the first
    marker to the start of the second, on the device's clock. Kernels,
    copies and sets that ran inside it are kept as (name, start us, end
    us); on a device without a trace the lists stay empty."""

    def __init__(self, device: torch.device):
        self.device = device
        self.events: List[Tuple[str, float, float]] = []
        self.window: Optional[Tuple[float, float]] = None
        self.host: List[float] = []
        self._prof = None

    def start(self) -> None:
        if self.device.type != "cuda":
            self.host.append(time.perf_counter())
            return
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA],
                             acc_events=True)
        self._prof.start()
        for _ in range(WARM_SPINS):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize(self.device)
        time.sleep(PAD_S)
        torch.cuda._sleep(MARK_CYCLES)
        self.host.append(time.perf_counter())

    def stop(self) -> None:
        if self._prof is not None:
            torch.cuda._sleep(MARK_CYCLES)
        self.host.append(time.perf_counter())
        if self._prof is None:
            return
        torch.cuda.synchronize(self.device)
        time.sleep(PAD_S)
        self._prof.stop()
        from torch.autograd import DeviceType

        evs = [(e.name, float(e.time_range.start), float(e.time_range.end))
               for e in self._prof.events()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
        self._prof = None
        spins = sorted((e for e in evs if "spin_kernel" in e[0]),
                       key=lambda e: e[1])
        if len(spins) < 2:
            return
        t0, t1 = spins[-2][2], spins[-1][1]
        self.window = (t0, t1)
        self.events = sorted(
            (e for e in evs if "spin_kernel" not in e[0]
             and e[1] >= t0 and e[2] <= t1), key=lambda e: e[1])

    @property
    def window_s(self) -> float:
        if self.window is None:
            return self.host[-1] - self.host[0]
        return (self.window[1] - self.window[0]) / 1e6

    def busy_s(self) -> float:
        """Seconds of the window in which some operation ran: the union of
        the intervals, so that overlapping streams count once."""
        busy, end = 0.0, -math.inf
        for _, s, e in self.events:
            if e > end:
                busy += e - max(s, end)
                end = e
        return busy / 1e6

    def kernel_seconds(self, match) -> Tuple[float, int]:
        """Seconds and launches of the events whose name ``match`` takes."""
        t = [e - s for name, s, e in self.events if match(name)]
        return sum(t) / 1e6, len(t)

    def breakdown(self, top: int = 10) -> dict:
        by_name: Dict[str, float] = {}
        for name, s, e in self.events:
            short = short_name(name)
            by_name[short] = by_name.get(short, 0.0) + (e - s) / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps, end, prev = [], self.window[0] if self.window else 0.0, "start"
        for name, s, e in self.events:
            if s > end:
                gaps.append((f"{prev} -> {short_name(name)}", (s - end) / 1e6))
            if e > end:
                end, prev = e, short_name(name)
        if self.window and self.window[1] > end:
            gaps.append((f"{prev} -> end", (self.window[1] - end) / 1e6))
        gaps.sort(key=lambda g: -g[1])
        return {"device_ops": [[n, t] for n, t in ops],
                "idle_gaps": [[n, t] for n, t in gaps[:top]]}


def short_name(name: str) -> str:
    """A kernel's name without its template arguments and parameters."""
    for cut in ("void ", "(anonymous namespace)::"):
        name = name.replace(cut, "")
    for sep in ("<", "("):
        name = name.split(sep)[0]
    return name[:80]


def read_metrics(cell_name: str, record: dict) -> Dict[str, dict]:
    """Each per-layer metric of the cell, read by its own reader; one that
    finds nothing to read is left out."""
    out = {}
    for m in manifest()["per_layer"]:
        if "workloads" in m and cell_name not in m["workloads"]:
            continue
        path = HERE / "metrics" / f"{m['name']}.py"
        spec = importlib.util.spec_from_file_location(
            "benchmark_metric_" + m["name"].replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        value = mod.read(record)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def e2e(cell_name: str, values: Dict[str, float]) -> Dict[str, dict]:
    """The cell's end-to-end metrics, with their units."""
    out = {}
    for m in manifest()["end_to_end"]:
        if "workloads" in m and cell_name not in m["workloads"]:
            continue
        out[m["name"]] = {"value": float(values[m["name"]]),
                          "unit": m["unit"]}
    return out


def checks(numbers: Dict[str, float], limits: Dict[str, float]
           ) -> Tuple[bool, Dict[str, dict]]:
    """Each number beside its limit; correct when none exceeds it."""
    out = {k: {"value": float(numbers[k]), "limit": float(limits[k])}
           for k in limits}
    ok = all(math.isfinite(v["value"]) and v["value"] <= v["limit"]
             for v in out.values())
    return ok, out
