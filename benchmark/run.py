"""Run one cell of the benchmark of detjax_torch and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell's configuration, traffic mix and
metrics are found by name (``BENCHMARK.json``, ``benchmark/configs``,
``benchmark/traffic/mixes``, ``benchmark/metrics``). The last line of
standard output is the result, one JSON object; the numbers the
correctness check compared, each beside its limit, are the last lines of
standard error. Exits with 2, printing no result, without a CUDA device
for each chip the cell asks for, and with 3 when the process holds jax,
flax or detjax once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every build and kernel cache of the run stays inside the checkout
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TRITON_CACHE_DIR": "triton"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "benchmark" / ".cache" / sub)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import harness

    cell, config, traffic = harness.load_cell(args.workload)
    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    print(harness.card_line(), file=sys.stderr)
    result = execute(harness.Run(cell, config, traffic, args.seed,
                                 args.seconds, bool(args.trace),
                                 torch.device("cuda", 0), T_START))
    return emit(result)


def execute(run) -> dict:
    """The cell's driver on ``run``."""
    import importlib

    driver = importlib.import_module(
        f"benchmark.drivers.{run.traffic['driver']}")
    return driver.run(run)


def emit(result: dict) -> int:
    """Check the process for forbidden modules, then print the checks and
    the result line."""
    from benchmark import harness

    found = harness.forbidden_modules()
    if found:
        print(f"the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    checks = result.pop("checks")
    line = {k: result[k] for k in ("correct", "attempted", "failed",
                                   "metrics", "device")}
    if "breakdown" in result:
        line["breakdown"] = result["breakdown"]
    line["checks"] = checks
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
