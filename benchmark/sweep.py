"""The knee of a configuration's open-loop serving, by a sweep of offered
rates.

    python3 benchmark/sweep.py --config retinanet_r50_1024 \
        --traffic open_b32_poisson --rates 300,400,500 [--seconds 8] \
        [--seed 1]

Runs the open loop (``drivers/serve.py::run_open``) of the configuration
under the mix at each rate in turn (each its own set-up, in one process)
and prints one JSON line a rate: requests offered and refused, the
latency percentiles of the window and of its two halves. The knee is the
highest rate at which no request is refused and the second half's tail is
no worse than the first's: the backlog does not grow.
"""

import argparse
import copy
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import harness
    from benchmark.drivers.serve import run_open

    config, traffic = harness.load_parts(args.config, args.traffic)
    cell = {"name": f"{args.config}+{args.traffic}"}
    print(harness.card_line(), flush=True)
    for rate in [float(x) for x in args.rates.split(",")]:
        tr = dict(copy.deepcopy(traffic), rate_img_s=rate)
        res = run_open(harness.Run(cell, copy.deepcopy(config), tr,
                                   args.seed, args.seconds, False,
                                   torch.device("cuda", 0),
                                   time.perf_counter()))
        print(json.dumps({"rate": rate, "correct": res["correct"],
                          **res["diag"]}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
