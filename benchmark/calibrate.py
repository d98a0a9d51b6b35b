"""The readings that a cell's correctness limits are set from, on the chip.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... \
        --control-seeds 1,2,3 [--seconds 3]

In one process: the cell's own run (set-up, a short window at the cell's
load, the comparison) on each of ``--seeds``, printing each number the
comparison reads; then, on each of ``--control-seeds``, the same numbers
for the control, the reference computed with every convolution's
operands in float8 e4m3 (the precision below the configuration's bf16)
put in the program's place, and for the faults a cell can have, planted
in the reference put in the program's place: for training, half of each
batch left out and the mean taken over the rest; for serving, half of a
batch's answers left out, and one answer a canvas altered (its top
detection's class moved by one). A state left unchanged reads 1 on the
change by construction and needs no run. One JSON line a reading.
"""

import argparse
import copy
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def train_controls(r, out):
    import torch

    from benchmark import weights
    from benchmark.drivers.train import make_pool
    from benchmark.reference import detection as D
    from benchmark.reference import model as R
    from benchmark.reference import train as T

    conf, tr = r.config, r.traffic
    mc, tc = conf["model"], conf["train"]
    batch = tr["batch"]
    images, gt_boxes, gt_labels = make_pool(r, mc, batch)
    ref = R.build(mc, r.device)
    w0 = {k: v.clone() for k, v in weights.make(
        ref, r.seed, images[0, :tr["desaturate_images"]]).items()}
    anc = D.anchors(mc["image_size"], range(mc["min_level"],
                                            mc["max_level"] + 1),
                    mc["anchor_scales"], mc["anchor_ratios"],
                    mc["anchor_base_scale"], r.device)
    checked = tr["checked_steps"]
    train_seed = int(r.seed) % 2 ** 31
    flips = [D.flip_mask(train_seed, s, batch, conf["data"]["hflip_prob"])
             for s in range(checked)]
    batches = [(images[s], gt_boxes[s], gt_labels[s]) for s in range(checked)]

    def steps(kind="fp32", rows=None):
        ref.load_state_dict(w0)
        with R.tf32_off(), R.precision(ref, kind):
            return T.run_steps(ref, batches, flips, anc, tc, mc["box_std"],
                               rows=rows)
    want = steps()
    for name, got in (("control_fp8", steps("fp8")),
                      ("fault_half_batch", steps(rows=batch // 2))):
        out({"reading": name, "seed": r.seed, **T.compare(got, want)})


def serve_controls(r, out):
    import numpy as np
    import torch

    from benchmark import weights
    from benchmark.drivers.serve import content_sizes
    from benchmark.reference import model as R
    from benchmark.reference import serve as RS
    from benchmark.traffic import scenes

    conf, tr = r.config, r.traffic
    mc = conf["model"]
    gen = torch.Generator(device=r.device).manual_seed(int(r.seed) + 1)
    pool = scenes.canvases(tr["pool"], mc["image_size"], content_sizes(
        mc["image_size"], tr["source_sizes_wh"], tr["resize_min_max"]), gen, r.device)
    ref = R.build(mc, r.device)
    weights.make(ref, r.seed, pool[:tr["desaturate_images"]])
    rng = np.random.default_rng(int(r.seed) + 2)
    canv = sorted(rng.choice(tr["pool"], size=tr["sample"], replace=False))
    canvases = pool[canv]
    exact = RS.detect(ref, conf, canvases, "fp32")
    fp8 = RS.detect(ref, conf, canvases, "fp8")
    half = [a if i % tr["batch"] < tr["batch"] // 2 else
            (a[0] * 0, a[1] * 0, a[2] * 0 - 1, 0)
            for i, a in enumerate(exact)]
    altered = []
    for a in exact:
        labels = a[2].copy()
        labels[0] = (labels[0] + 1) % mc["num_classes"]
        altered.append((a[0], a[1], labels, a[3]))
    for name, answers in (("control_fp8", fp8), ("fault_half_batch", half),
                          ("fault_altered_answer", altered),
                          ("reference_itself", exact)):
        out({"reading": name, "seed": r.seed,
             **RS.compare(ref, conf, canvases, [[a] for a in answers])})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import harness
    from benchmark.run import execute

    cell, config, traffic = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("calibrate runs on a CUDA device", file=sys.stderr)
        return 2
    sink = open(args.out, "a") if args.out else None

    def out(obj):
        obj = dict(cell=args.workload, **obj)
        print(json.dumps(obj), flush=True)
        if sink:
            sink.write(json.dumps(obj) + "\n")
            sink.flush()
    print(harness.card_line(), flush=True)
    dev = torch.device("cuda", 0)

    def run_for(seed):
        return harness.Run(cell, copy.deepcopy(config), copy.deepcopy(traffic),
                           seed, args.seconds, False, dev,
                           time.perf_counter())
    for seed in [int(s) for s in args.seeds.split(",") if s]:
        t0 = time.perf_counter()
        res = execute(run_for(seed))
        out({"reading": "program", "seed": seed, "correct": res["correct"],
             **{k: v["value"] for k, v in res["checks"].items()},
             "metrics": {k: v["value"] for k, v in res["metrics"].items()},
             "diag": res.get("diag"), "s": time.perf_counter() - t0})
        torch.cuda.empty_cache()
    controls = (train_controls if traffic["driver"] == "train"
                else serve_controls)
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        controls(run_for(seed), out)
        torch.cuda.empty_cache()
    if sink:
        sink.close()
    print("forbidden modules:", harness.forbidden_modules(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
