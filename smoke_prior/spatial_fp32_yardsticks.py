"""How far cuDNN's choice of algorithm moves one fp32 step's gradients,
beside the spatial pair's gap to the single-process step.

chip_smoke.py's spatial phase holds the pair's fp32 step (R50-1024, 8
images, TF32 off, sgd, clip off) to the single-process step at ``gloo_row``'s
bars: each gradient's 2-norm gap within the larger of 1e-3 and 4 x the
gap of the same single step with the batch's halves swapped. That
yardstick keeps every convolution's shape, so cuDNN runs the same
algorithms on both sides; the pair's shards (halo'd rows) are other
shapes, for which cuDNN may choose other algorithms. This script measures
the gaps that choice alone makes, on the same seeded, desaturated
weights and batch as the phase:

- A, the single-process step (cuDNN's default choice);
- B, A with the batch's halves swapped (the phase's yardstick);
- C, A under chip_smoke.py's ``deterministic()`` (cuDNN's deterministic
  algorithms);
- D, the (1, 2) pair's step (two gloo ranks on cuda:0), default;
- E, D under ``deterministic()``;
- F, A from weights nudged by one fp32 step each (every floating
  parameter times 1 + 2^-23 or 1 - 2^-23, by a seeded sign): how far a
  perturbation of the size of fp32 rounding moves each gradient, the
  tensor's conditioning;

and prints, per tensor, the 2-norm gap of B, C, D and F to A and of E to
C, for the tensors with the largest gaps, then ``grad_check``'s reading
of D against A and of E against C, and for the five tensors D moves most
the share of its two ranks' gradients that cancels in their sum
(1 - ||g0 + g1|| / (||g0|| + ||g1||)). Then, for
``regressionModel.conv1.weight`` (the tensor D moves most), its exact
gradient in fp64 from the inputs and output gradients A's step gave that
conv at its five levels (``torch.nn.grad.conv2d_weight``), the same sum
of the products' absolute values, and the gaps of A and D to the exact
gradient: a sum whose terms cancel amplifies the rounding of any order of
summation by the ratio of the two. One JSON line each.

    python3 smoke_prior/spatial_fp32_yardsticks.py
"""

from __future__ import annotations

import contextlib
import json
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

PRESET = "retinanet_r50_1024"
TOP = 8


def fp32_config():
    return cs.spatial_config(PRESET, **cs.SPATIAL_FP32)


def nudged(sd: dict) -> dict:
    """``sd`` with every floating parameter moved by one fp32 step, up or
    down by a seeded sign; buffers as they are."""
    gen = torch.Generator().manual_seed(0)
    out = {}
    for k, v in sd.items():
        if v.is_floating_point() and "running" not in k:
            sign = torch.randint(0, 2, v.shape, generator=gen) * 2 - 1
            v = v * (1 + sign.to(v.dtype) * 2.0 ** -23)
        out[k] = v
    return out


def captured_step(train, batch):
    """A's step, keeping regressionModel.conv1's input and output gradient
    at each level."""
    import detjax_torch

    conv = train.model.regressionModel.conv1
    seen = []

    def keep(module, args, out):
        rec = {"x": args[0].detach()}
        out.register_hook(lambda g: rec.__setitem__("dy", g.detach()))
        seen.append(rec)

    handle = conv.register_forward_hook(keep)
    try:
        rec = one_step(lambda x: detjax_torch.train_step(train, x), train,
                       batch, False)
    finally:
        handle.remove()
    return rec, seen


def exact_conv1_grad(seen, shape):
    """The weight gradient of the captured levels in fp64, and the sum of
    the products' absolute values."""
    from torch.nn.grad import conv2d_weight

    exact = absolute = 0
    for rec in seen:
        x, dy = rec["x"].double(), rec["dy"].double()
        exact = exact + conv2d_weight(x, shape, dy, padding=1)
        absolute = absolute + conv2d_weight(x.abs(), shape, dy.abs(),
                                            padding=1)
    return exact, absolute


def one_step(step, train, batch, det: bool) -> dict:
    scope = cs.deterministic() if det else contextlib.nullcontext()
    with cs.tf32_off(), scope:
        return cs.dp_steps(step, train, [batch])


def rank(r: int, port: int, root: str) -> None:
    import torch.distributed as dist

    from detjax_torch.parallel import (make_mesh, make_parallel_train_step,
                                       shard_batch)

    root = Path(root)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=r, world_size=2)
    try:
        mesh = make_mesh(["cuda:0"], spatial=2)
        inputs = torch.load(root / "inputs.pt", weights_only=False)
        cfg = fp32_config()
        out = {}
        for name, det in (("D", False), ("E", True)):
            train = cs.dp_state(cfg, inputs["sd"])
            run = make_parallel_train_step(cfg, mesh)
            out[name] = one_step(lambda b: run(train, shard_batch(b, mesh)),
                                 train, inputs["batch"], det)
            del train
        # the rank's own gradients, before the sum over the ranks
        from detjax_torch.train import step as tstep

        train = cs.dp_state(cfg, inputs["sd"])
        with cs.tf32_off():
            tstep.compute_gradients(train, shard_batch(inputs["batch"], mesh),
                                    mesh=mesh)
        local = {n: p.grad.detach().to("cpu", copy=True)
                 for n, p in train.model.named_parameters()}
        del train
        parts = [None, None]
        dist.all_gather_object(parts, local)
        out["local"] = parts
        dist.barrier()
    finally:
        dist.destroy_process_group()
    if r == 0:
        torch.save(out, root / "pair.pt")


def main() -> int:
    import torch.multiprocessing as mp

    import detjax_torch

    card = cs.print_card()
    t0 = time.perf_counter()
    cfg = cs.spatial_config(PRESET)
    batch = cs.train_batch(cfg, seed=0)
    train = detjax_torch.make_train_state(cfg, seed=0)
    cs.desaturate_(train.model, batch["images"][:4], cfg)
    sd = {k: v.detach().to("cpu", copy=True)
          for k, v in train.model.state_dict().items()}
    del train
    c = fp32_config()
    runs = {}
    train = cs.dp_state(c, sd)
    runs["A"], seen = captured_step(train, batch)
    w_shape = train.model.regressionModel.conv1.weight.shape
    del train
    exact, absolute = exact_conv1_grad(seen, w_shape)
    del seen
    for name, b, det, w in (("B", cs.swap_halves(batch), False, sd),
                            ("C", batch, True, sd),
                            ("F", batch, False, nudged(sd))):
        train = cs.dp_state(c, w)
        runs[name] = one_step(lambda x: detjax_torch.train_step(train, x),
                              train, b, det)
        del train
    torch.cuda.empty_cache()
    tmp = tempfile.TemporaryDirectory(prefix="detjax_yard_")
    root = Path(tmp.name)
    torch.save({"sd": sd, "batch": batch}, root / "inputs.pt")
    mp.start_processes(rank, args=(cs.free_port(), str(root)), nprocs=2,
                       start_method="spawn")
    runs.update(torch.load(root / "pair.pt", weights_only=False))
    tmp.cleanup()
    g0, g1 = runs.pop("local")

    grads = {k: v["grads_step_1"] for k, v in runs.items()}
    gaps = {"B_vs_A": cs.rel_norm_gaps(grads["B"], grads["A"]),
            "C_vs_A": cs.rel_norm_gaps(grads["C"], grads["A"]),
            "D_vs_A": cs.rel_norm_gaps(grads["D"], grads["A"]),
            "E_vs_C": cs.rel_norm_gaps(grads["E"], grads["C"]),
            "F_vs_A": cs.rel_norm_gaps(grads["F"], grads["A"])}
    worst = sorted(gaps["D_vs_A"], key=gaps["D_vs_A"].get, reverse=True)
    for k in worst[:TOP]:
        cs.emit({"tensor": k, **{g: v[k] for g, v in gaps.items()}})
    for g, v in gaps.items():
        cs.emit({"gaps": g, "max": max(v.values()),
                 "over_1e-3": sum(x > 1e-3 for x in v.values())})
    for k in worst[:5]:
        a, b = g0[k].double(), g1[k].double()
        cs.emit({"tensor": k, "cancels": float(
            1 - (a + b).norm() / (a.norm() + b.norm()))})
    key = "regressionModel.conv1.weight"
    cond = (absolute / exact.abs().clamp(min=1e-300)).flatten()
    cs.emit({"tensor": key, "exact_fp64_vs_A_bias_included": False,
             **{f"{n}_vs_exact": float(
                 (grads[n][key].double().cuda() - exact).norm()
                 / exact.norm()) for n in ("A", "D", "F")},
             "sum_abs_over_abs_sum_median": float(cond.median()),
             "sum_abs_over_abs_sum_norm": float(absolute.norm()
                                                / exact.norm())})
    cs.emit({"grad_check": "D against A (the phase's reading)",
             **cs.grad_check(runs["D"], runs["A"], [runs["B"]])})
    cs.emit({"grad_check": "E against C, both deterministic",
             **cs.grad_check(runs["E"], runs["C"], [runs["B"]])})
    cs.emit({"losses": {k: v["losses"][0] for k, v in runs.items()},
             "wall_s": time.perf_counter() - t0, "card": card})
    print(json.dumps({"ok": True}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
