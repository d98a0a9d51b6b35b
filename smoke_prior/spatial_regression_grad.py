"""Where the spatial pair's fp32 step moves the box tower's gradients, on
the card.

chip_smoke.py's spatial phase reads the pair's gradient of
``regressionModel.conv1.weight`` 9.79e-4 (2-norm ratio) from the
single-process step's at retinanet_r50_1024, which the same step matches
to 2.2e-7 against the exact fp64 gradient of its own inputs
(``smoke_prior/spatial_fp32_yardsticks.py``). This script takes one fp32
step (TF32 off) of that cell on the pair (two gloo ranks on cuda:0) and in
this process, on the same weights and batch, keeping at each of the five
levels the input, the pre-activation output and its gradient of every
conv of the box tower (``regressionModel.conv1..4``; ``output``'s input),
and prints:

- for conv1, the pair's weight gradient against the exact fp64 gradient of
  the pair's own inputs and output gradients (each rank's rows, summed):
  whether the spatial path computes the gradient of what it was given;
- for conv1..4, the ReLU masks that differ between the pair and this
  process (pre-activations of opposite signs), all of them and those
  whose output gradient is not zero in this process;
- the order in which each rank ran the backward's halo exchanges and row
  gathers, numbered in the forward's order: the all-gathers pair the
  ranks' calls by position, so the lists must be equal.

    python3 smoke_prior/spatial_regression_grad.py
"""

from __future__ import annotations

import json
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

PRESET = "retinanet_r50_1024"
CONVS = ("conv1", "conv2", "conv3", "conv4")


def numbered(fn_cls, log):
    """Wrap an autograd Function's forward and backward: the forward
    numbers its node, the backward logs the number."""
    fwd, bwd = fn_cls.forward, fn_cls.backward

    def forward(ctx, *args):
        ctx.serial = (fn_cls.__name__, len(log["forward"]))
        log["forward"].append(ctx.serial)
        return fwd(ctx, *args)

    def backward(ctx, *grads):
        log["backward"].append(ctx.serial)
        return bwd(ctx, *grads)

    fn_cls.forward = staticmethod(forward)
    fn_cls.backward = staticmethod(backward)


def captured_grads(train, batch, mesh=None):
    """One fp32 step's gradients (no update), keeping each box-tower
    conv's input, pre-activation output and output gradient a level."""
    from detjax_torch.train import step as tstep

    seen = {c: [] for c in CONVS}
    handles = []
    for name in CONVS:
        conv = getattr(train.model.regressionModel, name)

        def keep(module, args, out, name=name):
            rec = {"x": args[0].detach(), "y": out.detach()}
            out.register_hook(lambda g: rec.__setitem__("dy", g.detach()))
            seen[name].append(rec)

        handles.append(conv.register_forward_hook(keep))
    try:
        with cs.tf32_off():
            tstep.compute_gradients(train, batch, mesh=mesh)
    finally:
        for h in handles:
            h.remove()
    torch.cuda.synchronize()
    return seen


def exact_weight_grad(recs, shape):
    from torch.nn.grad import conv2d_weight

    out = 0
    for rec in recs:
        out = out + conv2d_weight(rec["x"].double(), shape,
                                  rec["dy"].double(), padding=1)
    return out


def rank(r: int, port: int, root: str) -> None:
    import torch.distributed as dist

    from detjax_torch.models import spatial
    from detjax_torch.parallel import make_mesh, shard_batch

    log = {"forward": [], "backward": []}
    numbered(spatial._Halo, log)
    numbered(spatial._GatherRows, log)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=r, world_size=2)
    try:
        mesh = make_mesh(["cuda:0"], spatial=2)
        inputs = torch.load(Path(root) / "inputs.pt", weights_only=False)
        cfg = cs.spatial_config(PRESET, **cs.SPATIAL_FP32)
        train = cs.dp_state(cfg, inputs["sd"])
        tower = train.model.regressionModel
        seen = {c: [] for c in CONVS}
        real = spatial.conv2d

        def conv2d(conv, x):
            y = real(conv, x)
            for name in CONVS:
                if conv is getattr(tower, name):
                    rec = {"x": spatial.halo(x, 1, 1, 0.0).detach(),
                           "y": y.detach()}
                    y.register_hook(
                        lambda g, rec=rec: rec.__setitem__("dy", g.detach()))
                    seen[name].append(rec)
            return y

        spatial.conv2d = conv2d
        from detjax_torch.train import step as tstep

        with cs.tf32_off():
            tstep.compute_gradients(train, shard_batch(inputs["batch"], mesh),
                                    mesh=mesh)
        torch.cuda.synchronize()
        spatial.conv2d = real
        from torch.nn.grad import conv2d_weight

        w = tower.conv1.weight
        sg = mesh.space_context()
        exact = 0
        for rec in seen["conv1"]:  # halo'd input, no row padding
            exact = exact + conv2d_weight(rec["x"].double(), w.shape,
                                          rec["dy"].double(),
                                          padding=(0, 1))
        dist.all_reduce(exact, group=mesh.group)
        got = w.grad.double().clone()
        dist.all_reduce(got, group=mesh.group)
        out = {"log": log, "conv1_exact": exact.cpu(),
               "conv1_got": got.cpu(),
               "y": {n: [spatial.gather_rows(rec["y"], sg).cpu() > 0
                         for rec in seen[n]] for n in CONVS}}
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(out, Path(root) / f"rank{r}.pt")


def main() -> int:
    import torch.multiprocessing as mp

    import detjax_torch

    card = "cpu" if not torch.cuda.is_available() else cs.print_card()
    cfg = cs.spatial_config(PRESET)
    batch = cs.train_batch(cfg, seed=0)
    train = detjax_torch.make_train_state(cfg, seed=0)
    cs.desaturate_(train.model, batch["images"][:4], cfg)
    sd = {k: v.detach().to("cpu", copy=True)
          for k, v in train.model.state_dict().items()}
    del train
    tmp = tempfile.TemporaryDirectory(prefix="detjax_reg_")
    torch.save({"sd": sd, "batch": batch}, Path(tmp.name) / "inputs.pt")
    mp.start_processes(rank, args=(cs.free_port(), tmp.name), nprocs=2,
                       start_method="spawn")
    got = [torch.load(Path(tmp.name) / f"rank{r}.pt", weights_only=False)
           for r in range(2)]
    tmp.cleanup()

    c = cs.spatial_config(PRESET, **cs.SPATIAL_FP32)
    train = cs.dp_state(c, sd)
    seen = captured_grads(train, batch)
    w = train.model.regressionModel.conv1.weight
    single = w.grad.double().cpu()
    exact_single = exact_weight_grad(seen["conv1"], w.shape).cpu()
    g = got[0]

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    cs.emit({"conv1_pair_vs_its_exact": rel(g["conv1_got"],
                                            g["conv1_exact"]),
             "conv1_single_vs_its_exact": rel(single, exact_single),
             "conv1_pair_vs_single": rel(g["conv1_got"], single),
             "conv1_exacts_apart": rel(g["conv1_exact"], exact_single)})
    for name in CONVS:
        flips = live = total = 0
        for lvl, rec in enumerate(seen[name]):
            mine = rec["y"].cpu() > 0
            theirs = g["y"][name][lvl]
            d = mine != theirs
            flips += int(d.sum())
            live += int((d & (rec["dy"].cpu() != 0)).sum())
            total += mine.numel()
        cs.emit({"conv": name, "relu_masks_differing": flips,
                 "differing_with_gradient": live, "elements": total})
    a, b = (x["log"]["backward"] for x in got)
    diff = [i for i, (p, q) in enumerate(zip(a, b)) if p != q]
    cs.emit({"forward_order_equal": got[0]["log"]["forward"]
             == got[1]["log"]["forward"],
             "backward_order_equal": a == b,
             "backward_calls": [len(a), len(b)],
             "first_differences": [[i, a[i], b[i]] for i in diff[:12]],
             "card": card})
    print(json.dumps({"ok": True}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
