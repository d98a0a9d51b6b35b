"""One 3x3 stride-1 convolution of the RetinaNet head on rows split over
two ranks, against the same convolution on the whole rows, on the card.

For each pyramid level of retinanet_r50_1024 at batch 8 (256 channels,
128 to 8 rows, 128 to 8 columns), fp32 with TF32 off: the forward output,
the input gradient and the weight gradient of ``spatial.conv2d`` on each
rank's rows (two gloo ranks on cuda:0, a (1, 2) mesh; the weight
gradients summed over the ranks) against ``F.conv2d`` on the whole rows in
this process, on the same seeded inputs and output gradient (dense, and
zero but at 300 seeded pixels, as a box regression loss leaves it); and
``spatial.gather_rows``' backward (each rank's objective the gathered
rows times the output gradient, halved) against the output gradient. Prints
one JSON line a (level, cotangent): each result's largest relative
difference (max |a - b| / max |b|) and the 2-norm of the difference over
the 2-norm of the single process's. Then the whole retinanet_r50_1024
forward in fp32 on chip_smoke.py's spatial cell (seeded, desaturated
weights; its first batch), on the pair against this process: for each
pyramid level and each output (class logits, box deltas), the largest
difference over the largest value, and the three rows (of the level) with
the largest differences.

    python3 smoke_prior/spatial_conv_probe.py
"""

from __future__ import annotations

import json
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke as cs  # noqa: E402

SIZES = (128, 64, 32, 16, 8)
PRESET = "retinanet_r50_1024"
CHANNELS = 256
BATCH = 8


def case(rows: int, sparse: bool, dev) -> dict:
    gen = torch.Generator().manual_seed(rows * 2 + sparse)
    x = torch.randn(BATCH, CHANNELS, rows, rows, generator=gen)
    w = torch.randn(CHANNELS, CHANNELS, 3, 3, generator=gen) * 0.02
    dy = torch.randn(BATCH, CHANNELS, rows, rows, generator=gen)
    if sparse:
        keep = torch.zeros(BATCH * rows * rows, dtype=torch.bool)
        keep[torch.randperm(keep.numel(), generator=gen)[:300]] = True
        dy = dy * keep.view(BATCH, 1, rows, rows)
    return {k: v.to(dev).contiguous(memory_format=torch.channels_last)
            for k, v in (("x", x), ("w", w), ("dy", dy))}


def single(c: dict) -> dict:
    x = c["x"].clone().requires_grad_()
    w = c["w"].clone().requires_grad_()
    y = F.conv2d(x, w, None, 1, 1)
    y.backward(c["dy"])
    return {"y": y.detach(), "dx": x.grad, "dw": w.grad}


def rank(r: int, port: int, root: str) -> None:
    import types

    import torch.distributed as dist

    from detjax_torch.models import spatial
    from detjax_torch.parallel import make_mesh

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=r, world_size=2)
    out = {}
    try:
        mesh = make_mesh(["cuda:0"], spatial=2)
        dev = torch.device("cuda:0")
        with cs.tf32_off(), spatial.space_group(mesh.space_context()):
            for rows in SIZES:
                for sparse in (False, True):
                    c = case(rows, sparse, dev)
                    cut = mesh.image_rows(rows)
                    x = c["x"][:, :, cut].contiguous(
                        memory_format=torch.channels_last).requires_grad_()
                    w = c["w"].clone().requires_grad_()
                    conv = types.SimpleNamespace(
                        kernel_size=(3, 3), stride=(1, 1), padding=(1, 1),
                        dilation=(1, 1), groups=1, weight=w, bias=None)
                    y = spatial.conv2d(conv, x)
                    y.backward(c["dy"][:, :, cut])
                    dw = w.grad.clone()
                    dist.all_reduce(dw, group=mesh.group)
                    out[(rows, sparse)] = {
                        "y": spatial.gather_rows(y.detach()),
                        "dx": spatial.gather_rows(x.grad), "dw": dw}
                    # the row gather's backward: every rank's objective is
                    # <gathered, dy> / 2, so the rank's rows get dy's
                    g = c["x"][:, :, cut].clone().requires_grad_()
                    (spatial.gather_rows(g) * c["dy"]).sum().div(2).backward()
                    out[(rows, sparse)]["gather_dx"] = spatial.gather_rows(
                        g.grad)
            inputs = torch.load(Path(root) / "model.pt", weights_only=False)
            model = model_of(inputs["sd"])
            images = torch.as_tensor(inputs["batch"]["images"])
            x = normalized(model, images[:, mesh.image_rows(images.shape[1])])
            with torch.no_grad():
                out["model"] = {n: t.cpu() for n, t in zip(
                    ("cls", "box"), model(x))}
        dist.barrier()
    finally:
        dist.destroy_process_group()
    if r == 0:
        torch.save({k: {n: t.cpu() for n, t in v.items()}
                    for k, v in out.items()}, Path(root) / "pair.pt")


def model_of(sd):
    import detjax_torch

    cfg = cs.spatial_config(PRESET, **{"model.dtype": "float32"})
    model = detjax_torch.build_model(cfg, seed=0)
    model.load_state_dict(sd, strict=True)
    return model


def normalized(model, images_u8):
    from detjax_torch.data.pipeline import normalize_u8

    cfg = cs.spatial_config(PRESET)
    x = normalize_u8(images_u8.to("cuda:0"), cfg.data.mean, cfg.data.std,
                     torch.float32)
    return x.permute(0, 3, 1, 2)


def main() -> int:
    import torch.multiprocessing as mp

    import detjax_torch
    from detjax_torch.models.spatial import level_rows

    card = cs.print_card()
    tmp = tempfile.TemporaryDirectory(prefix="detjax_probe_")
    cfg = cs.spatial_config(PRESET)
    batch = cs.train_batch(cfg, seed=0)
    train = detjax_torch.make_train_state(cfg, seed=0)
    cs.desaturate_(train.model, batch["images"][:4], cfg)
    sd = {k: v.detach().to("cpu", copy=True)
          for k, v in train.model.state_dict().items()}
    del train
    torch.save({"sd": sd, "batch": batch}, Path(tmp.name) / "model.pt")
    mp.start_processes(rank, args=(cs.free_port(), tmp.name), nprocs=2,
                       start_method="spawn")
    pair = torch.load(Path(tmp.name) / "pair.pt", weights_only=False)
    tmp.cleanup()
    dev = torch.device("cuda:0")
    got_model = pair.pop("model")
    with cs.tf32_off(), torch.no_grad():
        model = model_of(sd)
        want = model(normalized(model, torch.as_tensor(batch["images"])))
        start = 0
        for lvl in range(3, 8):
            h = level_rows(1024, lvl)
            n = h * h * 9
            row = {"level": lvl, "rows": h}
            for name, w in zip(("cls", "box"), want):
                a = got_model[name][:, start:start + n].double()
                b = w[:, start:start + n].cpu().double()
                d = (a - b).abs().reshape(a.shape[0], h, h * 9, -1)
                per_row = d.amax(dim=(0, 2, 3))
                top = per_row.argsort(descending=True)[:3]
                row[f"{name}_max_rel"] = float(d.max() / b.abs().max())
                row[f"{name}_top_rows"] = [[int(i), float(per_row[i])]
                                           for i in top]
            cs.emit(row)
            start += n
    with cs.tf32_off():
        for (rows, sparse), got in pair.items():
            want = single(case(rows, sparse, dev))
            row = {"rows": rows, "sparse_dy": sparse}
            want["gather_dx"] = case(rows, sparse, dev)["dy"]
            for n in ("y", "dx", "dw", "gather_dx"):
                a, b = got[n].double(), want[n].cpu().double()
                row[f"{n}_max_rel"] = float((a - b).abs().max()
                                            / b.abs().max())
                row[f"{n}_norm_rel"] = float((a - b).norm() / b.norm())
            cs.emit(row)
    cs.emit({"card": card})
    print(json.dumps({"ok": True}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
