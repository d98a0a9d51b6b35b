"""A closed loop of ``detjax_torch.train_step`` over a seeded pool of
batches.

Set-up makes the weights and the pool, builds one training state, loads
the weights into it, and drives it through the checked steps on the
pool's first batches (rows that all differ) and a few warm-up steps; the
same object then trains through the window, cycling the pool. After the
window the program's state is freed and the reference follows the checked
steps from the same weights, batches and flips.

``train_img_s``: images of every step enqueued in the window over the
window, which a synchronise closes. With ``--trace 1`` the window is
``trace_steps`` steps under the device trace, each split into forward,
loss, backward and update by CUDA events through ``train_step(record=)``.
"""

from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch

from benchmark import counts, harness, weights
from benchmark.reference import detection as D
from benchmark.reference import model as R
from benchmark.reference import train as T
from benchmark.traffic import scenes

PHASES = ("forward", "loss", "backward", "update")


def make_pool(r: harness.Run, model_cfg: dict, batch: int):
    """The pool's u8 canvases [P, B, H, W, 3], GT boxes [P, B, G, 4] and
    labels [P, B, G], on the device."""
    tr = r.traffic
    hw = model_cfg["image_size"]
    n = tr["pool_batches"] * batch
    gen = torch.Generator(device=r.device).manual_seed(int(r.seed) + 1)
    rng = np.random.default_rng(int(r.seed))
    images = scenes.canvases(n, hw, [hw], gen, r.device)
    cnt = scenes.gt_counts(n, tr["gt_mean"], tr["gt_sigma"], tr["max_gt"],
                           rng)
    boxes, labels = scenes.gt_boxes(
        cnt, hw, tr["max_gt"], model_cfg["num_classes"], tr["size_shares"],
        tr["size_edges_px"], tr["aspect_log2_max"], rng)
    shape = (tr["pool_batches"], batch)
    return (images.view(*shape, *images.shape[1:]),
            torch.from_numpy(boxes).to(r.device).view(*shape, -1, 4),
            torch.from_numpy(labels).to(r.device).view(*shape, -1))


def _moments(opt, p):
    """The first moment the optimizer keeps for ``p`` after its first
    step (zeros where it keeps none)."""
    st = opt.state.get(p, {})
    for key in ("mu", "exp_avg"):
        if key in st:
            return st[key]
    return torch.zeros_like(p)


def run(r: harness.Run) -> dict:
    import detjax_torch

    conf, tr = r.config, r.traffic
    mc, tc = conf["model"], conf["train"]
    batch = tr["batch"]
    train_seed = int(r.seed) % 2 ** 31
    cfg = harness.program_config(conf, **{"train.seed": train_seed,
                                          "train.batch_size": batch})
    images, gt_boxes, gt_labels = make_pool(r, mc, batch)
    pool = [{"images": images[i], "gt_boxes": gt_boxes[i],
             "gt_labels": gt_labels[i]} for i in range(images.shape[0])]
    ref = R.build(mc, r.device)
    w0 = weights.make(ref, r.seed, images[0, :tr["desaturate_images"]])
    state = detjax_torch.make_train_state(cfg, seed=0, device=r.device)
    state.model.load_state_dict(w0)
    if r.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(r.device)

    # the checked steps: the window's own call on its own feed
    checked = tr["checked_steps"]
    named = list(state.model.named_parameters())
    losses, grad1 = [], None
    for s in range(checked):
        _, m = detjax_torch.train_step(state, pool[s])
        losses.append(float(m["loss"]))
        if s == 0:
            with torch.no_grad():
                grad1 = T.leaf_norms({n: _moments(state.optimizer, p)
                                      / (1 - T.ADAM_B1) for n, p in named})
    with torch.no_grad():
        change = T.leaf_norms({n: p.detach() - w0[n] for n, p in named})
    got = {"losses": losses, "grad": grad1, "change": change}
    for s in range(tr["warmup_steps"]):
        detjax_torch.train_step(state, pool[(checked + s) % len(pool)])
    harness.synchronize(r.device)
    step = checked + tr["warmup_steps"]

    if r.trace:
        tracer = harness.DeviceTrace(r.device)
        marks = []

        def note(name):
            if r.device.type == "cuda":
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                marks[-1].append((name, ev))
            else:
                marks[-1].append((name, time.perf_counter()))
        t_setup = time.perf_counter() - r.t_start
        tracer.start()
        traced = []
        for _ in range(tr["trace_steps"]):
            marks.append([])
            note("start")
            traced.append(step % len(pool))
            detjax_torch.train_step(state, pool[traced[-1]], record=note)
            step += 1
        tracer.stop()
        n_steps, window = len(traced), tracer.window_s
    else:
        t0 = time.perf_counter()
        t_setup = t0 - r.t_start
        n_steps, ends = 0, []
        while time.perf_counter() - t0 < r.seconds:
            detjax_torch.train_step(state, pool[step % len(pool)])
            if r.device.type == "cuda":
                ends.append(torch.cuda.Event(enable_timing=True))
                ends[-1].record()
            step += 1
            n_steps += 1
        harness.synchronize(r.device)
        window = time.perf_counter() - t0
        steps_ms = [a.elapsed_time(b) for a, b in zip(ends, ends[1:])]
        if len(steps_ms) >= 8:
            q = len(steps_ms) // 4
            print(f"step ms: first quarter {np.median(steps_ms[:q]):.3f}, "
                  f"last quarter {np.median(steps_ms[-q:]):.3f}, min "
                  f"{min(steps_ms):.3f}, max {max(steps_ms):.3f}; after the "
                  f"window: {harness.card_line()}", file=sys.stderr)
    peak = (torch.cuda.max_memory_allocated(r.device)
            if r.device.type == "cuda" else 0)
    del state, named, m
    gc.collect()
    if r.device.type == "cuda":
        torch.cuda.empty_cache()

    anc = D.anchors(mc["image_size"], range(mc["min_level"],
                                            mc["max_level"] + 1),
                    mc["anchor_scales"], mc["anchor_ratios"],
                    mc["anchor_base_scale"], r.device)
    flips = [D.flip_mask(train_seed, s, batch, conf["data"]["hflip_prob"])
             for s in range(checked)]
    batches = [(images[s], gt_boxes[s], gt_labels[s]) for s in range(checked)]
    with R.tf32_off():
        want = T.run_steps(ref, batches, flips, anc, tc, mc["box_std"])
    numbers = T.compare(got, want)
    ok, shown = harness.checks(numbers, conf["limits"]["train"])

    out = {"correct": ok, "attempted": n_steps * batch, "failed": 0,
           "device": harness.device_info(r.device, peak), "checks": shown}
    if not r.trace:
        out["metrics"] = harness.e2e(r.cell["name"], {
            "train_img_s": n_steps * batch / window, "setup_s": t_setup})
        return out
    spans = {p: [] for p in PHASES}
    for mk in marks:
        for (_, a), (name, b) in zip(mk, mk[1:]):
            spans[name].append(a.elapsed_time(b) if r.device.type == "cuda"
                               else (b - a) * 1e3)
    pairs = []
    for s_idx, p_idx in zip(range(step - n_steps, step), traced):
        f = D.flip_mask(train_seed, s_idx, batch, conf["data"]["hflip_prob"])
        _, boxes = D.flip(torch.zeros(batch, 1, 1, mc["image_size"][1],
                                      device=r.device),
                          gt_boxes[p_idx].float(), f)
        pairs.append(counts.match_listed_pairs(anc, boxes,
                                               gt_labels[p_idx] >= 0))
    record = {"trace": tracer, "batch": batch, "images": n_steps * batch,
              "spans": spans, "model": mc,
              "flops_forward": counts.forward_flops(mc),
              "anchors": anc.shape[0], "max_gt": tr["max_gt"],
              "match_pairs": pairs, "window_s": window}
    out["metrics"] = harness.read_metrics(r.cell["name"], record)
    out["device"].update(busy_s=tracer.busy_s(), window_s=window)
    if tracer.window is not None:
        out["breakdown"] = tracer.breakdown()
    return out
