"""PyTorch port vs detjax: data parallelism (``detjax/parallel``), on the
CPU.

Two gloo ranks, spawned with ``torch.multiprocessing`` on a free localhost
port, run the port's data-parallel step, ``fit(mesh=)`` and the sharded
evaluation; the parent runs detjax's ``make_parallel_train_step`` and
``run_coco_eval(mesh=)`` on ``make_mesh(jax.devices()[:2])`` (conftest's
virtual CPU devices) while they work. The weights are detjax's, carried by
the port's ``from_jax``: R18 at 64 px, FPN and head width 32, fp32. jax and
detjax are imported in the parent only, inside the tests: the ranks import
this module.

The one-step bars are ``tests/test_torch_port_train.py``'s: the loss
within 1e-5 relative, a gradient within 2e-3 relative plus 1e-4 of its
tensor's largest element (XLA's and oneDNN's fp32 convolutions sum in other
orders). The steps take sgd at lr 0.1 with the clip off: after one step
its momentum holds the gradient, exactly, on both sides.
"""

import hashlib
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import detjax_torch
from detjax_torch.data import SyntheticDetectionDataset, make_train_iterator
from detjax_torch.data.transforms import pad_annotations
from detjax_torch.evaluation.evaluator import iter_detections
from detjax_torch.parallel import (
    Mesh,
    make_mesh,
    make_parallel_train_step,
    parallel_train_state,
    replicate,
    shard_batch,
)
from detjax_torch.parallel.mesh import check_mesh
from detjax_torch.train import step as tstep
from detjax_torch.train.checkpoint import Checkpointer

# One intra-op thread a process: pytest-xdist runs several workers on
# the host's cores, and torch's default of a thread a core in each
# worker oversubscribes them many times over.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
HW = (64, 64)
LR = 0.1
_SMALL = {"model.image_size": HW, "model.num_classes": 4,
          "model.dtype": "float32", "model.fpn_channels": 32,
          "model.head_channels": 32, "model.backbone_depth": 18,
          "data.hflip_prob": 0.0, "data.host_workers": 2,
          "train.batch_size": 4, "train.max_gt": 4,
          "train.optimizer": "sgd", "train.learning_rate": LR,
          "train.lr_schedule": "constant", "train.grad_clip_norm": 1e9,
          "eval.batch_size": 2}
# the data-parallel steps the ranks take, against detjax's (hflip: the
# port's single-process step; the flip streams differ between packages)
CASES = {"frozen": {},
         "bn": {"model.frozen_backbone_bn": False},
         "bn_accum": {"model.frozen_backbone_bn": False,
                      "train.grad_accum_steps": 2},
         "hflip": {"data.hflip_prob": 0.5}}
EVAL_DS = dict(num_images=5, image_size=(96, 96), num_classes=4,
               max_objects=2, seed=2)
FIT_OVR = {"model.frozen_backbone_bn": False, "data.random_crop": True,
           "train.optimizer": "adam", "train.learning_rate": 1e-3,
           "train.grad_clip_norm": 0.1, "train.checkpoint_every_steps": 2,
           "train.eval_every_steps": 2}
RANKS_TIMEOUT_S = 240


def _tcfg(**extra):
    return detjax_torch.get_config("retinanet_r50_640", **{**_SMALL, **extra})


def _batch(seed=0, b=4):
    """uint8 64-px scenes with 1-3 objects a quarter to 0.6 of the side."""
    ds = SyntheticDetectionDataset(b, HW, 4, max_objects=3, seed=seed,
                                   size_range=(0.25, 0.6))
    recs = [ds[i] for i in range(b)]
    pads = [pad_annotations(r["boxes"], r["labels"], 4) for r in recs]
    return {"images": np.stack([r["image"] for r in recs]),
            "gt_boxes": np.stack([p[0] for p in pads]),
            "gt_labels": np.stack([p[1] for p in pads])}


def _fit_ds(n=8, seed=0):
    return SyntheticDetectionDataset(num_images=n, image_size=HW,
                                     num_classes=4, max_objects=4, seed=seed,
                                     size_range=(0.25, 0.6))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _state(cfg, sd, seed=5):
    state = detjax_torch.make_train_state(cfg, seed=seed, device="cpu")
    state.model.load_state_dict(sd, strict=True)
    return state


def _step_record(state, metrics, grads=False):
    model = state.model
    out = {"metrics": {k: float(v) for k, v in metrics.items()},
           "params": {n: p.detach().clone()
                      for n, p in model.named_parameters()},
           "stats": {k: v.clone() for k, v in model.state_dict().items()
                     if "running" in k}}
    if grads:
        out["grads"] = {n: p.grad.clone()
                        for n, p in model.named_parameters()}
    return out


def _every_tensor(state):
    out = {f"model.{k}": v.clone()
           for k, v in state.model.state_dict().items()}
    for idx, st in state.optimizer.state_dict()["state"].items():
        for k, v in st.items():
            out[f"opt.{idx}.{k}"] = torch.as_tensor(v).clone()
    out["step"] = torch.tensor(state.step)
    return out


def _digest(t):
    """A tensor's dtype, shape and the hash of its bytes (a digest passes
    through): two ranks' tensors are bit-equal when their digests are,
    and the ranks' files stay small."""
    if not isinstance(t, torch.Tensor):
        return t
    data = np.ascontiguousarray(t.detach().cpu().numpy()).tobytes()
    return str(t.dtype), tuple(t.shape), hashlib.sha256(data).hexdigest()


def _digests(tensors: dict) -> dict:
    return {k: _digest(v) for k, v in tensors.items()}


# -- the ranks ---------------------------------------------------------------

def _rank_main(rank: int, port: int, root: str) -> None:
    """One gloo rank of two: the data-parallel steps of CASES on the
    global batch, parallel_train_state, fit with a periodic sharded
    evaluation, checkpoints and a resume, and run_coco_eval sharded; then
    the single-process references on the global batch (rank 0: the
    batch-statistics cases, rank 1: frozen and hflip). Writes
    ``rank<r>.pt``."""
    torch.set_num_threads(1)
    root = Path(root)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2)
    try:
        mesh = make_mesh(["cpu"])
        out = {"mesh": (mesh.rank, mesh.world_size, mesh.multi_process),
               "fit": _rank_fit(rank, root, mesh)}
        inputs = _wait_for_inputs(root / "inputs.pt")
        for name, ovr in CASES.items():
            cfg = _tcfg(**ovr)
            state = _state(cfg, inputs["train_sd"])
            state, m = make_parallel_train_step(cfg, mesh)(
                state, shard_batch(inputs["batch"], mesh,
                                   cfg.train.grad_accum_steps))
            rec = _step_record(state, m, grads=name == "frozen")
            if rank == 1:  # held only against rank 0's
                rec = {k: v if k == "metrics" else _digests(v)
                       for k, v in rec.items()}
            out[name] = rec

        # every rank starts from rank 0's state, whatever its own seed
        # and moments (the last case's state holds sgd's)
        other = detjax_torch.make_train_state(_tcfg(), seed=rank,
                                              device="cpu")
        for st in state.optimizer.state.values():
            st["mu"].add_(rank)
        state.step = 7 + rank
        parallel_train_state(state, mesh)
        parallel_train_state(other, mesh)
        [module] = replicate(detjax_torch.build_model(
            _tcfg(), seed=rank, device="cpu"), mesh)
        out["replicated"] = {"fresh": _digests(_every_tensor(other)),
                             "stepped": _digests(_every_tensor(state)),
                             "module": _digests(module.state_dict()),
                             "stepped_step": state.step}

        # the sharded evaluation, and the unsharded one on rank 0
        ecfg = _tcfg()
        model = detjax_torch.build_model(ecfg, seed=0, device="cpu")
        model.load_state_dict(inputs["eval_sd"], strict=True)
        ds = SyntheticDetectionDataset(**EVAL_DS)
        out["eval_sharded"] = detjax_torch.evaluate(model, ds, ecfg,
                                                    mesh=mesh).stats
        out["dets_sharded"] = list(iter_detections(model, ds, ecfg,
                                                   mesh=mesh))
        dist.barrier()
    finally:
        dist.destroy_process_group()
    if rank == 0:
        out["eval_plain"] = detjax_torch.evaluate(model, ds, ecfg).stats
        out["dets_plain"] = list(iter_detections(model, ds, ecfg))
    for name in (("bn", "bn_accum") if rank == 0 else ("frozen", "hflip")):
        cfg = _tcfg(**CASES[name])
        state, m = tstep.train_step(_state(cfg, inputs["train_sd"]),
                                    inputs["batch"])
        out[f"single_{name}"] = _step_record(state, m)
    torch.save(out, root / f"rank{rank}.pt")


def _rank_fit(rank: int, root: Path, mesh) -> dict:
    """fit(mesh=) straight to step 4, and to 2 then resumed to 4, each
    with a checkpoint and a sharded evaluation every 2 steps; the saves
    this rank made are counted."""
    cfg = _tcfg(**FIT_OVR)
    saves = []
    save = Checkpointer.save

    def counting_save(self, *a, **k):
        saves.append(self.directory)
        return save(self, *a, **k)

    def run_fit(steps, ck):
        return detjax_torch.fit(
            cfg, make_train_iterator(_fit_ds(), cfg), steps,
            eval_dataset=SyntheticDetectionDataset(**EVAL_DS),
            checkpoint_dir=str(root / ck), log_dir=str(root / f"log{rank}"),
            log_every=1, mesh=mesh)

    Checkpointer.save = counting_save
    try:
        straight = run_fit(4, "ck_straight")
        run_fit(2, "ck_resumed")
        resumed = run_fit(4, "ck_resumed")
    finally:
        Checkpointer.save = save
    return {"straight": _digests(_every_tensor(straight.state)),
            "resumed": _digests(_every_tensor(resumed.state)),
            "steps": (straight.state.step, resumed.state.step),
            "history": straight.history, "saves": len(saves)}


def _wait_for_inputs(path: Path, timeout_s: float = RANKS_TIMEOUT_S):
    """The parent's inputs (detjax's weights through from_jax, the batch),
    once it has published them."""
    deadline = time.monotonic() + timeout_s
    while not path.exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"no {path}")
        time.sleep(0.05)
    return torch.load(path, weights_only=False)


# -- the parent: detjax's side, while the ranks work -------------------------

def _np_tree(tree):
    import jax

    return jax.tree.map(np.asarray, jax.device_get(tree))


def _jax_setup():
    """detjax's seeded R18 variables for training, and the evaluation's
    (the class output perturbed so that a sparse set of scores clears
    the 0.05 floor, as ``tests/test_torch_port_eval.py`` carries them)."""
    import jax

    from detjax.config import get_config as j_get_config
    from detjax.modeling import build_model as j_build_model
    from detjax.utils.torch_import import (
        export_full_detector,
        import_detector_into_variables,
    )

    jcfg = j_get_config("retinanet_r50_640", **_SMALL)
    _, variables = j_build_model(jcfg, jax.random.PRNGKey(0))
    train = (_np_tree(variables["params"]), _np_tree(variables["batch_stats"]))
    rng = np.random.default_rng(1)
    sd = dict(export_full_detector(*train, depth=18))
    w, b = ("classificationModel.output.weight",
            "classificationModel.output.bias")
    sd[w] = (sd[w] + rng.normal(0, 0.08, sd[w].shape)).astype(np.float32)
    sd[b] = (sd[b] + rng.normal(0, 1.2, sd[b].shape)).astype(np.float32)
    r = "regressionModel.output.weight"
    sd[r] = (sd[r] * 3.0).astype(np.float32)
    evaluation = import_detector_into_variables(variables, sd, depth=18)
    return train, (_np_tree(evaluation["params"]),
                   _np_tree(evaluation["batch_stats"]))


def _jax_dp_steps(weights, batch):
    """detjax's pjit data-parallel step over two CPU devices, one step of
    each CASES config but hflip: (metrics, params, batch_stats)."""
    import jax
    import jax.numpy as jnp

    from detjax.config import get_config as j_get_config
    from detjax.parallel import make_mesh as j_make_mesh
    from detjax.parallel import make_parallel_train_step as j_dp_step
    from detjax.train import step as jstep

    mesh = j_make_mesh(jax.devices()[:2])
    out = {}
    for name in ("frozen", "bn", "bn_accum"):
        jcfg = j_get_config("retinanet_r50_640", **{**_SMALL, **CASES[name]})
        params = jax.tree.map(jnp.asarray, weights[0])
        tx = jstep.make_optimizer(jcfg)
        state = jstep.TrainState(
            step=jnp.zeros((), jnp.int32), params=params,
            batch_stats=jax.tree.map(jnp.asarray, weights[1]),
            opt_state=tx.init(params), tx=tx, cfg=jcfg)
        state, m = j_dp_step(jcfg, mesh)(state, batch)
        out[name] = ({k: float(v) for k, v in m.items()},
                     _np_tree(state.params), _np_tree(state.batch_stats),
                     _np_tree(_sgd_trace(state.opt_state)))
    return out


def _sgd_trace(opt_state):
    """optax sgd's momentum trace, which after a first step holds the
    gradient it was given, exactly (0.9 * 0 + g)."""
    if type(opt_state).__name__ == "TraceState":
        return opt_state.trace
    for s in (opt_state if isinstance(opt_state, (tuple, list))
              else getattr(opt_state, "inner_state", ())):
        found = _sgd_trace(s)
        if found is not None:
            return found
    return None


def _jax_sharded_eval(weights):
    import jax

    from detjax.config import get_config as j_get_config
    from detjax.data import SyntheticDetectionDataset as JSynthetic
    from detjax.evaluation import evaluator as j_evaluator
    from detjax.parallel import make_mesh as j_make_mesh

    jcfg = j_get_config("retinanet_r50_640", **_SMALL)
    variables = {"params": weights[0], "batch_stats": weights[1]}
    return j_evaluator.run_coco_eval(
        variables, JSynthetic(**EVAL_DS), jcfg,
        mesh=j_make_mesh(jax.devices()[:2])).stats


def _cli_args(tmp: Path, *extra):
    args = ["--synthetic", "--device", "cpu", "--steps", "2", "--depth", "18",
            "--ckpt-dir", str(tmp / "ck"), "--log-dir", str(tmp / "log"),
            *extra]
    for k, v in {"model.image_size": "(64,64)", "model.fpn_channels": "32",
                 "model.head_channels": "32", "model.dtype": "float32",
                 "train.batch_size": "4", "data.host_workers": "2"}.items():
        args += ["--set", f"{k}={v}"]
    return args


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """Start the two ranks and a two-process ``torch.distributed.run`` of
    the train CLI, compute detjax's side meanwhile (its weights first,
    which the ranks wait for after their fit), then collect both."""
    from detjax_torch.utils.weights import from_jax

    root = tmp_path_factory.mktemp("parallel")
    ranks = mp.start_processes(_rank_main, args=(_free_port(), str(root)),
                               nprocs=2, join=False, start_method="spawn")
    cli_tmp = root / "cli"
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    cli = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
         "2", "--master_addr", "127.0.0.1", "--master_port",
         str(_free_port()), "-m", "detjax_torch.cli.train", "--dp",
         *_cli_args(cli_tmp)],
        cwd=str(REPO), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        train_w, eval_w = _jax_setup()
        model_cfg = _tcfg().model
        batch = _batch()
        torch.save({"train_sd": from_jax(*train_w, model_cfg),
                    "eval_sd": from_jax(*eval_w, model_cfg), "batch": batch},
                   root / "inputs.tmp")
        os.replace(root / "inputs.tmp", root / "inputs.pt")  # published
        jax_steps = _jax_dp_steps(train_w, batch)
        jax_eval = _jax_sharded_eval(eval_w)
        deadline = time.monotonic() + RANKS_TIMEOUT_S
        while not ranks.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                raise TimeoutError("the ranks did not finish")
        cli_out, _ = cli.communicate(timeout=RANKS_TIMEOUT_S)
    finally:
        for p in ranks.processes:
            if p.is_alive():
                p.terminate()
        if cli.poll() is None:
            cli.kill()
    return {"ranks": [torch.load(root / f"rank{r}.pt", weights_only=False)
                      for r in range(2)],
            "jax": jax_steps, "jax_eval": jax_eval, "train_w": train_w,
            "model_cfg": model_cfg, "root": root,
            "cli": (cli.returncode, cli_out, cli_tmp)}


# -- the bars ----------------------------------------------------------------

def _assert_grad_close(name, got, want):
    np.testing.assert_allclose(got, want, rtol=2e-3,
                               atol=1e-4 * np.abs(want).max() + 1e-12,
                               err_msg=name)


def _assert_step_close(got, want_params, start):
    """Every parameter's change, port vs the reference, within the
    one-step gradient bar (times the rate: sgd's first step is -lr * g),
    plus 2 ulp of the starting value (a change is the difference of two
    fp32 parameters)."""
    for name, p in got["params"].items():
        s = start[name].numpy()
        d_got = p.numpy() - s
        d_want = want_params[name].numpy() - s
        np.testing.assert_allclose(
            d_got, d_want, rtol=2e-3,
            atol=1e-4 * np.abs(d_want).max() + 2 * np.spacing(np.abs(s)).max(),
            err_msg=name)


def _assert_stats_close(got, want, rtol=1e-4):
    """Running statistics within ``rtol`` plus 1e-5: each is a mean over
    the batch of a conv output that the two sides sum in other orders."""
    assert len(got) == 40
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=rtol,
                                   atol=1e-5, err_msg=k)


def _assert_ranks_equal(a, b):
    """Every tensor bit-equal (tensors or their digests)."""
    assert a.keys() == b.keys()
    for k in a:
        assert _digest(a[k]) == _digest(b[k]), k


def _start(work):
    from detjax_torch.utils.weights import from_jax

    return from_jax(*work["train_w"], work["model_cfg"])


def _jax_sd(work, name, what="params"):
    """detjax's parameters (or gradients: ``what="grads"``) after the DP
    step, in the port's names."""
    from detjax_torch.utils.weights import from_jax

    _, params, stats, grads = work["jax"][name]
    return from_jax(grads if what == "grads" else params, stats,
                    work["model_cfg"])


# -- the data-parallel step ----------------------------------------------------

def test_frozen_step_matches_detjax_dp_step(work):
    """Frozen BN, global batch 4 over two ranks: the loss within 1e-5 of
    detjax's DP step, every averaged gradient and parameter within the
    one-step bar, and the two ranks' parameters bit-equal."""
    r0, r1 = (r["frozen"] for r in work["ranks"])
    metrics = work["jax"]["frozen"][0]
    want = _jax_sd(work, "frozen")
    start = _start(work)
    np.testing.assert_allclose(r0["metrics"]["loss"], metrics["loss"],
                               rtol=1e-5)
    assert r0["metrics"] == r1["metrics"]
    assert r0["metrics"]["num_pos"] == metrics["num_pos"] > 0
    want_grads = _jax_sd(work, "frozen", "grads")
    for name, g in r0["grads"].items():
        _assert_grad_close(name, g.numpy(), want_grads[name].numpy())
    _assert_step_close(r0, want, start)
    _assert_ranks_equal(r0["params"], r1["params"])
    _assert_ranks_equal(r0["grads"], r1["grads"])


@pytest.mark.parametrize("name", ["bn", "bn_accum"])
def test_batch_statistics_step_matches_detjax_and_single_process(work, name):
    """Batch-statistics BN, without and with grad_accum_steps=2: the
    statistics are the global (micro-)batch's, summed over the group. The
    running statistics and the parameters against detjax's DP step and
    against the port's single-process step on the global batch; the ranks
    bit-equal."""
    r0, r1 = (r[name] for r in work["ranks"])
    single = work["ranks"][0][f"single_{name}"]
    metrics = work["jax"][name][0]
    want = _jax_sd(work, name)
    start = _start(work)
    np.testing.assert_allclose(r0["metrics"]["loss"], metrics["loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(r0["metrics"]["loss"],
                               single["metrics"]["loss"], rtol=1e-5)
    _assert_stats_close(r0["stats"], want)
    _assert_stats_close(r0["stats"], single["stats"])
    _assert_step_close(r0, want, start)
    _assert_step_close(r0, single["params"], start)
    _assert_ranks_equal(r0["params"], r1["params"])
    _assert_ranks_equal(r0["stats"], r1["stats"])


def test_flip_mask_is_the_global_batch_rows(work):
    """hflip_prob 0.5: the two-rank step flips the images the
    single-process step on the global batch flips (both flip branches
    run), so the loss and every parameter's change agree."""
    from detjax_torch.train.step import flip_mask

    cfg = _tcfg(**CASES["hflip"])
    mask = flip_mask(cfg, 0, 4)
    assert mask.any() and not mask.all()
    r0, r1 = (r["hflip"] for r in work["ranks"])
    single = work["ranks"][1]["single_hflip"]
    np.testing.assert_allclose(r0["metrics"]["loss"],
                               single["metrics"]["loss"], rtol=1e-5)
    assert r0["metrics"]["loss"] != work["ranks"][1]["single_frozen"][
        "metrics"]["loss"]  # the flips moved it
    _assert_step_close(r0, single["params"], _start(work))
    _assert_ranks_equal(r0["params"], r1["params"])


def test_every_rank_starts_from_rank_0s_state(work):
    """parallel_train_state makes rank 1's state rank 0's: parameters,
    buffers, optimizer moments and counts, and the step, also from
    another seed; replicate does so for a module."""
    a, b = (r["replicated"] for r in work["ranks"])
    for kind in ("fresh", "stepped", "module"):
        _assert_ranks_equal(a[kind], b[kind])
    assert b["stepped_step"] == 7
    assert [r["mesh"] for r in work["ranks"]] == [(0, 2, True), (1, 2, True)]


# -- fit ---------------------------------------------------------------------

def test_fit_on_two_ranks_resumes_bit_exactly(work):
    """fit(mesh=) with batch statistics, Adam, random crop, a checkpoint
    every 2 steps and a sharded evaluation every 2: the run resumed from
    step 2 equals the straight run bit for bit on both ranks, the ranks
    equal each other, only rank 0 saved and logged, and both ranks
    recorded the same evaluations."""
    f0, f1 = (r["fit"] for r in work["ranks"])
    for f in (f0, f1):
        _assert_ranks_equal(f["straight"], f["resumed"])
        assert f["steps"] == (4, 4)
    _assert_ranks_equal(f0["straight"], f1["straight"])
    assert (f0["saves"], f1["saves"]) == (4, 0)  # 2, 4; 2; then 4
    root = work["root"]
    for ck in ("ck_straight", "ck_resumed"):
        assert sorted(os.listdir(root / ck)) == ["2", "4"]
    assert (root / "log0" / "metrics.jsonl").exists()
    assert not (root / "log1").exists()
    evals = [[h for h in f["history"] if "eval" in h] for f in (f0, f1)]
    assert [h["step"] for h in evals[0]] == [2, 4]
    assert evals[0] == evals[1] and len(evals[0][0]["eval"]) == 12
    losses = [[h["loss"] for h in f["history"] if "loss" in h]
              for f in (f0, f1)]
    assert losses[0] == losses[1] and len(losses[0]) == 4


def _fit_small(mesh, steps=3):
    cfg = _tcfg(**{**FIT_OVR, "train.checkpoint_every_steps": 10 ** 9,
                   "train.eval_every_steps": 10 ** 9})
    res = detjax_torch.fit(cfg, make_train_iterator(_fit_ds(), cfg), steps,
                           device=None if mesh else "cpu", mesh=mesh)
    return _every_tensor(res.state), res.history


@pytest.fixture(scope="module")
def plain_fit():
    return _fit_small(None)


@pytest.mark.parametrize("form", ["single_process", "gloo_world_1"])
def test_world_1_mesh_is_bit_equal_to_no_mesh(form, plain_fit):
    """fit for 3 steps on a world-1 mesh equals fit without one in every
    tensor: a one-device single-process mesh, and rank 0 of a gloo group of
    one (whose gradient all-reduce and division by 1 run and change no
    bit)."""
    want, want_hist = plain_fit
    if form == "single_process":
        got, hist = _fit_small(make_mesh(["cpu"]))
    else:
        dist.init_process_group("gloo", rank=0, world_size=1,
                                init_method=f"tcp://127.0.0.1:{_free_port()}")
        try:
            mesh = make_mesh(["cpu"])
            assert mesh.multi_process and mesh.world_size == 1
            got, hist = _fit_small(mesh)
        finally:
            dist.destroy_process_group()
    _assert_ranks_equal(got, want)

    def no_clock(history):
        return [{k: v for k, v in h.items() if k != "images_per_sec"}
                for h in history]

    assert no_clock(hist) == no_clock(want_hist)


def test_fit_rejects_another_object_as_mesh():
    with pytest.raises(TypeError, match="Mesh"):
        detjax_torch.fit(_tcfg(), [], 1, mesh=object())
    with pytest.raises(ValueError, match="one device a process"):
        detjax_torch.fit(_tcfg(), [], 1, mesh=make_mesh(["cpu", "cpu"]))


# -- evaluation ----------------------------------------------------------------

def _hold_e2e(got, want):
    """The e2e bars of ``tests/test_torch_port_eval.py``: 0.002 a stat,
    0.05 for AR1 (it moves by whole 1/num_gt quanta)."""
    for k in want:
        assert abs(got[k] - want[k]) <= (0.05 if k == "AR1" else 0.002), k


def _assert_same_detections(got, want):
    """Per image: the same kept labels, scores within 1e-6, boxes within
    1e-4 (a batch of one on each rank against a batch of two), and
    detections to score."""
    assert [g[0] for g in got] == [w[0] for w in want]
    for (_, gb, gs, gl), (_, wb, ws, wl) in zip(got, want):
        np.testing.assert_array_equal(gl, wl)
        np.testing.assert_allclose(gs, ws, rtol=0, atol=1e-6)
        np.testing.assert_allclose(gb, wb, rtol=0, atol=1e-4)
    assert sum(len(w[3]) for w in want) > 10


def test_sharded_eval_on_two_ranks(work):
    """run_coco_eval over the 2-rank mesh: the 12 stats equal the
    unsharded run's within 1e-6 on both ranks (detjax's bar) and lie within
    the e2e bars of detjax's run_coco_eval(mesh=...)."""
    plain = work["ranks"][0]["eval_plain"]
    for r in work["ranks"]:
        _assert_same_detections(r["dets_sharded"],
                                work["ranks"][0]["dets_plain"])
        for k in plain:
            assert abs(r["eval_sharded"][k] - plain[k]) < 1e-6, k
    _hold_e2e(work["ranks"][0]["eval_sharded"], work["jax_eval"])


def _eval_model(work):
    """The port's R18 on the evaluation weights (``_jax_setup``)."""
    cfg = _tcfg()
    inputs = torch.load(work["root"] / "inputs.pt", weights_only=False)
    model = detjax_torch.build_model(cfg, seed=0, device="cpu")
    model.load_state_dict(inputs["eval_sd"], strict=True)
    return cfg, model


def test_sharded_eval_over_two_local_devices(work):
    """A single-process mesh over [cpu, cpu] splits each eval batch over
    two replicas: the detections as the unsharded run's, the 12 stats
    equal to its within 1e-6 and to detjax's sharded run's within the e2e
    bars."""
    cfg, model = _eval_model(work)
    ds = SyntheticDetectionDataset(**EVAL_DS)
    mesh = make_mesh(["cpu", "cpu"])
    assert mesh.size == 2 and not mesh.multi_process
    _assert_same_detections(list(iter_detections(model, ds, cfg, mesh=mesh)),
                            work["ranks"][0]["dets_plain"])
    got = detjax_torch.evaluate(model, ds, cfg, mesh=mesh).stats
    plain = work["ranks"][0]["eval_plain"]
    for k in plain:
        assert abs(got[k] - plain[k]) < 1e-6, k
    _hold_e2e(got, work["jax_eval"])
    with pytest.raises(ValueError, match="divisible"):
        detjax_torch.evaluate(model, ds, _tcfg(**{"eval.batch_size": 3}),
                              mesh=mesh)


# -- serving ---------------------------------------------------------------------

def test_server_over_two_local_devices(work):
    """DetectionServer(mesh=[cpu, cpu]) answers as mesh=None does; a
    program engine, an indivisible batch and a multi-process mesh
    raise."""
    from detjax_torch.serve import DetectionServer

    cfg, model = _eval_model(work)
    mesh = make_mesh(["cpu", "cpu"])
    canvases = _batch(seed=4)["images"]
    plain = DetectionServer(model, cfg, batch_size=4, score_threshold=0.0)
    split = DetectionServer(model, cfg, batch_size=4, score_threshold=0.0,
                            mesh=mesh)
    try:
        want = plain._runs[0](canvases)
        got = split._runs[0](canvases)
        assert sum(w[3] for w in want) > 10
        for (gb, gs, gl, gn), (wb, ws, wl, wn) in zip(got, want):
            assert gn == wn
            np.testing.assert_array_equal(gl, wl)
            np.testing.assert_allclose(gs, ws, rtol=0, atol=1e-6)
            np.testing.assert_allclose(gb, wb, rtol=0, atol=1e-4)
    finally:
        plain.shutdown()
        split.shutdown()
    with pytest.raises(ValueError, match="program"):
        DetectionServer(model, cfg, engine="some_program.pt2", mesh=mesh)
    with pytest.raises(ValueError, match="divisible"):
        DetectionServer(model, cfg, batch_size=3, mesh=mesh)
    with pytest.raises(ValueError, match="multi-process"):
        DetectionServer(model, cfg, batch_size=4, mesh=Mesh(
            (torch.device("cpu"),), group=object(), world_size=2))


# -- the mesh ----------------------------------------------------------------------

def test_make_mesh_forms_and_refusals(monkeypatch):
    for v in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        monkeypatch.delenv(v, raising=False)
    mesh = make_mesh(["cpu", "cpu", "cpu"])
    assert (mesh.size, mesh.world_size, mesh.group) == (3, 1, None)
    assert mesh.axis_names == ("data",)
    assert (mesh.space, mesh.data_size, mesh.space_context()) == (1, 3, None)
    with pytest.raises(ValueError, match="does not divide"):
        make_mesh(["cpu", "cpu"], spatial=3)
    # a space axis is multi-process (tests/test_torch_port_spatial.py);
    # over one process's devices it is the serving slice, Queue 1 #8
    with pytest.raises(NotImplementedError, match="Queue 1 #8"):
        make_mesh(["cpu", "cpu"], spatial=2)
    rank_1 = Mesh((torch.device("cpu"),), group=object(), rank=1,
                  world_size=2, space=2,
                  space_group=object())
    assert check_mesh(rank_1) is rank_1
    assert (rank_1.data_size, rank_1.data_rank, rank_1.space_rank) == (1, 0, 1)
    assert rank_1.space_context().index == 1
    assert rank_1.image_rows(64) == slice(32, 64)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_mesh()


def test_rank_device_past_the_visible_cards_raises(monkeypatch):
    """A rank whose LOCAL_RANK names a card the host does not have is
    refused by name, rather than sharing another rank's card."""
    from detjax_torch.parallel import mesh as pmesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert pmesh._rank_device(None, 5) == torch.device("cuda", 1)
    monkeypatch.setenv("LOCAL_RANK", "3")
    with pytest.raises(ValueError, match="LOCAL_RANK=3 .* 2 CUDA device"):
        pmesh._rank_device(None, 3)


def test_shard_batch_follows_detjax_micro_batches():
    """Rank r's rows of a global batch are, for each micro-batch i, the
    r-th part of global rows [i*B/A, (i+1)*B/A), in micro-batch order."""
    m = [Mesh((torch.device("cpu"),), group=object(), rank=r, world_size=2)
         for r in range(2)]
    assert m[0].local_rows(8, 2).tolist() == [0, 1, 4, 5]
    assert m[1].local_rows(8, 2).tolist() == [2, 3, 6, 7]
    assert m[1].local_rows(8).tolist() == [4, 5, 6, 7]
    with pytest.raises(ValueError, match="does not split"):
        m[0].local_rows(6, 2)
    batch = {"images": np.arange(8)[:, None] * np.ones((8, 3), np.int64)}
    local = shard_batch(batch, m[1], accum_steps=2)
    assert local["images"][:, 0].tolist() == [2, 3, 6, 7]
    on_device = shard_batch({"images": torch.as_tensor(batch["images"])},
                            m[0], accum_steps=2)
    assert on_device["images"][:, 0].tolist() == [0, 1, 4, 5]


# -- the CLI -----------------------------------------------------------------------

def test_cli_train_under_torch_distributed_run(work):
    """``python -m torch.distributed.run --nproc_per_node 2 -m
    detjax_torch.cli.train --dp --device cpu --synthetic --steps 2``: the
    state reaches step 2, one checkpoint and one metrics file (rank 0's),
    and only rank 0 printed its summary."""
    rc, out, tmp = work["cli"]
    assert rc == 0, out
    assert os.listdir(tmp / "ck") == ["2"]
    assert os.listdir(tmp / "log") == ["metrics.jsonl"]
    rows = [json.loads(line) for line in
            (tmp / "log" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows if r["kind"] == "train"][-1] == 2
    assert out.count("done: step=2") == 1
    assert "data-parallel mesh: 2 process(es)" in out


def test_cli_spatial_names_its_slice(tmp_path):
    """``--spatial K`` builds a (data, space=K) mesh (implying --dp); K
    must divide the world, as in detjax: one process without torchrun
    refuses K = 2. The two-rank run is
    ``tests/test_torch_port_spatial.py``'s."""
    from detjax_torch.cli import train as cli_train

    assert "(data, space=K) mesh" in cli_train.build_parser().format_help()
    with pytest.raises(ValueError, match="spatial=2 does not divide 1"):
        cli_train.main(_cli_args(tmp_path, "--spatial", "2"))
