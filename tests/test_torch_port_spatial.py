"""PyTorch port vs detjax: spatial partitioning (``detjax/models/spatial.py``
and detjax's ``(data, space)`` mesh), on the CPU.

Gloo ranks, spawned with ``torch.multiprocessing`` on free localhost
ports, run the port's spatial steps and evaluation: two ranks on a ``(1,
2)`` mesh and four on a ``(2, 2)`` mesh. A two-process
``torch.distributed.run`` of the train CLI with ``--spatial 2`` runs
beside them. The parent meanwhile runs detjax's single-device steps and
its spatial step on ``make_mesh(jax.devices()[:2], spatial=2)`` (conftest's
virtual CPU devices), at detjax's ``tests/test_parallel.py`` spatial
configuration: R18, 128 px, 8 classes, FPN and head width 32, fp32, batch
4 (a degenerate pyramid: P6 is 2 rows, P7 1), and at 512 px with 2 images
(P7 is 4 rows, 2 a rank: nothing degenerate, the heads row-sharded). The
weights are detjax's, carried by the port's ``from_jax``. jax and detjax
are imported in the parent only, inside the tests: the ranks import this
module.

The one-step bars are ``tests/test_torch_port_parallel.py``'s: sgd at lr
0.1 with the clip off (after one step its momentum holds the gradient,
exactly, on both sides), the loss within 1e-5 relative, each gradient
within 2e-3 relative plus 1e-4 of its tensor's largest element. At 128 px
with frozen BN the spatial step meets them against detjax's steps. At 512
px and with batch statistics no fp32 step does: against the port's step
in fp64 (``smoke_prior/spatial_fp64_witness.py``), detjax's own fp32
gradients miss by up to 4.8x (512 px, ``layer1.0.conv1.weight``) and 183x
(batch statistics, ``layer2.0.conv2.weight``) that bar, the port's fp32
ones by 5.0x and 113x; in 2-norm detjax's miss by at most 1.5e-4 and
4.7e-3 of the tensor's norm, the port's by 4.1e-4 and 2.3e-3. Sums whose
terms cancel (normalising over few values; small biases) amplify fp32
rounding in any order. There the spatial step is held two ways: every
gradient at the elementwise bar to the port's single-process step on the
same global batch (a layout changes no more than summation order), and
every gradient's 2-norm gap to detjax's step within ``NORM_BARS`` of
detjax's norm, about 4-5x the larger of the two fp32 steps' gaps to the
fp64 one. A wrong divisor or a missing sum over the space group reads
0.5.
"""

import hashlib
import os
import socket
import subprocess
import sys
import threading
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import detjax_torch
from detjax_torch.evaluation.evaluator import iter_detections
from detjax_torch.models import spatial
from detjax_torch.parallel import (
    Mesh,
    make_mesh,
    make_parallel_train_step,
    shard_batch,
)
from detjax_torch.train import step as tstep

# One intra-op thread a process: pytest-xdist runs several workers on
# the host's cores, and torch's default of a thread a core in each
# worker oversubscribes them many times over.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
LR = 0.1
_STEP = {"model.num_classes": 8, "model.backbone_depth": 18,
         "model.fpn_channels": 32, "model.head_channels": 32,
         "model.dtype": "float32", "train.max_gt": 4,
         "train.optimizer": "sgd", "train.learning_rate": LR,
         "train.lr_schedule": "constant", "train.grad_clip_norm": 1e9,
         "data.hflip_prob": 0.0}
# name -> (canvas, global batch, extra overrides)
STEPS = {"frozen_128": (128, 4, {}),
         "frozen_512": (512, 2, {}),
         "bn_128": (128, 4, {"model.frozen_backbone_bn": False})}
# "on" through the fused block's CPU twin, and "off" as the yardstick of
# bf16 noise: R50 at 128 px, batch 2
FUSED = {"model.image_size": (128, 128), "model.num_classes": 6,
         "model.dtype": "bfloat16", "model.fpn_channels": 32,
         "model.head_channels": 32, "model.backbone_depth": 50,
         "train.batch_size": 2, "train.max_gt": 4, "data.hflip_prob": 0.0}
# detjax's sharded-evaluation configuration (tests/test_parallel.py:263-292)
EVAL = {"model.image_size": (64, 64), "model.num_classes": 8,
        "model.dtype": "float32", "model.backbone_depth": 18,
        "train.max_gt": 4, "eval.batch_size": 8, "eval.pre_nms_top_k": 50,
        "eval.max_detections": 10, "eval.score_threshold": 0.0}
EVAL_DS = dict(num_images=8, image_size=(64, 64), num_classes=8, seed=5)
# the tensors each rank of the (2, 2) mesh keeps before the average
KEPT = ("conv1.weight", "layer1.0.conv1.weight", "layer4.1.conv2.weight",
        "fpn.P3_2.weight", "fpn.P7_2.weight",
        "classificationModel.output.weight", "regressionModel.output.bias")
RANKS_TIMEOUT_S = 240
# each gradient's 2-norm gap to detjax's, over detjax's 2-norm, where the
# elementwise bar is beyond fp32 (module docstring)
NORM_BARS = {"frozen_512": 2e-3, "bn_128": 2e-2}


def _cfg(name):
    hw, bs, extra = STEPS[name]
    return detjax_torch.get_config("coco_v5e8", **{
        **_STEP, "model.image_size": (hw, hw), "train.batch_size": bs,
        **extra})


def _batch(hw, bs):
    """detjax's spatial batch (``tests/test_parallel.py:186-194``)."""
    rng = np.random.default_rng(0)
    boxes = np.asarray([[[8, 8, 40, 40], [30, 30, 100, 100], [0, 0, 0, 0],
                         [0, 0, 0, 0]]], np.float32)
    return {"images": rng.normal(0, 1, (bs, hw, hw, 3)).astype(np.float32),
            "gt_boxes": np.tile(boxes, (bs, 1, 1)),
            "gt_labels": np.tile(np.asarray([[2, 5, -1, -1]], np.int32),
                                 (bs, 1))}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _digest(t):
    data = np.ascontiguousarray(t.detach().cpu().numpy()).tobytes()
    return str(t.dtype), tuple(t.shape), hashlib.sha256(data).hexdigest()


def _record(state, metrics, keep_all: bool):
    """A step's metrics and gradients (digests only where the rank is held
    just against rank 0)."""
    grads = {n: p.grad.clone() for n, p in state.model.named_parameters()}
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": grads if keep_all else {k: _digest(v)
                                              for k, v in grads.items()}}


def _wait_for(path: Path, timeout_s: float = RANKS_TIMEOUT_S):
    deadline = time.monotonic() + timeout_s
    while not path.exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"no {path}")
        time.sleep(0.05)
    return torch.load(path, weights_only=False)


def _fused_state(fused_backbone):
    cfg = detjax_torch.get_config("retinanet_r50_640", **{
        **FUSED, "model.fused_backbone": fused_backbone})
    state = detjax_torch.make_train_state(cfg, seed=4, device="cpu")
    state.model.bottleneck_backend = "torch"
    return cfg, state


def _fused_batch():
    from detjax_torch.data import SyntheticDetectionDataset
    from detjax_torch.data.transforms import pad_annotations

    ds = SyntheticDetectionDataset(2, (128, 128), 6, max_objects=4, seed=1,
                                   size_range=(0.2, 0.6))
    recs = [ds[i] for i in range(2)]
    pads = [pad_annotations(r["boxes"], r["labels"], 4) for r in recs]
    return {"images": np.stack([r["image"] for r in recs]),
            "gt_boxes": np.stack([p[0] for p in pads]),
            "gt_labels": np.stack([p[1] for p in pads])}


def _eval_model():
    cfg = detjax_torch.get_config("coco_v5e8", **EVAL)
    return cfg, detjax_torch.build_model(cfg, seed=0, device="cpu")


# -- the ranks ---------------------------------------------------------------

def _pair_main(rank: int, port: int, root: str) -> None:
    """One gloo rank of two, on a (1, 2) mesh: "on" and "off" through the
    fused twin, the sharded evaluation, then (once the parent published
    detjax's weights) the frozen steps at 128 and 512 px; after the group,
    the single-process references (rank 0: "on", "off" and the
    evaluation; rank 1: nothing). Writes ``pair<r>.pt``."""
    torch.set_num_threads(1)
    root = Path(root)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2)
    try:
        mesh = make_mesh(["cpu"], spatial=2)
        out = {"mesh": (mesh.axis_names, mesh.rank, mesh.data_rank,
                        mesh.space_rank, mesh.data_size, mesh.space)}
        for fb in ("on", "off"):
            cfg, state = _fused_state(fb)
            spatial.exchanges.update(dict.fromkeys(spatial.exchanges, 0))
            state, m = make_parallel_train_step(cfg, mesh)(
                state, shard_batch(_fused_batch(), mesh))
            out[f"fused_{fb}"] = _record(state, m, rank == 0)
            out[f"fused_{fb}"]["exchanges"] = dict(spatial.exchanges)
            out[f"fused_{fb}"]["blocks"] = len(state.model.fused_blocks())
        ecfg, model = _eval_model()
        from detjax_torch.data import SyntheticDetectionDataset

        ds = SyntheticDetectionDataset(**EVAL_DS)
        out["eval"] = detjax_torch.evaluate(model, ds, ecfg, mesh=mesh).stats
        out["dets"] = list(iter_detections(model, ds, ecfg, mesh=mesh))
        inputs = _wait_for(root / "inputs.pt")
        for name in ("frozen_128", "frozen_512"):
            cfg = _cfg(name)
            state = detjax_torch.make_train_state(cfg, seed=5, device="cpu")
            state.model.load_state_dict(inputs["sd"], strict=True)
            spatial.exchanges.update(dict.fromkeys(spatial.exchanges, 0))
            state, m = make_parallel_train_step(cfg, mesh)(
                state, shard_batch(_batch(*STEPS[name][:2]), mesh))
            out[name] = _record(state, m, rank == 0)
            out[name]["exchanges"] = dict(spatial.exchanges)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    if rank == 1:
        out["single_frozen_512"] = _single_step("frozen_512", inputs["sd"])
    if rank == 0:
        for fb in ("on", "off"):
            cfg, state = _fused_state(fb)
            state, m = tstep.train_step(state, _fused_batch())
            out[f"single_fused_{fb}"] = _record(state, m, True)
        out["eval_plain"] = detjax_torch.evaluate(model, ds, ecfg).stats
        out["dets_plain"] = list(iter_detections(model, ds, ecfg))
    torch.save(out, root / f"pair{rank}.pt")


def _quad_main(rank: int, port: int, root: str) -> None:
    """One gloo rank of four, on a (2, 2) mesh: the batch-statistics step
    at 128 px, keeping KEPT's gradients before and after the average.
    Writes ``quad<r>.pt``."""
    torch.set_num_threads(1)
    root = Path(root)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=4)
    try:
        mesh = make_mesh(["cpu"], spatial=2)
        out = {"mesh": (mesh.axis_names, mesh.rank, mesh.data_rank,
                        mesh.space_rank, mesh.data_size, mesh.space)}
        inputs = _wait_for(root / "inputs.pt")
        cfg = _cfg("bn_128")
        state = detjax_torch.make_train_state(cfg, seed=5, device="cpu")
        state.model.load_state_dict(inputs["sd"], strict=True)
        local = shard_batch(_batch(128, 4), mesh)
        out["local_images"] = tuple(local["images"].shape)
        loss, metrics = tstep.compute_gradients(state, local, mesh=mesh)
        out["local_grads"] = {n: p.grad.clone() for n, p in
                              state.model.named_parameters() if n in KEPT}
        tstep.average_gradients(state, mesh)
        metrics = tstep.average_metrics(dict(metrics, loss=loss), mesh)
        tstep.apply_gradients(state)
        out["step"] = _record(state, metrics, rank == 0)
        out["stats"] = _running_stats(state)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    if rank == 1:
        out["single_bn_128"] = _single_step("bn_128", inputs["sd"])
    torch.save(out, root / f"quad{rank}.pt")


def _running_stats(state):
    return {k: v.clone() for k, v in state.model.state_dict().items()
            if "running" in k}


def _single_step(name, sd):
    """The port's single-process step of STEPS[name] on the global batch:
    its record and running statistics."""
    cfg = _cfg(name)
    state = detjax_torch.make_train_state(cfg, seed=5, device="cpu")
    state.model.load_state_dict(sd, strict=True)
    state, m = tstep.train_step(state, _batch(*STEPS[name][:2]))
    return dict(_record(state, m, True), stats=_running_stats(state))


# -- the parent: detjax's side, while the ranks work -------------------------

def _np_tree(tree):
    import jax

    return jax.tree.map(np.asarray, jax.device_get(tree))


def _sgd_trace(opt_state):
    """optax sgd's momentum trace: after a first step, the gradient."""
    if type(opt_state).__name__ == "TraceState":
        return opt_state.trace
    for s in (opt_state if isinstance(opt_state, (tuple, list))
              else getattr(opt_state, "inner_state", ())):
        found = _sgd_trace(s)
        if found is not None:
            return found
    return None


def _jax_steps():
    """detjax's seeded weights, and one step of each STEPS configuration on
    one device, plus frozen_128 on its (1, 2) spatial mesh: {name:
    (metrics, gradients)} as numpy trees."""
    import jax
    import jax.numpy as jnp

    from detjax.config import get_config as j_get_config
    from detjax.parallel import make_mesh as j_make_mesh
    from detjax.parallel import make_parallel_train_step as j_sp_step
    from detjax.train import step as jstep

    def jcfg(name):
        hw, bs, extra = STEPS[name]
        return j_get_config("coco_v5e8", **{
            **_STEP, "model.image_size": (hw, hw), "train.batch_size": bs,
            **extra})

    init = jstep.make_train_state(jcfg("frozen_128"), jax.random.PRNGKey(0))
    weights = (_np_tree(init.params), _np_tree(init.batch_stats))
    yield "weights", weights
    runs = [(name, name, None) for name in STEPS] + [
        ("spatial_frozen_128", "frozen_128", 2)]
    for key, name, space in runs:
        cfg = jcfg(name)
        tx = jstep.make_optimizer(cfg)
        state = jstep.TrainState(
            step=jnp.zeros((), jnp.int32), params=init.params,
            batch_stats=init.batch_stats, opt_state=tx.init(init.params),
            tx=tx, cfg=cfg)
        step = (jstep.make_train_step(cfg) if space is None else j_sp_step(
            cfg, j_make_mesh(jax.devices()[:2], spatial=space)))
        state, m = step(state, jax.tree.map(jnp.asarray,
                                            _batch(*STEPS[name][:2])))
        yield key, ({k: float(v) for k, v in m.items()},
                    _np_tree(_sgd_trace(state.opt_state)),
                    _np_tree(state.batch_stats))


def _cli_args(tmp: Path):
    args = ["--synthetic", "--device", "cpu", "--steps", "2", "--depth", "18",
            "--spatial", "2", "--ckpt-dir", str(tmp / "ck"), "--log-dir",
            str(tmp / "log")]
    for k, v in {"model.image_size": "(64,64)", "model.fpn_channels": "32",
                 "model.head_channels": "32", "model.dtype": "float32",
                 "train.batch_size": "2", "data.host_workers": "2"}.items():
        args += ["--set", f"{k}={v}"]
    return args


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """Start the (1, 2) pair, the (2, 2) quad and the ``--spatial 2`` CLI,
    compute detjax's side meanwhile (its weights first, which the ranks
    wait for), then collect all three."""
    from detjax_torch.utils.weights import from_jax

    root = tmp_path_factory.mktemp("spatial")
    groups = [mp.start_processes(fn, args=(_free_port(), str(root)),
                                 nprocs=n, join=False, start_method="spawn")
              for fn, n in ((_pair_main, 2), (_quad_main, 4))]
    cli_tmp = root / "cli"
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    cli = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
         "2", "--master_addr", "127.0.0.1", "--master_port",
         str(_free_port()), "-m", "detjax_torch.cli.train",
         *_cli_args(cli_tmp)],
        cwd=str(REPO), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    jax_out = {}
    try:
        model_cfg = _cfg("frozen_128").model
        for key, value in _jax_steps():
            jax_out[key] = value
            if key == "weights":
                torch.save({"sd": from_jax(*value, model_cfg)},
                           root / "inputs.tmp")
                os.replace(root / "inputs.tmp", root / "inputs.pt")
        deadline = time.monotonic() + RANKS_TIMEOUT_S
        for ranks in groups:
            while not ranks.join(timeout=max(deadline - time.monotonic(),
                                             0.1)):
                if time.monotonic() > deadline:
                    raise TimeoutError("the ranks did not finish")
        cli_out, _ = cli.communicate(timeout=RANKS_TIMEOUT_S)
    finally:
        for ranks in groups:
            for p in ranks.processes:
                if p.is_alive():
                    p.terminate()
        if cli.poll() is None:
            cli.kill()
    return {"pair": [torch.load(root / f"pair{r}.pt", weights_only=False)
                     for r in range(2)],
            "quad": [torch.load(root / f"quad{r}.pt", weights_only=False)
                     for r in range(4)],
            "jax": jax_out, "model_cfg": model_cfg,
            "cli": (cli.returncode, cli_out, cli_tmp)}


# -- the bars ----------------------------------------------------------------

def _jax_grads(work, key):
    from detjax_torch.utils.weights import from_jax

    _, grads, stats = work["jax"][key]
    return from_jax(grads, stats, work["model_cfg"])


def _bar(w):
    return 2e-3 * np.abs(w) + 1e-4 * np.abs(w).max() + 1e-12


def _assert_step(got, work, key, single=None):
    """The loss within 1e-5 relative of detjax's step ``key``, and every
    gradient within the bar (2e-3 relative plus 1e-4 of its tensor's
    largest element) of detjax's; or, given the port's ``single``-process
    step, within the bar of its gradients and within ``NORM_BARS[key]`` of
    detjax's in 2-norm."""
    metrics = work["jax"][key][0]
    np.testing.assert_allclose(got["metrics"]["loss"], metrics["loss"],
                               rtol=1e-5)
    assert got["metrics"]["num_pos"] == metrics["num_pos"] > 0
    want = _jax_grads(work, key)
    assert len(got["grads"]) == 96  # every parameter of the R18 detector
    for name, g in got["grads"].items():
        g, w = g.numpy(), want[name].numpy()
        if single is None:
            assert (np.abs(g - w) <= _bar(w)).all(), name
            continue
        s = single["grads"][name].numpy()
        assert (np.abs(g - s) <= _bar(s)).all(), name
        assert _rel_norm(g, w) <= NORM_BARS[key], (name, _rel_norm(g, w))


def _rel_norm(a, b):
    return float(np.linalg.norm(a.astype(np.float64) - b)
                 / max(np.linalg.norm(b.astype(np.float64)), 1e-30))


def _assert_ranks_equal(records):
    """Every rank's metrics and gradients bit-equal to rank 0's."""
    first = records[0]
    for r in records[1:]:
        assert r["metrics"] == first["metrics"]
        assert r["grads"] == {k: _digest(v)
                              for k, v in first["grads"].items()}


def test_two_ranks_at_128_px_match_detjax(work):
    """(1, 2) mesh, R18 at 128 px, frozen BN, a degenerate pyramid (P6 2
    rows, P7 1: the FPN's outputs are gathered): one step against
    detjax's single-device step and against its spatial step on
    ``make_mesh(jax.devices()[:2], spatial=2)``; the ranks bit-equal."""
    pair = [p["frozen_128"] for p in work["pair"]]
    _assert_step(pair[0], work, "frozen_128")
    _assert_step(pair[0], work, "spatial_frozen_128")
    _assert_ranks_equal(pair)
    assert work["pair"][0]["mesh"] == (("data", "space"), 0, 0, 0, 1, 2)
    assert work["pair"][1]["mesh"] == (("data", "space"), 1, 0, 1, 1, 2)
    # the 18 backbone convs and pools and P3-P5's output convs exchange
    # halos (the stem conv's has no backward: the images need no
    # gradient); the layout rule gathers P3-P5 and C5, P6's input: 4
    ex = pair[0]["exchanges"]
    assert ex["halo"] == 21 and ex["gather"] == 4, ex
    assert ex["halo_grad"] == 20 and ex["gather_grad"] == 4, ex


def test_two_ranks_at_512_px_row_shard_the_heads(work):
    """(1, 2) mesh at 512 px, 2 images: P7 is 4 rows, 2 a rank, so nothing
    is degenerate and the heads run on the ranks' rows; the step against
    detjax's single-device step through the port's and directly in 2-norm
    (module docstring).
    10 gathers: each level's two head outputs."""
    pair = [p["frozen_512"] for p in work["pair"]]
    _assert_step(pair[0], work, "frozen_512",
                 work["pair"][1]["single_frozen_512"])
    _assert_ranks_equal(pair)
    assert spatial.pyramid_sharded(512, range(3, 8), 2)
    ex = pair[0]["exchanges"]
    assert ex["gather"] == 10 and ex["gather_grad"] == 10, ex
    # backbone 18, FPN 5 (P3-P7), heads 2 towers x 5 convs x 5 levels
    assert ex["halo"] == 18 + 5 + 50, ex


def test_four_ranks_with_batch_statistics_match_detjax(work):
    """(2, 2) mesh, batch-statistics BN: the statistics are summed over
    all four ranks, the gradients summed and divided by the data-axis
    size 2. One step against detjax's single-device step through the
    port's and directly in 2-norm (module docstring), the running
    statistics within 1e-4 relative plus 1e-5 of both, the ranks
    bit-equal. A divisor of W = 4 in place of D = 2, or no sum over the
    space group, reads 0.5 or more in the same 2-norm (||error|| /
    ||detjax||), 25x its bar of 2e-2."""
    quad = work["quad"]
    assert [q["mesh"][2:] for q in quad] == [(0, 0, 2, 2), (0, 1, 2, 2),
                                             (1, 0, 2, 2), (1, 1, 2, 2)]
    assert all(q["local_images"] == (2, 64, 128, 3) for q in quad)
    steps = [q["step"] for q in quad]
    single = quad[1]["single_bn_128"]
    _assert_step(steps[0], work, "bn_128", single)
    _assert_ranks_equal(steps)
    want = _jax_grads(work, "bn_128")
    got = steps[0]["grads"]
    stats = work["jax"]["bn_128"][2]
    from detjax_torch.utils.weights import from_jax

    want_stats = from_jax(work["jax"]["bn_128"][1], stats, work["model_cfg"])
    assert len(quad[0]["stats"]) == 40
    for k, v in quad[0]["stats"].items():
        for ref in (want_stats[k], single["stats"][k]):
            np.testing.assert_allclose(v.numpy(), ref.numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=k)
    wrong_divisor = max(_rel_norm(got[n].numpy() * 2 / 4, want[n].numpy())
                        for n in KEPT)
    # rank 0 without the space sum: its data axis (ranks 0 and 2) only
    no_space_sum = max(_rel_norm(((quad[0]["local_grads"][n]
                                   + quad[2]["local_grads"][n]) / 2).numpy(),
                                 want[n].numpy()) for n in KEPT)
    assert wrong_divisor >= 0.5 * (1 - 1e-3), wrong_divisor
    assert no_space_sum >= 0.5 * (1 - 1e-3), no_space_sum


def _rel_norms(got, want):
    return {n: float(np.linalg.norm(g.float().numpy()
                                    - want[n].float().numpy())
                     / max(np.linalg.norm(want[n].float().numpy()), 1e-30))
            for n, g in got.items()}


def test_fused_blocks_on_row_shards_match_unsharded(work):
    """``fused_backbone="on"`` through the fused block's CPU twin on the
    (1, 2) mesh, R50 at 128 px, bf16: each of the five fused blocks runs
    on its rows with a one-row halo on the inner edge only. Against "on"
    unsharded, at ``tests/test_torch_port_fused_train.py``'s bars: the
    loss within 1e-2, and the 2-norm gradient errors within 1.25 x those
    of "off" sharded against "off" unsharded plus 0.02, in the median
    over all tensors and the mean over the fused blocks' tensors."""
    r0 = work["pair"][0]
    assert r0["fused_on"]["blocks"] == 5
    _assert_ranks_equal([p["fused_on"] for p in work["pair"]])
    np.testing.assert_allclose(r0["fused_on"]["metrics"]["loss"],
                               r0["single_fused_on"]["metrics"]["loss"],
                               rtol=1e-2)
    on = _rel_norms(r0["fused_on"]["grads"], r0["single_fused_on"]["grads"])
    off = _rel_norms(r0["fused_off"]["grads"],
                     r0["single_fused_off"]["grads"])
    assert len(on) == len(off) == 195
    assert np.median(list(on.values())) <= (
        1.25 * np.median(list(off.values())) + 0.02)
    fused = [n for n in on if n.startswith((
        "layer1.1.", "layer1.2.", "layer2.1.", "layer2.2.", "layer2.3."))]
    assert len(fused) == 45
    assert (np.mean([on[n] for n in fused])
            <= 1.25 * np.mean([off[n] for n in fused]) + 0.02)


def test_sharded_evaluation_equals_unsharded(work):
    """``evaluate(mesh=)`` on the (1, 2) mesh at detjax's 64-px eval
    configuration: the 12 stats within 1e-6 of the unsharded run on both
    ranks, and each image's detections at the detect bars (the same kept
    labels, scores within 2e-5, boxes within 5e-3)."""
    r0 = work["pair"][0]
    for r in work["pair"]:
        for k in r0["eval_plain"]:
            assert abs(r["eval"][k] - r0["eval_plain"][k]) < 1e-6, k
        got, want = r["dets"], r0["dets_plain"]
        assert [g[0] for g in got] == [w[0] for w in want]
        for (_, gb, gs, gl), (_, wb, ws, wl) in zip(got, want):
            np.testing.assert_array_equal(gl, wl)
            np.testing.assert_allclose(gs, ws, rtol=0, atol=2e-5)
            np.testing.assert_allclose(gb, wb, rtol=0, atol=5e-3)
        assert sum(len(w[3]) for w in want) > 10


def test_cli_train_spatial_under_torch_distributed_run(work):
    """``python -m torch.distributed.run --nproc_per_node 2 -m
    detjax_torch.cli.train --spatial 2 --device cpu --synthetic --steps
    2``: a (1 data x 2 space) mesh, step 2, one checkpoint and one metrics
    file (rank 0's), one summary."""
    rc, out, tmp = work["cli"]
    assert rc == 0, out
    assert "spatial mesh: 2 process(es) as (1 data x 2 space)" in out
    assert os.listdir(tmp / "ck") == ["2"]
    assert os.listdir(tmp / "log") == ["metrics.jsonl"]
    assert out.count("done: step=2") == 1


# -- one process -------------------------------------------------------------

def test_layout_rule_decides_as_detjax():
    """The layout rule's decisions equal detjax's on the pyramids of
    ``tests/test_parallel.py:220-244`` (a 'space' axis of 2), and the
    canvases the cells use decide as their pyramids' rows say."""
    import jax
    import jax.numpy as jnp

    from detjax.models.spatial import unshard_tiny_levels as j_rule
    from detjax.parallel import make_mesh as j_make_mesh

    mesh = j_make_mesh(jax.devices()[:2], spatial=2)
    pyramids = ([(3, 16), (4, 8), (5, 4)],
                [(3, 16), (4, 8), (5, 4), (6, 2), (7, 1)],
                [(3, 12), (4, 6), (5, 3)],
                [(3, 128), (4, 64), (5, 32), (6, 16), (7, 8)],
                [(3, 80), (4, 40), (5, 20), (6, 10), (7, 5)])
    for levels in pyramids:
        feats = {lvl: jnp.zeros((2, r, r, 8)) for lvl, r in levels}
        with jax.sharding.use_abstract_mesh(mesh.abstract_mesh):
            jaxpr = jax.make_jaxpr(j_rule)(feats)
        constrained = any("sharding_constraint" in str(e.primitive)
                          for e in jaxpr.jaxpr.eqns)
        assert spatial.gathers_levels(dict(levels), 2) == constrained
    assert spatial.pyramid_sharded(1024, range(3, 8), 2)  # R50-1024
    assert not spatial.pyramid_sharded(640, range(3, 8), 2)  # R50-640
    assert spatial.level_rows(640, 7) == 5
    spatial.check_canvas_rows(1024, 2)
    with pytest.raises(ValueError, match="32 x space"):
        spatial.check_canvas_rows(96, 2)
    with pytest.raises(ValueError, match="not divisible"):
        spatial.check_canvas_rows(99, 2)


class _ThreadGroup:
    """S ranks as threads of one process: an all-gather over a barrier."""

    def __init__(self, size: int):
        self.slots = [None] * size
        self.barrier = threading.Barrier(size)

    def all_gather(self, t, index):
        self.slots[index] = t.clone()
        self.barrier.wait()
        out = list(self.slots)
        self.barrier.wait()
        return out


def _on_threads(fn, size: int):
    """fn(i, SpaceGroup of rank i) on ``size`` threads; their results."""
    group = _ThreadGroup(size)
    results, errors = [None] * size, []

    def run(i):
        try:
            sg = spatial.SpaceGroup(group, i, size)
            with spatial.space_group(sg):
                results[i] = fn(i, sg)
        except BaseException as e:  # noqa: BLE001 (re-raised below)
            errors.append(e)
            group.barrier.abort()

    threads = [threading.Thread(target=run, args=(i,)) for i in range(size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results


def _sharded(op, size):
    """op as one function of the whole image, its rows split over
    ``size`` thread-ranks: forward on the shards, and a backward made of
    each rank's own backward (halo gradients exchanged), summed weight
    gradients."""

    class Sharded(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, w):
            ctx.save_for_backward(x, w)
            h = x.shape[2] // size
            outs = _on_threads(
                lambda i, sg: op(x[:, :, i * h:(i + 1) * h], w), size)
            return torch.cat(outs, 2)

        @staticmethod
        def backward(ctx, g):
            x, w = ctx.saved_tensors
            h = x.shape[2] // size
            ho = g.shape[2] // size

            def vjp(i, sg):
                with torch.enable_grad():
                    xi = x[:, :, i * h:(i + 1) * h].detach().requires_grad_()
                    wi = w.detach().requires_grad_()
                    op(xi, wi).backward(g[:, :, i * ho:(i + 1) * ho])
                return xi.grad, wi.grad

            parts = _on_threads(vjp, size)
            return (torch.cat([p[0] for p in parts], 2),
                    sum(p[1] for p in parts))

    return Sharded.apply


def _conv_op(k, s, p):
    """spatial.conv2d of a bias-free conv whose weight is the argument."""
    def op(x, w):
        conv = types.SimpleNamespace(
            kernel_size=(k, k), stride=(s, s), padding=(p, p),
            dilation=(1, 1), groups=1, weight=w, bias=None)
        return spatial.conv2d(conv, x)
    return op


@pytest.mark.parametrize("k,s,p,halo", [(7, 2, 3, (3, 2)), (3, 1, 1, (1, 1)),
                                        (3, 2, 1, (1, 0)), (1, 2, 0, (0, 0)),
                                        ("pool", 2, 1, (1, 0))])
def test_halo_helpers_equal_the_plain_op(monkeypatch, k, s, p, halo):
    """Each helper on rows split over two and four thread-ranks of one
    process (an in-process all-gather in place of gloo's): the forward
    bit-equal to the plain op on the whole image, the halo rows those of
    detjax's rule (top p, bottom k - p - s), and the backward, the halo
    gradients sent back to their owners, held by
    ``torch.autograd.gradcheck`` in fp64."""
    monkeypatch.setattr(spatial, "_all_gather",
                        lambda t, sg: sg.group.all_gather(t, sg.index))
    monkeypatch.setattr(spatial, "_all_reduce", lambda t, sg: sum(
        sg.group.all_gather(t, sg.index)))
    if k != "pool":
        assert spatial._pad_rows(k, s, p) == halo
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(1, 2, 16, 3, dtype=torch.float64, generator=gen)
    if k == "pool":
        def op(xi, w):
            return spatial.max_pool_3x3s2(xi) * w.sum()
        w = torch.ones(1, dtype=torch.float64)
        plain = torch.nn.functional.max_pool2d(x, 3, 2, 1)
    else:
        w = torch.randn(1, 2, k, k, dtype=torch.float64, generator=gen)
        op = _conv_op(k, s, p)
        plain = torch.nn.functional.conv2d(x, w, stride=s, padding=p)
    for size in (2, 4):
        if (16 // size) % s or 16 // size < max(halo):
            continue
        f = _sharded(op, size)
        assert torch.equal(f(x, w), plain)
        assert torch.autograd.gradcheck(
            f, (x.clone().requires_grad_(), w.clone().requires_grad_()))


def test_row_halo_adds_rows_on_inner_edges_only(monkeypatch):
    """``with_row_halo`` (the fused block's rule): a rank gets one row of
    each neighbour and none at the image's top and bottom, and the added
    rows are dropped from the output."""
    monkeypatch.setattr(spatial, "_all_gather",
                        lambda t, sg: sg.group.all_gather(t, sg.index))
    x = torch.arange(2 * 12 * 3, dtype=torch.float32).reshape(1, 2, 12, 3)
    seen = _on_threads(lambda i, sg: spatial.with_row_halo(
        lambda t: t * 0 + t.shape[2], x[:, :, i * 4:(i + 1) * 4], 1), 3)
    assert [int(t[0, 0, 0, 0]) for t in seen] == [5, 6, 5]
    assert all(t.shape[2] == 4 for t in seen)


def test_mesh_axes_and_rows(monkeypatch):
    """A (data, space) Mesh's indices, its rows of a global batch and of an
    image, and the single-process refusal naming ROADMAP Queue 1 #8."""
    for v in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        monkeypatch.delenv(v, raising=False)
    ranks = [Mesh((torch.device("cpu"),), group=object(), rank=r,
                  world_size=4, space=2)
             for r in range(4)]
    assert [(m.data_rank, m.space_rank) for m in ranks] == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    assert {m.size for m in ranks} == {4}
    assert {m.data_size for m in ranks} == {2}
    assert ranks[1].local_rows(8).tolist() == [0, 1, 2, 3]
    assert ranks[3].local_rows(8, 2).tolist() == [2, 3, 6, 7]
    assert ranks[3].image_rows(64) == slice(32, 64)
    batch = {"images": np.zeros((8, 64, 80, 3), np.uint8),
             "gt_boxes": np.zeros((8, 4, 4), np.float32)}
    local = shard_batch(batch, ranks[2])
    assert local["images"].shape == (4, 32, 80, 3)
    assert local["gt_boxes"].shape == (4, 4, 4)
    with pytest.raises(NotImplementedError, match="Queue 1 #8"):
        make_mesh(["cpu", "cpu"], spatial=2)
