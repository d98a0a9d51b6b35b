"""PyTorch port vs detjax: batch-statistics BatchNorm
(``model.frozen_backbone_bn=False``), detjax's fusion rule with it, detect
in eval mode, and the train step that moves the running statistics.

The same numpy inputs and weights (carried by the port's ``from_jax``) go
through flax / detjax and the port, on the CPU. R18 at 64 px, fp32, FPN
and head width 32, unless a test says otherwise; each tolerance is stated
where it is used, with its reason.
"""

import numpy as np
import pytest

import flax.linen as fnn
import jax
import jax.numpy as jnp
import torch

from detjax.config import get_config as j_get_config
from detjax.modeling import build_model as j_build_model
from detjax.models.resnet import _fold_bn as j_fold_bn
from detjax.train import step as jstep

import detjax_torch
from detjax_torch.data.synthetic import SyntheticDetectionDataset
from detjax_torch.data.transforms import pad_annotations
from detjax_torch.models import resnet as tresnet
from detjax_torch.models.resnet import (
    BatchNorm2d,
    Bottleneck,
    FrozenBatchNorm2d,
    fold_frozen_bn,
)
from detjax_torch.train import step as tstep
from detjax_torch.utils.weights import from_jax

# One intra-op thread a process: pytest-xdist runs several workers on
# the host's cores, and torch's default of a thread a core in each
# worker oversubscribes them many times over.
torch.set_num_threads(1)

HW = (64, 64)
_SMALL = {"model.image_size": HW, "model.num_classes": 4,
          "model.dtype": "float32", "model.fpn_channels": 32,
          "model.head_channels": 32, "model.backbone_depth": 18,
          "model.frozen_backbone_bn": False, "data.hflip_prob": 0.0,
          "train.batch_size": 4, "train.max_gt": 4,
          "train.learning_rate": 1e-3, "train.lr_schedule": "constant",
          "eval.batch_size": 2, "data.host_workers": 2}


def _cfgs(**extra):
    ovr = {**_SMALL, **extra}
    return (j_get_config("retinanet_r50_640", **ovr),
            detjax_torch.get_config("retinanet_r50_640", **ovr))


def _np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _batch(seed=0, b=4, max_gt=4):
    """uint8 64-px synthetic scenes, GT padded to ``max_gt``."""
    ds = SyntheticDetectionDataset(b, HW, 4, max_objects=3, seed=seed,
                                   size_range=(0.25, 0.6))
    recs = [ds[i] for i in range(b)]
    pads = [pad_annotations(r["boxes"], r["labels"], max_gt) for r in recs]
    return {"images": np.stack([r["image"] for r in recs]),
            "gt_boxes": np.stack([p[0] for p in pads]),
            "gt_labels": np.stack([p[1] for p in pads])}


@pytest.fixture(scope="module")
def weights():
    """detjax's seeded variables of the batch-statistics R18, as numpy;
    the running statistics made non-trivial so that eval mode reads
    them."""
    jcfg, _ = _cfgs()
    _, variables = j_build_model(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(3)

    def stats(leaf):
        if leaf.ndim != 1:
            return leaf
        return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)

    return (_np_tree(variables["params"]),
            jax.tree.map(stats, _np_tree(variables["batch_stats"])))


def _port_state(tcfg, weights):
    state = detjax_torch.make_train_state(tcfg, seed=5, device="cpu")
    state.model.load_state_dict(from_jax(*weights, tcfg.model), strict=True)
    return state


def _jax_state(jcfg, weights):
    params = jax.tree.map(jnp.asarray, weights[0])
    tx = jstep.make_optimizer(jcfg)
    return jstep.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree.map(jnp.asarray, weights[1]),
        opt_state=tx.init(params), tx=tx, cfg=jcfg)


# -- the module against flax's -----------------------------------------------

def _bn_case(seed, dtype, n=4, h=10, w=12, c=16):
    rng = np.random.default_rng(seed)
    x = rng.normal(0.7, 2.0, (n, h, w, c)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.normal(0, 0.3, c).astype(np.float32)
    mean = rng.normal(0, 0.5, c).astype(np.float32)
    var = rng.uniform(0.5, 2.0, c).astype(np.float32)
    dy = rng.normal(0, 1, (n, h, w, c)).astype(np.float32)
    if dtype == "bfloat16":  # both sides start from the same bf16 values
        x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
        dy = np.asarray(jnp.asarray(dy, jnp.bfloat16).astype(jnp.float32))
    return x, scale, bias, mean, var, dy


def _port_bn(scale, bias, mean, var):
    bn = BatchNorm2d(len(scale))
    with torch.no_grad():
        for t, v in ((bn.weight, scale), (bn.bias, bias),
                     (bn.running_mean, mean), (bn.running_var, var)):
            t.copy_(torch.from_numpy(v))
    return bn


def _nchw(a, dtype):
    return torch.from_numpy(a.transpose(0, 3, 1, 2).copy()).to(dtype)


def _nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def _bf16_steps(got, want, atol=1e-6):
    """The largest distance beyond ``atol``, in bf16 steps (the spacing of
    bf16 numbers at ``want``'s magnitude)."""
    exp = np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126)))
    off = np.maximum(np.abs(got - want) - atol, 0.0)
    return float((off / 2.0 ** (exp - 7)).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_mode_matches_flax(dtype):
    """Train mode against flax's ``nn.BatchNorm(use_running_average=False,
    momentum=0.9)``: output, new running mean and variance, and the
    ``jax.vjp`` gradients of x, scale and bias. fp32: every value within
    2e-5 relative plus 2e-6 absolute (the statistics are means over 480
    elements each, reduced by XLA and by ATen in other orders; the
    gradients through them add two more such sums). bf16 input (flax's
    ``dtype=bfloat16``, the port's bf16 activation): the statistics and
    the fp32 gradients of scale and bias as in fp32, since both reduce in
    fp32 from the same bf16 values; the bf16 output within one bf16 step
    of flax's (a sum that lands within fp32 rounding of a bf16 midpoint
    rounds either way) beyond 1e-6 absolute (where the output cancels to
    near 0, fp32 rounding of terms near 1 is many bf16 steps of the
    result: -7.30e-6 against flax's -7.21e-6, -7.28e-6 in fp64). The bf16
    dx: within one bf16 step (beyond 1e-6) of the fp64 gradient of the
    same formula, and within one bf16 step of the largest |dx| of flax's.
    flax's own dx is coarser: x reaches the statistics and the
    normalisation through two casts to fp32, so jax.grad rounds each
    branch's cotangent to bf16 and adds them in bf16 (up to 278 bf16
    steps off the fp64 gradient on small elements, measured); the port
    casts once and rounds the fp32 sum once."""
    x, scale, bias, mean, var, dy = _bn_case(0, dtype)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    mod = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                        epsilon=1e-5, dtype=jdt)
    stats = {"mean": jnp.asarray(mean), "var": jnp.asarray(var)}

    def apply(xx, s, b):
        return mod.apply({"params": {"scale": s, "bias": b},
                          "batch_stats": stats}, xx,
                         mutable=["batch_stats"])

    jy, jnew = apply(jnp.asarray(x, jdt), jnp.asarray(scale),
                     jnp.asarray(bias))
    _, vjp = jax.vjp(lambda xx, s, b: apply(xx, s, b)[0],
                     jnp.asarray(x, jdt), jnp.asarray(scale),
                     jnp.asarray(bias))
    jdx, jds, jdb = vjp(jnp.asarray(dy, jdt))

    bn = _port_bn(scale, bias, mean, var).train()
    tx = _nchw(x, tdt).requires_grad_(True)
    ty = bn(tx)
    ty.backward(_nchw(dy, tdt))
    assert ty.dtype == tdt and tx.grad.dtype == tdt

    close = dict(rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(jnew["batch_stats"]["mean"]),
                               **close)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(jnew["batch_stats"]["var"]),
                               **close)
    np.testing.assert_allclose(bn.weight.grad.numpy(), np.asarray(jds),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(bn.bias.grad.numpy(), np.asarray(jdb),
                               rtol=2e-5, atol=2e-5)
    want_y = np.asarray(jy.astype(jnp.float32))
    want_dx = np.asarray(jdx.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(_nhwc(ty), want_y, **close)
        np.testing.assert_allclose(_nhwc(tx.grad), want_dx, rtol=2e-5,
                                   atol=2e-5)
    else:
        assert _bf16_steps(_nhwc(ty), want_y) <= 1.0
        xd = torch.from_numpy(x.astype(np.float64)).requires_grad_(True)
        m = xd.mean((0, 1, 2))
        v = (xd * xd).mean((0, 1, 2)) - m * m
        yd = ((xd - m) * (torch.rsqrt(v + 1e-5) * torch.from_numpy(scale))
              + torch.from_numpy(bias))
        yd.backward(torch.from_numpy(dy.astype(np.float64)))
        got_dx = _nhwc(tx.grad)
        assert _bf16_steps(got_dx, xd.grad.numpy()) <= 1.0
        top = float(np.abs(want_dx).max())
        assert np.abs(got_dx - want_dx).max() <= 2.0 ** (
            np.floor(np.log2(top)) - 7)


def test_statistics_are_fp32_and_biased():
    """A bf16 activation with a large mean and a small spread: the port's
    batch variance is the biased fp32 one (a bf16 reduction of E[x^2] -
    E[x]^2 would lose it entirely), and the update is flax's
    ``0.9 * ra + 0.1 * batch``, written in place (version counters move)."""
    rng = np.random.default_rng(1)
    x = (100.0 + rng.normal(0, 0.5, (2, 3, 40, 40))).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    xf = xb.float().numpy().astype(np.float64)
    bn = BatchNorm2d(3).train()
    versions = (bn.running_mean._version, bn.running_var._version)
    bn(xb)
    mean = xf.mean((0, 2, 3))
    var = xf.var((0, 2, 3))  # ddof 0: biased
    np.testing.assert_allclose(bn.running_mean.numpy(), 0.1 * mean,
                               rtol=1e-5)
    # E[x^2] - E[x]^2 in fp32 at a mean of 100 keeps about 1e-3 of 1e4
    np.testing.assert_allclose(bn.running_var.numpy(), 0.9 + 0.1 * var,
                               atol=2e-3)
    assert (bn.running_mean._version, bn.running_var._version) > versions
    assert {n for n, _ in bn.named_buffers()} == {"running_mean",
                                                  "running_var"}


def test_eval_mode_matches_flax():
    """Eval mode against flax's ``use_running_average=True``: the running
    statistics, in fp32, within 2e-6 relative plus 2e-6 absolute (rsqrt in
    two libraries); the statistics do not move."""
    x, scale, bias, mean, var, _ = _bn_case(2, "float32")
    mod = fnn.BatchNorm(use_running_average=True, momentum=0.9,
                        epsilon=1e-5, dtype=jnp.float32)
    want = mod.apply({"params": {"scale": scale, "bias": bias},
                      "batch_stats": {"mean": mean, "var": var}},
                     jnp.asarray(x))
    bn = _port_bn(scale, bias, mean, var).eval()
    with torch.no_grad():
        got = bn(_nchw(x, torch.float32))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=2e-6,
                               atol=2e-6)
    assert torch.equal(bn.running_mean, torch.from_numpy(mean))
    assert torch.equal(bn.running_var, torch.from_numpy(var))


def test_fold_of_batch_statistics_bn_equals_detjax():
    """The fold of a ``BatchNorm2d``'s running statistics is detjax's
    ``_fold_bn`` bit for bit (the same rule as the frozen BN's)."""
    rng = np.random.default_rng(4)
    block = Bottleneck(256, 64, frozen_bn=False)
    assert isinstance(block.bn2, BatchNorm2d)
    hwio = rng.normal(0, 0.05, (3, 3, 64, 64)).astype(np.float32)
    scale, bias, mean, var = (rng.uniform(0.5, 1.5, 64).astype(np.float32)
                              for _ in range(4))
    with torch.no_grad():
        block.conv2.weight.copy_(torch.from_numpy(hwio.transpose(3, 2, 0, 1)))
        for t, v in ((block.bn2.weight, scale), (block.bn2.bias, bias),
                     (block.bn2.running_mean, mean),
                     (block.bn2.running_var, var)):
            t.copy_(torch.from_numpy(v))
        w, b = fold_frozen_bn(block.conv2.weight, block.bn2)
    jw, jb = j_fold_bn(*map(jnp.asarray, (hwio, scale, bias, mean, var)))
    np.testing.assert_array_equal(w.float().numpy(),
                                  np.asarray(jw.astype(jnp.float32)))
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))


# -- the detector ------------------------------------------------------------

def test_every_backbone_bn_takes_batch_statistics(weights):
    """With frozen_backbone_bn=False every backbone BatchNorm (stem, each
    block, each projection) is a BatchNorm2d and none is frozen; the FPN
    and head have none; from_jax loads with strict=True (no
    num_batches_tracked)."""
    _, tcfg = _cfgs()
    model = detjax_torch.build_model(tcfg, device="cpu")
    bns = [n for n, m in model.named_modules() if isinstance(m, BatchNorm2d)]
    assert len(bns) == 20 and "bn1" in bns and "layer2.0.downsample.1" in bns
    assert not any(isinstance(m, FrozenBatchNorm2d)
                   for m in model.modules())
    assert not any(n.startswith(("fpn", "classification", "regression"))
                   for n in bns)
    model.load_state_dict(from_jax(*weights, tcfg.model), strict=True)
    assert not any("num_batches" in k for k in model.state_dict())


@pytest.fixture
def count_fused(monkeypatch):
    """Counts Bottleneck.fused_forward calls."""
    calls = []
    real = Bottleneck.fused_forward

    def counted(self, x):
        calls.append(1)
        return real(self, x)

    monkeypatch.setattr(Bottleneck, "fused_forward", counted)
    return calls


def test_fusion_rule_at_r50(count_fused):
    """R50, bf16, fused_backbone="on", 64 px: with batch statistics no
    fused block runs in train mode (the statistics move) and 5 run in eval
    mode (folded from the running statistics, which do not move); frozen,
    5 run in train mode too. A train-mode forward moves the statistics in
    place, so the next eval folds them anew: its folded weights equal a
    fresh fold's, bit for bit."""
    ovr = {"model.image_size": HW, "model.num_classes": 4,
           "model.fpn_channels": 32, "model.head_channels": 32,
           "model.fused_backbone": "on", "model.dtype": "bfloat16"}
    cfg = detjax_torch.get_config("retinanet_r50_640", **ovr,
                                  **{"model.frozen_backbone_bn": False})
    model = detjax_torch.build_model(cfg, device="cpu")
    x = torch.from_numpy(np.random.default_rng(5).normal(
        0, 1, (2, 3, 64, 64)).astype(np.float32))
    block = model.layer1[1]
    with torch.no_grad():
        model.eval()
        model(x)
        assert len(count_fused) == 5
        before = [t.clone() for t in block.folded_weights()]
        model.train()
        stats = block.bn1.running_mean.clone()
        model(x)
        assert len(count_fused) == 5  # none in train mode
        assert not torch.equal(block.bn1.running_mean, stats)
        model.eval()
        model(x)
        assert len(count_fused) == 10
        after = block.folded_weights()
        fresh = [t for conv, bn in ((block.conv1, block.bn1),
                                    (block.conv2, block.bn2),
                                    (block.conv3, block.bn3))
                 for t in fold_frozen_bn(conv.weight, bn)]
    assert not torch.equal(after[1], before[1])
    for a, f in zip(after, fresh):
        assert torch.equal(a, f)

    frozen = detjax_torch.build_model(
        detjax_torch.get_config("retinanet_r50_640", **ovr), device="cpu")
    frozen.train()
    with torch.no_grad():
        frozen(x)
    assert len(count_fused) == 15


def _canvases(seed, b=2):
    ds = SyntheticDetectionDataset(b, HW, 4, max_objects=3, seed=seed,
                                   size_range=(0.25, 0.6))
    return np.stack([ds[i]["image"] for i in range(b)])


def test_detect_and_evaluate_run_in_eval_mode(weights):
    """A batch-statistics R18 left in train mode gives the same detections
    as in eval mode (detjax detects with ``train=False``); after
    ``detect_u8`` and after ``evaluate`` it is still in train mode and its
    running statistics have not moved, bit for bit."""
    _, tcfg = _cfgs()
    model = detjax_torch.build_model(tcfg, device="cpu")
    model.load_state_dict(from_jax(*weights, tcfg.model), strict=True)
    canv = _canvases(6)
    model.eval()
    want = detjax_torch.detect_u8(model, canv, tcfg)
    model.train()
    stats = {k: v.clone() for k, v in model.state_dict().items()
             if "running" in k}
    got = detjax_torch.detect_u8(model, canv, tcfg)
    assert model.training
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    ds = SyntheticDetectionDataset(4, HW, 4, max_objects=3, seed=7)
    res = detjax_torch.evaluate(model, ds, tcfg)
    assert model.training and len(res.stats) == 12
    for k, v in stats.items():
        assert torch.equal(model.state_dict()[k], v), k


# -- the train step ----------------------------------------------------------

def _assert_change_close(name, got, want, start, lr, steps, adam):
    """The change of one parameter tensor over ``steps`` steps, port vs
    detjax, as ``tests/test_torch_port_train.py`` holds it: within 1e-3
    relative plus 2 % of the tensor's largest change plus 2 ulp of the
    starting value; the elements that miss (Adam turns a gradient element
    whose sign is fp32 noise into a full +-lr step) stay within 2 * lr *
    steps, and their number is returned."""
    tol = (1e-3 * np.abs(want) + 0.02 * np.abs(want).max()
           + 2 * np.spacing(np.abs(start)))
    bad = np.abs(got - want) > tol
    if bad.any() and not adam:
        raise AssertionError(f"{name}: {int(bad.sum())} elements off")
    assert (np.abs(got - want)[bad] <= 2 * lr * steps).all(), name
    return int(bad.sum())


def _assert_stats_close(state, jstate, tcfg, weights, rtol):
    """The running statistics against detjax's batch_stats within ``rtol``
    plus 1e-5 absolute: each is a mean over the batch of a conv output
    that XLA and oneDNN sum in other orders, then blended."""
    want = from_jax(_np_tree(jstate.params), _np_tree(jstate.batch_stats),
                    tcfg.model)
    init = from_jax(*weights, tcfg.model)
    n = 0
    for k, v in state.model.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(v.numpy(), want[k].numpy(),
                                       rtol=rtol, atol=1e-5, err_msg=k)
            assert not torch.equal(want[k], init[k]), k  # they moved
            n += 1
    assert n == 40


@pytest.fixture
def eight_threads():
    """torch's CPU threads at eight for one test, then back to the cap."""
    before = torch.get_num_threads()
    torch.set_num_threads(8)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("accum", [1, 2])
def test_steps_match_detjax(weights, accum, eight_threads):
    """Three steps with batch statistics from the same weights and batch
    (hflip_prob 0) against detjax's train_step: loss, cls/reg loss and
    grad_norm per step within 1e-4 relative (``test_torch_port_train``'s
    bar); the parameters after steps 1 and 3 as that file's
    ``_assert_change_close`` holds them, at most 1e-4 of all elements
    off (2e-4 with ``grad_accum_steps=2``: a half batch's layer4
    statistics are means over 8 values, 2 images of 2x2, whose fp32
    noise reaches more Adam steps whose sign is noise; 1.1e-4 measured,
    all in layer3-4, with loss and grad_norm within 1e-6); every running
    statistic within ``_assert_stats_close``'s bar, 1e-4 relative after
    step 1 and 1e-3 after step 3, when they are the statistics of
    parameters that already differ by those Adam steps (the stem's mean
    moved 3.2e-4 relative with ``grad_accum_steps=2``, measured).
    ``grad_accum_steps=2`` normalises each half batch with its own
    statistics and moves the running statistics twice a step, as
    detjax's scan does.

    The share of noise-signed steps measures how closely the two
    frameworks' fp32 summation orders coincide, and oneDNN splits its
    weight-gradient reductions by thread: at one thread 29 tensors'
    step-0 gradients differ in their last bits from eight threads', and
    with ``accum=1`` 1.04 % of all elements then take a noise-signed step
    by step 3 (3.1e-5 at eight threads, the count these bars were
    measured at). So this test runs at eight threads (``eight_threads``),
    not at the file's cap."""
    lr = 1e-3
    jcfg, tcfg = _cfgs(**{"train.grad_accum_steps": accum})
    batch = _batch()
    jstate = _jax_state(jcfg, weights)
    state = _port_state(tcfg, weights)
    start = {n: p.detach().clone().numpy()
             for n, p in state.model.named_parameters()}
    step_fn = jstep.make_train_step(jcfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    for i in range(3):
        jstate, jm = step_fn(jstate, jbatch)
        state, tm = detjax_torch.train_step(state, batch)
        for key in ("loss", "cls_loss", "reg_loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-4, err_msg=f"{key} {i}")
        assert float(tm["num_pos"]) == float(jm["num_pos"]) > 0
        if i in (0, 2):
            want = from_jax(_np_tree(jstate.params), weights[1], tcfg.model)
            off = sum(_assert_change_close(
                f"{name} after step {i + 1}",
                p.detach().numpy() - start[name],
                want[name].numpy() - start[name], start[name], lr, i + 1,
                True)
                for name, p in state.model.named_parameters())
            share = 1e-4 * accum
            assert off <= share * sum(v.size for v in start.values()), off
            _assert_stats_close(state, jstate, tcfg, weights,
                                rtol=1e-4 if i == 0 else 1e-3)
    assert state.step == 3 and int(jstate.step) == 3


def test_accumulation_moves_the_statistics_once_a_micro_batch(weights):
    """grad_accum_steps=2 moves the running statistics twice a step: equal,
    bit for bit, to two train-mode forwards of the half batches."""
    _, tcfg = _cfgs(**{"train.grad_accum_steps": 2})
    batch = _batch(1)
    state = _port_state(tcfg, weights)
    probe = _port_state(tcfg, weights).model
    x = detjax_torch.data.device_augment(
        torch.from_numpy(batch["images"]), torch.from_numpy(
            batch["gt_boxes"]), hflip_prob=0.0)[0].permute(0, 3, 1, 2)
    with torch.no_grad():
        probe(x[:2])
        probe(x[2:])
    tstep.compute_gradients(state, batch)
    for k, v in probe.state_dict().items():
        if "running" in k:
            assert torch.equal(state.model.state_dict()[k], v), k


def test_unported_knobs_still_raise():
    """Batch statistics are ported; the TPU knobs beside them still
    raise."""
    assert "frozen_backbone_bn" not in tresnet._TPU_OR_TRAIN_KNOBS
    _, tcfg = _cfgs(**{"model.remat_early": 1})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        detjax_torch.make_train_state(tcfg, device="cpu")
