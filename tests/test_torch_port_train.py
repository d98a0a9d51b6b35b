"""PyTorch port vs detjax: box encoding, losses, augmentation and the train
step, on the CPU at fp32 and small widths (R18, 128 px, 6 classes, FPN and
head width 32, batch 2, 5 GT slots).

The same numpy inputs and the same weights (carried by the port's
``from_jax``) go through detjax's function and the port's. Each tolerance
is stated where it is used, with its reason.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from detjax.config import get_config as j_get_config
from detjax.data.pipeline import device_augment as j_device_augment
from detjax.modeling import anchor_config as j_anchor_config
from detjax.modeling import build_model as j_build_model
from detjax.models.detector import build_detector as j_build_detector
from detjax.ops import boxes as jboxes
from detjax.ops import losses as jlosses
from detjax.ops.anchors import anchors_for_shape as j_anchors_for_shape
from detjax.train import step as jstep

import detjax_torch
from detjax_torch.data.pipeline import device_augment
from detjax_torch.data.synthetic import SyntheticDetectionDataset
from detjax_torch.data.transforms import pad_annotations
from detjax_torch.kernels import matching as km
from detjax_torch.models.detector import Detector
from detjax_torch.modeling import anchor_config
from detjax_torch.ops import boxes as tboxes
from detjax_torch.ops import losses as tlosses
from detjax_torch.ops.anchors import anchors_for_shape
from detjax_torch.train import step as tstep
from detjax_torch.utils.weights import from_jax

# One intra-op thread a process: pytest-xdist runs several workers on
# the host's cores, and torch's default of a thread a core in each
# worker oversubscribes them many times over.
torch.set_num_threads(1)

HW = (128, 128)
_SMALL = {"model.image_size": HW, "model.num_classes": 6,
          "model.dtype": "float32", "model.fpn_channels": 32,
          "model.head_channels": 32, "model.backbone_depth": 18,
          "train.batch_size": 2, "train.max_gt": 5}
ANCHORS = anchors_for_shape(HW, anchor_config(
    detjax_torch.get_config("retinanet_r50_640")))
LEVEL_SIZES = {lvl: 9 * (HW[0] >> lvl) * (HW[1] >> lvl) for lvl in range(3, 8)}


def _cfgs(**extra):
    ovr = {**_SMALL, **extra}
    return (j_get_config("retinanet_r50_640", **ovr),
            detjax_torch.get_config("retinanet_r50_640", **ovr))


def _np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _batch(seed=0, b=2, max_gt=5):
    """uint8 128-px synthetic scenes, GT padded to ``max_gt``."""
    ds = SyntheticDetectionDataset(b, HW, 6, max_objects=4, seed=seed,
                                   size_range=(0.2, 0.6))
    recs = [ds[i] for i in range(b)]
    pads = [pad_annotations(r["boxes"], r["labels"], max_gt) for r in recs]
    return {"images": np.stack([r["image"] for r in recs]),
            "gt_boxes": np.stack([p[0] for p in pads]),
            "gt_labels": np.stack([p[1] for p in pads])}


def _gt(seed, b=2, g=5):
    rng = np.random.default_rng(seed)
    c = rng.uniform(0, 128, (b, g, 2))
    wh = rng.uniform(2, 70, (b, g, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    labels = rng.integers(0, 6, (b, g)).astype(np.int32)
    labels[:, -1] = -1
    return boxes, labels


@pytest.fixture(scope="module")
def weights():
    """detjax's seeded variables as numpy trees."""
    jcfg, _ = _cfgs()
    _, variables = j_build_model(jcfg, jax.random.PRNGKey(0))
    return _np_tree(variables["params"]), _np_tree(variables["batch_stats"])


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


def _jax_flip(jcfg, step, b):
    """The flip mask detjax's step ``step`` draws (train/step.py:225)."""
    rng = jax.random.fold_in(jax.random.PRNGKey(jcfg.train.seed), step)
    return np.array(jax.random.bernoulli(rng, jcfg.data.hflip_prob, (b,)))


@pytest.fixture
def jax_flips(monkeypatch):
    """Make the port's step draw detjax's flip masks, step by step."""
    jcfg, _ = _cfgs()
    monkeypatch.setattr(tstep, "flip_mask", lambda cfg, step, b: torch.from_numpy(
        _jax_flip(jcfg, step, b)))
    return [_jax_flip(jcfg, s, 2).tolist() for s in range(3)]


# -- box encoding, losses, augmentation ------------------------------------

def test_encode_boxes_matches_detjax():
    """Within 1e-6 relative: torch's and XLA's log differ by up to an ulp;
    the rest is the same order of IEEE operations."""
    boxes, _ = _gt(0, 3, 40)
    boxes[0, :3, 2] = boxes[0, :3, 0] + 0.5  # under the 1-px clamp
    boxes[1, :3, 3] = boxes[1, :3, 1]  # zero height
    anchors = ANCHORS[:40][None]
    want = jboxes.encode_boxes(jnp.asarray(boxes), jnp.asarray(anchors))
    got = tboxes.encode_boxes(torch.from_numpy(boxes), torch.from_numpy(anchors))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def _head_outputs(seed, b=2, k=6):
    rng = np.random.default_rng(seed)
    a = ANCHORS.shape[0]
    cls = (rng.normal(-2, 3, (b, a, k))).astype(np.float32)
    box = rng.normal(0, 1, (b, a, 4)).astype(np.float32)
    return cls, box


def _per_level(cls, box):
    """[B, sum A, C] -> {level: [B, H, W, 9*C]}, the heads' NHWC layout."""
    out, off = {}, 0
    for lvl, n in LEVEL_SIZES.items():
        h, w = HW[0] >> lvl, HW[1] >> lvl
        out[lvl] = (cls[:, off:off + n].reshape(cls.shape[0], h, w, -1),
                    box[:, off:off + n].reshape(box.shape[0], h, w, -1))
        off += n
    return out


@pytest.mark.parametrize("which", ["detection_loss", "per_level"])
def test_detection_losses_match_detjax(which):
    """cls, reg and num_pos against detjax at fp32 within 1e-5 relative:
    the per-image sums run over 18k elements in another order."""
    cls, box = _head_outputs(1)
    gt_boxes, gt_labels = _gt(2)
    if which == "detection_loss":
        want = jlosses.detection_loss(
            jnp.asarray(cls), jnp.asarray(box), jnp.asarray(ANCHORS),
            jnp.asarray(gt_boxes), jnp.asarray(gt_labels))
        got = tlosses.detection_loss(
            torch.from_numpy(cls), torch.from_numpy(box),
            torch.from_numpy(ANCHORS), torch.from_numpy(gt_boxes),
            torch.from_numpy(gt_labels))
    else:
        want = jlosses.detection_loss_per_level(
            {k: tuple(map(jnp.asarray, v))
             for k, v in _per_level(cls, box).items()},
            jnp.asarray(ANCHORS), LEVEL_SIZES, jnp.asarray(gt_boxes),
            jnp.asarray(gt_labels))
        got = tlosses.detection_loss_per_level(
            {k: tuple(map(torch.from_numpy, v))
             for k, v in _per_level(cls, box).items()},
            torch.from_numpy(ANCHORS), LEVEL_SIZES,
            torch.from_numpy(gt_boxes), torch.from_numpy(gt_labels))
    assert float(got.metrics["num_pos"]) == float(want.metrics["num_pos"]) > 0
    for name in ("cls_loss", "reg_loss"):
        np.testing.assert_allclose(float(getattr(got, name)),
                                   float(getattr(want, name)), rtol=1e-5)
        np.testing.assert_allclose(float(got.metrics[name]),
                                   float(want.metrics[name]), rtol=1e-5)


@pytest.mark.parametrize("fn", ["focal", "smooth_l1"])
def test_per_image_losses_match_detjax(fn):
    """Per-image values within 1e-5 relative (summation order)."""
    cls, box = _head_outputs(3)
    gt_boxes, gt_labels = _gt(4)
    m = detjax_torch.ops.matching.match_anchors(
        torch.from_numpy(ANCHORS), torch.from_numpy(gt_boxes),
        torch.from_numpy(gt_labels))
    if fn == "focal":
        want = jlosses.focal_loss(jnp.asarray(cls),
                                  jnp.asarray(m.matched_labels.numpy()),
                                  jnp.asarray(m.positive.numpy()),
                                  jnp.asarray(m.negative.numpy()))
        got = tlosses.focal_loss(torch.from_numpy(cls), m.matched_labels,
                                 m.positive, m.negative)
    else:
        tgt = tboxes.encode_boxes(m.matched_boxes,
                                  torch.from_numpy(ANCHORS)[None])
        want = jlosses.smooth_l1_loss(jnp.asarray(box),
                                      jnp.asarray(tgt.numpy()),
                                      jnp.asarray(m.positive.numpy()))
        got = tlosses.smooth_l1_loss(torch.from_numpy(box), tgt, m.positive)
    assert got.shape == (2,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_focal_gradient_matches_jax_grad_and_autograd():
    """The closed-form backward against jax.grad of detjax's focal loss
    and against torch autograd of the plain formula, within 1e-5 of the
    largest gradient (fp32 rounding of two different formulas); a bf16
    input gets its gradient back in bf16."""
    cls, _ = _head_outputs(5)
    gt_boxes, gt_labels = _gt(6)
    m = detjax_torch.ops.matching.match_anchors(
        torch.from_numpy(ANCHORS), torch.from_numpy(gt_boxes),
        torch.from_numpy(gt_labels))
    lab, pos, neg = m.matched_labels, m.positive, m.negative
    want = jax.grad(lambda x: jnp.sum(jlosses.focal_loss(
        x, jnp.asarray(lab.numpy()), jnp.asarray(pos.numpy()),
        jnp.asarray(neg.numpy()))))(jnp.asarray(cls))
    x = torch.from_numpy(cls).requires_grad_(True)
    tlosses.focal_loss(x, lab, pos, neg).sum().backward()
    scale = float(np.abs(np.asarray(want)).max())
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5 * scale)

    y = torch.from_numpy(cls).requires_grad_(True)
    weight = (pos | neg).float()
    num_pos = torch.clamp(pos.float().sum(-1), min=1.0)
    (tlosses._focal_elem(y, lab, weight, 0.25, 2.0) / num_pos).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), y.grad.numpy(), rtol=0,
                               atol=1e-5 * scale)

    z = torch.from_numpy(cls).to(torch.bfloat16).requires_grad_(True)
    tlosses.focal_loss(z, lab, pos, neg).sum().backward()
    assert z.grad.dtype == torch.bfloat16


def test_device_augment_with_a_fed_flip_mask():
    """detjax's device_augment, given the mask detjax draws: boxes
    bit-equal, images within 1e-6."""
    rng = np.random.default_rng(7)
    images = rng.integers(0, 256, (4, 16, 24, 3), dtype=np.uint8)
    boxes = rng.uniform(0, 24, (4, 3, 4)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    flip = np.array(jax.random.bernoulli(key, 0.5, (4,)))
    assert flip.any() and not flip.all()
    jx, jb = j_device_augment(jnp.asarray(images), jnp.asarray(boxes), key,
                              hflip_prob=0.5)
    tx, tb = device_augment(torch.from_numpy(images), torch.from_numpy(boxes),
                            flip=torch.from_numpy(flip))
    # images within 1e-6, the bar of PR 1's normalize_u8 test: XLA:CPU
    # rounds the division by the constant mean/std vectors differently
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))

    gen = torch.Generator().manual_seed(3)
    ax, _ = device_augment(torch.from_numpy(images), torch.from_numpy(boxes),
                           generator=gen, out_dtype=torch.bfloat16)
    bx, _ = device_augment(torch.from_numpy(images), torch.from_numpy(boxes),
                           generator=torch.Generator().manual_seed(3),
                           out_dtype=torch.bfloat16)
    assert ax.dtype == torch.bfloat16 and torch.equal(ax, bx)
    nx, nb = device_augment(torch.from_numpy(images),
                            torch.from_numpy(boxes), hflip_prob=0.0)
    np.testing.assert_array_equal(nb.numpy(), boxes)


# -- the train step ----------------------------------------------------------

def _jax_grads(jcfg, weights, batch):
    """detjax's loss_fn (train/step.py:136-165) and its gradient at step 0."""
    module = j_build_detector(jcfg.model)
    anchors = jnp.asarray(j_anchors_for_shape(HW, j_anchor_config(jcfg)))
    t = jcfg.train

    def loss_fn(params):
        rng = jax.random.fold_in(jax.random.PRNGKey(t.seed), 0)
        images, gt_boxes = j_device_augment.__wrapped__(
            jnp.asarray(batch["images"]), jnp.asarray(batch["gt_boxes"]),
            rng, hflip_prob=jcfg.data.hflip_prob, mean=jcfg.data.mean,
            std=jcfg.data.std)
        cls, box = module.apply({"params": params,
                                 "batch_stats": weights[1]}, images,
                                train=True)
        out = jlosses.detection_loss(cls, box, anchors, gt_boxes,
                                     jnp.asarray(batch["gt_labels"]))
        return out.cls_loss + out.reg_loss

    return jax.value_and_grad(loss_fn)(jax.tree.map(jnp.asarray, weights[0]))


def test_one_step_gradients_match_detjax(weights, jax_flips):
    """Every parameter's gradient, the frozen-BN affine included, mapped
    through the port's own from_jax: within 2e-3 relative plus 1e-4 of the
    tensor's largest gradient (XLA's and oneDNN's fp32 convolutions sum in
    different orders through 18 layers and back)."""
    jcfg, tcfg = _cfgs()
    batch = _batch()
    loss, grads = _jax_grads(jcfg, weights, batch)
    want = from_jax(_np_tree(grads), weights[1], tcfg.model)
    state = _port_state(tcfg, weights)
    got_loss, _ = tstep.compute_gradients(state, batch)
    np.testing.assert_allclose(float(got_loss), float(loss), rtol=1e-5)
    named = dict(state.model.named_parameters())
    bn = [n for n, m in state.model.named_modules()
          if type(m).__name__ == "FrozenBatchNorm2d"]
    assert len(named) == 96 and len(bn) == 20
    assert all(f"{n}.weight" in named and f"{n}.bias" in named for n in bn)
    for name, p in named.items():
        w = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=2e-3,
                                   atol=1e-4 * np.abs(w).max() + 1e-12,
                                   err_msg=name)


def _assert_change_close(name, got, want, start, lr, steps, adam):
    """The change of one parameter tensor over ``steps`` steps, port vs
    detjax: within 1e-3 relative plus 2 % of the tensor's largest change
    plus 2 ulp of the starting value (a change is read as the difference
    of two fp32 parameters). Returns the number of elements that miss;
    those must stay within the 2 * lr * steps that two Adam trajectories
    can drift apart. Adam's step is lr * m / (sqrt(v) + 1e-8), which turns
    a gradient element whose sign is fp32 noise into a full +-lr step."""
    tol = (1e-3 * np.abs(want) + 0.02 * np.abs(want).max()
           + 2 * np.spacing(np.abs(start)))
    bad = np.abs(got - want) > tol
    if bad.any() and not adam:
        raise AssertionError(f"{name}: {int(bad.sum())} elements off by up "
                             f"to {float(np.abs(got - want)[bad].max())}")
    assert (np.abs(got - want)[bad] <= 2 * lr * steps).all(), name
    return int(bad.sum())


@pytest.mark.parametrize("optimizer", ["adam", "sgd", "adamw"])
def test_steps_match_detjax(weights, jax_flips, optimizer):
    """Three steps from the same weights and batch, flips included, at
    lr 1e-3 so that the updates stand out. Loss, cls/reg loss and
    grad_norm per step within 1e-4 relative (fp32 convolutions in another
    order); num_pos equal; the parameters' change after steps 1 and 3 as
    ``_assert_change_close`` states, with at most 1e-4 of all elements
    off for the Adam rules (none for sgd)."""
    assert jax_flips[0] != jax_flips[1]  # both flip branches run
    lr = 1e-3
    jcfg, tcfg = _cfgs(**{"train.optimizer": optimizer,
                          "train.learning_rate": lr})
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
                optimizer != "sgd")
                for name, p in state.model.named_parameters())
            assert off <= 1e-4 * sum(v.size for v in start.values()), off
    assert state.step == 3 and int(jstate.step) == 3


def test_clip_engages_and_every_tensor_moves(weights):
    """grad_norm above 0.1 is clipped to a global norm of 0.1 exactly (up
    to fp32 rounding of the norm); every trainable tensor, the frozen-BN
    affine included, moves; the BN statistics do not."""
    _, tcfg = _cfgs()
    state = _port_state(tcfg, weights)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    launches = km.match_launches
    state, m = detjax_torch.train_step(state, _batch())
    assert km.match_launches == launches  # the CPU runs the plain twin
    assert float(m["grad_norm"]) > 0.1
    norm = torch.sqrt(sum(p.grad.pow(2).sum()
                          for p in state.model.parameters()))
    assert abs(float(norm) - 0.1) < 1e-6
    for name, t in state.model.state_dict().items():
        moved = not torch.equal(t, before[name])
        assert moved == ("running" not in name), name


def test_grad_accum_equals_full_batch(weights, monkeypatch):
    """grad_accum_steps=2 against one full batch, float images (no
    augmentation). The per-image loss normalisation makes them equal up
    to rounding. The model runs in float64 here: in fp32, oneDNN
    convolves a batch of 1 and a batch of 2 with different algorithms,
    whose rounding differs by up to 0.5 % of a tensor's largest gradient
    (layer4 of R18, measured), which would hide a real error. In float64
    the two agree within 1e-12 of each tensor's largest gradient (the
    losses themselves are still reduced in fp32, identically)."""
    from detjax_torch.models import detector

    monkeypatch.setitem(detector._DTYPES, "float32", torch.float64)
    batch = _batch(1)
    batch["images"] = ((batch["images"].astype(np.float64) / 255 - 0.45)
                       / 0.225)
    grads = []
    for accum in (1, 2):
        _, tcfg = _cfgs(**{"train.grad_accum_steps": accum})
        state = _port_state(tcfg, weights)
        state.model.double()
        loss, metrics = tstep.compute_gradients(state, batch)
        grads.append(({n: p.grad.clone()
                       for n, p in state.model.named_parameters()},
                      float(loss), float(metrics["num_pos"])))
    (g1, l1, n1), (g2, l2, n2) = grads
    assert g1["conv1.weight"].dtype == torch.float64
    np.testing.assert_allclose(l2, l1, rtol=1e-6)
    assert n1 == n2
    for name, want in g1.items():
        np.testing.assert_allclose(g2[name].numpy(), want.numpy(), rtol=0,
                                   atol=1e-12 * float(want.abs().max()),
                                   err_msg=name)
    _, tcfg = _cfgs(**{"train.grad_accum_steps": 3})
    with pytest.raises(ValueError, match="divide"):
        tstep.compute_gradients(_port_state(tcfg, weights), batch)


def test_ema_recurrence_and_variables(weights):
    """ema <- ema * d + p * (1 - d) after every step, in fp32, exactly;
    ema_variables loads into a fresh detector."""
    _, tcfg = _cfgs(**{"train.ema_decay": 0.9,
                       "train.learning_rate": 1e-3})
    state = _port_state(tcfg, weights)
    state.ema = {n: p.detach().clone()
                 for n, p in state.model.named_parameters()}
    want = {n: e.clone() for n, e in state.ema.items()}
    d, one_minus = np.float32(0.9), np.float32(1) - np.float32(0.9)
    for _ in range(2):
        state, _ = detjax_torch.train_step(state, _batch())
        for n, p in state.model.named_parameters():
            want[n] = want[n] * float(d) + p.detach() * float(one_minus)
    for n, e in state.ema.items():
        assert torch.equal(e, want[n]), n
    fresh = Detector(tcfg.model)
    fresh.load_state_dict(tstep.ema_variables(state), strict=True)
    assert torch.equal(fresh.conv1.weight, state.ema["conv1.weight"])
    _, plain = _cfgs()
    assert detjax_torch.make_train_state(plain, device="cpu").ema is None


def test_learning_rate_controls(weights):
    """set/get_learning_rate through param_groups; lr 0 freezes Adam;
    the cosine schedule is optax's, counted from the first update."""
    _, tcfg = _cfgs()
    state = _port_state(tcfg, weights)
    assert tstep.get_learning_rate(state) == tcfg.train.learning_rate
    tstep.set_learning_rate(state, 0.0)
    assert tstep.get_learning_rate(state) == 0.0
    before = state.model.conv1.weight.detach().clone()
    detjax_torch.train_step(state, _batch())
    assert torch.equal(state.model.conv1.weight, before)

    _, ccfg = _cfgs(**{"train.lr_schedule": "cosine",
                       "train.learning_rate": 1e-3})
    sched = optax.cosine_decay_schedule(1e-3, 10_000_000)
    for count in (0, 1, 2_500_000, 10_000_000, 12_000_000):
        np.testing.assert_allclose(tstep._scheduled_lr(ccfg, count),
                                   float(sched(count)), rtol=1e-6)
    assert tstep._scheduled_lr(tcfg, 5) is None


@pytest.mark.parametrize("knob,value", [
    ("dot_1x1", "dw"), ("remat_early", 2), ("f8_remat_stages", 1),
])
def test_unported_training_knobs_raise(knob, value):
    _, tcfg = _cfgs(**{f"model.{knob}": value})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        detjax_torch.make_train_state(tcfg, device="cpu")


def test_frozen_bn_affine_is_trainable_and_serving_is_frozen():
    _, tcfg = _cfgs()
    served = detjax_torch.build_model(tcfg, device="cpu")
    assert not any(p.requires_grad for p in served.parameters())
    bn = served.layer1[0].bn1
    assert {n for n, _ in bn.named_parameters()} == {"weight", "bias"}
    assert {n for n, _ in bn.named_buffers()} == {"running_mean",
                                                  "running_var"}
    state = detjax_torch.make_train_state(tcfg, device="cpu")
    assert all(p.requires_grad for p in state.model.parameters())
