"""``retinanet_r101_fpn`` (benchmark config 4) in the port against
detjax's, on the CPU: the full 3-4-23-3 ResNet-101 under a narrow FPN and
head (width 32, one tower conv) on 64-px canvases, fp32, detjax's weights
carried by the port's ``from_jax``, inputs from a numpy seed. detjax's
fp32 R101 runs here on the CPU (on a TPU its fp32 detect crashes the
worker). The bars are those of ``tests/test_torch_port_model.py``
(forward), ``test_torch_port_detect.py`` (keep-sets) and
``test_torch_port_train.py`` (one step)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from detjax import modeling as jmodeling
from detjax.config import get_config as j_get_config
from detjax.data.pipeline import device_augment as j_device_augment
from detjax.models.detector import build_detector as j_build_detector
from detjax.ops import losses as jlosses
from detjax.ops.anchors import anchors_for_shape as j_anchors_for_shape
from detjax.utils import torch_import as j_torch_import

import detjax_torch
from detjax_torch.train import step as tstep
from detjax_torch.utils.weights import from_jax

# One intra-op thread a process: pytest-xdist runs several workers on
# the host's cores, and torch's default of a thread a core in each
# worker oversubscribes them many times over.
torch.set_num_threads(1)

HW = (64, 64)
_OVR = {"model.image_size": HW, "model.num_classes": 6,
        "model.dtype": "float32", "model.fpn_channels": 32,
        "model.head_channels": 32, "model.num_head_convs": 1,
        "eval.pre_nms_top_k": 300, "eval.max_detections": 60,
        "train.batch_size": 2, "train.max_gt": 4}


def _np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


@pytest.fixture(scope="module")
def pair():
    """detjax's R101 variables and the port's model on the same weights.
    Each block's last BatchNorm scale is drawn in [0.1, 0.3], as a trained
    ResNet's are small: at detjax's identity init the 33 residual sums
    grow the logits to about 3e4, where both frameworks' fp32 forwards lie
    0.05-0.08 from an fp64 one, above the bars' absolute terms. The class
    output is perturbed so that a sparse set of scores clears the 0.05
    floor without saturating the fp32 sigmoid (the recipe of
    test_torch_port_detect.py)."""
    rng = np.random.default_rng(5)
    jcfg = j_get_config("retinanet_r101_fpn", **_OVR)
    tcfg = detjax_torch.get_config("retinanet_r101_fpn", **_OVR)
    assert tcfg.model.backbone_depth == 101
    _, variables = jmodeling.build_model(jcfg, jax.random.PRNGKey(3))
    sd = dict(j_torch_import.export_full_detector(
        variables["params"], variables["batch_stats"], depth=101,
        num_head_convs=1))
    for key in sd:
        if key.endswith("bn3.weight"):
            sd[key] = rng.uniform(0.1, 0.3, sd[key].shape).astype(np.float32)
    w = "classificationModel.output.weight"
    b = "classificationModel.output.bias"
    sd[w] = (sd[w] + rng.normal(0, 0.08, sd[w].shape)).astype(np.float32)
    sd[b] = (sd[b] + rng.normal(0, 1.2, sd[b].shape)).astype(np.float32)
    r = "regressionModel.output.weight"
    sd[r] = (sd[r] * 3.0).astype(np.float32)
    variables = _np_tree(j_torch_import.import_detector_into_variables(
        variables, sd, depth=101, num_head_convs=1))
    model = detjax_torch.build_model(tcfg, seed=0, device="cpu")
    model.load_state_dict(from_jax(variables["params"],
                                   variables["batch_stats"], tcfg.model),
                          strict=True)
    return dict(jcfg=jcfg, tcfg=tcfg, variables=variables, model=model,
                sd=sd, canvases=rng.integers(0, 256, (2, *HW, 3), np.uint8))


def test_r101_from_jax_and_forward_match_detjax(pair):
    """``from_jax`` equals detjax's ``export_full_detector`` key for key
    (the 23 blocks of layer3 included); logits and deltas at fp32 within
    atol/rtol 5e-4 (the bar of test_torch_port_model.py)."""
    variables, tcfg = pair["variables"], pair["tcfg"]
    sd = from_jax(variables["params"], variables["batch_stats"], tcfg.model)
    assert sorted(sd) == sorted(pair["sd"])
    assert "layer3.22.conv3.weight" in sd
    for key, want in pair["sd"].items():
        np.testing.assert_array_equal(sd[key].numpy(), want, err_msg=key)
    x = np.random.default_rng(0).normal(0, 1, (2, *HW, 3)).astype(np.float32)
    j_cls, j_box = jax.jit(j_build_detector(pair["jcfg"].model).apply)(
        variables, jnp.asarray(x))
    with torch.no_grad():
        t_cls, t_box = pair["model"](torch.from_numpy(x).permute(0, 3, 1, 2))
    assert t_cls.shape == j_cls.shape == (2, 774, 6)
    np.testing.assert_allclose(t_cls.numpy(), np.asarray(j_cls), atol=5e-4,
                               rtol=5e-4)
    np.testing.assert_allclose(t_box.numpy(), np.asarray(j_box), atol=5e-4,
                               rtol=5e-4)


def test_r101_detect_u8_matches_detjax(pair):
    """Identical keep-sets (labels and order), scores within atol 2e-5,
    boxes within atol 5e-3 (the bars of test_torch_port_detect.py)."""
    want = _np_tree(jmodeling.detect_u8(pair["variables"], pair["canvases"],
                                        pair["jcfg"]))
    got = detjax_torch.detect_u8(pair["model"], pair["canvases"],
                                 pair["tcfg"])
    assert want.num_valid.min() > 10, "too few detections to be a test"
    np.testing.assert_array_equal(got.num_valid.numpy(), want.num_valid)
    np.testing.assert_array_equal(got.labels.numpy(), want.labels)
    np.testing.assert_allclose(got.scores.numpy(), want.scores, rtol=0,
                               atol=2e-5)
    np.testing.assert_allclose(got.boxes.numpy(), want.boxes, rtol=0,
                               atol=5e-3)


def test_r101_one_step_gradients_match_detjax(pair, monkeypatch):
    """detjax's loss and gradient at step 0 (its loss_fn with the flip mask
    it draws) against the port's ``compute_gradients``: the loss within
    1e-5 relative, every gradient of the 101 layers, the frozen-BN affines
    included, within 2e-3 relative plus 1e-4 of the tensor's largest
    (test_torch_port_train.py's bars)."""
    jcfg, tcfg, variables = pair["jcfg"], pair["tcfg"], pair["variables"]
    rng = np.random.default_rng(1)
    c = rng.uniform(10, 54, (2, 4, 2))
    wh = rng.uniform(12, 40, (2, 4, 2))
    batch = {"images": rng.integers(0, 256, (2, *HW, 3), np.uint8),
             "gt_boxes": np.concatenate([c - wh / 2, c + wh / 2],
                                        -1).astype(np.float32),
             "gt_labels": np.array([[0, 3, 5, -1], [2, 2, -1, -1]],
                                   np.int32)}
    module = j_build_detector(jcfg.model)
    anchors = jnp.asarray(j_anchors_for_shape(HW,
                                              jmodeling.anchor_config(jcfg)))
    key = jax.random.fold_in(jax.random.PRNGKey(jcfg.train.seed), 0)
    flip = np.array(jax.random.bernoulli(key, jcfg.data.hflip_prob, (2,)))
    monkeypatch.setattr(tstep, "flip_mask",
                        lambda cfg, step, b: torch.from_numpy(flip))

    def loss_fn(params):
        images, gt_boxes = j_device_augment.__wrapped__(
            jnp.asarray(batch["images"]), jnp.asarray(batch["gt_boxes"]),
            key, hflip_prob=jcfg.data.hflip_prob, mean=jcfg.data.mean,
            std=jcfg.data.std)
        cls, box = module.apply({"params": params,
                                 "batch_stats": variables["batch_stats"]},
                                images, train=True)
        out = jlosses.detection_loss(cls, box, anchors, gt_boxes,
                                     jnp.asarray(batch["gt_labels"]))
        return out.cls_loss + out.reg_loss, out.metrics["num_pos"]

    (loss, num_pos), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jax.tree.map(jnp.asarray,
                                             variables["params"]))
    assert float(num_pos) > 0
    want = from_jax(_np_tree(grads), variables["batch_stats"], tcfg.model)
    state = detjax_torch.make_train_state(tcfg, seed=5, device="cpu")
    state.model.load_state_dict(pair["model"].state_dict(), strict=True)
    got_loss, metrics = tstep.compute_gradients(state, batch)
    np.testing.assert_allclose(float(got_loss), float(loss), rtol=1e-5)
    assert float(metrics["num_pos"]) == float(num_pos)
    named = dict(state.model.named_parameters())
    assert len(named) == 336  # 312 backbone, 16 FPN, 8 head
    for name, p in named.items():
        w = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=2e-3,
                                   atol=1e-4 * np.abs(w).max() + 1e-12,
                                   err_msg=name)
