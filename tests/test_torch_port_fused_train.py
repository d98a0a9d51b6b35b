"""PyTorch port vs detjax: one training step's loss and gradients with
``model.fused_backbone="on"``, on the CPU.

R50 at 128 px, batch 1, bf16, 6 classes, FPN and head width 32, every
BatchNorm's scale, bias, mean and var drawn away from identity so that the
fold matters. detjax's fused blocks run its Pallas forward and backward in
interpret mode, as its own tests run them (about a minute here, the cost
of this file); the port's run their CPU twins through ``_FusedBottleneck``.
Both get the same weights (the port's ``from_jax``) and the same flip mask.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from detjax.config import get_config as j_get_config
from detjax.data.pipeline import device_augment as j_device_augment
from detjax.modeling import anchor_config as j_anchor_config
from detjax.modeling import build_model as j_build_model
from detjax.models.detector import build_detector as j_build_detector
from detjax.ops import losses as jlosses
from detjax.ops.anchors import anchors_for_shape as j_anchors_for_shape

import detjax_torch
from detjax_torch.data.synthetic import SyntheticDetectionDataset
from detjax_torch.data.transforms import pad_annotations
from detjax_torch.kernels import bottleneck as kb
from detjax_torch.train import step as tstep
from detjax_torch.utils.weights import from_jax

# One intra-op thread a process: pytest-xdist runs several workers on
# the host's cores, and torch's default of a thread a core in each
# worker oversubscribes them many times over.
torch.set_num_threads(1)

HW = (128, 128)
_OVR = {"model.image_size": HW, "model.num_classes": 6,
        "model.dtype": "bfloat16", "model.fpn_channels": 32,
        "model.head_channels": 32, "model.backbone_depth": 50,
        "model.fused_backbone": "on", "train.batch_size": 1,
        "train.max_gt": 5}


def _perturbed_variables(jcfg, seed):
    """detjax's seeded variables with every BatchNorm's scale, bias, mean
    and var drawn away from identity, as numpy trees."""
    _, variables = j_build_model(jcfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    lo_hi = {"scale": (0.5, 1.5), "var": (0.5, 1.5)}

    def perturb(path, leaf):
        name = getattr(path[-1], "key", "")
        inside_bn = any("bn" in str(getattr(p, "key", "")) for p in path)
        leaf = np.asarray(leaf)
        if not inside_bn or name not in ("scale", "bias", "mean", "var"):
            return leaf
        if name in lo_hi:
            return rng.uniform(*lo_hi[name], leaf.shape).astype(np.float32)
        return rng.normal(0, 0.1, leaf.shape).astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(perturb, jax.device_get(
        {"params": variables["params"],
         "batch_stats": variables["batch_stats"]}))
    return tree["params"], tree["batch_stats"]


def _batch(seed=0):
    ds = SyntheticDetectionDataset(1, HW, 6, max_objects=4, seed=seed,
                                   size_range=(0.2, 0.6))
    rec = ds[0]
    boxes, labels = pad_annotations(rec["boxes"], rec["labels"], 5)
    return {"images": rec["image"][None], "gt_boxes": boxes[None],
            "gt_labels": labels[None]}


def _step(fused_backbone, params, stats, batch):
    """detjax's loss and gradients at step 0 (value_and_grad of its
    loss_fn, train/step.py:136-165) and the port's from one
    compute_gradients, on the same weights, batch and flip mask, with
    ``model.fused_backbone`` set on both sides."""
    ovr = {**_OVR, "model.fused_backbone": fused_backbone}
    jcfg = j_get_config("retinanet_r50_640", **ovr)
    tcfg = detjax_torch.get_config("retinanet_r50_640", **ovr)
    module = j_build_detector(jcfg.model)
    anchors = jnp.asarray(j_anchors_for_shape(HW, j_anchor_config(jcfg)))
    rng = jax.random.fold_in(jax.random.PRNGKey(jcfg.train.seed), 0)
    flip = np.array(jax.random.bernoulli(rng, jcfg.data.hflip_prob, (1,)))

    def loss_fn(p):
        images, gt_boxes = j_device_augment.__wrapped__(
            jnp.asarray(batch["images"]), jnp.asarray(batch["gt_boxes"]),
            rng, hflip_prob=jcfg.data.hflip_prob, mean=jcfg.data.mean,
            std=jcfg.data.std)
        cls, box = module.apply({"params": p, "batch_stats": stats}, images,
                                train=True)
        out = jlosses.detection_loss(cls, box, anchors, gt_boxes,
                                     jnp.asarray(batch["gt_labels"]))
        return out.cls_loss + out.reg_loss

    loss, grads = jax.value_and_grad(loss_fn)(
        jax.tree.map(jnp.asarray, params))
    want = from_jax(jax.tree.map(np.asarray, jax.device_get(grads)), stats,
                    tcfg.model)

    state = detjax_torch.make_train_state(tcfg, seed=5, device="cpu")
    state.model.load_state_dict(from_jax(params, stats, tcfg.model),
                                strict=True)
    saved = tstep.flip_mask
    tstep.flip_mask = lambda cfg, step, b: torch.from_numpy(flip)
    try:
        got_loss, _ = tstep.compute_gradients(state, batch)
    finally:
        tstep.flip_mask = saved
    got = {n: p.grad.numpy() for n, p in state.model.named_parameters()}
    return {"loss": float(loss), "got_loss": float(got_loss),
            "want": {n: want[n].numpy() for n in got}, "got": got,
            "fused_blocks": len(state.model.fused_blocks())}


@pytest.fixture(scope="module")
def steps():
    """One step with "on" and, as the yardstick of bf16 noise between the
    two frameworks, one with "off", from the same weights and batch; the
    fused kernels' launch counters do not move (CPU tensors run the
    twins)."""
    jcfg = j_get_config("retinanet_r50_640", **_OVR)
    params, stats = _perturbed_variables(jcfg, 3)
    batch = _batch()
    launches = (kb.bottleneck_launches, kb.bottleneck_bwd_launches)
    out = {fb: _step(fb, params, stats, batch) for fb in ("on", "off")}
    assert (kb.bottleneck_launches, kb.bottleneck_bwd_launches) == launches
    return out


def _rel(step) -> dict:
    """Per tensor, |port - detjax| / |detjax| in the 2-norm."""
    return {n: float(np.linalg.norm(g - step["want"][n])
                     / max(np.linalg.norm(step["want"][n]), 1e-30))
            for n, g in step["got"].items()}


def test_fused_loss_matches_detjax_fused(steps):
    """The step's loss within 1e-2 relative: bf16 rounds at other places in
    the two frameworks' unfused blocks (BN applied in bf16 here, in flax's
    order there), and the forward twin sums fp32 in another order than
    detjax's Pallas kernel."""
    on = steps["on"]
    assert on["fused_blocks"] == 5
    assert np.isfinite(on["got_loss"])
    np.testing.assert_allclose(on["got_loss"], on["loss"], rtol=1e-2)


FUSED_PREFIXES = ("layer1.0.", "layer1.1.", "layer1.2.", "layer2.1.",
                  "layer2.2.", "layer2.3.")


def test_fused_gradients_match_detjax_fused(steps):
    """Every parameter's gradient (195 tensors, the fused blocks' frozen-BN
    affines included) against detjax's, no further from it with "on" than
    the port's unfused path is from detjax's unfused path on the same
    weights: 1.25 x that yardstick plus 0.02, in the median over all
    tensors and in the mean over the fused blocks' and layer1.0's tensors
    of |port - detjax| / |detjax| (2-norms).

    Why not 0.05 x max|ref| per tensor: in bf16 at R50 that bar fails for
    184 of the 195 tensors with "off" as well (median 2-norm error near
    35 %): both frameworks round every activation and gradient to bf16 in
    other places, which flips ReLU masks of near-zero activations and
    compounds through 50 layers and back. A fused backward that was wrong
    (a missed mask, a dropped halo row, gradients of the folded weights
    not carried through the fold) moves these errors to order 1."""
    on, off = _rel(steps["on"]), _rel(steps["off"])
    assert len(on) == len(off) == 195
    for name, g in steps["on"]["got"].items():
        assert np.isfinite(g).all() and np.abs(g).max() > 0, name
    med_on, med_off = np.median(list(on.values())), np.median(
        list(off.values()))
    assert med_on <= 1.25 * med_off + 0.02, (med_on, med_off)
    fused = [n for n in on if n.startswith(FUSED_PREFIXES)]
    assert len(fused) == 57
    mean_on = np.mean([on[n] for n in fused])
    mean_off = np.mean([off[n] for n in fused])
    assert mean_on <= 1.25 * mean_off + 0.02, (mean_on, mean_off)
