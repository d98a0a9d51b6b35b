"""PyTorch port vs detjax: config, anchors, box ops, the NMS twin and
candidate selection, on the CPU at small sizes.

The same numpy inputs, made from a seed, go through detjax's function and
the port's. Equal means bit-equal unless a test states a tolerance.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from detjax import config as jconfig
from detjax.kernels.postprocess import nms_pallas
from detjax.modeling import anchor_config as j_anchor_config
from detjax.ops import anchors as janchors
from detjax.ops import boxes as jboxes
from detjax.ops import nms as jnms

from detjax_torch import config as tconfig
from detjax_torch.kernels.postprocess import nms_cuda, nms_reference
from detjax_torch.modeling import anchor_config as t_anchor_config
from detjax_torch.ops import anchors as tanchors
from detjax_torch.ops import boxes as tboxes
from detjax_torch.ops import nms as tnms

# One intra-op thread a process: pytest-xdist runs several workers on
# the host's cores, and torch's default of a thread a core in each
# worker oversubscribes them many times over.
torch.set_num_threads(1)

OFFSET = 642.0  # max(640, 640) + 2, the class offset at 640 canvases


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("preset", sorted(jconfig.PRESETS))
def test_config_presets_equal(preset):
    ovr = {"eval.pre_nms_top_k": 512, "model.num_classes": 7}
    assert (dataclasses.asdict(tconfig.get_config(preset, **ovr))
            == dataclasses.asdict(jconfig.get_config(preset, **ovr)))


@pytest.mark.parametrize("preset,hw", [
    ("retinanet_r50_640", (640, 640)),
    ("retinanet_r50_640", (608, 832)),
    ("retinanet_r50_640", (96, 130)),
    ("ssd_512", (512, 512)),
    ("retinanet_r50_1024", (1024, 1024)),
])
def test_anchors_bit_equal(preset, hw):
    jcfg, tcfg = jconfig.get_config(preset), tconfig.get_config(preset)
    want = janchors.anchors_for_shape(hw, j_anchor_config(jcfg))
    got = tanchors.anchors_for_shape(hw, t_anchor_config(tcfg))
    np.testing.assert_array_equal(got, want)
    assert got.shape[0] == tanchors.num_anchors(hw, t_anchor_config(tcfg))


def test_flagship_anchor_count():
    cfg = tconfig.get_config("retinanet_r50_640")
    assert tanchors.num_anchors((640, 640), t_anchor_config(cfg)) == \
        9 * (80 ** 2 + 40 ** 2 + 20 ** 2 + 10 ** 2 + 5 ** 2) == 76725


def _boxes(rng, n, span=600.0, min_wh=-5.0):
    xy = rng.uniform(0, span, (n, 2))
    wh = rng.uniform(min_wh, 120, (n, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def test_box_ops_bit_equal(rng):
    a, b = _boxes(rng, 50), _boxes(rng, 70, min_wh=1.0)
    d = rng.normal(0, 1, (70, 4)).astype(np.float32)
    np.testing.assert_array_equal(tboxes.box_area(_t(a)).numpy(),
                                  np.asarray(jboxes.box_area(a)))
    np.testing.assert_array_equal(tboxes.box_iou(_t(a), _t(b)).numpy(),
                                  np.asarray(jboxes.box_iou(a, b)))
    np.testing.assert_array_equal(
        tboxes.decode_boxes(_t(d), _t(b), (0.1, 0.1, 0.2, 0.2)).numpy(),
        np.asarray(jboxes.decode_boxes(d, b, (0.1, 0.1, 0.2, 0.2))))
    big = a * 1.5 - 100.0
    np.testing.assert_array_equal(
        tboxes.clip_boxes(_t(big), (480, 640)).numpy(),
        np.asarray(jboxes.clip_boxes(big, (480, 640))))


def _nms_case(kind, rng, b=3, n=300, k=20):
    """NMS inputs: random, tied, pre-suppressed or empty."""
    centers = rng.uniform(0, 600, (b, 12, 2))
    c = np.take_along_axis(centers, rng.integers(0, 12, (b, n, 1)), 1)
    c = c + rng.normal(0, 5, (b, n, 2))
    wh = rng.uniform(10, 90, (b, n, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    scores = rng.uniform(0.05, 1, (b, n)).astype(np.float32)
    labels = rng.integers(0, k, (b, n)).astype(np.int32)
    labels[:, : n // 2] = rng.integers(0, 2, (b, n // 2))
    if kind == "tied":
        scores = np.round(scores, 1)  # ~10 bit-equal tie blocks
        boxes[:, n // 2:] = boxes[:, : n - n // 2]  # duplicate boxes too
    elif kind == "presuppressed":
        scores[rng.uniform(size=(b, n)) < 0.4] = jnms.NEG_INF
        scores[1, 10:] = jnms.NEG_INF  # runs out before max_det
    elif kind == "empty":
        scores[:] = jnms.NEG_INF
    return boxes, scores, labels


@pytest.mark.parametrize("kind", ["random", "tied", "presuppressed", "empty"])
def test_nms_twin_bit_equal_to_detjax(kind, rng):
    """The port's plain twin (the CPU route of ``nms_cuda``) keeps exactly
    what detjax's lax twin and its Pallas kernel keep, bit for bit."""
    boxes, scores, labels = _nms_case(kind, rng)
    got_i, got_s = nms_cuda(_t(boxes), _t(scores), _t(labels), 0.5, 100,
                            OFFSET)
    off = boxes + (labels.astype(np.float32) * np.float32(OFFSET))[..., None]
    lax_i, lax_s = jax.vmap(
        lambda bx, s: jnms._greedy_suppress(bx, s, 0.5, 100))(
            jnp.asarray(off), jnp.asarray(scores))
    pal_i, pal_s = nms_pallas(jnp.asarray(boxes), jnp.asarray(scores),
                              jnp.asarray(labels), 0.5, 100, OFFSET,
                              interpret=True)
    for want_i, want_s in ((lax_i, lax_s), (pal_i, pal_s)):
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    if kind == "empty":
        assert (got_i.numpy() == -1).all()
    else:
        assert (got_i.numpy() >= 0).sum() > 50


def test_nms_reference_is_offset_plus_greedy(rng):
    boxes, scores, labels = _nms_case("random", rng)
    i1, s1 = nms_reference(_t(boxes), _t(scores), _t(labels), 0.5, 60,
                           OFFSET)
    off = _t(boxes) + (_t(labels).float() * OFFSET)[..., None]
    i2, s2 = tnms._greedy_suppress(off, _t(scores), 0.5, 60)
    assert torch.equal(i1, i2) and torch.equal(s1, s2)


def test_nms_cuda_rejects_bad_shapes():
    boxes = torch.zeros(2, 5, 4)
    with pytest.raises(ValueError, match="boxes must be"):
        nms_cuda(torch.zeros(2, 5, 3), torch.zeros(2, 5),
                 torch.zeros(2, 5, dtype=torch.int32))
    with pytest.raises(ValueError, match="scores and labels"):
        nms_cuda(boxes, torch.zeros(2, 4), torch.zeros(2, 5,
                                                       dtype=torch.int32))
    with pytest.raises(ValueError, match="max_det"):
        nms_cuda(boxes, torch.zeros(2, 5), torch.zeros(2, 5,
                                                       dtype=torch.int32),
                 max_det=-1)


def _select_inputs(rng, b=2, a=300, k=8):
    anchors = _boxes(rng, a, span=240.0, min_wh=8.0)
    deltas = rng.normal(0, 0.4, (b, a, 4)).astype(np.float32)
    logits = rng.normal(-3, 2.5, (b, a, k)).astype(np.float32)
    logits[0, :40] = np.round(logits[0, :40])  # exact ties
    return deltas, anchors, logits


@pytest.mark.parametrize("two_stage", [False, True])
@pytest.mark.parametrize("threshold", [0.0, 0.05, 1.0])
@pytest.mark.parametrize("scores_are_logits", [True, False])
def test_select_candidates_equal(two_stage, threshold, scores_are_logits,
                                 rng, monkeypatch):
    """Both branches (exact; two-stage with ``_EXACT_PAIRS_MAX`` patched to
    0 on both sides) and the threshold extremes give the same candidates:
    labels and the -1e10 sentinel bit-equal, sigmoid scores and decoded
    boxes within 1 ulp-scale atol (XLA and ATen sigmoid may round apart)."""
    if two_stage:
        monkeypatch.setattr(jnms, "_EXACT_PAIRS_MAX", 0)
        monkeypatch.setattr(tnms, "_EXACT_PAIRS_MAX", 0)
    deltas, anchors, logits = _select_inputs(rng)
    scores = logits if scores_are_logits else 1 / (1 + np.exp(-logits))
    scores = scores.astype(np.float32)
    args = ((0.1, 0.1, 0.2, 0.2), (256, 256), threshold, 64, False,
            scores_are_logits)
    jb, js, jl = jax.vmap(lambda d, s: jnms._select_candidates(
        d, jnp.asarray(anchors), s, *args))(jnp.asarray(deltas),
                                            jnp.asarray(scores))
    tb, ts, tl = tnms._select_candidates(_t(deltas), _t(anchors),
                                         _t(scores), *args)
    js, jl, jb = np.asarray(js), np.asarray(jl), np.asarray(jb)
    np.testing.assert_array_equal(tl.numpy(), jl)
    np.testing.assert_array_equal(ts.numpy() <= -5e9, js <= -5e9)
    np.testing.assert_allclose(ts.numpy(), js, rtol=0, atol=1e-7)
    np.testing.assert_allclose(tb.numpy(), jb, rtol=0, atol=1e-4)
    live = (js > -5e9).sum()
    if threshold >= 1.0:
        assert live == 0
    elif threshold <= 0.0:
        assert live == js.size


def test_select_candidates_bf16_logits_match(rng, monkeypatch):
    """bf16 logits: the threshold is compared in bf16, as detjax does."""
    monkeypatch.setattr(jnms, "_EXACT_PAIRS_MAX", 0)
    monkeypatch.setattr(tnms, "_EXACT_PAIRS_MAX", 0)
    deltas, anchors, logits = _select_inputs(rng)
    jl16 = jnp.asarray(logits).astype(jnp.bfloat16)
    tl16 = _t(logits).to(torch.bfloat16)
    args = ((0.1, 0.1, 0.2, 0.2), (256, 256), 0.05, 64, False, True)
    _, js, jl = jax.vmap(lambda d, s: jnms._select_candidates(
        d, jnp.asarray(anchors), s, *args))(jnp.asarray(deltas), jl16)
    _, ts, tl = tnms._select_candidates(_t(deltas), _t(anchors), tl16, *args)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-7)


def test_fused_postprocess_backends(rng):
    deltas, anchors, logits = _select_inputs(rng)
    kw = dict(image_size=(256, 256), num_candidates=64, max_detections=20,
              scores_are_logits=True)
    auto = tnms.fused_detect_postprocess(_t(deltas), _t(anchors),
                                         _t(logits), **kw)
    twin = tnms.fused_detect_postprocess(_t(deltas), _t(anchors),
                                         _t(logits), backend="torch", **kw)
    for a, b in zip(auto, twin):
        assert torch.equal(a, b)
    assert auto.num_valid.min() > 0
    with pytest.raises(ValueError, match="backend"):
        tnms.fused_detect_postprocess(_t(deltas), _t(anchors), _t(logits),
                                      backend="pallas", **kw)
    with pytest.raises(ValueError, match="topk"):
        tnms.fused_detect_postprocess(_t(deltas), _t(anchors), _t(logits),
                                      topk="approx", **kw)
