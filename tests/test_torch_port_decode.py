"""PyTorch port vs detjax on the full-anchor-set eval branch, on the CPU:
decode + clip of every anchor (the plain twin of the CUDA decode kernel)
and the per-class NMS ops (``nms_single_class``, ``class_aware_nms``,
``batched_detect_postprocess``), then the whole branch at R18, 128 px.

Decode tolerance: every coordinate within 4 ulps of its box's largest
|coordinate|. XLA's and ATen's CPU ``exp`` differ in the last bit on about
9 % of inputs, which moves a decoded coordinate by 1 ulp against detjax's
jnp path and by 2 against its Pallas kernel in interpret mode (detjax's
own two paths differ by 2). The NMS ops take identical fp32 inputs and
must return the same indices and bit-equal scores and boxes.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from detjax.kernels.postprocess import decode_boxes_pallas
from detjax.models.detector import build_detector as j_build_detector
from detjax.modeling import anchor_config as j_anchor_config
from detjax.data.pipeline import normalize_u8 as j_normalize_u8
from detjax.ops import boxes as jboxes
from detjax.ops import nms as jnms
from detjax.ops.anchors import anchors_for_shape as j_anchors_for_shape

import detjax.ops
import detjax_torch.ops
from detjax_torch.data.pipeline import normalize_u8
from detjax_torch.kernels import postprocess as pp
from detjax_torch.modeling import anchor_config
from detjax_torch.ops import boxes as tboxes
from detjax_torch.ops import nms as tnms
from detjax_torch.ops.anchors import anchors_for_shape

from tests.test_torch_port_detect import pair  # noqa: F401  (fixture)

# One intra-op thread a process: pytest-xdist runs several workers on
# the host's cores, and torch's default of a thread a core in each
# worker oversubscribes them many times over.
torch.set_num_threads(1)

STD = (0.1, 0.1, 0.2, 0.2)
CANVAS = (640, 640)


def _anchors_640():
    import detjax_torch

    cfg = detjax_torch.get_config("retinanet_r50_640")
    return anchors_for_shape(cfg.model.image_size, anchor_config(cfg))


def _deltas(seed, b, n):
    """Seeded deltas: most near 0, some large enough that boxes leave the
    canvas and the clip binds."""
    rng = np.random.default_rng(seed)
    d = rng.normal(0, 1.0, (b, n, 4))
    d[:, ::7] *= 6.0
    return d.astype(np.float32)


def _within_ulps(got, want, ulps=4):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    bar = ulps * np.spacing(np.abs(want).max(axis=-1, keepdims=True))
    worst = (np.abs(got - want) / bar).max()
    assert worst <= 1.0, f"off by {worst * ulps:.2f} ulps of the box's max"


def test_anchor_set_is_detjax_s():
    import detjax_torch

    cfg = detjax_torch.get_config("retinanet_r50_640")
    from detjax.config import get_config as j_get_config

    want = j_anchors_for_shape(CANVAS, j_anchor_config(
        j_get_config("retinanet_r50_640")))
    np.testing.assert_array_equal(_anchors_640(), want)
    assert want.shape == (76725, 4)
    assert cfg.model.box_std == STD


@pytest.mark.parametrize("clip", [True, False])
def test_decode_twin_matches_detjax_jnp(clip):
    """The kernel's twin (``decode_clip_boxes(backend="cuda")`` routes a CPU
    tensor to it) and the "torch" branch against detjax's jnp path on the
    640 anchor set at B = 2, fp32."""
    anchors = _anchors_640()
    deltas = _deltas(0, 2, anchors.shape[0])
    if clip:
        want = jboxes.decode_clip_boxes(jnp.asarray(deltas),
                                        jnp.asarray(anchors), CANVAS, STD,
                                        backend="jnp")
        routes = [tboxes.decode_clip_boxes(torch.from_numpy(deltas),
                                           torch.from_numpy(anchors), CANVAS,
                                           STD, backend=b)
                  for b in ("cuda", "torch", "auto")]
    else:
        want = jboxes.decode_boxes(jnp.asarray(deltas), jnp.asarray(anchors),
                                   STD)
        routes = [pp.decode_boxes_cuda(torch.from_numpy(deltas),
                                       torch.from_numpy(anchors), STD)]
    for got in routes:
        assert got.dtype == torch.float32
        _within_ulps(got.numpy(), want)
    if clip:
        g = routes[0].numpy()
        assert (g >= 0).all() and (g[..., 0::2] <= 640).all()
        assert (g == 0).any() and (g == 640).any(), "the clip never bound"


@pytest.mark.parametrize("clip", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_twin_matches_detjax_pallas_interpret(clip, dtype):
    """The twin against ``decode_boxes_pallas`` in interpret mode, the TPU
    kernel it replaces, at B = 2 over the 640 anchor set; both cast bf16
    deltas to fp32 first."""
    anchors = _anchors_640()
    deltas = _deltas(1, 2, anchors.shape[0])
    jd = jnp.asarray(deltas).astype(dtype)
    td = torch.from_numpy(deltas).to(getattr(torch, dtype))
    size = CANVAS if clip else None
    want = decode_boxes_pallas(jd, jnp.asarray(anchors), STD,
                               image_size=size, interpret=True)
    got = pp.decode_boxes_reference(td, torch.from_numpy(anchors), STD, size)
    _within_ulps(got.numpy(), want)


def test_decode_twin_keeps_nan_and_inf_as_detjax_does():
    """Hard rows: dw large enough that exp overflows to inf (and an inf - inf
    corner), a NaN delta, anchors on the canvas edge; the clip keeps NaN
    and sends +-inf to the bounds, as jnp.clip does."""
    anchors = np.array([[0, 0, 32, 32], [608, 608, 640, 640],
                        [-16, 300, 16, 332], [100, 100, 164, 132],
                        [0, 0, 640, 640]], np.float32)
    deltas = np.array([[[0, 0, 500, -500], [0, 0, 80, -80],
                        [np.nan, 0, 0, 0], [1e38, 0, 500, 0],
                        [0, np.nan, 0, 500]]], np.float32)
    for size in (CANVAS, None):
        want = np.asarray(decode_boxes_pallas(
            jnp.asarray(deltas), jnp.asarray(anchors), STD, image_size=size,
            interpret=True))
        got = pp.decode_boxes_reference(torch.from_numpy(deltas),
                                        torch.from_numpy(anchors), STD,
                                        size).numpy()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        assert np.isnan(got).any()
        fin = np.isfinite(want)
        np.testing.assert_array_equal(got[~fin & ~np.isnan(want)],
                                      want[~fin & ~np.isnan(want)])
        np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=0)


def test_ops_export_detjax_s_names():
    assert sorted(detjax_torch.ops.__all__) == sorted(detjax.ops.__all__)
    for name in detjax.ops.__all__:
        assert callable(getattr(detjax_torch.ops, name)), name


# -- per-class NMS ------------------------------------------------------------

def _boxes_scores(rng, n, span=200.0):
    xy = rng.uniform(0, span, (n, 2))
    wh = rng.uniform(10, 80, (n, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    scores = rng.uniform(0.01, 1.0, (n,)).astype(np.float32)
    return boxes, scores


def _single_cases():
    rng = np.random.default_rng(3)
    golden = (np.array([[0, 0, 10, 10], [1, 1, 11, 11], [50, 50, 60, 60],
                        [0, 0, 10, 10]], np.float32),
              np.array([0.9, 0.8, 0.7, 0.85], np.float32))
    cases = {"golden": golden}
    for t in range(3):
        cases[f"random{t}"] = _boxes_scores(rng, 60)
    boxes, scores = _boxes_scores(rng, 80, span=60.0)  # crowded
    cases["ties"] = (boxes, np.round(scores, 1))
    cases["all_suppressed"] = (boxes, np.full(80, tnms.NEG_INF, np.float32))
    half = scores.copy()
    half[::2] = tnms.NEG_INF
    cases["half_presuppressed"] = (boxes, half)
    return cases


@pytest.mark.parametrize("name", list(_single_cases()))
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_nms_single_class_matches_detjax(name, backend):
    """Indices equal and scores bit-equal to detjax's on the same fp32
    input ("cuda" routes CPU tensors to the NMS kernel's twin, with labels
    0 and class offset 0)."""
    boxes, scores = _single_cases()[name]
    for max_output in (20, 100):
        want = jnms.nms_single_class(jnp.asarray(boxes), jnp.asarray(scores),
                                     0.5, max_output)
        got = tnms.nms_single_class(torch.from_numpy(boxes),
                                    torch.from_numpy(scores), 0.5,
                                    max_output, backend=backend)
        np.testing.assert_array_equal(got.indices.numpy(), want.indices)
        np.testing.assert_array_equal(got.scores.numpy(), want.scores)
        assert int(got.num_valid) == int(want.num_valid)


def _class_cases():
    rng = np.random.default_rng(5)
    n, k = 120, 6
    boxes, _ = _boxes_scores(rng, n)
    scores = rng.uniform(0, 1, (n, k)).astype(np.float32)
    tied = np.round(scores, 1)  # exact ties within and across classes
    dead_class = scores.copy()
    dead_class[:, 2] = 0.01  # below the threshold: class 2 all suppressed
    basic = (np.array([[0, 0, 10, 10], [1, 1, 11, 11], [50, 50, 60, 60]],
                      np.float32),
             np.array([[0.9, 0.01], [0.8, 0.01], [0.01, 0.7]], np.float32))
    return {"basic": basic, "random": (boxes, scores), "ties": (boxes, tied),
            "dead_class": (boxes, dead_class),
            "nothing_above_threshold": (boxes, scores * 0.04)}


@pytest.mark.parametrize("name", list(_class_cases()))
@pytest.mark.parametrize("pre_k,max_det,per_class", [
    (1000, 100, 100),  # detjax's defaults
    (30, 25, 10),  # the prefilter and both caps bind
])
def test_class_aware_nms_matches_detjax(name, pre_k, max_det, per_class):
    boxes, scores = _class_cases()[name]
    want = jnms.class_aware_nms(jnp.asarray(boxes), jnp.asarray(scores),
                                0.05, 0.5, pre_k, max_det, per_class)
    for backend in ("torch", "cuda"):
        got = tnms.class_aware_nms(torch.from_numpy(boxes),
                                   torch.from_numpy(scores), 0.05, 0.5,
                                   pre_k, max_det, per_class,
                                   backend=backend)
        assert got.labels.dtype == torch.int32
        for field in ("labels", "scores", "boxes", "num_valid"):
            np.testing.assert_array_equal(getattr(got, field).numpy(),
                                          np.asarray(getattr(want, field)),
                                          err_msg=f"{name} {field}")


def test_batched_detect_postprocess_matches_detjax():
    """A batch of 3 with different score sets (one with nothing above the
    threshold), held field by field to detjax's vmapped path."""
    rng = np.random.default_rng(7)
    b, a, k = 3, 90, 5
    boxes = np.stack([_boxes_scores(rng, a)[0] for _ in range(b)])
    scores = rng.uniform(0, 1, (b, a, k)).astype(np.float32)
    scores[1] = np.round(scores[1], 1)
    scores[2] *= 0.04
    want = jnms.batched_detect_postprocess(jnp.asarray(boxes),
                                           jnp.asarray(scores), 0.05, 0.5,
                                           40, 30)
    got = tnms.batched_detect_postprocess(torch.from_numpy(boxes),
                                          torch.from_numpy(scores), 0.05,
                                          0.5, 40, 30)
    assert got.boxes.shape == (b, 30, 4)
    for field in ("labels", "scores", "boxes", "num_valid"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)),
                                      err_msg=field)
    assert int(got.num_valid[2]) == 0 and int(got.num_valid[0]) > 0


# -- the whole eval branch ----------------------------------------------------

def test_eval_branch_matches_detjax(pair):  # noqa: F811
    """R18, 128 px, fp32, weights carried by from_jax: forward -> fp32
    deltas -> decode_clip_boxes over every anchor -> sigmoid ->
    batched_detect_postprocess, against detjax's same composition
    (decode_clip_boxes "jnp", batched_detect_postprocess). The bars of
    tests/test_torch_port_detect.py: identical keep-sets, scores within
    atol 2e-5, boxes within atol 5e-3."""
    jcfg, tcfg, variables, model, canvases = pair
    e = tcfg.eval
    module = j_build_detector(jcfg.model)
    janchors = jnp.asarray(j_anchors_for_shape(jcfg.model.image_size,
                                               j_anchor_config(jcfg)))
    x = j_normalize_u8(canvases, jcfg.data.mean, jcfg.data.std,
                       jcfg.model.dtype)
    cls, box = module.apply(variables, x, train=False)
    jboxes_ = jboxes.decode_clip_boxes(box.astype(jnp.float32), janchors,
                                       jcfg.model.image_size,
                                       jcfg.model.box_std, backend="jnp")
    want = jax.tree.map(np.asarray, jnms.batched_detect_postprocess(
        jboxes_, jax.nn.sigmoid(cls.astype(jnp.float32)), e.score_threshold,
        e.nms_iou_threshold, e.pre_nms_top_k, e.max_detections))

    anchors = torch.from_numpy(anchors_for_shape(tcfg.model.image_size,
                                                 anchor_config(tcfg)))
    with torch.inference_mode():
        xt = normalize_u8(torch.from_numpy(canvases), tcfg.data.mean,
                          tcfg.data.std)
        cls_t, box_t = model(xt.permute(0, 3, 1, 2))
        tb = tboxes.decode_clip_boxes(box_t.to(torch.float32), anchors,
                                      tcfg.model.image_size,
                                      tcfg.model.box_std)
        got = tnms.batched_detect_postprocess(
            tb, torch.sigmoid(cls_t.to(torch.float32)), e.score_threshold,
            e.nms_iou_threshold, e.pre_nms_top_k, e.max_detections)
    assert got.boxes.shape == (2, e.max_detections, 4)
    np.testing.assert_array_equal(got.num_valid.numpy(), want.num_valid)
    assert want.num_valid.min() > 10, "too few detections to be a test"
    np.testing.assert_array_equal(got.labels.numpy(), want.labels)
    np.testing.assert_allclose(got.scores.numpy(), want.scores, rtol=0,
                               atol=2e-5)
    np.testing.assert_allclose(got.boxes.numpy(), want.boxes, rtol=0,
                               atol=5e-3)
