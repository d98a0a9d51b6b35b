"""PyTorch port vs detjax: anchor <-> GT matching, on the CPU.

The port's plain twin (``match_anchors(backend="torch")``, and under it
``match_iou_reference``) against detjax's lax ``match_anchors`` and its
Pallas kernel ``match_iou_pallas`` run in interpret mode, at the anchor set
of a 128-px canvas (3,069 anchors). Equal means bit-equal in every field,
with one stated exception: the Pallas kernel's ``max_iou`` in interpret
mode.

That exception is detjax's, not the port's. XLA:CPU lowers the
interpret-mode kernel's fused ``[G, tile]`` block with another rounding
of the IoU than its lax path: up to 4 ulp apart on these cases (detjax's
own ``tests/test_kernels.py`` holds the two at 1e-6). The port follows the
lax path's IEEE order, ``inter / max((area_a + area_g) - inter, 1e-8)``,
which the CUDA kernel also keeps (built with ``-fmad=false``). Every
decision the kernel makes from the IoU (argmax, winner box and label,
positive, negative) is bit-equal to the Pallas kernel on all cases.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from detjax.kernels.matching import match_iou_pallas
from detjax.ops import matching as jmatching

import detjax_torch
from detjax_torch.kernels import matching as km
from detjax_torch.modeling import anchor_config
from detjax_torch.ops import matching as tmatching
from detjax_torch.ops.anchors import anchors_for_shape

# One intra-op thread a process: pytest-xdist runs several workers on
# the host's cores, and torch's default of a thread a core in each
# worker oversubscribes them many times over.
torch.set_num_threads(1)

HW = (128, 128)
ANCHORS = anchors_for_shape(HW, anchor_config(
    detjax_torch.get_config("retinanet_r50_640")))


def _square_anchor(cell):
    """The anchor of side 32 (level 3, scale 1, ratio 1) at grid cell
    ``cell`` of the 16 x 16 level-3 grid, row-major."""
    wh = ANCHORS[:, 2:] - ANCHORS[:, :2]
    return ANCHORS[np.flatnonzero((wh[:, 0] == 32) & (wh[:, 1] == 32))[cell]]


CASES = ["random", "no_gt_image", "all_padding", "duplicates", "degenerate",
         "exact_iou", "g_13", "g_1"]


def _random_boxes(rng, shape, lo=4.0, hi=96.0):
    c = rng.uniform(0, HW[1], shape + (2,))
    wh = rng.uniform(lo, hi, shape + (2,))
    return np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)


def _case(name):
    """(gt_boxes [B, G, 4] f32, gt_labels [B, G] int32) for one case."""
    rng = np.random.default_rng(CASES.index(name))
    b, g = 3, 8
    if name == "g_13":
        g = 13
    if name == "g_1":
        g = 1
    boxes = _random_boxes(rng, (b, g))
    labels = rng.integers(0, 5, (b, g)).astype(np.int32)
    if name == "random":
        labels[:, 1::3] = -1  # padding interleaved with valid GTs
    elif name == "no_gt_image":
        labels[1] = -1  # one image without a valid GT, one with one
        labels[2, 1:] = -1
    elif name == "all_padding":
        labels[:] = -1
    elif name == "duplicates":
        boxes[:, 3] = boxes[:, 1]  # exact IoU ties across GT slots
        boxes[:, 6] = boxes[:, 1]
        boxes[:, 7] = boxes[:, 6]
        labels[:, 6] = -1  # a padded duplicate must never win
    elif name == "degenerate":
        boxes[:, 0, 2] = boxes[:, 0, 0]  # zero width
        boxes[:, 1, 3] = boxes[:, 1, 1]  # zero height
        boxes[:, 2] = [-40.0, -40.0, 200.0, 180.0]  # larger than the canvas
        boxes[:, 3] = [50.0, 50.0, 40.0, 40.0]  # inverted: area clamps at 0
    elif name == "exact_iou":
        # each GT against its own anchor, far from the others
        a, b2, c, d = (_square_anchor(k) for k in (34, 136, 221, 45))
        boxes[:, 0] = a  # IoU exactly 1
        boxes[:, 1] = [b2[0], b2[1], b2[2], b2[1] + 16.0]  # exactly 0.5
        boxes[:, 2] = [c[0], c[1], c[2], c[1] + 12.8]  # fp32 rounding of 0.4
        boxes[:, 3] = [d[0] + 32.0 / 3.0, d[1], d[2] + 32.0 / 3.0, d[3]]
        labels[:, 4:] = -1
    return boxes, labels


def _torch_match(boxes, labels, backend="torch"):
    return tmatching.match_anchors(
        torch.from_numpy(ANCHORS), torch.from_numpy(boxes),
        torch.from_numpy(labels), backend=backend)


PALLAS_MAX_IOU_ULP = 4  # see the module docstring


def _assert_equal(name, got, want, iou_ulp=0):
    got, want = got.numpy(), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, name
    if iou_ulp and name == "max_iou":
        np.testing.assert_array_max_ulp(got, want, maxulp=iou_ulp)
    else:
        np.testing.assert_array_equal(got, want, err_msg=name)


def _assert_match_equal(got, want, iou_ulp=0):
    for field in tmatching.MatchResult._fields:
        _assert_equal(field, getattr(got, field), getattr(want, field),
                      iou_ulp)


@pytest.mark.parametrize("backend", ["lax", "pallas"])
@pytest.mark.parametrize("case", CASES)
def test_match_result_bit_equal_to_detjax(case, backend):
    """Every MatchResult field against detjax's lax path and its Pallas
    kernel (interpret mode on the CPU)."""
    boxes, labels = _case(case)
    want = jmatching.match_anchors(jnp.asarray(ANCHORS), jnp.asarray(boxes),
                                   jnp.asarray(labels), backend=backend)
    got = _torch_match(boxes, labels)
    assert got.matched_gt.dtype == torch.int32
    assert got.matched_labels.dtype == torch.int32
    assert got.positive.dtype == got.negative.dtype == torch.bool
    _assert_match_equal(got, want,
                        PALLAS_MAX_IOU_ULP if backend == "pallas" else 0)


@pytest.mark.parametrize("case", CASES)
def test_reference_bit_equal_to_pallas_kernel(case):
    """The raw outputs of the kernel's twin against match_iou_pallas's:
    max_iou, argmax, the winner's box and its raw label."""
    boxes, labels = _case(case)
    valid = labels >= 0
    want = match_iou_pallas(jnp.asarray(ANCHORS), jnp.asarray(boxes),
                            jnp.asarray(valid), jnp.asarray(labels),
                            tile=1024, interpret=True)
    got = km.match_iou_reference(torch.from_numpy(ANCHORS),
                                 torch.from_numpy(boxes),
                                 torch.from_numpy(valid),
                                 torch.from_numpy(labels))
    for name, g, w in zip(("max_iou", "argmax", "boxes", "labels"), got,
                          want):
        _assert_equal(name, g, w, PALLAS_MAX_IOU_ULP)


def test_hard_cases_hit_their_edges():
    """The cases above really contain exact ties, IoU 1 and 0.5, and
    images matched to nothing."""
    ties = _torch_match(*_case("duplicates"))
    assert (ties.matched_gt == 1).any() and not (ties.matched_gt == 6).any()
    exact = _torch_match(*_case("exact_iou"))
    assert (exact.max_iou == 1.0).any() and (exact.max_iou == 0.5).any()
    near_bg = exact.max_iou[(exact.max_iou - 0.4).abs() < 1e-6]
    assert len(near_bg) and ((near_bg < 0.4) == exact.negative[
        (exact.max_iou - 0.4).abs() < 1e-6]).all()
    empty = _torch_match(*_case("all_padding"))
    assert (empty.max_iou == -1).all() and (empty.matched_gt == 0).all()
    assert not empty.positive.any() and empty.negative.all()
    assert (empty.matched_labels == -1).all()
    assert (empty.matched_boxes == 0).all()


def test_auto_on_cpu_is_the_twin_and_launches_nothing():
    boxes, labels = _case("random")
    before = km.match_launches
    auto = _torch_match(boxes, labels, backend="auto")
    _assert_match_equal(auto, _torch_match(boxes, labels))
    assert km.match_launches == before


def test_single_image_and_detached_outputs():
    boxes, labels = _case("random")
    want = _torch_match(boxes[:1], labels[:1])
    anchors = torch.from_numpy(ANCHORS).requires_grad_(True)
    got = tmatching.match_anchors(anchors, torch.from_numpy(boxes[0]),
                                  torch.from_numpy(labels[0]))
    for g, w in zip(got, want):
        assert torch.equal(g, w[0]) and not g.requires_grad


def test_wrapper_refuses_bad_input():
    boxes, labels = _case("random")
    a, bx = torch.from_numpy(ANCHORS), torch.from_numpy(boxes)
    valid, lab = torch.from_numpy(labels >= 0), torch.from_numpy(labels)
    with pytest.raises(ValueError, match="G=0"):
        km.match_iou_cuda(a, bx[:, :0], valid[:, :0], lab[:, :0])
    with pytest.raises(ValueError, match=r"\[B, G\]"):
        km.match_iou_cuda(a, bx, valid[:, :2], lab)
    with pytest.raises(ValueError, match=r"\[A, 4\]"):
        km.match_iou_cuda(a[:, :3], bx, valid, lab)
    with pytest.raises(ValueError, match="backend"):
        tmatching.match_anchors(a, bx, lab, backend="pallas")
