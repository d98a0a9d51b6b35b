"""The port's CUDA kernels against their plain twins, and the paths that
launch them, on the card.

Every test here needs a CUDA device and skips without one. The file
imports neither jax nor detjax, so it also runs where jax is absent:

    python -m pytest --noconftest tests/test_torch_port_cuda.py -q
"""

import numpy as np
import pytest
import torch

from detjax_torch.kernels import postprocess as pp


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    return torch.device("cuda")


def _case(seed, b, n, k=24, presuppress=0.1, ties=True):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0, 600, (b, max(1, n // 25), 2))
    c = np.take_along_axis(
        centers, rng.integers(0, centers.shape[1], (b, n, 1)), 1)
    c = c + rng.normal(0, 6, (b, n, 2))
    wh = rng.uniform(8, 120, (b, n, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    scores = rng.uniform(0.05, 1, (b, n)).astype(np.float32)
    if ties:
        scores[:, ::2] = np.round(scores[:, ::2], 2)
    scores[rng.uniform(size=(b, n)) < presuppress] = -1e10
    labels = rng.integers(0, k, (b, n)).astype(np.int32)
    return boxes, scores, labels


@pytest.mark.parametrize("b,n,max_det", [
    (8, 1000, 100),  # the main path's shape
    (1, 512, 100),  # the latency preset's shape
    (3, 1, 5),  # one candidate, more slots than candidates
    (2, 37, 100),  # fewer candidates than threads and than max_det
    (2, 5000, 300),  # > 48 KB of dynamic shared memory
    (1, pp.MAX_CANDIDATES, 100),  # the kernel's limit
])
def test_nms_kernel_bit_equal_to_twin(cuda, b, n, max_det):
    boxes, scores, labels = (torch.from_numpy(a).to(cuda)
                             for a in _case(b * 7 + n, b, n))
    scores[-1, : n // 2] = -1e10  # the last image runs out early
    before = pp.nms_launches
    ki, ks = pp.nms_cuda(boxes, scores, labels, 0.5, max_det, 642.0)
    ri, rs = pp.nms_reference(boxes, scores, labels, 0.5, max_det, 642.0)
    torch.cuda.synchronize()
    assert pp.nms_launches == before + 1
    assert torch.equal(ki, ri) and torch.equal(ks, rs)


def test_nms_kernel_empty_image(cuda):
    boxes, _, labels = (torch.from_numpy(a).to(cuda) for a in _case(1, 2, 64))
    scores = torch.full((2, 64), -1e10, device=cuda)
    ki, ks = pp.nms_cuda(boxes, scores, labels, 0.5, 10, 642.0)
    assert (ki == -1).all() and (ks == 0).all()


def test_nms_wrapper_raises_instead_of_falling_back(cuda):
    boxes, scores, labels = (torch.from_numpy(a).to(cuda)
                             for a in _case(2, 2, 64))
    with pytest.raises(TypeError, match="float32"):
        pp.nms_cuda(boxes.double(), scores, labels)
    with pytest.raises(TypeError, match="int32"):
        pp.nms_cuda(boxes, scores, labels.long())
    with pytest.raises(ValueError, match="contiguous"):
        pp.nms_cuda(boxes, scores.t().contiguous().t(), labels)
    with pytest.raises(ValueError, match="one device"):
        pp.nms_cuda(boxes, scores.cpu(), labels)
    big = pp.MAX_CANDIDATES + 1
    with pytest.raises(ValueError, match="shared-memory"):
        pp.nms_cuda(torch.zeros(1, big, 4, device=cuda),
                    torch.zeros(1, big, device=cuda),
                    torch.zeros(1, big, dtype=torch.int32, device=cuda))


def test_detect_path_runs_the_kernel(cuda):
    import detjax_torch

    cfg = detjax_torch.get_config("retinanet_r50_640", **{
        "model.backbone_depth": 18, "model.image_size": (128, 128),
        "model.num_classes": 8, "model.prior_prob": 0.3})
    model = detjax_torch.build_model(cfg, seed=0)
    assert next(model.parameters()).is_cuda
    canvases = np.random.default_rng(0).integers(0, 256, (2, 128, 128, 3),
                                                 np.uint8)
    before = pp.nms_launches
    det = detjax_torch.detect_u8(model, canvases, cfg)
    assert pp.nms_launches == before + 1
    twin = detjax_torch.detect_u8(model, canvases, cfg, nms_backend="torch")
    assert pp.nms_launches == before + 1
    for a, b in zip(det, twin):
        assert torch.equal(a, b)


# -- anchor matching ---------------------------------------------------------

def _match_case(seed, b, a, g):
    """Anchors and a hard GT set: exact duplicates (tied IoUs), padding
    between valid GTs, an image with no valid GT, zero-area GTs and GTs
    larger than the canvas and equal to an anchor."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(0, 640, (a, 2))
    wh = rng.uniform(8, 300, (a, 2))
    anchors = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    c = rng.uniform(0, 640, (b, g, 2))
    wh = rng.uniform(4, 400, (b, g, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    labels = rng.integers(0, 80, (b, g)).astype(np.int32)
    labels[:, 1::3] = -1
    if g > 2:
        boxes[:, 2] = boxes[:, 0]  # a tie with slot 0
        boxes[0, 1] = [-50.0, -50.0, 700.0, 690.0]
        boxes[0, -1, 2] = boxes[0, -1, 0]  # zero width
    boxes[:, 0] = anchors[rng.integers(0, a, b)]  # IoU exactly 1
    if b > 1:
        labels[-1] = -1  # no valid GT
    return anchors, boxes, labels


@pytest.mark.parametrize("b,a,g", [
    (16, 76725, 100),  # the training shape of retinanet_r50_640
    (2, 3069, 5),  # a 128-px canvas
    (3, 1000, 1),  # G = 1, A not a multiple of 256
    (1, 257, 13),  # one anchor past a block
    (2, 513, 5000),  # > 48 KB of dynamic shared memory
])
def test_match_kernel_bit_equal_to_twin(cuda, b, a, g):
    from detjax_torch.kernels import matching as km

    anchors, boxes, labels = (torch.from_numpy(x).to(cuda)
                              for x in _match_case(b * 31 + g, b, a, g))
    valid = labels >= 0
    before = km.match_launches
    got = km.match_iou_cuda(anchors, boxes, valid, labels)
    want = km.match_iou_reference(anchors, boxes, valid, labels)
    torch.cuda.synchronize()
    assert km.match_launches == before + 1
    for name, x, y in zip(("max_iou", "argmax", "boxes", "labels"), got,
                          want):
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert torch.equal(x, y), name
    if b > 1:
        assert (got[0][-1] == -1).all() and (got[1][-1] == 0).all()


def test_match_wrapper_raises_instead_of_falling_back(cuda):
    from detjax_torch.kernels import matching as km

    anchors, boxes, labels = (torch.from_numpy(x).to(cuda)
                              for x in _match_case(3, 2, 300, 7))
    valid = labels >= 0
    with pytest.raises(TypeError, match="float32"):
        km.match_iou_cuda(anchors.double(), boxes, valid, labels)
    with pytest.raises(TypeError, match="int32"):
        km.match_iou_cuda(anchors, boxes, valid, labels.long())
    with pytest.raises(TypeError, match="bool"):
        km.match_iou_cuda(anchors, boxes, valid.to(torch.uint8), labels)
    with pytest.raises(ValueError, match="contiguous"):
        km.match_iou_cuda(anchors, boxes.transpose(0, 1).contiguous()
                          .transpose(0, 1), valid, labels)
    with pytest.raises(ValueError, match="G=0"):
        km.match_iou_cuda(anchors, boxes[:, :0].contiguous(),
                          valid[:, :0].contiguous(),
                          labels[:, :0].contiguous())
    with pytest.raises(ValueError, match="one device"):
        km.match_iou_cuda(anchors, boxes.cpu(), valid, labels)


def test_train_step_runs_the_match_kernel(cuda):
    import detjax_torch
    from detjax_torch.kernels import matching as km

    cfg = detjax_torch.get_config("retinanet_r50_640", **{
        "model.backbone_depth": 18, "model.image_size": (128, 128),
        "model.num_classes": 8, "train.max_gt": 6})
    state = detjax_torch.make_train_state(cfg, seed=0)
    assert next(state.model.parameters()).is_cuda
    rng = np.random.default_rng(0)
    batch = {"images": rng.integers(0, 256, (2, 128, 128, 3), np.uint8),
             "gt_boxes": np.tile(np.array([[10, 10, 70, 60]], np.float32),
                                 (2, 6, 1)),
             "gt_labels": np.array([[1, 4, -1, -1, -1, -1]] * 2, np.int32)}
    before = km.match_launches
    state, m = detjax_torch.train_step(state, batch)
    assert km.match_launches == before + 1 and state.step == 1
    assert all(bool(torch.isfinite(v)) for v in m.values())
    assert float(m["num_pos"]) > 0
    detjax_torch.train_step(state, batch, match_backend="torch")
    assert km.match_launches == before + 1
