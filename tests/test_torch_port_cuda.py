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


# -- fused identity bottleneck -----------------------------------------------

def _bottleneck_case(seed, b, h, w, m, device):
    """chip_smoke.py's seeded inputs: x = relu(N(0, 1)) in bf16 and
    He-normal convs folded through non-identity BatchNorm statistics."""
    from detjax_torch.kernels import bottleneck as kb

    x, block = kb.seeded_block(seed, b, h, w, m, device)
    with torch.no_grad():
        return x, block.folded_weights()


def _twin_without_tf32(args):
    from detjax_torch.kernels import bottleneck as kb

    flag = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        return kb.bottleneck_identity_reference(*args)
    finally:
        torch.backends.cudnn.allow_tf32 = flag


@pytest.mark.parametrize("b,h,w,m", [
    (2, 8, 16, 16),  # small
    (1, 7, 32, 32),  # B=1, H not a multiple of the 2-row tile
    (1, 5, 48, 64),  # odd H at layer1's width
    (8, 160, 160, 64),  # layer1 of R50 at 640 px, eval batch 8
    (8, 80, 80, 128),  # layer2
    (2, 5, 8, 16),  # W < 16: one masked tile a row
    (1, 6, 24, 32),  # a masked tail tile
    (2, 7, 104, 128),  # layer2's width on a 608x832 canvas
])
def test_bottleneck_kernel_matches_twin(cuda, b, h, w, m):
    """detjax's bars for kernel vs oracle (tests/test_kernels.py:175-177):
    within 0.05 x max(|twin|, 1), under 1 % of elements differing (the
    kernel's fp32 sums run in another order than cuDNN's)."""
    from detjax_torch.kernels import bottleneck as kb

    x, weights = _bottleneck_case(b * 131 + h + m, b, h, w, m, cuda)
    before = kb.bottleneck_launches
    got = kb.bottleneck_identity(x, *weights)
    want = _twin_without_tf32([x, *weights])
    torch.cuda.synchronize()
    assert kb.bottleneck_launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    assert torch.isfinite(got.float()).all()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 0.05 * max(want.float().abs().max().item(), 1.0)
    assert (got != want).float().mean().item() < 0.01


def test_bottleneck_wrapper_raises_instead_of_falling_back(cuda):
    from detjax_torch.kernels import bottleneck as kb

    x, w = _bottleneck_case(0, 1, 4, 16, 16, cuda)
    before = kb.bottleneck_launches
    with pytest.raises(TypeError, match="bfloat16"):
        kb.bottleneck_identity(x.float(), *w)
    with pytest.raises(TypeError, match="float32"):
        kb.bottleneck_identity(x, w[0], w[1].double(), *w[2:])
    with pytest.raises(ValueError, match="contiguous"):
        kb.bottleneck_identity(x.transpose(1, 2).contiguous().transpose(1, 2),
                               *w)
    with pytest.raises(ValueError, match="w2 must be"):
        kb.bottleneck_identity(x, w[0], w[1], w[2][:, :2].contiguous(),
                               *w[3:])
    with pytest.raises(ValueError, match="C = 4 M"):
        kb.bottleneck_identity(x[..., :32].contiguous(), w[0][:32], w[1],
                               w[2], w[3], w[4][:, :32].contiguous(),
                               w[5][:, :32].contiguous())
    # W = 8 (not a multiple of 16) is taken: a masked tile, held to the twin
    narrow = x[:, :, :8].contiguous()
    got = kb.bottleneck_identity(narrow, *w)
    want = _twin_without_tf32([narrow, *w])
    assert (got.float() - want.float()).abs().max().item() <= 0.05 * max(
        want.float().abs().max().item(), 1.0)
    assert kb.bottleneck_launches == before + 1
    before += 1
    with pytest.raises(ValueError, match="one device"):
        kb.bottleneck_identity(x, w[0].cpu(), *w[1:])
    # a row too wide for one block's shared memory: the launcher refuses,
    # naming the widest row it takes at each M
    with pytest.raises(RuntimeError, match="shared memory.*W <= 816 at M=16"):
        kb.bottleneck_identity(torch.zeros(1, 2, 4096, 64, device=cuda,
                                           dtype=torch.bfloat16), *w)
    assert kb.bottleneck_launches == before


def test_fused_detect_path_runs_the_kernel(cuda):
    """fused_backbone="on" at R50, 128 px: five kernel launches a forward,
    none through the twin route; a backward through the fused blocks
    launches the backward kernel five times."""
    import detjax_torch
    from detjax_torch.kernels import bottleneck as kb

    cfg = detjax_torch.get_config("retinanet_r50_640", **{
        "model.image_size": (128, 128), "model.num_classes": 8,
        "model.fpn_channels": 64, "model.head_channels": 64,
        "model.prior_prob": 0.3, "model.fused_backbone": "on"})
    model = detjax_torch.build_model(cfg, seed=0)
    canvases = np.random.default_rng(0).integers(0, 256, (2, 128, 128, 3),
                                                 np.uint8)
    before = kb.bottleneck_launches
    det = detjax_torch.detect_u8(model, canvases, cfg)
    torch.cuda.synchronize()
    assert kb.bottleneck_launches == before + 5
    model.bottleneck_backend = "torch"
    twin = detjax_torch.detect_u8(model, canvases, cfg)
    assert kb.bottleneck_launches == before + 5
    assert det.boxes.shape == twin.boxes.shape
    model.bottleneck_backend = "auto"
    model.requires_grad_(True)
    x = torch.zeros(1, 3, 128, 128, device=cuda)
    cls, _ = model(x)
    bwd_before = kb.bottleneck_bwd_launches
    cls.float().sum().backward()
    torch.cuda.synchronize()
    assert kb.bottleneck_bwd_launches == bwd_before + 5
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for blk in model.fused_blocks() for p in blk.parameters())


# -- fused identity bottleneck, backward ---------------------------------------

def _bwd_case(seed, b, h, w, m, device):
    from detjax_torch.kernels import bottleneck as kb

    x, weights = _bottleneck_case(seed, b, h, w, m, device)
    rng = np.random.default_rng(seed + 1)
    dy = torch.from_numpy(rng.normal(0, 1, x.shape).astype(np.float32)).to(
        device, torch.bfloat16)
    return x, dy, weights


@pytest.mark.parametrize("b,h,w,m", [
    (2, 8, 16, 16),  # small
    (1, 7, 32, 32),  # B=1, odd H
    (3, 5, 48, 64),  # layer1's width, more tiles than one per block
    (1, 6, 160, 64),  # layer1's row width at 640 px: the most shared memory
    (2, 9, 80, 128),  # layer2's width at 640 px
    (1, 1, 16, 16),  # one row: every halo row outside the image
    (3, 100, 16, 16),  # more rows than blocks: each block walks several
    (2, 5, 8, 16),  # W < 16: one masked tile a row
    (1, 6, 24, 32),  # a masked tail tile
    (1, 5, 104, 128),  # 608x832's layer2: tiles straddle rows
    (1, 4, 232, 64),  # a wide row at layer1's width: tiles straddle rows
    (1, 2, 1024, 16),  # a 1024-px row at M=16: eight tiles a row
    (3, 11, 13, 32),  # 128-pixel tiles straddle rows and images
    (2, 7, 20, 64),  # a tile holds the end of one image and the next's top
    (1, 1, 3, 64),  # B H W = 3: one part-filled tile, fewer than one per SM
    (2, 3, 5, 128),  # B H W = 30 at layer2's width
])
def test_bottleneck_bwd_kernel_matches_twin(cuda, b, h, w, m):
    """Against the twin with TF32 off, detjax's 2 % bar (tests/
    test_kernels.py:196-197) in the 2-norm for each of the seven outputs,
    and dx within 0.02 x max|twin| on all but 1 % of its elements. The
    kernel sums fp32 in other orders than cuDNN, which moves bf16
    roundings of y1 and y2 by a step; where y3 + x, y2 or y1 lies that
    close to 0 the two decide its ReLU mask differently, which moves dx by
    up to |dy| at that element (a flip of y1's mask, at all C channels of
    one pixel) and a small sum by a few percent of its max: 0.19 % of dx's
    elements at (2, 9, 80, 128) on an H100. Two runs give equal bits (no
    atomics)."""
    from detjax_torch.kernels import bottleneck as kb

    x, dy, weights = _bwd_case(b * 131 + h + m, b, h, w, m, cuda)
    before = kb.bottleneck_bwd_launches
    got = kb.bottleneck_identity_backward(x, dy, *weights)
    again = kb.bottleneck_identity_backward(x, dy, *weights)
    flag = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        want = kb.bottleneck_identity_backward_reference(x, dy, *weights)
    finally:
        torch.backends.cudnn.allow_tf32 = flag
    torch.cuda.synchronize()
    assert kb.bottleneck_bwd_launches == before + 2
    for name, g, a, r in zip(("dx", "dw1", "db1", "dw2", "db2", "dw3", "db3"),
                             got, again, want):
        assert g.dtype == r.dtype and g.shape == r.shape, name
        assert torch.equal(g, a), name
        g, r = g.float(), r.float()
        assert torch.isfinite(g).all(), name
        rel = (torch.linalg.vector_norm(g - r)
               / torch.linalg.vector_norm(r).clamp(min=1e-3)).item()
        assert rel <= 0.02, (name, rel)
        if name == "dx":
            tol = 0.02 * max(r.abs().max().item(), 1e-3)
            share = ((g - r).abs() > tol).float().mean().item()
            assert share <= 1e-2, share


def test_bottleneck_bwd_through_autograd(cuda):
    """Autograd through bottleneck_identity on CUDA tensors runs the
    backward kernel once and returns its gradients in detjax's dtypes:
    dx and the weights' in bf16, the biases' in fp32 [1, n]."""
    from detjax_torch.kernels import bottleneck as kb

    x, dy, weights = _bwd_case(5, 2, 6, 32, 32, cuda)
    direct = kb.bottleneck_identity_backward(x, dy, *weights)
    leaves = [t.detach().clone().requires_grad_(True) for t in (x, *weights)]
    before = kb.bottleneck_bwd_launches
    out = kb.bottleneck_identity(*leaves)
    out.backward(dy)
    torch.cuda.synchronize()
    assert kb.bottleneck_bwd_launches == before + 1
    for leaf, d in zip(leaves, direct):
        assert leaf.grad.dtype == leaf.dtype and leaf.grad.shape == leaf.shape
        assert torch.equal(leaf.grad, d.to(leaf.dtype))


def test_bottleneck_bwd_wrapper_raises_instead_of_falling_back(cuda):
    from detjax_torch.kernels import bottleneck as kb

    x, dy, w = _bwd_case(0, 1, 4, 16, 16, cuda)
    before = kb.bottleneck_bwd_launches
    with pytest.raises(TypeError, match="dy must be bfloat16"):
        kb.bottleneck_identity_backward(x, dy.float(), *w)
    with pytest.raises(ValueError, match="dy must be contiguous"):
        kb.bottleneck_identity_backward(
            x, dy.transpose(1, 2).contiguous().transpose(1, 2), *w)
    with pytest.raises(ValueError, match="one device"):
        kb.bottleneck_identity_backward(x, dy.cpu(), *w)
    with pytest.raises(ValueError, match="dy must be"):
        kb.bottleneck_identity_backward(x, dy[:, :2].contiguous(), *w)
    with pytest.raises(TypeError, match="float32"):
        kb.bottleneck_identity_backward(x, dy, w[0], w[1].double(), *w[2:])
    assert kb.bottleneck_bwd_launches == before
    # a 1024-px row is cut into pixel tiles like any other, not refused:
    # held to the twin at that shape, every tile kernel's shared memory
    # within the card's limit
    wx, wdy, ww = _bwd_case(1, 1, 2, 1024, 16, cuda)
    assert kb.bwd_plan(1, 2, 1024, 16)["tiles"] == 16
    geom = kb.bwd_geometry(16)
    assert max(geom[k] for k in ("smem_y1", "smem_tile", "smem_wgrad")
               ) <= 232448
    got = kb.bottleneck_identity_backward(wx, wdy, *ww)
    flag = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        want = kb.bottleneck_identity_backward_reference(wx, wdy, *ww)
    finally:
        torch.backends.cudnn.allow_tf32 = flag
    for g, r in zip(got, want):
        g, r = g.float(), r.float()
        assert torch.isfinite(g).all()
        assert (torch.linalg.vector_norm(g - r)
                / torch.linalg.vector_norm(r).clamp(min=1e-3)).item() <= 0.02
    assert kb.bottleneck_bwd_launches == before + 1


def test_bottleneck_bwd_launches_the_planned_kernels(cuda):
    """One call of the fused backward counts one in bottleneck_bwd_launches
    and, in bottleneck_bwd_kernel_launches, the CUDA kernels the launcher
    reports it launched (one for each launch the runtime accepted): the
    planned five (y1, dy3/dc2, dc1/dx, weight gradients, ordered sums), at
    a shape whose parts and tiles have tails; the library's geometry is the
    wrapper's plan."""
    from detjax_torch.kernels import bottleneck as kb

    x, dy, weights = _bwd_case(3, 2, 6, 40, 64, cuda)
    plan = kb.bwd_plan(2, 6, 40, 64)
    geom = kb.bwd_geometry(64)
    assert (geom["pixel_tile"], geom["pixel_step"], geom["weight_tile"],
            geom["jobs"]) == (plan["pixel_tile"], plan["pixel_step"],
                              plan["weight_tile"], plan["jobs"])
    calls, kernels = kb.bottleneck_bwd_launches, \
        kb.bottleneck_bwd_kernel_launches
    kb.bottleneck_identity_backward(x, dy, *weights)
    torch.cuda.synchronize()
    assert kb.bottleneck_bwd_launches == calls + 1
    assert kb.bottleneck_bwd_kernel_launches - kernels == plan["kernels"]
    assert plan["kernels"] == kb.BWD_KERNELS == 5


def test_bottleneck_bwd_frees_its_scratch(cuda):
    """The scratch (y1, y2, bf16(dy3), bf16(dc2), bf16(dc1)) and the
    workspaces are freed when the backward returns: allocated memory is
    back to its value before the call, dx and the summed gradients aside.
    The scratch alone is larger than those two together."""
    from detjax_torch.kernels import bottleneck as kb

    x, dy, weights = _bwd_case(4, 4, 40, 40, 64, cuda)
    plan = kb.bwd_plan(4, 40, 40, 64)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    out = kb.bottleneck_identity_backward(x, dy, *weights)
    torch.cuda.synchronize()
    storages = {o.untyped_storage().data_ptr(): o.untyped_storage().nbytes()
                for o in out}
    held = torch.cuda.memory_allocated() - before
    assert len(storages) == 2  # dx, and one buffer of the six sums
    kept = sum(storages.values())
    assert kept <= held < kept + 2 * 512  # the allocator's 512-byte blocks
    assert plan["scratch_bytes"] > held
    del out
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == before


def test_fused_train_step_runs_both_kernels(cuda):
    """make_train_state with fused_backbone="on" at R50, 128 px: one
    train_step launches the fused forward and backward kernels 5 times
    each and the matching kernel once; the twin route launches none of
    the fused kernels."""
    import detjax_torch
    from detjax_torch.kernels import bottleneck as kb
    from detjax_torch.kernels import matching as km

    cfg = detjax_torch.get_config("retinanet_r50_640", **{
        "model.image_size": (128, 128), "model.num_classes": 8,
        "model.fpn_channels": 64, "model.head_channels": 64,
        "model.fused_backbone": "on", "train.max_gt": 6})
    state = detjax_torch.make_train_state(cfg, seed=0)
    assert len(state.model.fused_blocks()) == 5
    rng = np.random.default_rng(0)
    batch = {"images": rng.integers(0, 256, (2, 128, 128, 3), np.uint8),
             "gt_boxes": np.tile(np.array([[10, 10, 70, 60]], np.float32),
                                 (2, 6, 1)),
             "gt_labels": np.array([[1, 4, -1, -1, -1, -1]] * 2, np.int32)}
    before = {n: p.detach().clone()
              for n, p in state.model.named_parameters()}
    counts = (kb.bottleneck_launches, kb.bottleneck_bwd_launches,
              km.match_launches)
    state, m = detjax_torch.train_step(state, batch)
    torch.cuda.synchronize()
    assert (kb.bottleneck_launches - counts[0],
            kb.bottleneck_bwd_launches - counts[1],
            km.match_launches - counts[2]) == (5, 5, 1)
    assert all(bool(torch.isfinite(v)) for v in m.values())
    assert not [n for n, p in state.model.named_parameters()
                if torch.equal(p, before[n])]
    state.model.bottleneck_backend = "torch"
    counts = (kb.bottleneck_launches, kb.bottleneck_bwd_launches)
    detjax_torch.train_step(state, batch)
    assert (kb.bottleneck_launches, kb.bottleneck_bwd_launches) == counts


# -- full-set decode and the per-class NMS ---------------------------------------

def _decode_case(seed, b, n):
    """Seeded deltas over the 640 anchor set's first n anchors, with hard
    rows: dw and dh of +-80 and +-500 (exp overflows to inf), inf - inf
    corners, NaN deltas."""
    import detjax_torch
    from detjax_torch.modeling import anchor_config
    from detjax_torch.ops.anchors import anchors_for_shape

    cfg = detjax_torch.get_config("retinanet_r50_640")
    anchors = anchors_for_shape(cfg.model.image_size, anchor_config(cfg))[:n]
    rng = np.random.default_rng(seed)
    d = rng.normal(0, 1.0, (b, n, 4)).astype(np.float32)
    d[:, ::5] *= 8.0
    d[:, :4, 2] = [80, -80, 500, -500]
    d[:, 4:8, 3] = [80, -80, 500, -500]
    d[:, 8, 0], d[:, 8, 2] = 1e38, 500
    d[:, 9, 1] = np.nan
    return d, anchors


@pytest.mark.parametrize("b,n", [(8, 76725), (1, 10), (3, 1001)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [True, False])
def test_decode_kernel_bit_equal_to_twin(cuda, b, n, dtype, clip):
    """Bit-equal to the twin, NaN equal to NaN: the same fp32 operations in
    the same order (no FMA contraction), expf as ATen's exp."""
    d, anchors = _decode_case(b + n, b, n)
    deltas = torch.from_numpy(d).to(cuda, getattr(torch, dtype))
    a = torch.from_numpy(anchors).to(cuda)
    size = (640, 640) if clip else None
    before = pp.decode_launches
    got = pp.decode_boxes_cuda(deltas, a, (0.1, 0.1, 0.2, 0.2), size)
    want = pp.decode_boxes_reference(deltas, a, (0.1, 0.1, 0.2, 0.2), size)
    torch.cuda.synchronize()
    assert pp.decode_launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (b, n, 4)
    assert bool(((got == want) | (got.isnan() & want.isnan())).all())
    assert bool(got.isnan().any())


def test_decode_wrapper_raises_instead_of_falling_back(cuda):
    d, anchors = _decode_case(0, 2, 64)
    deltas, a = torch.from_numpy(d).to(cuda), torch.from_numpy(anchors).to(cuda)
    before = pp.decode_launches
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        pp.decode_boxes_cuda(deltas.double(), a)
    with pytest.raises(TypeError, match="anchors must be float32"):
        pp.decode_boxes_cuda(deltas, a.double())
    with pytest.raises(ValueError, match="contiguous"):
        pp.decode_boxes_cuda(deltas.transpose(0, 1).contiguous()
                             .transpose(0, 1), a)
    with pytest.raises(ValueError, match="one device"):
        pp.decode_boxes_cuda(deltas, a.cpu())
    with pytest.raises(ValueError, match="anchors must be"):
        pp.decode_boxes_cuda(deltas, a[:10])
    assert pp.decode_launches == before


def test_per_class_nms_route_bit_equal_to_twin_route(cuda):
    """decode_clip_boxes and batched_detect_postprocess through the kernels
    ("auto" on CUDA tensors) against backend="torch" on both: detections
    bit-equal; one decode and one NMS launch for the batch."""
    from detjax_torch.ops import batched_detect_postprocess, decode_clip_boxes

    d, anchors = _decode_case(3, 2, 76725)
    d = np.nan_to_num(d, nan=0.0, posinf=0.0, neginf=0.0).clip(-3, 3)
    rng = np.random.default_rng(4)
    scores = torch.from_numpy(rng.uniform(0, 1, (2, 76725, 6)).astype(
        np.float32) ** 8).to(cuda)
    scores[..., 5] = 0.01  # a class with nothing above the threshold
    deltas, a = torch.from_numpy(d).to(cuda), torch.from_numpy(anchors).to(cuda)
    counts = (pp.decode_launches, pp.nms_launches)
    outs = []
    for backend in ("auto", "torch"):
        boxes = decode_clip_boxes(deltas, a, (640, 640), backend=backend)
        outs.append(batched_detect_postprocess(boxes, scores, 0.05, 0.5, 1000,
                                               100, backend=backend))
        if backend == "auto":
            torch.cuda.synchronize()
            assert (pp.decode_launches - counts[0],
                    pp.nms_launches - counts[1]) == (1, 1)
    got, want = outs
    assert int(got.num_valid.min()) > 0
    for u, v in zip(got, want):
        assert torch.equal(u, v)


def _pool_case(seed, b, hz, wz, c, device, dtype, hard=True):
    from detjax_torch.kernels import stem as ks

    z, dp = ks.seeded_pool_inputs(seed, b, hz, wz, c, hard=hard)
    # NHWC arrays -> channels-last NCHW views
    return (torch.from_numpy(z).to(device, dtype).permute(0, 3, 1, 2),
            torch.from_numpy(dp).to(device, dtype).permute(0, 3, 1, 2))


def _same_bits(a, b):
    return a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.int16 if a.dtype == torch.bfloat16
                            else torch.int32),
        b.contiguous().view(torch.int16 if b.dtype == torch.bfloat16
                            else torch.int32))


@pytest.mark.parametrize("b,hz,wz,c", [
    (2, 16, 16, 4), (2, 16, 24, 8),
    (1, 128, 128, 8),  # two of detjax's row tiles
    (2, 32, 48, 64),  # the stem's C = 64: one warp a pixel
    (1, 16, 16, 3),  # odd C: bf16 one channel a thread
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["channels_last", "contiguous"])
def test_maxpool_bwd_kernel_bit_equal_to_twin(cuda, b, hz, wz, c, dtype,
                                              layout):
    """Bit-equal to the twin on ties, -inf windows and NaN (compared as
    bits), twice; one launch a call, and the contiguous-NCHW inputs copied
    once each."""
    from detjax_torch.kernels import stem as ks

    z, dp = _pool_case(b + hz + wz + c, b, hz, wz, c, cuda,
                       getattr(torch, dtype))
    if layout == "contiguous":
        z, dp = z.contiguous(), dp.contiguous()
    before = ks.maxpool_bwd_launches, ks.maxpool_bwd_copies
    got = ks.maxpool_bwd_cuda(z, dp)
    again = ks.maxpool_bwd_cuda(z, dp)
    want = ks.maxpool_bwd_reference(z, dp)
    torch.cuda.synchronize()
    copies = 0 if layout == "channels_last" else 4
    assert (ks.maxpool_bwd_launches - before[0],
            ks.maxpool_bwd_copies - before[1]) == (2, copies)
    assert got.shape == z.shape and got.is_contiguous(
        memory_format=torch.channels_last)
    assert _same_bits(got, want) and _same_bits(got, again)
    # NaN in z routes nowhere: dz holds none, and the hard rows were there
    assert bool(z.isnan().any()) and not bool(got.isnan().any())
    assert bool((got != 0).any())


def test_maxpool_bwd_kernel_unaligned_bf16(cuda):
    """bf16 inputs that start 2 bytes off a 4-byte boundary take the
    one-channel route and stay bit-equal."""
    from detjax_torch.kernels import stem as ks

    z, dp = _pool_case(3, 1, 16, 16, 8, cuda, torch.bfloat16)
    zs = torch.empty(z.numel() + 1, dtype=z.dtype, device=cuda)[1:]
    ds = torch.empty(dp.numel() + 1, dtype=dp.dtype, device=cuda)[1:]
    zu = zs.view(1, 16, 16, 8).copy_(z.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
    du = ds.view(1, 8, 8, 8).copy_(dp.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
    assert zu.data_ptr() % 4 == 2
    assert _same_bits(ks.maxpool_bwd_cuda(zu, du),
                      ks.maxpool_bwd_reference(z, dp))


def test_max_pool_3x3s2_backward_runs_the_kernel_once(cuda):
    """Autograd through max_pool_3x3s2: ATen's forward, one kernel launch
    in the backward, dz bit-equal to the twin's; post-ReLU inputs route as
    ATen's pool does (same support, within 1 bf16 step)."""
    from detjax_torch.kernels import stem as ks

    z, dp = _pool_case(7, 2, 64, 64, 64, cuda, torch.bfloat16, hard=False)
    leaf = z.detach().requires_grad_(True)
    out = ks.max_pool_3x3s2(leaf)
    assert torch.equal(out, ks.max_pool_3x3s2_reference(z))
    before = ks.maxpool_bwd_launches
    out.backward(dp)
    torch.cuda.synchronize()
    assert ks.maxpool_bwd_launches == before + 1
    assert _same_bits(leaf.grad, ks.maxpool_bwd_reference(z, dp))
    aten = z.detach().requires_grad_(True)
    torch.nn.functional.max_pool2d(aten, 3, 2, 1).backward(dp)
    assert torch.equal(leaf.grad != 0, aten.grad != 0)
    step = 2.0 ** (torch.floor(torch.log2(aten.grad.float().abs()
                                          .clamp(min=1e-30))) - 7)
    assert bool(((leaf.grad.float() - aten.grad.float()).abs() <= step).all())


def test_maxpool_bwd_wrapper_raises_instead_of_falling_back(cuda):
    from detjax_torch.kernels import stem as ks

    z, dp = _pool_case(0, 1, 16, 16, 8, cuda, torch.bfloat16)
    before = ks.maxpool_bwd_launches
    with pytest.raises(ValueError, match="even"):
        ks.maxpool_bwd_cuda(z[:, :, :15], dp)
    with pytest.raises(ValueError, match="even"):
        ks.maxpool_bwd_cuda(z[:, :, :, :15], dp)
    with pytest.raises(ValueError, match="dp must be"):
        ks.maxpool_bwd_cuda(z, dp[:, :, :7])
    with pytest.raises(TypeError, match="both bfloat16"):
        ks.maxpool_bwd_cuda(z, dp.float())
    with pytest.raises(TypeError, match="float32 or both bfloat16"):
        ks.maxpool_bwd_cuda(z.double(), dp.double())
    with pytest.raises(ValueError, match="one device"):
        ks.maxpool_bwd_cuda(z, dp.cpu())
    assert ks.maxpool_bwd_launches == before
    empty = ks.maxpool_bwd_cuda(z[:0], dp[:0])
    assert empty.shape == (0, 8, 16, 16) and ks.maxpool_bwd_launches == before
