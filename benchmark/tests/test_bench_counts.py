"""Each count function against hand arithmetic at one shape."""

import json
import math

import pytest
import torch

from benchmark import counts
from benchmark.harness import HERE

BW, F32, BF16 = 3.35e12, 67e12, 989e12


def test_nms_bound():
    ms, by = counts.nms_bound_ms(2, 10, 3, 100)
    assert by == "bytes"
    assert ms == pytest.approx((2 * 10 * 24 + 2 * 3 * 8) / BW * 1e3)
    ms, by = counts.nms_bound_ms(1, 1, 1, 10 ** 9)
    assert by == "operations" and ms == pytest.approx(14e9 / F32 * 1e3)


def test_match_bound():
    ms, by = counts.match_bound_ms(2, 100, 5, 7)
    assert by == "bytes"
    want = 100 * 16 + 2 * 5 * 21 + 2 * 100 * 28
    assert ms == pytest.approx(want / BW * 1e3)


def test_bottleneck_bounds():
    # m = 64: c = 256; macs a pixel 256*64 + 9*64*64 + 64*256 = 69,632
    ms, by = counts.bottleneck_bound_ms(32, 160, 160, 64)
    assert by == "bytes"
    assert ms == pytest.approx(2 * 32 * 160 * 160 * 256 * 2 / BW * 1e3)
    ms, by = counts.bottleneck_bwd_bound_ms(1, 10, 10, 512)
    macs = (2048 * 512 * 2 + 9 * 512 * 512) * 100
    assert by == "operations"
    assert ms == pytest.approx(6 * macs / BF16 * 1e3)


def test_fused_block_shapes():
    assert counts.fused_block_shapes(50, (640, 640)) == \
        [(160, 160, 64)] * 2 + [(80, 80, 128)] * 3


def test_match_listed_pairs_culls_far_gts():
    anchors = torch.tensor([[0, 0, 10, 10], [5, 5, 15, 15],
                            [100, 100, 110, 110]], dtype=torch.float32)
    boxes = torch.tensor([[[0, 0, 8, 8], [200, 200, 210, 210]]],
                         dtype=torch.float32)
    valid = torch.tensor([[True, True]])
    # one block of 2 anchors sees GT 0 only; the block of anchor 2 none
    assert counts.match_listed_pairs(anchors, boxes, valid, per=2) == 2


def test_nms_pairs_lower():
    assert counts.nms_pairs_lower(100) == 4950
    assert counts.nms_pairs_lower(0) == 0


def _model(**kw):
    conf = json.loads((HERE / "configs" / "retinanet_r50_1024.json")
                      .read_text())
    return {**conf["model"], "image_size": [640, 640], **kw}


def test_forward_flops_of_the_head_by_hand():
    cells = sum(math.ceil(640 / 2 ** lvl) ** 2 for lvl in range(3, 8))
    full = counts.forward_flops(_model())
    one = counts.forward_flops(_model(num_classes=1))
    assert full - one == pytest.approx(2 * cells * 9 * 256 * 9 * 79)
    three = counts.forward_flops(_model(num_head_convs=3))
    assert full - three == pytest.approx(2 * 2 * cells * 9 * 256 * 256)


def test_forward_flops_of_r50_and_r101():
    r50 = counts.forward_flops(_model())
    r101 = counts.forward_flops(_model(backbone_depth=101))
    # 17 more layer3 blocks at 40 x 40: 1024->256, 3x3 256, 256->1024
    extra = 17 * 2 * 40 * 40 * (1024 * 256 + 9 * 256 * 256 + 256 * 1024)
    assert r101 - r50 == pytest.approx(extra)
    assert 170e9 < r50 < 210e9


def test_shares():
    assert counts.shares(989e12, 1.0) == pytest.approx(100.0)
