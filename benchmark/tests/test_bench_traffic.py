"""The generators repeat exactly for a seed and differ across seeds."""

import numpy as np
import torch

from benchmark.drivers.serve import content_sizes
from benchmark.traffic import arrivals, scenes


def _scene(seed):
    gen = torch.Generator().manual_seed(seed + 1)
    rng = np.random.default_rng(seed)
    img = scenes.canvases(4, (64, 64), [(64, 48), (40, 64)], gen, "cpu")
    cnt = scenes.gt_counts(32, 7.3, 1.0, 100, rng)
    boxes, labels = scenes.gt_boxes(cnt, (64, 64), 100, 80,
                                    (0.41, 0.34, 0.25), (4, 32, 96, 640),
                                    1.0, rng)
    return img, cnt, boxes, labels


def test_scenes_repeat_for_a_seed():
    a, b = _scene(2 ** 31 + 5), _scene(2 ** 31 + 5)
    assert torch.equal(a[0], b[0])
    for x, y in zip(a[1:], b[1:]):
        assert np.array_equal(x, y)


def test_scenes_differ_across_seeds():
    a, b = _scene(1), _scene(2)
    assert not torch.equal(a[0], b[0])
    assert not np.array_equal(a[2], b[2])


def test_every_seed_sends_the_same_counts_in_its_own_order():
    a, b = _scene(1)[1], _scene(2)[1]
    assert sorted(a) == sorted(b) and not np.array_equal(a, b)
    assert a.min() >= 1 and a.max() <= 100
    assert abs(a.mean() - 7.3) < 1.0


def test_boxes_lie_inside_the_canvas_and_padding_is_marked():
    _, cnt, boxes, labels = _scene(3)
    for i, c in enumerate(cnt):
        assert (labels[i, :c] >= 0).all() and (labels[i, c:] == -1).all()
        b = boxes[i, :c]
        assert (b[:, 0] >= 0).all() and (b[:, 2] <= 64).all()
        assert (b[:, 2] > b[:, 0]).all() and (b[:, 3] > b[:, 1]).all()


def test_canvases_pad_outside_their_content():
    img = _scene(4)[0]
    # content (h, w): canvas 0 holds 64 x 48, canvas 1 holds 40 x 64
    assert (img[0, :, 48:] == 0).all() and (img[1, 40:] == 0).all()
    assert img[0, :, :48].float().std() > 10


def test_arrivals_repeat_and_share_their_gaps():
    def stream(seed):
        rng = np.random.default_rng(seed)
        return (arrivals.poisson_offsets(1000, 500.0, rng),
                arrivals.canvas_order(1000, 256, rng))
    a, b, c = stream(9), stream(9), stream(10)
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    assert not np.array_equal(a[0], c[0])
    ga, gc = np.diff(a[0], prepend=0), np.diff(c[0], prepend=0)
    assert np.allclose(np.sort(ga), np.sort(gc))
    assert abs(a[0][-1] - 2.0) < 0.01  # 1000 requests at 500/s
    assert sorted(a[1][:256]) == list(range(256))


def test_content_follows_the_resize_rule_and_fits_the_canvas():
    got = content_sizes((1024, 1024), [(640, 480), (480, 640), (500, 375),
                                       (1000, 300)], (608, 1024))
    # shortest side to 608; the longest side stops at 1024
    assert got == [[608, 811], [811, 608], [608, 811], [307, 1024]]
    assert content_sizes((512, 512), [(640, 480)], (608, 1024)) == \
        [[384, 512]]
