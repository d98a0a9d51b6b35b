"""The port's FPN under bf16 autocast on the CPU, where P6 or P7's input is
1x1 (canvases of 64 px and less).

PyTorch's CPU bf16 convolution computes the weight gradient of a 3x3
stride-2 conv with a 1x1 input from uninitialised memory: inf, NaN or
values near 1e17 in more than half of fresh draws at batch 16.
``models/fpn.stride2_conv`` computes that case as an fp32 convolution of the
bf16-rounded operands (what autocast computes: bf16 operands, fp32 sums,
bf16 out). These tests hold it to that, and R50 training at 64 px to finite
gradients.
"""

import numpy as np
import pytest
import torch

import detjax_torch
from detjax_torch.models.fpn import FPN, stride2_conv

# One intra-op thread a process: pytest-xdist runs several workers on
# the host's cores, and torch's default of a thread a core in each
# worker oversubscribes them many times over.
torch.set_num_threads(1)

R50_CHANNELS = (256, 512, 1024, 2048)


@pytest.mark.parametrize("level", ["P6", "P7_2"])
def test_stride2_conv_weight_grad_at_1x1_is_finite_and_right(level):
    """20 fresh draws of the conv and a [16, C, 1, 1] channels-last input
    under CPU bf16 autocast: every weight and bias gradient finite and
    within bf16 tolerance (2 % of its max, in the max norm) of the same
    conv computed in fp32 without autocast."""
    for draw in range(20):
        torch.manual_seed(draw)
        fpn = FPN(R50_CHANNELS)
        conv = getattr(fpn, level)
        x = torch.randn(16, conv.in_channels, 1, 1).to(
            memory_format=torch.channels_last)
        g = torch.randn(16, conv.out_channels, 1, 1)
        with torch.autocast("cpu", dtype=torch.bfloat16):
            y = stride2_conv(conv, x)
        assert y.dtype == torch.bfloat16 and y.shape == g.shape
        (y.float() * g).sum().backward()
        got = (conv.weight.grad.clone(), conv.bias.grad.clone())
        conv.zero_grad()
        (conv(x) * g).sum().backward()
        want = (conv.weight.grad, conv.bias.grad)
        for name, a, b in zip(("weight", "bias"), got, want):
            assert torch.isfinite(a).all(), (draw, name)
            err = (a - b).abs().max().item()
            assert err <= 0.02 * b.abs().max().item(), (draw, name, err)


def test_stride2_conv_elsewhere_is_the_plain_conv():
    """Off the 1x1 case, or without bf16 autocast, the route is ``conv(x)``
    itself: the same bits."""
    torch.manual_seed(0)
    conv = FPN(R50_CHANNELS).P7_2
    for shape, autocast in (((2, 256, 2, 2), True), ((2, 256, 1, 1), False)):
        x = torch.randn(*shape)
        with torch.autocast("cpu", dtype=torch.bfloat16, enabled=autocast):
            assert torch.equal(stride2_conv(conv, x), conv(x))


def test_r50_trains_at_64px_in_bf16_with_finite_gradients():
    """Five train_steps of R50 at 64 px, batch 2, bf16 on the CPU: P6 is
    1x1 there; every step's grad_norm and loss finite."""
    state = detjax_torch.make_train_state(
        "retinanet_r50_640", seed=0, device="cpu",
        **{"model.image_size": (64, 64), "model.num_classes": 8,
           "train.batch_size": 2, "train.max_gt": 4})
    rng = np.random.default_rng(0)
    batch = {"images": rng.integers(0, 256, (2, 64, 64, 3), np.uint8),
             "gt_boxes": np.tile(np.array([[8, 8, 40, 36]], np.float32),
                                 (2, 4, 1)),
             "gt_labels": np.array([[1, 5, -1, -1]] * 2, np.int32)}
    for step in range(5):
        state, m = detjax_torch.train_step(state, batch)
        assert np.isfinite(float(m["grad_norm"])), (step, m)
        assert np.isfinite(float(m["loss"])), (step, m)
