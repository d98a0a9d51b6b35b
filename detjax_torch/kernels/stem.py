"""Stem max-pool (3x3, stride 2, pad 1): the CUDA backward's wrapper and its
plain twin.

The counterpart of ``detjax/kernels/stem.py``. ``maxpool_bwd_cuda``
replaces the TPU kernel ``_maxpool_bwd`` (body ``_bwd_kernel``) with the
hand-written kernel in ``detjax_torch/csrc/maxpool_bwd.cu``. It recomputes
each window's max from z and routes the window's dp to the first tap in
scan order (row, then column) that equals it, detjax's rule:

- the max propagates NaN, so a window holding NaN routes nowhere;
- an out-of-range tap reads as -inf, so a border window whose real taps are
  all -inf routes to its first (padding) tap, which is nowhere;
- each dz pixel sums, in fp32 from +0.0, the dp of the windows that route
  to it in tap scan order, then rounds once to dp's dtype.

ATen's ``F.max_pool2d`` backward differs on exactly those inputs (it sends
an all--inf border window to its first in-bounds pixel, a NaN window to its
last NaN, and sums a pixel's windows in the reverse order, so fp32 sums
round differently), so the twin routes by hand. What bounds the kernel on
an H100: bytes (z and dp read once, dz written once: 471.9 MB, 0.141 ms at
3.35 TB/s, at the R50-640 training stem [16, 64, 320, 320] bf16). The
kernel's strip instance takes bf16 with C a multiple of 64 and 16-byte
aligned buffers (the stem): a block stages its strip of z and dp in shared
memory by 16-byte ``cp.async`` and routes 8 channels a thread on bf16
pairs; fp32, other C and unaligned views take the gather instance (one
thread a 2x2 dz block).

As in detjax, :func:`max_pool_3x3s2` is wired into nothing: the port's
``ResNet.forward`` keeps ATen's pool, as detjax's keeps XLA's
(``detjax/models/resnet.py``). It is an autograd function: ATen's forward,
z saved (the ReLU before it keeps z already) and no indices, and the kernel
as its backward.

Layout: NCHW tensors in any memory format. The kernel reads z and dp and
writes dz as NHWC, which is the port's channels-last NCHW; other layouts
are copied once and counted in ``maxpool_bwd_copies``.

Routing: a CPU tensor goes to the twin :func:`maxpool_bwd_reference`; a
CUDA tensor goes to the kernel or raises. ``maxpool_bwd_launches`` counts
kernel launches, and nothing else; ``maxpool_bwd_strip_launches`` those of
them that ran the strip instance.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

maxpool_bwd_launches = 0
maxpool_bwd_strip_launches = 0
maxpool_bwd_copies = 0

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from detjax_torch.kernels._build import load_library

        lib = load_library("detjax_maxpool_bwd", ["maxpool_bwd.cu"])
        fn = lib.detjax_maxpool_bwd_launch
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        which = lib.detjax_maxpool_bwd_instance
        which.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
        which.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def max_pool_3x3s2_reference(z: torch.Tensor) -> torch.Tensor:
    """The forward: max over 3x3 windows, stride 2, -inf padding of 1."""
    return F.max_pool2d(z, 3, stride=2, padding=1)


def _check(z: torch.Tensor, dp: torch.Tensor) -> None:
    if z.dim() != 4 or dp.dim() != 4:
        raise ValueError(f"z and dp must be NCHW, got {tuple(z.shape)} and "
                         f"{tuple(dp.shape)}")
    b, c, hz, wz = z.shape
    if hz % 2 or wz % 2:
        raise ValueError(f"z's height and width must be even (detjax splits "
                         f"them into row and column pairs), got {hz}x{wz}")
    if tuple(dp.shape) != (b, c, hz // 2, wz // 2):
        raise ValueError(f"dp must be {(b, c, hz // 2, wz // 2)} for z of "
                         f"{tuple(z.shape)}, got {tuple(dp.shape)}")
    if z.device != dp.device:
        raise ValueError("z and dp must be on one device")


def maxpool_bwd_reference(z: torch.Tensor, dp: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`maxpool_bwd_cuda`, detjax's rule step
    by step: the 9 stride-2 taps of -inf-padded z, their NaN-propagating
    max, first-match routing with a ``taken`` mask, fp32 sums onto a padded
    dz in tap order, the padding cropped, one rounding to dp's dtype."""
    _check(z, dp)
    b, c, hz, wz = z.shape
    h, w = hz // 2, wz // 2
    fmt = (torch.channels_last if z.is_contiguous(
        memory_format=torch.channels_last) else torch.contiguous_format)
    zp = F.pad(z.to(torch.float32), (1, 1, 1, 1), value=float("-inf"))
    taps = [zp[:, :, d:d + 2 * h:2, e:e + 2 * w:2]
            for d in range(3) for e in range(3)]
    m = taps[0]
    for t in taps[1:]:
        m = torch.maximum(m, t)
    g = dp.to(torch.float32)
    taken = torch.zeros_like(m, dtype=torch.bool)
    dzp = torch.zeros_like(zp)
    for k, t in enumerate(taps):
        d, e = divmod(k, 3)
        eq = (t == m) & ~taken
        taken |= eq
        dzp[:, :, d:d + 2 * h:2, e:e + 2 * w:2] += torch.where(eq, g, 0.0)
    return dzp[:, :, 1:-1, 1:-1].to(dp.dtype).contiguous(memory_format=fmt)


def maxpool_bwd_cuda(z: torch.Tensor, dp: torch.Tensor) -> torch.Tensor:
    """The 3x3/s2/pad-1 max-pool's backward: z [B, C, 2H, 2W] and dp
    [B, C, H, W], bf16 or fp32 (one dtype). Returns dz, z's shape in dp's
    dtype, channels-last."""
    global maxpool_bwd_launches, maxpool_bwd_strip_launches
    global maxpool_bwd_copies
    _check(z, dp)
    if z.device.type == "cpu":
        return maxpool_bwd_reference(z, dp)
    if z.device.type != "cuda":
        raise ValueError(f"maxpool_bwd_cuda takes CPU or CUDA tensors, got "
                         f"{z.device}")
    if z.dtype not in (torch.float32, torch.bfloat16) or dp.dtype != z.dtype:
        raise TypeError(f"z and dp must both be float32 or both bfloat16, "
                        f"got {z.dtype} and {dp.dtype}")
    cl = torch.channels_last
    b, c, hz, wz = z.shape
    h, w = hz // 2, wz // 2
    if h > 65535 or b > 65535:
        raise ValueError(f"B={b} and H={h} must be at most 65535 (grid "
                         f"dimensions)")
    dz = torch.empty_like(z, memory_format=cl)
    if dz.numel() == 0:
        return dz
    z_cl, dp_cl = z.contiguous(memory_format=cl), dp.contiguous(
        memory_format=cl)
    maxpool_bwd_copies += (z_cl.data_ptr() != z.data_ptr()) + (
        dp_cl.data_ptr() != dp.data_ptr())
    dev = z.device.index if z.device.index is not None \
        else torch.cuda.current_device()
    stream = torch.cuda.current_stream(dev).cuda_stream
    bf16 = int(z.dtype == torch.bfloat16)
    lib = _lib()
    strip = lib.detjax_maxpool_bwd_instance(
        z_cl.data_ptr(), dp_cl.data_ptr(), dz.data_ptr(), b, c, bf16)
    err = lib.detjax_maxpool_bwd_launch(
        z_cl.data_ptr(), dp_cl.data_ptr(), dz.data_ptr(), b, h, w, c, bf16,
        dev, stream)
    if err != 0:
        raise RuntimeError(f"max-pool backward kernel launch failed: "
                           f"cudaError {err}")
    maxpool_bwd_launches += 1
    maxpool_bwd_strip_launches += strip
    return dz


class _MaxPool3x3s2(torch.autograd.Function):
    """ATen's pool forward, the kernel as its backward; saves only z."""

    @staticmethod
    def forward(ctx, z):
        ctx.save_for_backward(z)
        return max_pool_3x3s2_reference(z)

    @staticmethod
    def backward(ctx, dp):
        (z,) = ctx.saved_tensors
        return maxpool_bwd_cuda(z, dp)


def max_pool_3x3s2(z: torch.Tensor) -> torch.Tensor:
    """3x3/s2/pad-1 max pool whose gradient routes as detjax's
    ``max_pool_3x3s2``: first max in window scan order, NaN windows and
    all--inf border windows nowhere."""
    return _MaxPool3x3s2.apply(z)


def seeded_pool_inputs(seed: int, b: int, hz: int, wz: int, c: int,
                       hard: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """Seeded fp32 NHWC ``(z [b, hz, wz, c], dp [b, hz/2, wz/2, c])``, the
    one generator of the tests and ``chip_smoke.py``.

    z is the ReLU of normals with all-zero 4x4 patches, so windows tie at 0
    as in the stem. ``hard`` adds, in every image: rows rounded to steps of
    0.5 (equal maxima in many windows); two equal maxima in window (1, 1);
    all--inf windows at the top-left corner, the top and the left border
    (their padding taps come first) and in the interior; NaN. It needs hz
    and wz of at least 16."""
    rng = np.random.default_rng(seed)
    z = np.maximum(rng.standard_normal((b, hz, wz, c), dtype=np.float32), 0)
    ys, xs = np.arange(hz)[:, None] // 4, np.arange(wz)[None, :] // 4
    z[:, (ys + xs) % 7 == 0] = 0.0
    dp = rng.standard_normal((b, hz // 2, wz // 2, c), dtype=np.float32)
    if not hard:
        return z, dp
    if hz < 16 or wz < 16:
        raise ValueError(f"hard inputs need hz, wz >= 16, got {hz}x{wz}")
    z[:, ::5] = np.round(z[:, ::5] * 2) / 2
    z[:, 2, 3] = z[:, 3, 2] = 9.0
    inf, ch, cw = np.float32(-np.inf), hz // 2, wz // 2
    z[:, 0:2, 0:2, ::3] = inf  # corner window (0, 0)
    z[:, 0:2, 5:8, 1::3] = inf  # top window (0, 3)
    z[:, 9:12, 0:2, 2::3] = inf  # left window (5, 0)
    z[:, ch - 1:ch + 2, cw - 1:cw + 2, ::2] = inf  # interior window
    z[:, ch + 4, cw + 4, ::5] = np.nan
    n = max(1, b * hz * wz // 4096)
    z[rng.integers(0, b, n), rng.integers(0, hz, n), rng.integers(0, wz, n),
      rng.integers(0, c, n)] = np.nan
    return z, dp
