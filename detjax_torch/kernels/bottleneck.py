"""Fused identity bottleneck: the CUDA kernels' wrappers and their twins.

``bottleneck_identity`` replaces the TPU kernels ``detjax/kernels/
bottleneck.py::_bottleneck_fwd`` (body ``_fwd_kernel``) and, for its
gradient, ``_bottleneck_bwd`` (body ``_bwd_kernel``) with the hand-written
kernels in ``detjax_torch/csrc/bottleneck.cu`` and
``detjax_torch/csrc/bottleneck_bwd.cu``, which share their tiles and
products through ``csrc/bottleneck_common.cuh``. The forward computes a
whole stride-1 ResNet identity block with its frozen BatchNorms folded into
the convs: ``relu(conv3(relu(conv2(relu(conv1(x))))) + x)``, in bf16 with
fp32 accumulation, rounding where ``_fwd_kernel`` rounds. Both cut the
B H W pixels into flat 128-pixel tiles (a tile may straddle rows and
images), so both take any width W. The forward is two launches: y1 to a
transient bf16 scratch, then per tile the 3x3 over y1 read back with its
halo (zero outside the image) into shared memory, and the second 1x1, the
residual and the ReLU 64 channels at a time; y2 never reaches device
memory. :func:`fwd_plan` is its partition in Python. The backward
recomputes y1 and y2 from x and returns dx and the six weight and bias
gradients, rounding where ``_bwd_kernel`` rounds, in five launches: three
kernels over the same tiles write dx and every weight-gradient operand to
transient bf16 scratch, a split-K kernel reduces the weight gradients over
contiguous pixel ranges into one fp32 partial per part, and a last kernel
sums the partials and the tiles' bias sums in a fixed order (the bits do
not change between runs). :func:`bwd_plan` is its partition in Python.
Every product of both is Hopper's ``wgmma`` from 128-byte-swizzled shared
tiles.

What bounds them on an H100: the forward is bound by bytes at the main
path's shapes, reading x and writing the output once (210 MB for layer1 at
B=8, 0.063 ms at 3.35 TB/s), with the tensor-core operations just below
(28.5 GFLOP, 0.029 ms at 989 TFLOP/s). The backward at the training shapes
(B=16) is bound by bytes at layer1 (x and dy read, dx written: 0.188 ms) and
by operations at layer2 (three times the forward's: 0.173 ms). Both are far
from those bounds; their times are in ``PERF.md``.

Layout: NHWC, as detjax's kernels take it. The port's modules hold NCHW
tensors in ``channels_last`` memory, so ``x.permute(0, 2, 3, 1)`` is
already a contiguous NHWC view and the output's ``permute(0, 3, 1, 2)``
is a ``channels_last`` NCHW view: no transpose runs on the main path. The
folded weights are small contiguous copies.

Routing: :func:`bottleneck_identity` runs the autograd function
``_FusedBottleneck``. Its forward sends a CPU tensor to the plain twin
:func:`bottleneck_identity_reference` and a CUDA tensor to the forward
kernels (or raises); its backward sends CPU tensors to the plain twin
:func:`bottleneck_identity_backward_reference` and CUDA tensors to the
backward kernels (or raises). Tests and ``chip_smoke.py`` call the twins
directly on any device to compare whole paths
(``Detector.bottleneck_backend="torch"`` differentiates through the forward
twin by plain autograd). ``bottleneck_launches`` counts calls of the fused
forward on CUDA tensors and ``bottleneck_kernel_launches`` the CUDA kernels
they launched; ``bottleneck_bwd_launches`` and
``bottleneck_bwd_kernel_launches`` count the same for the backward. The
kernels are counted as the launchers count them (one for each launch the
CUDA runtime accepted; ``FWD_KERNELS`` and ``BWD_KERNELS`` a call), and
nothing else; ``bottleneck_bwd_grad_copies`` counts gradients that arrived
in another layout or dtype than the kernel takes and were copied.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

# Widths the kernels are instantiated for (M = C / 4): R50/101/152's layer1
# and layer2 (64, 128) and narrow test widths.
WIDTHS = (16, 32, 64, 128)

bottleneck_launches = 0  # calls of the fused forward
bottleneck_kernel_launches = 0  # CUDA kernels those calls launched
bottleneck_bwd_launches = 0  # calls of the fused backward
bottleneck_bwd_kernel_launches = 0  # CUDA kernels those calls launched
bottleneck_bwd_grad_copies = 0

_LIB = None
_BWD_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from detjax_torch.kernels._build import load_library

        lib = load_library("detjax_bottleneck", ["bottleneck.cu"])
        fn = lib.detjax_bottleneck_fwd_launch
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        lib.detjax_bottleneck_fwd_geometry.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        lib.detjax_bottleneck_fwd_geometry.restype = ctypes.c_int
        for m in WIDTHS:  # the launcher's tiles are fwd_plan's
            tile = _geometry(lib.detjax_bottleneck_fwd_geometry, m,
                             FWD_GEOMETRY)["pixel_tile"]
            if tile != PIXEL_TILE:
                raise RuntimeError(f"the forward library's tile at M={m} is "
                                   f"{tile} pixels, fwd_plan's {PIXEL_TILE}")
        _LIB = lib
    return _LIB


def _bwd_lib():
    global _BWD_LIB
    if _BWD_LIB is None:
        from detjax_torch.kernels._build import load_library

        lib = load_library("detjax_bottleneck_bwd", ["bottleneck_bwd.cu"])
        fn = lib.detjax_bottleneck_bwd_launch
        fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        lib.detjax_bottleneck_bwd_geometry.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        lib.detjax_bottleneck_bwd_geometry.restype = ctypes.c_int
        for m in WIDTHS:  # the launcher's partition is bwd_plan's
            geom = _geometry(lib.detjax_bottleneck_bwd_geometry, m,
                             BWD_GEOMETRY)
            want = {"pixel_tile": BWD_PIXEL_TILE,
                    "pixel_step": BWD_PIXEL_STEP,
                    "weight_tile": bwd_weight_tile(m),
                    "jobs": len(bwd_jobs(m))}
            if {k: geom[k] for k in want} != want:
                raise RuntimeError(f"the backward library's partition at "
                                   f"M={m} is {geom}, bwd_plan's {want}")
        _BWD_LIB = lib
    return _BWD_LIB


# Both directions cut the B H W pixels of a block, one image after another,
# into flat tiles of PIXEL_TILE; the forward launches FWD_KERNELS a call.
PIXEL_TILE = 128
FWD_KERNELS = 2  # y1, then y2 / y3 / out


def fwd_plan(b: int, h: int, w: int, m: int) -> dict:
    """How the forward cuts a [b, h, w, 4 m] block: pixel tiles of both
    kernels (the backward's activation tiles), the kernels a call and the
    bytes of the bf16 y1 scratch [B H W, M]. Pure arithmetic: the wrapper
    launches with it and the CPU tests check it."""
    npx = b * h * w
    return {"pixel_tile": PIXEL_TILE, "tiles": -(-npx // PIXEL_TILE),
            "kernels": FWD_KERNELS, "scratch_bytes": 2 * npx * m}


# What the launchers' geometry calls report, in order
FWD_GEOMETRY = ("pixel_tile", "smem_y1", "smem_tile")
BWD_GEOMETRY = ("pixel_tile", "pixel_step", "weight_tile", "jobs", "smem_y1",
                "smem_tile", "smem_wgrad")


def _geometry(fn, m: int, keys) -> dict:
    out = (ctypes.c_int * len(keys))()
    err = fn(m, out)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} failed: cudaError {err} (M={m})")
    return dict(zip(keys, out))


def fwd_geometry(m: int) -> dict:
    """The forward launcher's pixel tile at ``M = m`` and the dynamic
    shared memory of its kernels, ``smem_y1`` and ``smem_tile``; neither
    depends on W (builds the library)."""
    return _geometry(_lib().detjax_bottleneck_fwd_geometry, m, FWD_GEOMETRY)


# The backward's partition (csrc/bottleneck_bwd.cu; the launcher reports
# its copy through detjax_bottleneck_bwd_geometry, checked when the library
# loads):
# the activation kernels own the pixels of one image after another in tiles
# of BWD_PIXEL_TILE; the weight-gradient kernel cuts dw1 / dw2 (per tap) /
# dw3 into square tiles of bwd_weight_tile(M) and reduces each over
# contiguous pixel ranges ("parts") in steps of BWD_PIXEL_STEP.
BWD_PIXEL_TILE = PIXEL_TILE
BWD_PIXEL_STEP = 64
BWD_KERNELS = 5  # y1, dy3/dc2, dc1/dx, weight gradients, ordered sums
# weight-gradient blocks (jobs x parts) to aim at, per SM: 8, 16 and 32
# timed within 3 % of each other on an H100 at R50's shapes; 16 keeps the
# partials under 40 MB
BWD_BLOCKS_PER_SM = 16


def bwd_weight_tile(m: int) -> int:
    return min(64, m)


def bwd_jobs(m: int) -> list:
    """The weight-gradient kernel's jobs at ``M = m``, in launch order:
    ``(gradient, tap, row0, col0)`` tiles of dw1 [C, M], dw2[tap] [M, M]
    (tap = 3 ky + kx) and dw3 [M, C]; together they cover each element of
    the three gradients once."""
    t, c = bwd_weight_tile(m), 4 * m
    jobs = [("dw1", None, a, b) for a in range(0, c, t)
            for b in range(0, m, t)]
    jobs += [("dw2", k, a, b) for k in range(9) for a in range(0, m, t)
             for b in range(0, m, t)]
    jobs += [("dw3", None, a, b) for a in range(0, m, t)
             for b in range(0, c, t)]
    return jobs


def bwd_plan(b: int, h: int, w: int, m: int, sms: int = None) -> dict:
    """How the backward cuts a [b, h, w, 4 m] block for a card with ``sms``
    SMs (default: CUDA device 0's): pixel tiles of the activation kernels,
    the weight-gradient jobs, its parts (``parts`` contiguous ranges of
    ``part_pixels`` pixels, the last one shorter) and the bytes of the bf16
    scratch (y1, y2, bf16(dc2), bf16(dc1) [B H W, M]; bf16(dy3) [B H W, C])
    and of the fp32 workspaces (one slice of the three weight gradients per
    part, one row of the bias sums per tile). Pure arithmetic: the wrapper
    launches with it and the CPU tests check it."""
    if sms is None:
        sms = torch.cuda.get_device_properties(0).multi_processor_count
    c, npx = 4 * m, b * h * w
    tiles = -(-npx // BWD_PIXEL_TILE)
    jobs = len(bwd_jobs(m))
    parts = max(1, min(-(-BWD_BLOCKS_PER_SM * sms // jobs),
                       -(-npx // (8 * BWD_PIXEL_STEP))))
    part_pixels = -(-npx // parts)
    part_pixels = -(-part_pixels // BWD_PIXEL_STEP) * BWD_PIXEL_STEP
    parts = -(-npx // part_pixels)
    weight_floats = 2 * c * m + 9 * m * m
    return {"pixel_tile": BWD_PIXEL_TILE, "pixel_step": BWD_PIXEL_STEP,
            "tiles": tiles,
            "weight_tile": bwd_weight_tile(m), "jobs": jobs,
            "parts": parts, "part_pixels": part_pixels,
            "kernels": BWD_KERNELS,
            "scratch_bytes": 2 * npx * (4 * m + c),
            "workspace_bytes": 4 * (parts * weight_floats + tiles * 6 * m)}


def bwd_geometry(m: int) -> dict:
    """The launcher's own copy of the partition constants at ``M = m`` and
    the dynamic shared memory of its kernels: ``smem_y1``, ``smem_tile``
    (dc2_kernel and dc1_kernel each) and ``smem_wgrad`` (builds the
    library)."""
    return _geometry(_bwd_lib().detjax_bottleneck_bwd_geometry, m,
                     BWD_GEOMETRY)


def bottleneck_identity_reference(x: torch.Tensor, w1: torch.Tensor,
                                  b1: torch.Tensor, w2: torch.Tensor,
                                  b2: torch.Tensor, w3: torch.Tensor,
                                  b3: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the fused block, after detjax's
    ``bottleneck_identity_reference``: fp32 convolutions on the
    bf16-rounded input, bf16 rounding after y1, after y2 and at the
    output. Shapes as :func:`bottleneck_identity`; runs with autocast off
    so that the convolutions stay fp32."""
    with torch.autocast(device_type=x.device.type, enabled=False):
        xf = x.to(torch.bfloat16).permute(0, 3, 1, 2).float()

        def conv(v, w_hwio, pad):
            return F.conv2d(v, w_hwio.float().permute(3, 2, 0, 1),
                            padding=pad)

        def bias(b):
            return b.float().reshape(1, -1, 1, 1)

        y1 = torch.relu(conv(xf, w1[None, None], 0) + bias(b1))
        y1 = y1.to(torch.bfloat16).float()
        y2 = torch.relu(conv(y1, w2, 1) + bias(b2))
        y2 = y2.to(torch.bfloat16).float()
        y3 = conv(y2, w3[None, None], 0) + bias(b3)
        out = torch.relu(y3 + xf).to(torch.bfloat16)
    return out.permute(0, 2, 3, 1)


def bottleneck_identity_backward_reference(
        x: torch.Tensor, dy: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
        w2: torch.Tensor, b2: torch.Tensor, w3: torch.Tensor,
        b3: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of ``_bwd_kernel``'s math on whole images:
    fp32 convolutions with autocast off, y1 and y2 recomputed and rounded
    as the forward rounds them, and the kernel's roundings of the
    gradients: bf16 at dy3, dc2 and dc1 before each product, fp32 bias
    sums, the ReLU masks on ``y3 + x`` in fp32 and on the bf16 y2 and y1,
    and ``dx = bf16(dy3 + bf16(dc1) @ w1^T)`` with the unrounded dy3.

    x and dy [B, H, W, C] bf16 NHWC, weights as :func:`bottleneck_identity`.
    Returns ``(dx, dw1, db1, dw2, db2, dw3, db3)``: dx [B, H, W, C] bf16,
    the rest fp32 in the shapes of w1, b1, w2, b2, w3, b3."""
    with torch.autocast(device_type=x.device.type, enabled=False):
        def nchw(t):
            return t.to(torch.bfloat16).permute(0, 3, 1, 2).float()

        def bf(t):
            return t.to(torch.bfloat16).float()

        def conv1x1(v, w_io):  # w_io [I, O]
            return F.conv2d(v, w_io.float().t()[:, :, None, None])

        def bias(b):
            return b.float().reshape(1, -1, 1, 1)

        k2 = w2.float().permute(3, 2, 0, 1)  # OIHW
        xf, g = nchw(x), nchw(dy)
        y1 = bf(torch.relu(conv1x1(xf, w1) + bias(b1)))
        y2 = bf(torch.relu(F.conv2d(y1, k2, padding=1) + bias(b2)))
        y3 = conv1x1(y2, w3) + bias(b3)
        dy3 = torch.where(y3 + xf > 0, g, 0.0)
        dy3b = bf(dy3)
        dc2 = torch.where(y2 > 0, conv1x1(dy3b, w3.t()), 0.0)
        dc2b = bf(dc2)
        dy1 = F.conv_transpose2d(dc2b, k2, padding=1)
        dc1 = torch.where(y1 > 0, dy1, 0.0)
        dc1b = bf(dc1)
        dx = (dy3 + conv1x1(dc1b, w1.t())).to(torch.bfloat16)
        dw1 = torch.einsum("nchw,nmhw->cm", xf, dc1b)
        dw2 = torch.nn.grad.conv2d_weight(y1, tuple(k2.shape), dc2b,
                                          padding=1).permute(2, 3, 1, 0)
        dw3 = torch.einsum("nmhw,nchw->mc", y2, dy3b)

        def bias_sum(v):
            return v.sum(dim=(0, 2, 3))[None]

    return (dx.permute(0, 2, 3, 1).contiguous(), dw1, bias_sum(dc1),
            dw2.contiguous(), bias_sum(dc2), dw3, bias_sum(dy3))


def _check(x, w1, b1, w2, b2, w3, b3) -> Tuple[int, int, int, int, int]:
    if x.dim() != 4:
        raise ValueError(f"x must be [B, H, W, C], got {tuple(x.shape)}")
    bsz, h, w, c = x.shape
    if w1.dim() != 2 or w1.shape[0] != c:
        raise ValueError(f"w1 must be [C, M] with C={c}, got "
                         f"{tuple(w1.shape)}")
    m = w1.shape[1]
    want = {"w1": (c, m), "b1": (1, m), "w2": (3, 3, m, m), "b2": (1, m),
            "w3": (m, c), "b3": (1, c)}
    for name, t in (("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2),
                    ("w3", w3), ("b3", b3)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, got "
                             f"{tuple(t.shape)}")
    if c != 4 * m:
        raise ValueError(f"an identity bottleneck has C = 4 M, got C={c}, "
                         f"M={m}")
    if len({t.device for t in (x, w1, b1, w2, b2, w3, b3)}) != 1:
        raise ValueError("x and the weights must be on one device")
    return bsz, h, w, c, m


def _check_kernel_args(x, w1, b1, w2, b2, w3, b3, dy=None
                       ) -> Tuple[int, int, int, int, int]:
    """What both kernels take, beyond :func:`_check`; raises on anything
    else."""
    bsz, h, w, c, m = _check(x, w1, b1, w2, b2, w3, b3)
    bf16 = [("x", x), ("w1", w1), ("w2", w2), ("w3", w3)]
    if dy is not None:
        if tuple(dy.shape) != tuple(x.shape):
            raise ValueError(f"dy must be {tuple(x.shape)}, got "
                             f"{tuple(dy.shape)}")
        if dy.device != x.device:
            raise ValueError("x, dy and the weights must be on one device")
        bf16.append(("dy", dy))
    for name, t in bf16:
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} must be bfloat16, got {t.dtype}")
    fp32 = [("b1", b1), ("b2", b2), ("b3", b3)]
    for name, t in fp32:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    for name, t in bf16 + fp32:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous (x and dy as NHWC)")
    for name, t in bf16:
        if t.data_ptr() % 32:
            raise ValueError(f"{name} must be 32-byte aligned")
    if m not in WIDTHS:
        raise ValueError(f"M={m} is not one of the kernel's widths {WIDTHS}")
    return bsz, h, w, c, m


def _stream(dev: torch.device) -> Tuple[int, int]:
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return index, torch.cuda.current_stream(index).cuda_stream


def _launch(x, w1, b1, w2, b2, w3, b3) -> torch.Tensor:
    """Checks what the forward kernels take, then launches them on the
    current stream with the y1 scratch from ``torch.empty`` (freed on
    return; the caching allocator keeps it stream-ordered); raises on
    anything else."""
    global bottleneck_launches, bottleneck_kernel_launches
    bsz, h, w, c, m = _check_kernel_args(x, w1, b1, w2, b2, w3, b3)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = _lib()
    index, stream = _stream(x.device)
    plan = fwd_plan(bsz, h, w, m)
    y1 = torch.empty(bsz * h * w, m, dtype=torch.bfloat16, device=x.device)
    launched = ctypes.c_int(0)
    err = lib.detjax_bottleneck_fwd_launch(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), w3.data_ptr(), b3.data_ptr(), y1.data_ptr(),
        out.data_ptr(), bsz, h, w, m, index, stream, ctypes.byref(launched))
    bottleneck_kernel_launches += launched.value
    if err != 0 or launched.value != plan["kernels"]:
        raise RuntimeError(
            f"bottleneck kernel launch failed: cudaError {err} after "
            f"{launched.value} of {plan['kernels']} kernels (B={bsz}, H={h}, "
            f"W={w}, M={m}; plan {plan})")
    bottleneck_launches += 1
    return out


def _launch_backward(x, dy, w1, b1, w2, b2, w3, b3
                     ) -> Tuple[torch.Tensor, ...]:
    """Checks what the backward kernels take, then launches them on the
    current stream with scratch and workspaces from ``torch.empty`` (freed
    on return; the caching allocator keeps them stream-ordered); raises on
    anything else. Returns the twin's outputs: ``(dx, dw1, db1, dw2, db2,
    dw3, db3)``, all but dx fp32 views of one summed buffer."""
    global bottleneck_bwd_launches, bottleneck_bwd_kernel_launches
    bsz, h, w, c, m = _check_kernel_args(x, w1, b1, w2, b2, w3, b3, dy=dy)
    dx = torch.empty_like(x)
    sizes = (c * m, 9 * m * m, m * c, m, m, c)
    if x.numel() == 0:
        flat = torch.zeros(sum(sizes), dtype=torch.float32, device=x.device)
    else:
        lib = _bwd_lib()
        index, stream = _stream(x.device)
        plan = bwd_plan(bsz, h, w, m, torch.cuda.get_device_properties(index)
                        .multi_processor_count)
        npx = bsz * h * w

        def scratch(width):
            return torch.empty(npx, width, dtype=torch.bfloat16,
                               device=x.device)

        y1, y2, dc2, dc1, d3 = (scratch(m), scratch(m), scratch(m),
                                scratch(m), scratch(c))
        wsw = torch.empty(plan["parts"], sum(sizes[:3]), dtype=torch.float32,
                          device=x.device)
        wsb = torch.empty(plan["tiles"], sum(sizes[3:]), dtype=torch.float32,
                          device=x.device)
        flat = torch.empty(sum(sizes), dtype=torch.float32, device=x.device)
        launched = ctypes.c_int(0)
        err = lib.detjax_bottleneck_bwd_launch(
            x.data_ptr(), dy.data_ptr(), w1.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), b2.data_ptr(), w3.data_ptr(), b3.data_ptr(),
            dx.data_ptr(), y1.data_ptr(), y2.data_ptr(), d3.data_ptr(),
            dc2.data_ptr(), dc1.data_ptr(), wsw.data_ptr(), wsb.data_ptr(),
            flat.data_ptr(), bsz, h, w, m, plan["parts"],
            plan["part_pixels"], index, stream, ctypes.byref(launched))
        bottleneck_bwd_kernel_launches += launched.value
        if err != 0 or launched.value != plan["kernels"]:
            raise RuntimeError(
                f"bottleneck backward kernel launch failed: cudaError {err} "
                f"after {launched.value} of {plan['kernels']} kernels (B={bsz}"
                f", H={h}, W={w}, M={m}; plan {plan})")
        bottleneck_bwd_launches += 1
    dw1, dw2, dw3, db1, db2, db3 = flat.split(sizes)
    return (dx, dw1.view(c, m), db1.view(1, m), dw2.view(3, 3, m, m),
            db2.view(1, m), dw3.view(m, c), db3.view(1, c))


class _FusedBottleneck(torch.autograd.Function):
    """The kernels (or, for CPU tensors, the twins) as one autograd
    function, after detjax's custom VJP (``_op_fwd`` / ``_op_bwd``): the
    forward saves x and the six folded tensors, the backward recomputes
    from them."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, w3, b3):
        ctx.save_for_backward(x, w1, b1, w2, b2, w3, b3)
        if x.device.type == "cpu":
            return bottleneck_identity_reference(x, w1, b1, w2, b2, w3, b3)
        if x.device.type != "cuda":
            raise ValueError(f"bottleneck_identity takes CPU or CUDA "
                             f"tensors, got {x.device}")
        return _launch(x, w1, b1, w2, b2, w3, b3)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_out):
        global bottleneck_bwd_grad_copies
        x, w1, b1, w2, b2, w3, b3 = ctx.saved_tensors
        dy = grad_out
        if dy.dtype != torch.bfloat16 or not dy.is_contiguous():
            bottleneck_bwd_grad_copies += 1
            dy = dy.to(torch.bfloat16).contiguous()
        dx, dw1, db1, dw2, db2, dw3, db3 = bottleneck_identity_backward(
            x, dy, w1, b1, w2, b2, w3, b3)
        # as detjax's _op_bwd: weight gradients in the folded weights'
        # dtype (bf16), bias gradients fp32
        return (dx, dw1.to(w1.dtype), db1.to(b1.dtype), dw2.to(w2.dtype),
                db2.to(b2.dtype), dw3.to(w3.dtype), db3.to(b3.dtype))


def bottleneck_identity(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                        w2: torch.Tensor, b2: torch.Tensor, w3: torch.Tensor,
                        b3: torch.Tensor) -> torch.Tensor:
    """Fused stride-1 identity bottleneck, BN folded into w and b: the CUDA
    kernels for CUDA tensors, the plain twins for CPU tensors; its gradient
    is the backward kernel's (or twin's).

    x [B, H, W, C] bf16 NHWC; w1 [C, M], w2 [3, 3, M, M] (HWIO), w3 [M, C]
    bf16; b1 [1, M], b2 [1, M], b3 [1, C] fp32 (:meth:`detjax_torch.
    models.resnet.Bottleneck.folded_weights` makes them). Returns
    [B, H, W, C] bf16.
    """
    _check(x, w1, b1, w2, b2, w3, b3)
    return _FusedBottleneck.apply(x, w1, b1, w2, b2, w3, b3)


def bottleneck_identity_backward(x: torch.Tensor, dy: torch.Tensor,
                                 w1: torch.Tensor, b1: torch.Tensor,
                                 w2: torch.Tensor, b2: torch.Tensor,
                                 w3: torch.Tensor, b3: torch.Tensor
                                 ) -> Tuple[torch.Tensor, ...]:
    """The fused block's backward: the CUDA kernel for CUDA tensors (or
    raises), the plain twin :func:`bottleneck_identity_backward_reference`
    for CPU tensors. x and dy [B, H, W, C] bf16 NHWC, the folded weights as
    :func:`bottleneck_identity`. Returns ``(dx, dw1, db1, dw2, db2, dw3,
    db3)``: dx bf16, the sums fp32 in the shapes of the weights."""
    if x.device.type == "cpu":
        _check(x, w1, b1, w2, b2, w3, b3)
        return bottleneck_identity_backward_reference(
            x, dy, w1, b1, w2, b2, w3, b3)
    if x.device.type != "cuda":
        raise ValueError(f"bottleneck_identity_backward takes CPU or CUDA "
                         f"tensors, got {x.device}")
    return _launch_backward(x, dy, w1, b1, w2, b2, w3, b3)


def seeded_block(seed: int, b: int, h: int, w: int, m: int, device):
    """Seeded inputs for holding the kernel against its twin: x =
    relu(N(0, 1)) as bf16 NHWC [b, h, w, 4 m], and a ``Bottleneck(4 m, m)``
    with He-normal convs and non-identity frozen-BN statistics (scale and
    var from U(0.5, 1.5), bias and mean from N(0, 0.1)), channels-last on
    ``device``."""
    from detjax_torch.models.resnet import Bottleneck

    c = 4 * m
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(np.maximum(rng.normal(0, 1, (b, h, w, c)), 0)
                         .astype(np.float32)).to(device, torch.bfloat16)
    block = Bottleneck(c, m)
    with torch.no_grad():
        for conv, bn in ((block.conv1, block.bn1), (block.conv2, block.bn2),
                         (block.conv3, block.bn3)):
            n, fan_in = conv.weight.shape[0], conv.weight[0].numel()
            conv.weight.copy_(torch.from_numpy(rng.normal(
                0, (2.0 / fan_in) ** 0.5, conv.weight.shape)
                .astype(np.float32)))
            for t, draw in ((bn.weight, rng.uniform(0.5, 1.5, n)),
                            (bn.bias, rng.normal(0, 0.1, n)),
                            (bn.running_mean, rng.normal(0, 0.1, n)),
                            (bn.running_var, rng.uniform(0.5, 1.5, n))):
                t.copy_(torch.from_numpy(draw.astype(np.float32)))
    return x, block.to(device, memory_format=torch.channels_last)
