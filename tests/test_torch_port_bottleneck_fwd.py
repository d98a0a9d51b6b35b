"""The fused bottleneck's forward, as ``csrc/bottleneck.cu`` cuts it, on the
CPU.

The CUDA kernels run only on the card; here a Python copy of their
partition (``kernels/bottleneck.py::fwd_plan`` and the index arithmetic
below, line for line with ``tile_coords`` and ``load_shifted_sw`` in
``csrc/bottleneck_common.cuh``) is checked to own every pixel once and to
read every 3x3 neighbour inside the pixel's own image, with zeros outside.
A staged emulation of the two kernels (y1 rounded to bf16 into a scratch,
then per tile the 3x3 from it, y2, and out by 64-channel chunks) is held to
the port's twin and to detjax's ``_bottleneck_fwd`` in interpret mode.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from detjax.kernels.bottleneck import _bottleneck_fwd as j_bottleneck_fwd

from detjax_torch.kernels import bottleneck as kb

# One intra-op thread a process: pytest-xdist runs several workers on
# the host's cores, and torch's default of a thread a core in each
# worker oversubscribes them many times over.
torch.set_num_threads(1)

# (B, H, W, M): the backward's partition tests' shapes, then W = 1, the
# 608x832 canvas's layer2 (W = 104) and a 4096-px row
SHAPES = [(2, 8, 16, 16), (1, 7, 24, 32), (3, 5, 48, 64), (2, 9, 80, 128),
          (1, 5, 104, 128), (1, 2, 1024, 16),
          (2, 3, 1, 16), (2, 76, 104, 128), (1, 2, 4096, 16)]
SMS = 132  # an H100's SM count, for bwd_plan
TAPS = [(ky - 1, kx - 1) for ky in range(3) for kx in range(3)]
CHUNK = 64  # channels of C a chunk of the tile kernel

# detjax's own bars for the fused forward (tests/test_kernels.py:175-177):
# within 5 % of max(|ref|, 1), under 1 % of elements differing
REL_BAR = 0.05
DIFF_FRAC_BAR = 0.01


def _tile_coords(p0, npx, h, w):
    """``tile_coords``: image row and column of the tile's pixels; -4 for
    pixels at or beyond npx, so that every shift of them lands outside."""
    p = p0 + np.arange(kb.PIXEL_TILE)
    live = p < npx
    return np.where(live, (p // w) % h, -4), np.where(live, p % w, -4)


def _shifted_source(p, prow, pcol, dyy, dxx, h, w):
    """``load_shifted_sw``'s source pixel for each row, or -1 (zero
    fill)."""
    rr, cc = prow + dyy, pcol + dxx
    ok = (rr >= 0) & (rr < h) & (cc >= 0) & (cc < w)
    return np.where(ok, p + dyy * w + dxx, -1)


def _truth_source(b, h, w, dyy, dxx):
    """The pixel each pixel's (dyy, dxx) neighbour is, or -1 outside its
    image: from the image grid, independent of the kernels' arithmetic."""
    idx = np.arange(b * h * w).reshape(b, h, w)
    pad = np.pad(idx, ((0, 0), (1, 1), (1, 1)), constant_values=-1)
    return pad[:, 1 + dyy:1 + dyy + h, 1 + dxx:1 + dxx + w].reshape(-1)


@pytest.mark.parametrize("b,h,w,m", SHAPES)
def test_fwd_plan_tiles_own_every_pixel_and_halos_fall_inside(b, h, w, m):
    """Each pixel belongs to one tile of the forward's kernels; every tap
    of the 3x3 reads the neighbour inside the same image and zeros exactly
    where it is outside (borders, image boundaries inside a tile, the last
    tile's dead rows). The tiles are the backward's activation tiles, and
    the scratch is one bf16 y1 [B H W, M]."""
    npx = b * h * w
    plan = kb.fwd_plan(b, h, w, m)
    bwd = kb.bwd_plan(b, h, w, m, SMS)
    assert (plan["pixel_tile"], plan["tiles"]) == (bwd["pixel_tile"],
                                                   bwd["tiles"])
    assert plan["tiles"] * kb.PIXEL_TILE >= npx
    assert (plan["tiles"] - 1) * kb.PIXEL_TILE < npx
    assert plan["kernels"] == kb.FWD_KERNELS == 2
    assert plan["scratch_bytes"] == 2 * npx * m
    owned = np.zeros(npx, np.int64)
    truth = {t: _truth_source(b, h, w, *t) for t in TAPS}
    for t in range(plan["tiles"]):
        p0 = t * kb.PIXEL_TILE
        p = p0 + np.arange(kb.PIXEL_TILE)
        live = p < npx
        owned[p[live]] += 1
        prow, pcol = _tile_coords(p0, npx, h, w)
        for tap in TAPS:
            src = _shifted_source(p, prow, pcol, *tap, h, w)
            assert (src[~live] == -1).all()
            assert np.array_equal(src[live], truth[tap][p[live]])
    assert (owned == 1).all()


def test_fwd_plan_at_the_r50_shapes():
    """R50's fused blocks at 640 px, bs 8: the y1 scratch is 26.2 and 13.1
    MB; written once and read once it adds a quarter to the bytes of the
    bound (x read and the output written once)."""
    for (b, h, w, m), scratch_mb in (((8, 160, 160, 64), 26.2),
                                     ((8, 80, 80, 128), 13.1)):
        plan = kb.fwd_plan(b, h, w, m)
        assert round(plan["scratch_bytes"] / 1e6, 1) == scratch_mb
        bound_bytes = 2 * b * h * w * 4 * m * 2
        assert 2 * plan["scratch_bytes"] == bound_bytes // 4


# -- the staged emulation ----------------------------------------------------

def _bf(t):
    return t.to(torch.bfloat16).float()


def _emulate(x, w1, b1, w2, b2, w3, b3):
    """The two kernels of csrc/bottleneck.cu on the CPU in fp32:
    y1_kernel's bf16 y1 into a scratch [B H W, M]; then fwd_tile_kernel per
    128-pixel tile: the 3x3 from the scratch at the kernels' shifted rows
    (zeros where the neighbour is outside the image), y2 rounded to bf16,
    and out by 64-channel chunks (y3 + b3, + the chunk of x, ReLU, bf16),
    stored for the tile's live pixels only. Unwritten output stays NaN."""
    b, h, w, c = x.shape
    m, npx = c // 4, b * h * w
    plan = kb.fwd_plan(b, h, w, m)
    xf = x.reshape(npx, c).float()
    w2f, w3f = w2.float().reshape(9, m, m), w3.float()
    b2f, b3f = b2.float()[0], b3.float()[0]
    y1 = torch.relu(xf @ w1.float() + b1.float()[0]).to(torch.bfloat16)
    out = torch.full((npx, c), float("nan")).to(torch.bfloat16)

    def gather(t, src):  # rows of t at src, zeros where src is -1
        rows = t[torch.from_numpy(np.maximum(src, 0))].float()
        return rows * torch.from_numpy(src >= 0)[:, None]

    for t in range(plan["tiles"]):
        p0 = t * kb.PIXEL_TILE
        p = p0 + np.arange(kb.PIXEL_TILE)
        live = p < npx
        prow, pcol = _tile_coords(p0, npx, h, w)
        acc = torch.zeros(kb.PIXEL_TILE, m)
        for k, tap in enumerate(TAPS):
            acc = acc + gather(
                y1, _shifted_source(p, prow, pcol, *tap, h, w)) @ w2f[k]
        y2 = _bf(torch.relu(acc + b2f))
        resid = gather(xf, np.where(live, p, -1))
        for n0 in range(0, c, CHUNK):
            ch = slice(n0, n0 + CHUNK)
            o = torch.relu((y2 @ w3f[:, ch] + b3f[ch]) + resid[:, ch])
            out[p[live], ch] = o[torch.from_numpy(live)].to(torch.bfloat16)
    return out.reshape(b, h, w, c)


def _case(seed, b, h, w, m):
    """detjax's kernel-test inputs: x ~ N(0, 1) and weights ~ N(0, 0.1) in
    bf16, biases ~ N(0, 0.1) in fp32, as torch tensors."""
    rng = np.random.default_rng(seed)
    c = 4 * m

    def bf16(shape, s):
        return torch.from_numpy(rng.normal(0, s, shape).astype(np.float32)
                                ).to(torch.bfloat16)

    def f32(shape):
        return torch.from_numpy(rng.normal(0, 0.1, shape).astype(np.float32))

    return bf16((b, h, w, c), 1.0), (bf16((c, m), 0.1), f32((1, m)),
                                     bf16((3, 3, m, m), 0.1), f32((1, m)),
                                     bf16((m, c), 0.1), f32((1, c)))


def _within_bars(got: np.ndarray, want: np.ndarray) -> None:
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= REL_BAR * max(np.abs(want).max(), 1.0)
    assert (got != want).mean() < DIFF_FRAC_BAR


@pytest.mark.parametrize("b,h,w,m", [(2, 8, 16, 16), (1, 7, 24, 32),
                                     (3, 5, 48, 64)])
def test_staged_emulation_matches_the_twin(b, h, w, m):
    """The emulation and the twin round at the same places and differ only
    in the order of fp32 sums; held to detjax's bar."""
    x, weights = _case(b * 13 + h + m, b, h, w, m)
    got = _emulate(x, *weights)
    want = kb.bottleneck_identity_reference(x, *weights)
    assert got.dtype == want.dtype and got.shape == want.shape
    _within_bars(got.float().numpy(), want.float().numpy())


@pytest.mark.parametrize("b,h,w,m", [(2, 8, 16, 16), (1, 6, 24, 32)])
def test_staged_emulation_matches_detjax_fwd_kernel(b, h, w, m):
    """Against detjax's _bottleneck_fwd in interpret mode, with detjax's
    own bar for it."""
    x, weights = _case(b * 31 + h + m, b, h, w, m)
    got = _emulate(x, *weights)

    def j(t):
        return jnp.asarray(t.float().numpy(),
                           jnp.bfloat16 if t.dtype == torch.bfloat16
                           else jnp.float32)

    want = j_bottleneck_fwd(j(x), *map(j, weights), interpret=True)
    _within_bars(got.float().numpy(),
                 np.asarray(jnp.asarray(want, jnp.float32)))


def test_cpu_forward_runs_the_twin_and_counts_nothing():
    """On CPU tensors the fused forward is the twin, bit for bit, and
    neither counter moves: bottleneck_launches counts calls that launched
    the kernels, bottleneck_kernel_launches their CUDA kernels."""
    x, weights = _case(5, 1, 4, 24, 16)
    counts = (kb.bottleneck_launches, kb.bottleneck_kernel_launches)
    got = kb.bottleneck_identity(x, *weights)
    want = kb.bottleneck_identity_reference(x, *weights)
    assert torch.equal(got, want)
    assert (kb.bottleneck_launches, kb.bottleneck_kernel_launches) == counts
