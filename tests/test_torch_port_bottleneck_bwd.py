"""The fused bottleneck's backward, as ``csrc/bottleneck_bwd.cu`` cuts it, on
the CPU.

The CUDA kernels run only on the card; here a Python copy of their
partition (``kernels/bottleneck.py``: ``bwd_plan``, ``bwd_jobs`` and the
index arithmetic below, line for line with the kernels' ``tile_coords``,
``load_shifted`` and ``wgrad_kernel``'s loader) is checked to own every
pixel once and to sum every pixel into every weight-gradient element once,
with zeros where a 3x3 tap falls outside the image. A staged emulation of
the two passes (bf16 scratch, one fp32 partial per split-K part summed in
``sum_rows``' order) is held to the port's backward twin and to detjax's
``_bottleneck_bwd`` in interpret mode.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from detjax.kernels.bottleneck import _bottleneck_bwd as j_bottleneck_bwd

from detjax_torch.kernels import bottleneck as kb

# (B, H, W, M): the card test's shapes with tails, single rows and wide rows
SHAPES = [(2, 8, 16, 16), (1, 7, 24, 32), (3, 5, 48, 64), (2, 9, 80, 128),
          (1, 5, 104, 128), (1, 2, 1024, 16)]
SMS = 132  # an H100's SM count: the plan the card takes


def _tile_coords(p0, npx, h, w):
    """``tile_coords``: image row and column of the tile's pixels; -4 for
    pixels at or beyond npx, so that every shift of them lands outside."""
    p = p0 + np.arange(kb.BWD_PIXEL_TILE)
    live = p < npx
    return np.where(live, (p // w) % h, -4), np.where(live, p % w, -4)


def _shifted_source(p, prow, pcol, dyy, dxx, h, w):
    """``load_shifted``'s source pixel for each row, or -1 (zero fill)."""
    rr, cc = prow + dyy, pcol + dxx
    ok = (rr >= 0) & (rr < h) & (cc >= 0) & (cc < w)
    return np.where(ok, p + dyy * w + dxx, -1)


def _part_source(p, pe, dyy, dxx, h, w):
    """``wgrad_kernel``'s loader: the A row of pixel p in a part ending at
    pe, shifted by (dyy, dxx) inside p's image, or -1 (zero fill)."""
    ok = p < pe
    rr, cc = (p // w) % h + dyy, p % w + dxx
    ok = ok & (rr >= 0) & (rr < h) & (cc >= 0) & (cc < w)
    return np.where(ok, p + dyy * w + dxx, -1)


def _truth_source(b, h, w, dyy, dxx):
    """The pixel each pixel's (dyy, dxx) neighbour is, or -1 outside its
    image: from the image grid, independent of the kernels' arithmetic."""
    idx = np.arange(b * h * w).reshape(b, h, w)
    pad = np.pad(idx, ((0, 0), (1, 1), (1, 1)), constant_values=-1)
    return pad[:, 1 + dyy:1 + dyy + h, 1 + dxx:1 + dxx + w].reshape(-1)


def _parts(plan, npx):
    pp = plan["part_pixels"]
    return [(j * pp, min(npx, j * pp + pp)) for j in range(plan["parts"])]


@pytest.mark.parametrize("b,h,w,m", SHAPES)
def test_tiles_own_every_pixel_once_and_halos_fall_inside(b, h, w, m):
    """Each pixel belongs to one activation tile; for every tap of the 3x3
    and of its transpose the tile reads the neighbour inside the same
    image, and zeros exactly where the neighbour is outside (borders,
    image boundaries inside a tile, the last tile's dead rows)."""
    npx = b * h * w
    plan = kb.bwd_plan(b, h, w, m, SMS)
    assert plan["tiles"] * kb.BWD_PIXEL_TILE >= npx
    assert (plan["tiles"] - 1) * kb.BWD_PIXEL_TILE < npx
    owned = np.zeros(npx, np.int64)
    taps = [(ky - 1, kx - 1) for ky in range(3) for kx in range(3)]
    truth = {t: _truth_source(b, h, w, *t) for t in taps}
    for t in range(plan["tiles"]):
        p0 = t * kb.BWD_PIXEL_TILE
        p = p0 + np.arange(kb.BWD_PIXEL_TILE)
        live = p < npx
        owned[p[live]] += 1
        prow, pcol = _tile_coords(p0, npx, h, w)
        for dyy, dxx in taps:  # forward taps (dc2_kernel) and their
            for sy, sx in ((dyy, dxx), (-dyy, -dxx)):  # transpose (dc1)
                src = _shifted_source(p, prow, pcol, sy, sx, h, w)
                assert (src[~live] == -1).all()
                assert np.array_equal(src[live], truth[(sy, sx)][p[live]])
    assert (owned == 1).all()


@pytest.mark.parametrize("b,h,w,m", SHAPES)
def test_split_k_sums_every_pixel_into_every_element_once(b, h, w, m):
    """The jobs tile dw1, each tap of dw2 and dw3 exactly once; the parts
    cut the pixels into contiguous ranges that cover each pixel once (in
    steps of BWD_PIXEL_STEP, the last part shorter); so each (pixel,
    element) term is summed once. The shifted operand of dw2 reads the
    neighbour inside the pixel's image, zero outside."""
    c, npx = 4 * m, b * h * w
    plan = kb.bwd_plan(b, h, w, m, SMS)
    t = plan["weight_tile"]
    cover = {"dw1": np.zeros((c, m), int), "dw3": np.zeros((m, c), int),
             "dw2": np.zeros((9, m, m), int)}
    for grad, tap, a0, b0 in kb.bwd_jobs(m):
        view = cover[grad] if tap is None else cover[grad][tap]
        view[a0:a0 + t, b0:b0 + t] += 1
    assert len(kb.bwd_jobs(m)) == plan["jobs"]
    assert all((v == 1).all() for v in cover.values())
    parts = _parts(plan, npx)
    assert plan["part_pixels"] % kb.BWD_PIXEL_STEP == 0
    assert parts[-1][1] == npx and all(lo < hi for lo, hi in parts)
    seen = np.zeros(npx, int)
    for lo, hi in parts:
        seen[lo:hi] += 1
    assert (seen == 1).all()
    for ky in range(3):
        for kx in range(3):
            truth = _truth_source(b, h, w, ky - 1, kx - 1)
            for lo, hi in parts:
                steps = -(-(hi - lo) // kb.BWD_PIXEL_STEP)
                p = lo + np.arange(steps * kb.BWD_PIXEL_STEP)
                src = _part_source(p, hi, ky - 1, kx - 1, h, w)
                assert (src[p >= hi] == -1).all()
                assert np.array_equal(src[p < hi], truth[lo:hi])
    assert plan["scratch_bytes"] == 2 * npx * (4 * m + c)
    assert plan["workspace_bytes"] == 4 * (
        plan["parts"] * (2 * c * m + 9 * m * m) + plan["tiles"] * 6 * m)


def test_plan_at_the_r50_training_shapes():
    """R50's fused blocks at 640 px, bs 16, on 132 SMs: the scratch is the
    size of four M-wide and one C-wide bf16 copy of the block (about 420
    and 210 MB), and the split-K grid fills the card several times over
    with partials well under the scratch."""
    for (b, h, w, m), scratch_mb in (((16, 160, 160, 64), 419.4),
                                     ((16, 80, 80, 128), 209.7)):
        plan = kb.bwd_plan(b, h, w, m, SMS)
        assert round(plan["scratch_bytes"] / 1e6, 1) == scratch_mb
        assert plan["jobs"] * plan["parts"] >= 4 * SMS
        assert plan["workspace_bytes"] < plan["scratch_bytes"] / 4
        assert plan["kernels"] == kb.BWD_KERNELS == 5


# -- the staged emulation ----------------------------------------------------

def _bf(t):
    return t.to(torch.bfloat16).float()


def _ordered_row_sum(ws):
    """``sum_rows``: 32 row groups, group g adding rows g, g + 32, ... in
    order, then the groups in order."""
    groups = []
    for g in range(32):
        s = torch.zeros(ws.shape[1])
        for r in range(g, ws.shape[0], 32):
            s = s + ws[r]
        groups.append(s)
    out = torch.zeros(ws.shape[1])
    for s in groups:
        out = out + s
    return out


def _emulate(x, dy, w1, b1, w2, b2, w3, b3):
    """The two passes of csrc/bottleneck_bwd.cu on the CPU in fp32: the
    activation pass over pixel tiles with its bf16 scratch (y1, y2,
    bf16(dy3), bf16(dc2), bf16(dc1)) and per-tile bias sums, the 3x3 taps
    gathered by the kernels' index arithmetic; then one fp32 partial of
    each weight-gradient job per split-K part, and the ordered sums."""
    b, h, w, c = x.shape
    m, npx = c // 4, b * h * w
    plan = kb.bwd_plan(b, h, w, m, SMS)
    xf, g = x.reshape(npx, c).float(), dy.reshape(npx, c).float()
    w1f, w2f, w3f = w1.float(), w2.float().reshape(9, m, m), w3.float()
    b1f, b2f, b3f = b1.float()[0], b2.float()[0], b3.float()[0]
    taps = [(ky - 1, kx - 1) for ky in range(3) for kx in range(3)]

    def gather(t, src):  # rows of t at src, zeros where src is -1
        out = t[torch.from_numpy(np.maximum(src, 0))]
        return out * torch.from_numpy(src >= 0)[:, None]

    y1 = _bf(torch.relu(xf @ w1f + b1f))
    y2, d3, dc2, dc1 = (torch.zeros(npx, m), torch.zeros(npx, c),
                        torch.zeros(npx, m), torch.zeros(npx, m))
    dx = torch.zeros(npx, c, dtype=torch.bfloat16)
    wsb = torch.zeros(plan["tiles"], 6 * m)
    tiles = []
    for t in range(plan["tiles"]):
        p0 = t * kb.BWD_PIXEL_TILE
        p = p0 + np.arange(kb.BWD_PIXEL_TILE)
        live = p < npx
        prow, pcol = _tile_coords(p0, npx, h, w)
        tiles.append((p[live], prow, pcol, p, live))
    for p_live, prow, pcol, p, live in tiles:  # dc2_kernel
        acc = sum(gather(y1, _shifted_source(p, prow, pcol, dyy, dxx, h, w))
                  @ w2f[k] for k, (dyy, dxx) in enumerate(taps))
        y2t = _bf(torch.relu(acc + b2f))[live]
        y3 = y2t @ w3f + b3f
        d3t = torch.where(y3 + xf[p_live] > 0, g[p_live], 0.0)
        dc2t = torch.where(y2t > 0, _bf(d3t) @ w3f.t(), 0.0)
        y2[p_live], d3[p_live], dc2[p_live] = y2t, _bf(d3t), _bf(dc2t)
        t = p_live[0] // kb.BWD_PIXEL_TILE
        wsb[t, m:2 * m], wsb[t, 2 * m:] = dc2t.sum(0), d3t.sum(0)
    for p_live, prow, pcol, p, live in tiles:  # dc1_kernel
        dy1 = sum(gather(dc2, _shifted_source(p, prow, pcol, -dyy, -dxx, h,
                                              w)) @ w2f[k].t()
                  for k, (dyy, dxx) in enumerate(taps))[live]
        dc1t = torch.where(y1[p_live] > 0, dy1, 0.0)
        dc1[p_live] = _bf(dc1t)
        dx[p_live] = (d3[p_live] + _bf(dc1t) @ w1f.t()).to(torch.bfloat16)
        wsb[p_live[0] // kb.BWD_PIXEL_TILE, :m] = dc1t.sum(0)
    # wgrad_kernel: one partial a part, in dw1 / dw2 / dw3 order
    partials = []
    for lo, hi in _parts(plan, npx):
        p = np.arange(lo, hi)
        dw2 = torch.stack([
            gather(y1, _part_source(p, hi, dyy, dxx, h, w)).t() @ dc2[lo:hi]
            for dyy, dxx in taps])
        partials.append(torch.cat([(xf[lo:hi].t() @ dc1[lo:hi]).reshape(-1),
                                   dw2.reshape(-1),
                                   (y2[lo:hi].t() @ d3[lo:hi]).reshape(-1)]))
    flat = torch.cat([_ordered_row_sum(torch.stack(partials)),
                      _ordered_row_sum(wsb)])
    dw1, dw2, dw3, db1, db2, db3 = flat.split(
        (c * m, 9 * m * m, m * c, m, m, c))
    return (dx.reshape(b, h, w, c), dw1.view(c, m), db1.view(1, m),
            dw2.view(3, 3, m, m), db2.view(1, m), dw3.view(m, c),
            db3.view(1, c))


def _case(seed, b, h, w, m):
    """detjax's kernel-test inputs (x ~ N(0, 1), weights ~ N(0, 0.1), bf16)
    and dy ~ N(0, 1) in bf16, as torch tensors."""
    rng = np.random.default_rng(seed)
    c = 4 * m

    def bf16(shape, s):
        return torch.from_numpy(rng.normal(0, s, shape).astype(np.float32)
                                ).to(torch.bfloat16)

    def f32(shape):
        return torch.from_numpy(rng.normal(0, 0.1, shape).astype(np.float32))

    x = bf16((b, h, w, c), 1.0)
    weights = (bf16((c, m), 0.1), f32((1, m)), bf16((3, 3, m, m), 0.1),
               f32((1, m)), bf16((m, c), 0.1), f32((1, c)))
    return x, bf16((b, h, w, c), 1.0), weights


# The emulation and the twin round at the same places and differ only in
# the order of fp32 sums (matmul tiles, parts, tiles against one conv):
# measured, 2e-7 of the max on the fp32 outputs, up to 2e-4 where that
# order moved an intermediate across a bf16 rounding boundary (one dc1
# element at (3, 5, 48, 64)). Bars: the fp32 outputs within 1e-3 of their
# max, and dx within one bf16 step (0.4 %) of the twin on all but 1e-3 of
# its elements.
SUM_BAR = 1e-3
DX_STEP_SHARE = 1e-3


@pytest.mark.parametrize("b,h,w,m", [(2, 8, 16, 16), (1, 7, 24, 32),
                                     (3, 5, 48, 64), (1, 3, 40, 128)])
def test_staged_emulation_matches_the_twin(b, h, w, m):
    x, dy, weights = _case(b * 17 + h + m, b, h, w, m)
    got = _emulate(x, dy, *weights)
    want = kb.bottleneck_identity_backward_reference(x, dy, *weights)
    for name, gt, wt in zip(("dx", "dw1", "db1", "dw2", "db2", "dw3", "db3"),
                            got, want):
        assert gt.dtype == wt.dtype and gt.shape == wt.shape, name
        gf, wf = gt.float(), wt.float()
        if name == "dx":
            off = (gf - wf).abs() > 2.0 ** -7 * wf.abs().clamp(min=1e-3)
            assert off.float().mean().item() <= DX_STEP_SHARE
        else:
            err = (gf - wf).abs().max().item()
            assert err <= SUM_BAR * max(wf.abs().max().item(), 1e-3), name


@pytest.mark.parametrize("b,h,w,m", [(2, 8, 16, 16), (1, 6, 24, 32)])
def test_staged_emulation_matches_detjax_bwd_kernel(b, h, w, m):
    """Against detjax's _bottleneck_bwd in interpret mode with detjax's
    own bar for it (tests/test_kernels.py:196-197): max |a - b| <= 0.02 x
    max(|b|, 1e-3), all seven outputs."""
    x, dy, weights = _case(b * 29 + h + m, b, h, w, m)
    got = _emulate(x, dy, *weights)

    def j(t):
        return jnp.asarray(t.float().numpy(),
                           jnp.bfloat16 if t.dtype == torch.bfloat16
                           else jnp.float32)

    want = j_bottleneck_bwd(j(x), j(dy), *map(j, weights), interpret=True)
    for gt, wt in zip(got, want):
        gf = gt.float().numpy()
        wf = np.asarray(jnp.asarray(wt, jnp.float32)).reshape(gf.shape)
        assert np.abs(gf - wf).max() <= 0.02 * max(np.abs(wf).max(), 1e-3)


def test_cpu_backward_runs_the_twin_and_counts_nothing():
    """On CPU tensors the fused backward is the twin, bit for bit, and
    neither counter moves: bottleneck_bwd_launches counts calls that
    launched the kernels, bottleneck_bwd_kernel_launches their CUDA
    kernels."""
    x, dy, weights = _case(3, 1, 4, 24, 16)
    counts = (kb.bottleneck_bwd_launches, kb.bottleneck_bwd_kernel_launches)
    got = kb.bottleneck_identity_backward(x, dy, *weights)
    want = kb.bottleneck_identity_backward_reference(x, dy, *weights)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert (kb.bottleneck_bwd_launches,
            kb.bottleneck_bwd_kernel_launches) == counts
