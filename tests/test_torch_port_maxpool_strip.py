"""The max-pool backward's strip instance (``csrc/maxpool_bwd.cu``,
``maxpool_bwd_strip_kernel``), as it walks and decides, on the CPU.

The CUDA kernel runs only on the card. Here a numpy copy of its walk works
on bf16 bit patterns as the kernel does: blocks of ``cols`` pool columns
(plus the halo window to their right) by ``seg`` pool rows, one window row
a step; a step's stage holds z rows 2k - 1 (first step only), 2k, 2k + 1
over the columns 2j0 - 1 .. 2j0 + 2 cols + 1 with -inf outside z, and dp
row k with zeros outside; each window's NaN-propagating max, its first
equal tap (-0 equal to +0), dp masked onto 9 taps; the left-column taps
from the right neighbour; one- and two-term sums in bf16 (single
rounding), four-term sums in fp32 from +0.0 rounded once. Every dz pixel
the walk writes is written once. It is held bit for bit to the port's twin
``maxpool_bwd_reference`` and to detjax's ``max_pool_3x3s2`` gradient
(its Pallas backward in interpret mode): halo rows, a last partial
segment, W not a multiple of the column run, ties, -inf windows and NaN.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from detjax.kernels.stem import max_pool_3x3s2 as j_max_pool_3x3s2

from detjax_torch.kernels import stem as ks

# One intra-op thread a process: pytest-xdist runs several workers on
# the host's cores, and torch's default of a thread a core in each
# worker oversubscribes them many times over.
torch.set_num_threads(1)

NEG_INF_BF16 = np.uint16(0xFF80)
UNWRITTEN = np.uint16(0x7FC1)  # a NaN no route produces


def _to_f64(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32).astype(np.float64)


def _rn_bf16(x: np.ndarray) -> np.ndarray:
    """float64 values rounded once to bf16 (ties to even, subnormals kept,
    zeros keep their sign), as bit patterns."""
    x = np.asarray(x, np.float64)
    _, e = np.frexp(x)
    ulp = np.ldexp(1.0, np.maximum(e - 8, -133))
    with np.errstate(over="ignore", invalid="ignore"):
        r = np.round(x / ulp) * ulp
        r = np.where(np.abs(r) >= 2.0 ** 128, np.copysign(np.inf, x), r)
    return (r.astype(np.float32).view(np.uint32) >> 16).astype(np.uint16)


def _add2(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """add.rn.bf16x2: the exact sum rounded once to bf16."""
    return _rn_bf16(_to_f64(a) + _to_f64(b))


def _sum4(a, b, c, d) -> np.ndarray:
    """(((0 + a) + b) + c) + d in fp32, rounded once to bf16."""
    s = np.zeros(a.shape, np.float32)
    for t in (a, b, c, d):
        s = s + _to_f64(t).astype(np.float32)
    return _rn_bf16(s.astype(np.float64))


def _route(p, g):
    """The kernel's ``route``: p[d][e] bit patterns [cols + 1, C], g the
    window's dp bits; the 9 masked dp values, one a tap."""
    taps = [_to_f64(p[u // 3][u % 3]) for u in range(9)]
    m = taps[0]
    for t in taps[1:]:  # max.NaN: NaN if either side is NaN
        m = np.where(np.isnan(m) | np.isnan(t), np.nan, np.maximum(m, t))
    taken = np.zeros(m.shape, bool)
    out = []
    for t in taps:
        e = t == m  # -0 == +0, NaN equal to nothing
        out.append(np.where(e & ~taken, g, np.uint16(0)))
        taken |= e
    return out


def strip_emulated(z: np.ndarray, dp: np.ndarray, cols: int, seg: int):
    """The strip instance on NHWC bf16 bit patterns z [B, 2H, 2W, C] and dp
    [B, H, W, C]: (dz bits, blocks, steps walked, dz pixels written)."""
    b, hz, wz, c = z.shape
    h, w = hz // 2, wz // 2
    dz = np.full(z.shape, UNWRITTEN, np.uint16)
    writes = np.zeros((b, hz, wz), np.int32)
    blocks = steps_walked = 0
    zcols = 2 * cols + 3
    for img in range(b):
        for j0 in range(0, w, cols):
            zc = 2 * j0 - 1 + np.arange(zcols)
            zc_ok = (zc >= 0) & (zc < wz)
            jw = j0 + np.arange(cols + 1)  # the run's windows and the halo
            jw_ok = jw < w
            for k0 in range(0, h, seg):
                blocks += 1
                k1 = min(k0 + seg, h)
                top = prev7 = prev8 = prev_nb6 = None
                for i in range(k1 - k0 + 1):
                    steps_walked += 1
                    k = k0 + i

                    def zrow(r):
                        row = np.full((zcols, c), NEG_INF_BF16, np.uint16)
                        if 0 <= r < hz:
                            row[zc_ok] = z[img, r, zc[zc_ok]]
                        return row
                    rows = [zrow(2 * k - 1) if i == 0 else top,
                            zrow(2 * k), zrow(2 * k + 1)]
                    top = rows[2]
                    g = np.zeros((cols + 1, c), np.uint16)
                    if k < h:
                        g[jw_ok] = dp[img, k, jw[jw_ok]]
                    p = [[r[2 * np.arange(cols + 1) + e] for e in range(3)]
                         for r in rows]
                    x = _route(p, g)
                    # the right neighbour's left-column taps (0, 3, 6)
                    nb0, nb3, nb6 = (x[u][1:] for u in (0, 3, 6))
                    own = [x[u][:cols] for u in range(9)]
                    js = j0 + np.arange(cols)
                    ok = js < w
                    outs = []
                    if i > 0:
                        outs.append((2 * k - 1,
                                     _add2(_add2(np.zeros_like(own[1]),
                                                 own[1]), prev7),
                                     _sum4(nb0, own[2], prev_nb6, prev8)))
                    if k < k1:
                        zero = np.zeros_like(own[4])
                        outs.append((2 * k, _add2(zero, own[4]),
                                     _add2(_add2(zero, nb3), own[5])))
                    for r, even, odd in outs:
                        dz[img, r, 2 * js[ok]] = even[ok]
                        dz[img, r, 2 * js[ok] + 1] = odd[ok]
                        writes[img, r, 2 * js[ok]] += 1
                        writes[img, r, 2 * js[ok] + 1] += 1
                    prev7, prev8, prev_nb6 = own[7], own[8], nb6
    return dz, blocks, steps_walked, writes


def _inputs(seed, b, hz, wz, c, kind):
    """Seeded bf16 inputs: NHWC bit patterns, detjax arrays and the port's
    channels-last tensors of the same values. ``kind``: "relu", "hard"
    (``seeded_pool_inputs``' ties, -inf windows and NaN), or "hard_dp"
    (also dp of -0.0, bf16 subnormals and values 2^20 apart)."""
    z, dp = ks.seeded_pool_inputs(seed, b, hz, wz, c, hard=kind != "relu")
    if kind == "hard_dp":
        dp[:, 1::7, ::3] = -0.0  # routed -0: sums start from +0.0
        dp[:, ::5, ::2] *= 2.0 ** -130  # bf16 subnormals
        dp[:, 2::9] *= 2.0 ** 20
    zj, dpj = jnp.asarray(z, jnp.bfloat16), jnp.asarray(dp, jnp.bfloat16)
    zt, dpt = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        torch.bfloat16).permute(0, 3, 1, 2) for a in (zj, dpj))
    bits = [np.asarray(a).view(np.uint16) for a in (zj, dpj)]
    return bits, (zj, dpj), (zt, dpt)


# (B, 2H, 2W, C, cols, seg): stand-in runs and segments (H, W not
# multiples of them, a run wider than W), then the kernel's own
STRIP_CASES = [
    (2, 22, 26, 8, 4, 3),
    (1, 16, 34, 16, 5, 4),
    (1, 18, 16, 8, 16, 2),
    (2, 32, 30, 8, 3, 16),
    (1, 80, 74, 64, 32, 16),
]


@pytest.mark.parametrize("b,hz,wz,c,cols,seg", STRIP_CASES)
@pytest.mark.parametrize("kind", ["relu", "hard", "hard_dp"])
def test_strip_walk_bit_equal_to_twin_and_detjax(b, hz, wz, c, cols, seg,
                                                 kind):
    """The emulated walk writes every dz pixel once, walks each segment's
    rows and one halo row, and equals the twin bit for bit; and detjax's
    gradient in interpret mode, except (``hard_dp``) where XLA:CPU's
    arithmetic is not detjax's kernel's: it folds the kernel's first
    ``0 + x``, so a pixel whose every term is a routed -0.0 keeps -0.0
    (its kernel sums from +0.0, as the twin and the port do), and it
    flushes bf16 subnormals to zero (the card and the twin keep them)."""
    (zb, dpb), (zj, dpj), (zt, dpt) = _inputs(hz * 7 + wz + cols, b, hz, wz,
                                              c, kind)
    got, blocks, steps, writes = strip_emulated(zb, dpb, cols, seg)
    h, w = hz // 2, wz // 2
    assert (writes == 1).all()  # every dz pixel written exactly once
    assert blocks == b * -(-w // cols) * -(-h // seg)
    # each segment walks its rows and one halo row
    assert steps == b * -(-w // cols) * (h + -(-h // seg))
    want = ks.maxpool_bwd_reference(zt, dpt)
    want_bits = want.permute(0, 2, 3, 1).contiguous().view(
        torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(got, want_bits)
    _, vjp = jax.vjp(j_max_pool_3x3s2, zj)
    pallas = np.asarray(vjp(dpj)[0]).view(np.uint16)
    apart = got != pallas
    if kind == "hard_dp":
        signed_zero = (got == 0) & (pallas == 0x8000)
        tiny = ((np.abs(_to_f64(got)) < 2.0 ** -125)
                & (np.abs(_to_f64(pallas)) < 2.0 ** -125))
        assert apart.any() and not (apart & ~signed_zero & ~tiny).any()
        apart[:] = False
    assert not apart.any()
    assert np.isnan(_to_f64(zb)).any() == (kind != "relu")


def test_two_term_bf16_sum_equals_fp32_then_bf16():
    """The strip instance adds one or two routed bf16 values in bf16 with
    one rounding, where the twin adds in fp32 from +0.0 and rounds to bf16:
    equal on every pair of values, across exponent gaps, signs, zeros of
    both signs and subnormals."""
    rng = np.random.default_rng(11)
    n = 400_000
    mant = rng.integers(0, 1 << 16, n, dtype=np.uint32).astype(np.uint16)
    a = mant.copy()
    # b: a's exponent moved by -30 .. +30, random sign and mantissa
    exp_a = (a.astype(np.int32) >> 7) & 0xFF
    shift = rng.integers(-30, 31, n)
    exp_b = np.clip(exp_a + shift, 0, 254)
    bits_b = ((rng.integers(0, 2, n) << 15) | (exp_b << 7)
              | rng.integers(0, 128, n)).astype(np.uint16)
    finite = (exp_a < 255)
    a, bb = a[finite], bits_b[finite]
    specials = np.array([0x0000, 0x8000, 0x0001, 0x8001, 0x007F, 0x0080,
                         0x3F80, 0xBF80, 0x7F7F, 0xFF7F], np.uint16)
    sa, sb = np.meshgrid(specials, specials)
    a = np.concatenate([a, sa.ravel()])
    bb = np.concatenate([bb, sb.ravel()])
    kernel = _add2(_add2(np.zeros_like(a), a), bb)
    with np.errstate(over="ignore"):
        f32 = ((np.float32(0) + _to_f64(a).astype(np.float32))
               + _to_f64(bb).astype(np.float32))
    twin = torch.from_numpy(f32).to(torch.bfloat16).view(
        torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(kernel, twin)
    # one term: +0.0 + -0.0 is +0.0
    assert _add2(np.uint16([0]), np.uint16([0x8000]))[0] == 0
