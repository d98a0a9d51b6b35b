"""The NMS and matching kernels' designs, as ``csrc/nms.cu`` and
``csrc/matching.cu`` decide, on the CPU.

The CUDA kernels run only on the card. Here a Python copy of each design's
decisions is held bit for bit to the port's plain twins and to detjax's
Pallas kernels in interpret mode:

- NMS: the order check and the bitonic sort of 64-bit (score, index) keys,
  then the rounds of 64 candidates: (a) each candidate against the keeps
  so far, (b) the round's own 64-bit IoU > thr words for the rows (a) left
  open, (c) word by word the fixed point of K = open minus the bits K's
  rows remove (which is the greedy keep set), cut at ``max_det``, and the
  keeps' bits in the later words; every decision division-free, against
  the threshold's upper midpoint in fp64.
- Matching: the block's union box over its run of consecutive anchors
  (128 in the kernel; held here at runs of 128, 256 and 512, since the
  design is exact for any run), the conservative culling test, the ascending list
  of the GTs left, the strict-``>`` scan and the merge with (0, the first
  dropped valid GT) and (-1, the first invalid one).
"""

import math

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from detjax.kernels.matching import match_iou_pallas
from detjax.kernels.postprocess import nms_pallas

import detjax_torch
from detjax_torch.kernels import matching as km
from detjax_torch.kernels import postprocess as pp
from detjax_torch.modeling import anchor_config
from detjax_torch.ops.anchors import anchors_for_shape
from detjax_torch.ops.nms import NEG_INF

# One intra-op thread a process: pytest-xdist runs several workers on
# the host's cores, and torch's default of a thread a core in each
# worker oversubscribes them many times over.
torch.set_num_threads(1)

OFFSET = 642.0
TILE = 64  # candidates a word
ROUND_WORDS = 1  # words a round
ROUND = ROUND_WORDS * TILE  # candidates a round
FULL = (1 << 64) - 1
# detjax's interpret-mode rounding of max_iou (see test_torch_port_match)
PALLAS_MAX_IOU_ULP = 4

# -- NMS ----------------------------------------------------------------------


def _f32(x):
    return np.float32(x)


def _is_live(s):
    return s > _f32(NEG_INF * 0.5)


def _in_order(s):
    """The kernel's check: live candidates first, live scores
    non-increasing."""
    live = _is_live(s)
    bad = live[1:] & (~live[:-1] | (s[:-1] < s[1:]))
    return not bad.any()


def _sort_keys(s):
    """sort_key for each candidate; dead ones ~0."""
    s = np.where(s == 0, _f32(0), s).astype(np.float32)
    u = s.view(np.uint32).astype(np.uint64)
    u = np.where(u & 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)
    keys = ((~u & 0xFFFFFFFF) << np.uint64(32)) | np.arange(len(s),
                                                            dtype=np.uint64)
    return np.where(_is_live(s), keys, ~np.uint64(0))


def _bitonic(keys):
    """The kernel's network, stage by stage, pairs t -> (i, i + d)."""
    keys = keys.copy()
    p2 = len(keys)
    k = 2
    while k <= p2:
        d = k >> 1
        while d > 0:
            t = np.arange(p2 // 2)
            i = ((t & ~(d - 1)) << 1) | (t & (d - 1))
            a, b = keys[i], keys[i + d]
            swap = (a > b) == ((i & k) == 0)
            keys[i] = np.where(swap, b, a)
            keys[i + d] = np.where(swap, a, b)
            d >>= 1
        k <<= 1
    return keys


def _order(s):
    """(order of the live prefix, L, whether the row was sorted)."""
    live = int(_is_live(s).sum())
    if _in_order(s):
        return np.arange(live), live, False
    p2 = 1
    while p2 < len(s):
        p2 <<= 1
    keys = np.full(p2, ~np.uint64(0))
    keys[:len(s)] = _sort_keys(s)
    keys = _bitonic(keys)
    return (keys[:live] & np.uint64(0xFFFFFFFF)).astype(np.int64), live, True


def _upper_midpoint(t):
    """upper_midpoint: t and the next float above it, halfway, in fp64."""
    t = _f32(t)
    nxt = np.nextafter(t, _f32(np.inf))
    if np.isinf(nxt) and not np.isinf(t):
        return float(t) + 2.0 ** 103
    return (float(t) + float(nxt)) * 0.5


def _area(b):
    zero = torch.zeros((), dtype=torch.float32)
    return (torch.maximum(b[..., 2] - b[..., 0], zero)
            * torch.maximum(b[..., 3] - b[..., 1], zero))


def _inter_union(p, q):
    """fp32 intersection and clamped union of rows p [P, 4] and q [Q, 4],
    in the twin's order."""
    zero = torch.zeros((), dtype=torch.float32)
    iw = torch.maximum(torch.minimum(p[:, None, 2], q[None, :, 2])
                       - torch.maximum(p[:, None, 0], q[None, :, 0]), zero)
    ih = torch.maximum(torch.minimum(p[:, None, 3], q[None, :, 3])
                       - torch.maximum(p[:, None, 1], q[None, :, 1]), zero)
    inter = iw * ih
    union = torch.clamp(_area(p)[:, None] + _area(q)[None, :] - inter,
                        min=1e-8)
    return inter, union


def _overlaps(p, q, thr):
    """The kernel's decision RN(inter / union) > thr, division-free:
    inter > mid * union in fp64, or equal with thr odd."""
    inter, union = _inter_union(p, q)
    mid = _upper_midpoint(thr)
    odd = bool(np.array(thr, np.float32).view(np.uint32) & 1)
    x, bound = inter.double(), mid * union.double()
    return (x > bound) | ((x == bound) & odd)


def _nms_row(off, s, thr, max_det):
    """One block's row: (keep_idx, keep_scores, whether it sorted, rounds
    walked)."""
    order, live, was_sorted = _order(s)
    out_i = np.full(max_det, -1, np.int32)
    out_s = np.zeros(max_det, np.float32)
    _, _, rounds = _walk(off, s, order, thr, max_det, out_i, out_s,
                         off[:0], 0)
    return out_i, out_s, was_sorted, rounds


def _walk(off, s, order, thr, max_det, out_i, out_s, kept_boxes, k):
    """The rounds over the candidates ``order`` (in the sweep's order),
    after ``k`` keeps whose boxes are ``kept_boxes``: the keeps go into
    out_i / out_s from slot k; returns (kept_boxes, k, rounds walked)."""
    live = len(order)
    rounds = 0
    for r0 in range(0, live, ROUND):
        if k >= max_det:
            break
        rounds += 1
        ncols = min(ROUND, live - r0)
        cidx = torch.from_numpy(np.asarray(order[r0:r0 + ncols], np.int64))
        cols = off[cidx]
        removed = np.ones(ROUND, bool)
        removed[:ncols] = False
        if k:  # (a)
            removed[:ncols] |= _overlaps(kept_boxes, cols,
                                         thr).any(dim=0).numpy()
        # (b): the bits of row p in each word, rows still open, columns
        # after p
        hit = _overlaps(cols, cols, thr).numpy()
        blk = np.zeros((ROUND_WORDS, ROUND), object)
        for wd in range(ROUND_WORDS):
            for p in range(ROUND):
                if wd < p // TILE or wd * TILE >= ncols or removed[p]:
                    continue
                nv = min(TILE, ncols - wd * TILE)
                lo = p % TILE + 1 if wd == p // TILE else 0
                blk[wd, p] = sum(1 << c for c in range(lo, nv)
                                 if hit[p, wd * TILE + c])
        # (c): word by word, the fixed point of K = open \ (the bits K's
        # rows remove), from K = open; the first max_det - k kept in order;
        # then their rows' bits in the later words
        cur = [sum(1 << c for c in range(TILE) if removed[wd * TILE + c])
               for wd in range(ROUND_WORDS)]
        kept = []
        for wd in range(ROUND_WORDS):
            if k + len(kept) >= max_det:
                break
            open_ = ~cur[wd] & FULL
            keep = open_
            for _ in range(TILE + 1):
                gone = 0
                for b in range(TILE):
                    if (keep >> b) & 1:
                        gone |= int(blk[wd, wd * TILE + b])
                nxt = open_ & ~gone
                if nxt == keep:
                    break
                keep = nxt
            budget = max_det - k - len(kept)
            word_keeps = [wd * TILE + b for b in range(TILE)
                          if (keep >> b) & 1][:budget]
            kept += word_keeps
            for w2 in range(wd + 1, ROUND_WORDS):
                for p in word_keeps:
                    cur[w2] |= int(blk[w2, p])
        for t, p in enumerate(kept):
            out_i[k + t] = int(cidx[p])
            out_s[k + t] = s[int(cidx[p])]
        kept_boxes = torch.cat([kept_boxes, cols[kept]])
        k += len(kept)
    return kept_boxes, k, rounds


def nms_emulated(boxes, scores, labels, thr, max_det, offset):
    """The kernel's decisions over a batch: (keep_idx, keep_scores, rows
    sorted, rounds walked a row)."""
    off = (torch.from_numpy(boxes)
           + (torch.from_numpy(labels).to(torch.float32)
              * _f32(offset))[..., None])
    rows = [_nms_row(off[r], scores[r], thr, max_det)
            for r in range(scores.shape[0])]
    return (np.stack([r[0] for r in rows]), np.stack([r[1] for r in rows]),
            [r[2] for r in rows], [r[3] for r in rows])


def _nms_case(kind, b=3, n=200, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0, 600, (b, 10, 2))
    c = np.take_along_axis(centers, rng.integers(0, 10, (b, n, 1)), 1)
    c = c + rng.normal(0, 5, (b, n, 2))
    wh = rng.uniform(10, 90, (b, n, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    scores = rng.uniform(0.05, 1, (b, n)).astype(np.float32)
    labels = rng.integers(0, 4, (b, n)).astype(np.int32)
    labels[:, : n // 2] = rng.integers(0, 2, (b, n // 2))
    if kind == "ties":
        scores = np.round(scores, 1)  # tie blocks
        boxes[:, n // 2:] = boxes[:, : n - n // 2]  # duplicate boxes
        scores[:, 5] = -0.0
        scores[:, 6] = 0.0  # -0 and +0 tie: the lower index first
    elif kind == "presuppressed":
        scores[rng.uniform(size=(b, n)) < 0.4] = NEG_INF
    elif kind == "empty_row":
        scores[1] = NEG_INF
    elif kind == "runs_out":
        scores[0, 12:] = NEG_INF  # 12 live, max_det 100
    elif kind == "clustered":
        # one class in four piles: few keeps, every round walked
        c = rng.uniform(0, 600, (b, 4, 2))
        c = np.take_along_axis(c, rng.integers(0, 4, (b, n, 1)), 1)
        c = c + rng.normal(0, 4, (b, n, 2))
        boxes = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(
            np.float32)
        labels[:] = 0
    elif kind == "spread":
        # boxes apart from each other, as one class's top scores are: the
        # sweep keeps max_det early and stops
        c = rng.uniform(0, 640, (b, n, 2))
        boxes = np.concatenate([c - 8, c + 8], -1).astype(np.float32)
    if kind != "unsorted":
        # the port's callers' order: a stable descending sort, dead last
        o = np.argsort(-scores, axis=1, kind="stable")
        boxes = np.take_along_axis(boxes, o[..., None], 1)
        scores = np.take_along_axis(scores, o, 1)
        labels = np.take_along_axis(labels, o, 1)
    return boxes, scores, labels


NMS_CASES = [
    # (kind, B, N, max_det): sorted rows unless "unsorted"
    ("sorted", 3, 200, 100),
    ("unsorted", 3, 200, 100),
    ("ties", 3, 160, 100),
    ("presuppressed", 3, 200, 100),
    ("empty_row", 3, 130, 50),  # N not a multiple of 64
    ("runs_out", 2, 200, 100),
    ("sorted", 2, 64, 100),  # exactly one word
    ("sorted", 2, 65, 30),  # one word and one candidate
    ("unsorted", 2, 1, 5),  # one candidate, more slots
    ("sorted", 2, 600, 100),
    ("clustered", 2, 600, 100),  # many rounds: (a) against earlier keeps
    ("unsorted", 2, 300, 100),  # two rounds, sorted first
    ("sorted", 2, 600, 7),  # max_det reached inside the first round
    ("spread", 2, 600, 100),  # max_det reached early: two rounds of ten
]


def _nms_inputs(kind, b, n):
    if kind == "unsorted":
        boxes, scores, labels = _nms_case("unsorted", b, n, seed=n)
        scores[0, ::7] = NEG_INF  # dead entries between live ones
        scores[-1, ::2] = np.round(scores[-1, ::2], 1)  # ties, out of order
        return boxes, scores, labels
    return _nms_case(kind, b, n, seed=n + b)


@pytest.mark.parametrize("kind,b,n,max_det", NMS_CASES)
def test_nms_design_bit_equal_to_twin_and_pallas(kind, b, n, max_det):
    """The emulated order / rounds design keeps exactly what the twin
    (``nms_reference`` -> ``_greedy_suppress``) and detjax's
    ``nms_pallas`` in interpret mode keep, bit for bit; the kernel sorts
    exactly the unsorted rows, and stops once max_det are kept."""
    boxes, scores, labels = _nms_inputs(kind, b, n)
    got_i, got_s, sorted_rows, rounds = nms_emulated(boxes, scores, labels,
                                                     0.5, max_det, OFFSET)
    ref_i, ref_s = pp.nms_reference(torch.from_numpy(boxes),
                                    torch.from_numpy(scores),
                                    torch.from_numpy(labels), 0.5, max_det,
                                    OFFSET)
    pal_i, pal_s = nms_pallas(jnp.asarray(boxes), jnp.asarray(scores),
                              jnp.asarray(labels), 0.5, max_det, OFFSET,
                              interpret=True)
    for want_i, want_s in ((ref_i.numpy(), ref_s.numpy()),
                           (np.asarray(pal_i), np.asarray(pal_s))):
        np.testing.assert_array_equal(got_i, want_i)
        np.testing.assert_array_equal(got_s, want_s)
    assert any(sorted_rows) == (kind == "unsorted" and n > 1)
    if kind == "empty_row":
        assert (got_i[1] == -1).all() and rounds[1] == 0
    if kind == "runs_out":
        assert 0 < (got_i[0] >= 0).sum() <= 12
    if kind == "spread" or max_det == 7:
        assert max(rounds) <= 2 and (got_i >= 0).sum(axis=1).min() == max_det
    if kind == "clustered":
        assert min(rounds) >= 5  # many rounds: (a) against earlier keeps


@pytest.mark.parametrize("density", [0.0, 0.02, 0.1, 0.5, 1.0])
def test_nms_fixed_point_is_the_serial_greedy(density):
    """Within a word, iterating K = open minus the bits K's rows remove,
    from K = open, stops at the serial greedy pass's keeps (its only fixed
    point), in at most the depth of the removal chains plus one steps:
    random upper-triangular rows at several densities, random open masks,
    and a full chain (each candidate removes the next)."""
    rng = np.random.default_rng(int(density * 100))
    cases = []
    for _ in range(300):
        rows = [sum(1 << q for q in range(p + 1, TILE)
                    if rng.uniform() < density) for p in range(TILE)]
        cases.append((rows, int(rng.integers(0, 1 << 63)) | 1))
    cases.append(([1 << (p + 1) if p + 1 < TILE else 0 for p in range(TILE)],
                  FULL))
    for rows, open_ in cases:
        serial, c = 0, ~open_ & FULL
        for p in range(TILE):
            if not (c >> p) & 1:
                serial |= 1 << p
                c |= rows[p]
        keep, steps = open_, 0
        while True:
            gone = 0
            for p in range(TILE):
                if (keep >> p) & 1:
                    gone |= rows[p]
            nxt = open_ & ~gone
            steps += 1
            if nxt == keep:
                break
            keep = nxt
        assert keep == serial
        assert steps <= TILE + 1
    assert steps == TILE  # the full chain: one step a link


def test_nms_order_sorts_like_the_callers_sort():
    """The bitonic network's order of the live candidates equals a stable
    descending sort's (ties to the lower index, -0 equal to +0)."""
    rng = np.random.default_rng(3)
    for n in (2, 5, 64, 100, 300, 1000):
        s = np.round(rng.uniform(-1, 1, n), 1).astype(np.float32)
        s[rng.uniform(size=n) < 0.2] = NEG_INF
        s[rng.integers(0, n, 3)] = -0.0
        order, live, _ = _order(s)
        want = np.argsort(-np.where(_is_live(s), s, -np.inf), kind="stable")
        np.testing.assert_array_equal(order, want[:live])
        assert live == int(_is_live(s).sum())


@pytest.mark.parametrize("thr", [0.5, 0.3, 0.7, 0.45, 1.0, 0.0, -0.25,
                                 1e-30, 0.99999994])
def test_nms_midpoint_decision_equals_the_division(thr):
    """inter > mid(thr) * union in fp64 (or equal with thr odd) decides
    exactly as fp32 RN(inter / union) > thr: on random (inter, union)
    pairs, on pairs whose quotient is thr or a float next to it, on pairs
    whose inter is the float just below or just above mid * union (the
    quotient within an ulp of the midpoint, on either side), and on zero,
    infinite and huge operands. (A tie needs mid * union to be a float: not
    for a normal thr, whose mid has an odd 25-bit significand, but for
    thr = 0, whose mid is 2^-150; then both sides round to even.)"""
    rng = np.random.default_rng(7)
    t = _f32(thr)
    mid = _upper_midpoint(thr)
    union = rng.uniform(1e-3, 1e6, 200_000).astype(np.float32)
    inter = (union * rng.uniform(0, 1.2, union.size)).astype(np.float32)
    nb = np.array([np.nextafter(t, _f32(-np.inf)), t,
                   np.nextafter(t, _f32(np.inf))], np.float32)
    u2 = rng.uniform(1e-3, 1e6, 60_000).astype(np.float32)
    q = nb[rng.integers(0, 3, u2.size)]
    exact = mid * u2.astype(np.float64)
    f = exact.astype(np.float32)
    below = np.where(f > exact, np.nextafter(f, _f32(-np.inf)), f)
    above = np.where(f < exact, np.nextafter(f, _f32(np.inf)), f)
    near = np.concatenate([below, above])
    inter = np.concatenate([inter, (q * u2).astype(np.float32), near,
                            [0.0, 0.0, 1.0, 3e38, np.inf]])
    union = np.concatenate([union, u2, u2, u2,
                            [1e-8, np.inf, np.inf, 1e-8, 1e-8]])
    inter, union = inter.astype(np.float32), union.astype(np.float32)
    with np.errstate(over="ignore"):
        want = (inter / union) > t
    odd = bool(np.array(t).view(np.uint32) & 1)
    x, bound = inter.astype(np.float64), mid * union.astype(np.float64)
    got = (x > bound) | ((x == bound) & odd)
    np.testing.assert_array_equal(got, want)
    # the floats strictly either side of mid * union decide apart
    lo = got[-5 - 2 * u2.size:-5 - u2.size]
    hi = got[-5 - u2.size:-5]
    assert not lo[below < exact].any() and hi[above > exact].all()


def test_nms_scratch_bytes():
    """The wrapper's scratch holds the boxes of the keeps past the first
    512 of a row (shared memory holds those): none at max_det 100."""
    assert pp.nms_scratch_bytes(8, 100) == 0
    assert pp.nms_scratch_bytes(640, 512) == 0
    assert pp.nms_scratch_bytes(2, 600) == 2 * 88 * 16
    assert pp.SHARED_SORT_CANDIDATES * 8 <= 128 * 1024


# -- NMS rows past the split point (the large instance) ------------------------


def _select_batch(keys, lo, need):
    """select_batch: the ``need`` smallest live keys >= lo, by a radix
    select over 8-bit digits, high to low, stopping at the first digit
    whose bin holds exactly the keys still needed; then the gathered keys
    through the bitonic network. Returns (sorted batch, passes)."""
    keys = keys[keys != ~np.uint64(0)]
    above = keys[keys >= np.uint64(lo)]
    prefix, passes = 0, 0
    for shift in range(56, -8, -8):
        passes += 1
        cand = above
        if shift != 56:
            cand = cand[(cand >> np.uint64(shift + 8)) == np.uint64(prefix)]
        hist = np.bincount(((cand >> np.uint64(shift)) & np.uint64(255))
                           .astype(np.int64), minlength=256)
        cum = np.cumsum(hist)
        pick = int(np.searchsorted(cum, need))  # the first bin reaching it
        before = int(cum[pick] - hist[pick])
        prefix = (prefix << 8) | pick
        need -= before
        if hist[pick] == need:
            hi = (prefix << shift) | ((1 << shift) - 1)
            break
    take = above[above <= np.uint64(hi)]
    p2 = 1
    while p2 < len(take):
        p2 <<= 1
    padded = np.full(p2, ~np.uint64(0))
    padded[:len(take)] = take
    return _bitonic(padded)[:len(take)], passes


def _nms_row_long(off, s, thr, max_det, split, first):
    """One block's row in the kernel's large instance, whose shared memory
    sorts ``split`` keys (16,384 in the kernel): a row in order walks as it
    is; a row out of order walks batch after batch of its order, ``first``
    keys (1,024 in the kernel), then twice as many at each refill up to
    ``split``, each selected above the last one's key, until max_det keeps
    or the live candidates run out. Returns (keep_idx, keep_scores,
    batches, select passes)."""
    out_i = np.full(max_det, -1, np.int32)
    out_s = np.zeros(max_det, np.float32)
    live = int(_is_live(s).sum())
    if _in_order(s):
        _walk(off, s, np.arange(live), thr, max_det, out_i, out_s,
              off[:0], 0)
        return out_i, out_s, 0, 0
    keys = _sort_keys(s)
    kept_boxes, k, walked, lo, batches, passes = off[:0], 0, 0, 0, 0, 0
    cap = first
    while k < max_det and walked < live:
        batch, p = _select_batch(keys, lo, min(cap, live - walked))
        cap = min(2 * cap, split)
        batches += 1
        passes += p
        order = (batch & np.uint64(0xFFFFFFFF)).astype(np.int64)
        kept_boxes, k, _ = _walk(off, s, order, thr, max_det, out_i, out_s,
                                 kept_boxes, k)
        walked += len(batch)
        lo = int(batch[-1]) + 1
    return out_i, out_s, batches, passes


LONG_CASES = [
    # (kind, B, N, max_det, split, first): the stand-in split and first
    # batch are far below N, so rows take many batches
    ("unsorted", 2, 300, 100, 64, 16),
    ("ties", 2, 260, 100, 64, 16),
    ("presuppressed", 2, 300, 100, 32, 8),
    ("clustered", 2, 400, 100, 64, 16),  # few keeps: every batch walked
    ("runs_out", 2, 300, 100, 64, 16),
    ("sorted", 2, 300, 100, 64, 16),  # in order: no select
    ("unsorted", 2, 20000, 100, 16384, 1024),  # the kernel's own sizes
]


@pytest.mark.parametrize("kind,b,n,max_det,split,first", LONG_CASES)
def test_nms_long_rows_bit_equal_to_twin_and_pallas(kind, b, n, max_det,
                                                    split, first):
    """Rows longer than the large instance sorts at once: the emulated
    radix select with its refills keeps exactly what the twin and detjax's
    ``nms_pallas`` in interpret mode keep, bit for bit, on rows out of
    order with ties (-0 and +0 among them), pre-suppressed entries, and
    rows whose first batches run out before max_det."""
    boxes, scores, labels = _nms_case(kind, b, n, seed=n + split)
    if kind != "sorted":
        rng = np.random.default_rng(n)
        perm = np.stack([rng.permutation(n) for _ in range(b)])
        boxes = np.take_along_axis(boxes, perm[..., None], 1)
        scores = np.take_along_axis(scores, perm, 1)
        labels = np.take_along_axis(labels, perm, 1)
    if kind == "ties":
        scores[:, 7] = -0.0
        scores[:, 3] = 0.0
    off = (torch.from_numpy(boxes)
           + (torch.from_numpy(labels).to(torch.float32)
              * _f32(OFFSET))[..., None])
    rows = [_nms_row_long(off[r], scores[r], 0.5, max_det, split, first)
            for r in range(b)]
    got_i = np.stack([r[0] for r in rows])
    got_s = np.stack([r[1] for r in rows])
    ref_i, ref_s = pp.nms_reference(torch.from_numpy(boxes),
                                    torch.from_numpy(scores),
                                    torch.from_numpy(labels), 0.5, max_det,
                                    OFFSET)
    pal_i, pal_s = nms_pallas(jnp.asarray(boxes), jnp.asarray(scores),
                              jnp.asarray(labels), 0.5, max_det, OFFSET,
                              interpret=True)
    for want_i, want_s in ((ref_i.numpy(), ref_s.numpy()),
                           (np.asarray(pal_i), np.asarray(pal_s))):
        np.testing.assert_array_equal(got_i, want_i)
        np.testing.assert_array_equal(got_s, want_s)
    batches = [r[2] for r in rows]
    if kind == "sorted":
        assert batches == [0] * b
    else:
        assert min(batches) >= 1
    if kind in ("clustered", "runs_out"):
        assert max(batches) >= 2  # refilled


def test_nms_select_takes_the_next_keys_of_the_order():
    """The radix select's batch is the next ``need`` keys of a full sort
    above the bound, for bounds inside tie blocks, and stops early at a
    digit whose bin holds exactly the keys needed (fewer than 8 passes)."""
    rng = np.random.default_rng(5)
    s = np.round(rng.uniform(-1, 1, 5000), 2).astype(np.float32)
    s[rng.uniform(size=5000) < 0.1] = NEG_INF
    s[::97] = -0.0
    keys = _sort_keys(s)
    full = np.sort(keys[keys != ~np.uint64(0)])
    passes_seen = set()
    for start, need in ((0, 1), (0, 64), (0, 1000), (17, 300), (1000, 4500),
                        (4000, 500)):
        need = min(need, len(full) - start)
        lo = 0 if start == 0 else int(full[start - 1]) + 1
        batch, passes = _select_batch(keys, lo, need)
        np.testing.assert_array_equal(batch, full[start:start + need])
        passes_seen.add(passes)
    assert min(passes_seen) < 8 and max(passes_seen) <= 8


# -- matching -----------------------------------------------------------------

TAME = _f32(1e30)
HW = (128, 128)
ANCHORS = anchors_for_shape(HW, anchor_config(
    detjax_torch.get_config("retinanet_r50_640")))


def _match_block(anchors, gt_boxes, gt_valid, gt_labels, lo, hi, out):
    """One block's anchors [lo, hi) for every image."""
    an = torch.from_numpy(anchors[lo:hi])
    union = (an[:, 0].min(), an[:, 1].min(), an[:, 2].max(), an[:, 3].max())
    cull = bool((an.abs() <= TAME).all())
    for img in range(gt_boxes.shape[0]):
        g = torch.from_numpy(gt_boxes[img])
        valid = torch.from_numpy(gt_valid[img])
        tame = (g.abs() <= TAME).all(dim=1)
        apart = cull & tame & (
            (torch.minimum(union[2], g[:, 2])
             <= torch.maximum(union[0], g[:, 0]))
            | (torch.minimum(union[3], g[:, 3])
               <= torch.maximum(union[1], g[:, 1])))
        listed = torch.nonzero(valid & ~apart)[:, 0]  # ascending
        dropped = torch.nonzero(valid & apart)[:, 0]
        invalid = torch.nonzero(~valid)[:, 0]
        lb = g[listed]
        zero = torch.zeros((), dtype=torch.float32)
        iw = torch.maximum(torch.minimum(an[:, None, 2], lb[None, :, 2])
                           - torch.maximum(an[:, None, 0], lb[None, :, 0]),
                           zero)
        ih = torch.maximum(torch.minimum(an[:, None, 3], lb[None, :, 3])
                           - torch.maximum(an[:, None, 1], lb[None, :, 1]),
                           zero)
        inter = iw * ih
        iou = inter / torch.clamp(_area(an)[:, None] + _area(lb)[None, :]
                                  - inter, min=1e-8)
        # the strict-'>' scan in ascending order: the largest IoU that is
        # a number, at its first listed position; (-inf, 0) with none
        iou = torch.where(iou.isnan(), -math.inf, iou)
        best = torch.full((hi - lo,), -math.inf)
        bi = torch.zeros((hi - lo,), dtype=torch.int64)
        if len(listed):
            best = iou.max(dim=1).values
            first = (iou == best[:, None]).to(torch.int8).argmax(dim=1)
            bi = torch.where(best > -math.inf, listed[first], 0)
        if len(dropped):
            take = (0.0 > best) | ((0.0 == best) & (dropped[0] < bi))
            best = torch.where(take, 0.0, best)
            bi = torch.where(take, dropped[0], bi)
        if len(invalid):
            take = (-1.0 > best) | ((-1.0 == best) & (invalid[0] < bi))
            best = torch.where(take, -1.0, best)
            bi = torch.where(take, invalid[0], bi)
        out[0][img, lo:hi] = best.numpy()
        out[1][img, lo:hi] = bi.numpy()
        out[4][img, lo:hi] = len(listed)


def match_emulated(anchors, gt_boxes, gt_valid, gt_labels, threads=256,
                   anchors_per_thread=1):
    """The kernel's decisions: (max_iou, argmax, boxes, labels, GTs listed
    per anchor's block)."""
    b, _ = gt_valid.shape
    a = len(anchors)
    out = [np.zeros((b, a), np.float32), np.zeros((b, a), np.int32), None,
           None, np.zeros((b, a), np.int32)]
    per_block = threads * anchors_per_thread
    for lo in range(0, a, per_block):
        # thread t's u-th anchor is lo + u * threads + t: the block's run
        _match_block(anchors, gt_boxes, gt_valid, gt_labels, lo,
                     min(a, lo + per_block), out)
    idx = out[1].astype(np.int64)
    out[2] = np.take_along_axis(gt_boxes, idx[..., None], 1)
    out[3] = np.take_along_axis(gt_labels, idx, 1).astype(np.int32)
    return out


def _square_anchor(k):
    wh = ANCHORS[:, 2:] - ANCHORS[:, :2]
    return ANCHORS[np.flatnonzero((wh[:, 0] == 32) & (wh[:, 1] == 32))[k]]


def _match_case(name):
    rng = np.random.default_rng(len(name))
    b, g = 3, 12
    c = rng.uniform(0, HW[1], (b, g, 2))
    wh = rng.uniform(4, 60, (b, g, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    labels = rng.integers(0, 5, (b, g)).astype(np.int32)
    labels[:, 2::5] = -1  # padding between valid GTs
    if name == "touching_edges":
        # GTs whose edge lies exactly on an anchor's edge (inter exactly
        # 0 against it, listed), and one just past the anchor set's edge
        a0, a1 = _square_anchor(17), _square_anchor(200)
        boxes[:, 0] = [a0[2], a0[1], a0[2] + 20.0, a0[3]]
        boxes[:, 1] = [a1[0], a1[3], a1[2], a1[3] + 9.0]
        boxes[:, 3] = [ANCHORS[:, 2].max(), 10.0,
                       ANCHORS[:, 2].max() + 30.0, 40.0]
        labels[:, :4] = 1
    elif name == "padding_only":
        labels[1] = -1  # an image whose GTs are all padding
        labels[2, :] = -1
        labels[2, g - 1] = 3  # one valid GT, last
    elif name == "off_blocks":
        # every GT in one corner: most blocks drop them all
        c = rng.uniform(0, 8, (b, g, 2))
        boxes = np.concatenate([c, c + rng.uniform(2, 6, (b, g, 2))],
                               -1).astype(np.float32)
        labels[:] = rng.integers(0, 5, (b, g))
    elif name == "duplicates":
        boxes[:, 4] = boxes[:, 1]
        boxes[:, 9] = boxes[:, 1]
        labels[:, 9] = -1  # a padded duplicate never wins
        boxes[:, 6] = _square_anchor(40)
        boxes[:, 8] = boxes[:, 6]  # IoU exactly 1, tied
        labels[:, [1, 4, 6, 8]] = 2
    return boxes, labels


MATCH_CASES = ["random", "touching_edges", "padding_only", "off_blocks",
               "duplicates"]


@pytest.mark.parametrize("threads,apt", [(128, 1), (256, 1), (256, 2)])
@pytest.mark.parametrize("case", MATCH_CASES)
def test_match_design_bit_equal_to_twin_and_pallas(case, threads, apt):
    """The emulated cull-and-merge design against ``match_iou_reference``
    (all four outputs bit-equal) and detjax's ``match_iou_pallas`` in
    interpret mode (argmax, boxes and labels bit-equal; max_iou within
    detjax's own 4-ulp interpret-mode rounding)."""
    boxes, labels = _match_case(case)
    valid = labels >= 0
    got = match_emulated(ANCHORS, boxes, valid, labels, threads, apt)
    want = km.match_iou_reference(torch.from_numpy(ANCHORS),
                                  torch.from_numpy(boxes),
                                  torch.from_numpy(valid),
                                  torch.from_numpy(labels))
    pal = match_iou_pallas(jnp.asarray(ANCHORS), jnp.asarray(boxes),
                           jnp.asarray(valid), jnp.asarray(labels),
                           tile=1024, interpret=True)
    names = ("max_iou", "argmax", "boxes", "labels")
    for name, g, w, p in zip(names, got, want, pal):
        np.testing.assert_array_equal(g, w.numpy(), err_msg=name)
        if name == "max_iou":
            np.testing.assert_array_max_ulp(g, np.asarray(p),
                                            maxulp=PALLAS_MAX_IOU_ULP)
        else:
            np.testing.assert_array_equal(g, np.asarray(p), err_msg=name)
    listed = got[4]
    if case == "off_blocks":
        # whole blocks drop every GT and answer (0, first valid GT)
        dropped_all = listed == 0
        assert dropped_all.any()
        assert (got[0][dropped_all] == 0).all()
        assert (got[1][dropped_all] == valid.argmax(axis=1)[
            np.nonzero(dropped_all)[0]]).all()
    if case == "padding_only":
        assert (got[0][1] == -1).all() and (got[1][1] == 0).all()
    # the culling really drops GTs: fewer listed than valid somewhere
    assert (listed < valid.sum(axis=1)[:, None]).any()


def test_match_touching_edges_are_exact_zeros():
    """A GT whose edge touches an anchor's edge exactly has inter 0 and IoU
    0 against it, in the kernel's arithmetic and in the twin's; the GT past
    the anchor set's right edge is dropped by every block."""
    boxes, labels = _match_case("touching_edges")
    a0 = torch.from_numpy(_square_anchor(17))[None]
    g0 = torch.from_numpy(boxes[0, 0])[None]
    assert not _overlaps(a0, g0, 0.0).any()
    ux2 = _f32(ANCHORS[:, 2].max())
    assert min(ux2, boxes[0, 3, 2]) <= max(_f32(ANCHORS[:, 0].min()),
                                           boxes[0, 3, 0])
    valid = labels >= 0
    got = match_emulated(ANCHORS, boxes, valid, labels)
    assert not (got[1] == 3).any()


def test_match_culling_keeps_non_finite_coordinates_listed():
    """A GT with an inf or NaN coordinate is never dropped, and a block
    with an anchor beyond 1e30 culls nothing: their IoU need not be 0."""
    boxes, labels = _match_case("off_blocks")
    boxes[0, 0] = [np.inf, 0.0, np.inf, 10.0]
    boxes[1, 1] = [np.nan, 0.0, 5.0, 5.0]
    valid = labels >= 0
    anchors = ANCHORS.copy()
    anchors[5] = [-1e31, 0.0, 1e31, 1.0]
    listed = match_emulated(anchors, boxes, valid, labels)[4]
    assert (listed[:, :256] == valid.sum(axis=1)[:, None]).all()
    assert (listed[:2] >= 1).all()  # the non-finite GTs, in every block
    assert (listed[2] == 0).any()  # the corner GTs, dropped elsewhere


def _chunked_scan(an, g, valid, cull, union, chunk):
    """The chunked instance's scan for one block and image: the GT slots
    ``chunk`` at a time, in order; each chunk's listed GTs (culled against
    the block's union box) scanned with strict '>', carrying (best, index)
    from chunk to chunk; then the merge with (0, the first dropped valid
    GT) and (-1, the first invalid one). Returns (best, index, listed)."""
    zero = torch.zeros((), dtype=torch.float32)
    best = torch.full((an.shape[0],), -math.inf)
    bi = torch.zeros((an.shape[0],), dtype=torch.int64)
    dropped = invalid = None
    listed_total = 0
    for s0 in range(0, g.shape[0], chunk):
        gs, vs = g[s0:s0 + chunk], valid[s0:s0 + chunk]
        tame = (gs.abs() <= TAME).all(dim=1)
        apart = cull & tame & (
            (torch.minimum(union[2], gs[:, 2])
             <= torch.maximum(union[0], gs[:, 0]))
            | (torch.minimum(union[3], gs[:, 3])
               <= torch.maximum(union[1], gs[:, 1])))
        listed = torch.nonzero(vs & ~apart)[:, 0]
        d = torch.nonzero(vs & apart)[:, 0]
        inv = torch.nonzero(~vs)[:, 0]
        if dropped is None and len(d):
            dropped = s0 + int(d[0])
        if invalid is None and len(inv):
            invalid = s0 + int(inv[0])
        listed_total += len(listed)
        if not len(listed):
            continue
        lb = gs[listed]
        iw = torch.maximum(torch.minimum(an[:, None, 2], lb[None, :, 2])
                           - torch.maximum(an[:, None, 0], lb[None, :, 0]),
                           zero)
        ih = torch.maximum(torch.minimum(an[:, None, 3], lb[None, :, 3])
                           - torch.maximum(an[:, None, 1], lb[None, :, 1]),
                           zero)
        inter = iw * ih
        iou = inter / torch.clamp(_area(an)[:, None] + _area(lb)[None, :]
                                  - inter, min=1e-8)
        iou = torch.where(iou.isnan(), -math.inf, iou)
        cbest = iou.max(dim=1).values
        first = (iou == cbest[:, None]).to(torch.int8).argmax(dim=1)
        take = cbest > best  # strict: an earlier chunk keeps its ties
        best = torch.where(take, cbest, best)
        bi = torch.where(take, s0 + listed[first], bi)
    if dropped is not None:
        take = (0.0 > best) | ((0.0 == best) & (dropped < bi))
        best = torch.where(take, 0.0, best)
        bi = torch.where(take, dropped, bi)
    if invalid is not None:
        take = (-1.0 > best) | ((-1.0 == best) & (invalid < bi))
        best = torch.where(take, -1.0, best)
        bi = torch.where(take, invalid, bi)
    return best, bi, listed_total


def match_chunked_emulated(anchors, gt_boxes, gt_valid, chunk, per=128):
    """The chunked instance over every block of ``per`` anchors: (max_iou,
    argmax, GTs listed a block)."""
    b = gt_valid.shape[0]
    a = len(anchors)
    best = np.zeros((b, a), np.float32)
    idx = np.zeros((b, a), np.int64)
    listed = []
    for lo in range(0, a, per):
        an = torch.from_numpy(anchors[lo:lo + per])
        union = (an[:, 0].min(), an[:, 1].min(), an[:, 2].max(),
                 an[:, 3].max())
        cull = bool((an.abs() <= TAME).all())
        for img in range(b):
            m, i, n = _chunked_scan(an, torch.from_numpy(gt_boxes[img]),
                                    torch.from_numpy(gt_valid[img]), cull,
                                    union, chunk)
            best[img, lo:lo + per] = m.numpy()
            idx[img, lo:lo + per] = i.numpy()
            listed.append(n)
    return best, idx, listed


@pytest.mark.parametrize("case", MATCH_CASES)
@pytest.mark.parametrize("g,chunk", [(12, 5), (300, 64), (300, 300)])
def test_match_chunked_merge_equals_the_full_scan(case, g, chunk):
    """The chunked instance's merge (GT slots ``chunk`` at a time, each
    chunk culled and scanned, (max, first argmax) carried in GT order)
    equals the one-list scan and the twin's full [B, A, G] scan bit for
    bit, with ties split across chunks (duplicates ``chunk`` slots apart)
    and chunks that list nothing."""
    boxes, labels = _match_case(case)
    if g > boxes.shape[1]:
        rng = np.random.default_rng(g)
        reps = -(-g // boxes.shape[1])
        boxes = np.tile(boxes, (1, reps, 1))[:, :g].copy()
        labels = np.tile(labels, (1, reps))[:, :g].copy()
        labels[:, rng.uniform(size=g) < 0.5] = -1  # padding between them
    valid = labels >= 0
    best, idx, listed = match_chunked_emulated(ANCHORS, boxes, valid, chunk)
    want = km.match_iou_reference(torch.from_numpy(ANCHORS),
                                  torch.from_numpy(boxes),
                                  torch.from_numpy(valid),
                                  torch.from_numpy(labels))
    np.testing.assert_array_equal(best, want[0].numpy())
    np.testing.assert_array_equal(idx, want[1].numpy())
    one = match_emulated(ANCHORS, boxes, valid, labels, threads=128)
    np.testing.assert_array_equal(best, one[0])
    np.testing.assert_array_equal(idx, one[1])
    assert min(listed) < max(listed)


def test_match_gt_chunk_constants():
    """The wrapper's constants are the kernel's: one list up to 9,642 GT
    slots (24 bytes each within 227 KB less 1 KB), 4,096 a chunk past
    it (96 KB)."""
    assert km.ONE_LIST_GT == 9642
    assert km.GT_CHUNK * 24 == 96 * 1024
