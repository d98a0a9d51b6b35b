"""Spatial partitioning: image rows split over the ``space`` ranks
(``detjax/models/spatial.py`` and what detjax's partitioner inserts).

Under detjax's 2-D ``(data, space)`` mesh each image is sharded
``P('data', 'space')``: the S ranks of a space group hold contiguous
blocks of its rows, and the partitioner adds a halo exchange to every
convolution and pool, forward and backward, gathers the pyramid when a
level is too small to row-shard (:func:`unshard_tiny_levels`, detjax's
layout rule) and all-gathers the anchor axis before matching, the loss and
NMS. PyTorch inserts none of this, so this module writes it:

- :func:`space_group` makes a :class:`SpaceGroup` active on this thread;
  the model's convolutions and its stem pool then run on the rank's rows
  through :func:`conv2d` and :func:`max_pool_3x3s2`. Without an active
  group each is the plain op, so the single-process model is unchanged.
- For kernel k, stride s and padding p, a shard takes p rows from the
  rank above and max(k - p - s, 0) from the rank below (:func:`halo`),
  runs the op with no row padding and produces its own output rows; at
  the image's true top and bottom the halo rows are the op's padding
  (zeros for a conv, -inf for the pool). The stem's 7x7/s2 takes (3, 2),
  a 3x3/s1 (1, 1), a 3x3/s2 and the max-pool (1, 0), a 1x1/s2 (0, 0). A
  strided op needs each shard to start on a multiple of its stride: the
  backbone's five halvings need the canvas height divisible by 32 x S
  (:func:`check_canvas_rows`). detjax's partitioner accepts any height
  that S divides by padding and resharding; here such a canvas raises.
- detjax's layout rule is decided once a forward, from the canvas
  (:func:`pyramid_sharded`, in ``models/detector.py``). On a pyramid it
  gathers, the FPN gathers P3-P5 and C5 (P6's input) and runs P6 and P7
  on whole rows (:func:`unshard_tiny_levels`): their strides would not
  split the shards evenly there (R50-640's P6 is 10 rows, 5 a rank). On a
  pyramid it keeps row-sharded, every level's rows a rank are even, so
  P6 and P7 run on the rank's rows.
- Each level of the heads' outputs is gathered over the space group
  before it is flattened (:func:`gather_rows`): flattening the shards
  first would interleave the anchors out of ``ops/anchors.py``'s order.

Gradients: after the gathers every rank of a space group computes the
same loss, so the train step makes each rank's objective its data group's
loss divided by S. A gather's backward sums the cotangent over the space
group and keeps the rank's rows; the halo's backward sends each halo row's
gradient back to its owner, which adds it to its boundary rows. Every
parameter gradient summed over all ranks and divided by the data-axis size
is then the single-process gradient of the global batch
(``train/step.py``).

Transport: every exchange is an ``all_gather`` over the space group (of
the boundary rows for a halo), never point-to-point ``send``/``recv``:
gloo's ``send``/``recv`` take CPU tensors only, and the all-gather works on
gloo (CPU, and CUDA tensors) and NCCL alike. A halo exchange moves S times
the rows it needs, two rows' worth at S = 2. The counters in
:data:`exchanges` count the collectives.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

# A level is row-shardable when every 'space' shard gets at least this
# many whole rows (detjax's rule, ``detjax/models/spatial.py:47``).
MIN_ROWS_PER_SHARD = 2
# The backbone halves the rows five times (stem conv, stem pool, layer2-4)
BACKBONE_STRIDE = 32

# Collectives issued on this process: "halo" and "gather" forwards, and
# their backwards "halo_grad" and "gather_grad". Reset them by assignment.
exchanges: Dict[str, int] = {"halo": 0, "halo_grad": 0, "gather": 0,
                             "gather_grad": 0}


@dataclasses.dataclass(frozen=True)
class SpaceGroup:
    """The ranks that split one set of images by rows: ``group`` (a
    process group), this rank's ``index`` in it (its block of rows) and
    its ``size`` S."""

    group: Any
    index: int
    size: int


_LOCAL = threading.local()


def active() -> Optional[SpaceGroup]:
    """The space group active on this thread, or None."""
    return getattr(_LOCAL, "group", None)


@contextlib.contextmanager
def space_group(sg: Optional[SpaceGroup]):
    """Inside, the model's convolutions and pool run on this rank's rows
    of ``sg`` (None: the plain ops)."""
    before = active()
    _LOCAL.group = sg
    try:
        yield
    finally:
        _LOCAL.group = before


def replicated():
    """Inside, the ops run plain on whole rows that every rank of the
    space group holds alike (after a gather)."""
    return space_group(None)


def _degenerate(rows: int, n_sp: int) -> bool:
    return rows < MIN_ROWS_PER_SHARD * n_sp or rows % n_sp != 0


def gathers_levels(rows: Dict[int, int], n_sp: int) -> bool:
    """detjax's layout rule on a pyramid of ``rows`` (level -> its rows
    over the whole image): True when some level is too small to row-shard
    over ``n_sp`` ranks, so that every level is gathered."""
    return any(_degenerate(r, n_sp) for r in rows.values())


def level_rows(canvas_rows: int, level: int) -> int:
    """The rows of pyramid ``level`` on a canvas of ``canvas_rows``: each
    stride-2 stage takes ceil(rows / 2)."""
    r = int(canvas_rows)
    for _ in range(level):
        r = -(-r // 2)
    return r


def pyramid_sharded(canvas_rows: int, levels, n_sp: int) -> bool:
    """Whether the FPN's outputs on this canvas stay row-sharded (else
    :func:`unshard_tiny_levels` gathered them)."""
    return not gathers_levels({lvl: level_rows(canvas_rows, lvl)
                               for lvl in levels}, n_sp)


def check_canvas_rows(rows: int, n_sp: int) -> None:
    """Raise ValueError unless a canvas of ``rows`` splits over ``n_sp``
    ranks through the backbone: detjax's rule (S divides the height) and
    this module's (each of the five stride-2 stages halves every rank's
    rows, so 32 x S divides it)."""
    if rows % n_sp:
        raise ValueError(f"the canvas height {rows} is not divisible by "
                         f"the space axis ({n_sp})")
    if rows % (BACKBONE_STRIDE * n_sp):
        raise ValueError(
            f"the canvas height {rows} must be divisible by "
            f"{BACKBONE_STRIDE} x space = {BACKBONE_STRIDE * n_sp}: each of "
            f"the backbone's five stride-2 stages halves every rank's rows")


def _cat_rows(pieces: List[torch.Tensor], like: torch.Tensor
              ) -> torch.Tensor:
    """``pieces`` concatenated along the rows, in ``like``'s memory format
    (the model's channels_last): the small pieces are converted first, so
    that the concatenation writes that format directly."""
    if like.dim() == 4 and not like.is_contiguous() and like.is_contiguous(
            memory_format=torch.channels_last):
        pieces = [p if p is like else
                  p.contiguous(memory_format=torch.channels_last)
                  for p in pieces]
    return torch.cat(pieces, 2)


def _all_gather(t: torch.Tensor, sg: SpaceGroup) -> List[torch.Tensor]:
    parts = [torch.empty_like(t) for _ in range(sg.size)]
    dist.all_gather(parts, t, group=sg.group)
    return parts


def _all_reduce(t: torch.Tensor, sg: SpaceGroup) -> torch.Tensor:
    dist.all_reduce(t, group=sg.group)
    return t


class _Halo(torch.autograd.Function):
    """x [B, C, h, W] -> [B, C, top + h + bottom, W]: ``top`` rows of the
    rank above and ``bottom`` rows of the rank below around the rank's
    own. At the image's top and bottom the added rows hold ``fill``, or
    are left out when ``fill`` is None. One all-gather of each rank's
    first ``bottom`` and last ``top`` rows, forward and backward."""

    @staticmethod
    def forward(ctx, x, top: int, bottom: int, fill, sg: SpaceGroup):
        h = x.shape[2]
        if top > h or bottom > h:
            raise ValueError(f"a halo of ({top}, {bottom}) rows needs at "
                             f"least as many on every rank; it has {h}")
        ctx.top, ctx.bottom, ctx.sg = top, bottom, sg
        i, last = sg.index, sg.size - 1
        ctx.lo = top if (i > 0 or fill is not None) else 0
        ctx.hi = bottom if (i < last or fill is not None) else 0
        exchanges["halo"] += 1
        send = torch.cat([x[:, :, :bottom], x[:, :, h - top:]], 2)
        parts = _all_gather(send.contiguous(), sg)
        pieces = []
        if i > 0:
            pieces.append(parts[i - 1][:, :, bottom:])
        elif fill is not None and top:
            pieces.append(x.new_full((*x.shape[:2], top, x.shape[3]), fill))
        pieces.append(x)
        if i < last:
            pieces.append(parts[i + 1][:, :, :bottom])
        elif fill is not None and bottom:
            pieces.append(x.new_full((*x.shape[:2], bottom, x.shape[3]),
                                     fill))
        return _cat_rows(pieces, x)

    @staticmethod
    def backward(ctx, g):
        top, bottom, sg = ctx.top, ctx.bottom, ctx.sg
        i, last = sg.index, sg.size - 1
        h = g.shape[2] - ctx.lo - ctx.hi
        exchanges["halo_grad"] += 1
        gx = g[:, :, ctx.lo:ctx.lo + h].clone()
        # what the rank above owes this rank's first `bottom` rows, and
        # the rank below its last `top` rows
        g_above = (g[:, :, :top] if i > 0 else
                   g.new_zeros((*g.shape[:2], top, g.shape[3])))
        g_below = (g[:, :, ctx.lo + h:] if i < last else
                   g.new_zeros((*g.shape[:2], bottom, g.shape[3])))
        parts = _all_gather(torch.cat([g_below, g_above], 2).contiguous(),
                            sg)
        if i > 0:
            gx[:, :, :bottom] += parts[i - 1][:, :, :bottom]
        if i < last:
            gx[:, :, h - top:] += parts[i + 1][:, :, bottom:]
        return gx, None, None, None, None


def halo(x: torch.Tensor, top: int, bottom: int, fill=0.0,
         sg: Optional[SpaceGroup] = None) -> torch.Tensor:
    """x's rows with ``top`` rows of the rank above and ``bottom`` of the
    rank below (of ``sg``, default the active group); at the image's
    edges ``fill`` rows, or none when ``fill`` is None."""
    sg = sg or active()
    if top == 0 and bottom == 0:
        return x
    return _Halo.apply(x, top, bottom, fill, sg)


class _GatherRows(torch.autograd.Function):
    """x [B, C, h, W] -> [B, C, S*h, W], every rank's rows in rank order.
    The backward sums the cotangent over the space group (in fp32) and
    keeps the rank's rows."""

    @staticmethod
    def forward(ctx, x, sg: SpaceGroup):
        ctx.sg, ctx.h = sg, x.shape[2]
        exchanges["gather"] += 1
        return _cat_rows(_all_gather(x.contiguous(), sg), x)

    @staticmethod
    def backward(ctx, g):
        sg, h = ctx.sg, ctx.h
        exchanges["gather_grad"] += 1
        # a buffer of its own: g may be autograd's, and fp32 already
        total = torch.empty(g.shape, dtype=torch.float32, device=g.device)
        total = _all_reduce(total.copy_(g), sg)
        return (total[:, :, sg.index * h:(sg.index + 1) * h].to(g.dtype),
                None)


def gather_rows(x: torch.Tensor, sg: Optional[SpaceGroup] = None
                ) -> torch.Tensor:
    """The whole image's rows of a row-sharded x, on every rank of ``sg``
    (default the active group)."""
    return _GatherRows.apply(x, sg or active())


def _pad_rows(k: int, s: int, p: int) -> Tuple[int, int]:
    return p, max(k - p - s, 0)


def conv2d(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv(x)``; with an active space group, on this rank's rows of
    the image: the halo of :func:`_pad_rows`, zeros at the image's edges,
    and no row padding of the op's own. A 1x1 stride-1 conv stays local.
    Raises where the rank's rows do not split under the stride."""
    sg = active()
    k, s = conv.kernel_size[0], conv.stride[0]
    if sg is None or (k == 1 and s == 1):
        return conv(x)
    if x.shape[2] % s:
        raise ValueError(f"{x.shape[2]} rows a rank do not split under "
                         f"stride {s}")
    top, bottom = _pad_rows(k, s, conv.padding[0])
    return F.conv2d(halo(x, top, bottom, 0.0, sg), conv.weight, conv.bias,
                    conv.stride, (0, conv.padding[1]), conv.dilation,
                    conv.groups)


def max_pool_3x3s2(x: torch.Tensor) -> torch.Tensor:
    """The stem's 3x3 stride-2 max-pool, padding 1 with -inf; with an
    active space group on this rank's rows (a halo of one row above, -inf
    at the image's top)."""
    sg = active()
    if sg is None:
        return F.max_pool2d(x, 3, stride=2, padding=1)
    if x.shape[2] % 2:
        raise ValueError(f"{x.shape[2]} rows a rank do not split under "
                         f"stride 2")
    return F.max_pool2d(halo(x, 1, 0, float("-inf"), sg), 3, stride=2,
                        padding=(0, 1))


def with_row_halo(fn: Callable[[torch.Tensor], torch.Tensor],
                  x: torch.Tensor, rows: int) -> torch.Tensor:
    """``fn`` (a stride-1 op that keeps the rows, padding its own
    intermediate maps at the image's edges) on this rank's rows: ``rows``
    rows from each neighbour on the inner edges only, none at the image's
    top and bottom, and the added rows dropped from the output. Plain
    ``fn(x)`` without an active group."""
    sg = active()
    if sg is None:
        return fn(x)
    h = x.shape[2]
    y = fn(halo(x, rows, rows, None, sg))
    lo = rows if sg.index > 0 else 0
    return y[:, :, lo:lo + h]


def unshard_tiny_levels(feats: Dict[int, torch.Tensor],
                        row_sharded: bool) -> Dict[int, torch.Tensor]:
    """detjax's layout rule across a pyramid, as :func:`pyramid_sharded`
    decided it: ``feats`` as they are without an active space group or on
    a row-sharded pyramid; else every level gathered whole."""
    sg = active()
    if sg is None or row_sharded:
        return feats
    return {lvl: gather_rows(x, sg) for lvl, x in feats.items()}
