"""What the readers share: kernel time and launches from the device
trace, the fused blocks' bounds, the step's FLOPs.

A record (``drivers/train.py``, ``drivers/serve.py``) holds the traced
window (``trace``: a ``harness.DeviceTrace``), the images completed in it,
the batch, the model's configuration, its forward FLOPs an image and what
the bounds need (matching's culled pairs a step, the kept detections of
each answered request)."""

from __future__ import annotations

from typing import Optional

from benchmark import counts
from benchmark.harness import short_name

SHARED = "y1_kernel"  # the fused forward's first kernel, rerun by the backward
OPENS = {"fwd_tile_kernel": False, "dc2_kernel": True}  # a call's 2nd
BWD_REST = ("dc1_kernel", "wgrad_kernel", "sum_rows")


def seconds(rec: dict, names) -> tuple:
    """Device seconds and launches of the kernels named ``names``."""
    return rec["trace"].kernel_seconds(lambda n: short_name(n) in names)


def fused_seconds(rec: dict, backward: bool) -> tuple:
    """Device seconds of the fused forward's (or backward's) kernels, and
    its calls. A y1_kernel launch belongs to the kernel that follows it:
    fwd_tile_kernel in a forward, dc2_kernel in a backward."""
    total, calls, y1 = 0.0, 0, 0.0
    for name, s, e in rec["trace"].events:
        name, t = short_name(name), e - s
        if name == SHARED:
            y1 = t
        elif name in OPENS:
            if OPENS[name] == backward:
                total += t + y1
                calls += 1
            y1 = 0.0
        elif backward and name in BWD_REST:
            total += t
    return total / 1e6, calls


def fused_roofline(rec: dict, backward: bool) -> Optional[float]:
    """The fused block's bound over its device time, as a percentage; the
    bound of a call is the mean over the forward's block shapes (the
    window may cut a forward)."""
    t, calls = fused_seconds(rec, backward)
    if t <= 0 or calls == 0:
        return None
    shapes = counts.fused_block_shapes(rec["model"]["backbone_depth"],
                                       rec["model"]["image_size"])
    fn = counts.bottleneck_bwd_bound_ms if backward else \
        counts.bottleneck_bound_ms
    per_call_ms = sum(fn(rec["batch"], h, w, m)[0]
                      for h, w, m in shapes) / len(shapes)
    return 100.0 * per_call_ms * calls / 1e3 / t


def nms_roofline(rec: dict) -> Optional[float]:
    t, launches = seconds(rec, ("nms_kernel",))
    if t <= 0 or launches == 0 or not rec["kept"]:
        return None
    pairs = sum(counts.nms_pairs_lower(k) for k in rec["kept"]) / launches
    bound_ms = counts.nms_bound_ms(rec["batch"], rec["candidates"],
                                   rec["max_det"], int(pairs))[0]
    return 100.0 * bound_ms * launches / 1e3 / t


def mfu(rec: dict, per_image_passes: float, over_busy: bool = False
        ) -> Optional[float]:
    tr = rec["trace"]
    t = tr.busy_s() if over_busy else rec["window_s"]
    if rec["images"] == 0 or t <= 0 or tr.window is None:
        return None
    return counts.shares(per_image_passes * rec["flops_forward"]
                         * rec["images"], t)


def idle(rec: dict) -> Optional[float]:
    tr = rec["trace"]
    if tr.window is None or rec["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / rec["window_s"])


def batch_fill(rec: dict) -> Optional[float]:
    """Requests answered in the traced window over the device batches they
    came in times the batch; the answers of one batch are views of one
    array, which names the batch."""
    sizes = rec.get("batch_sizes") or []
    if not sizes:
        return None
    return 100.0 * sum(sizes) / (len(sizes) * rec["batch"])


def latency_p50_ms(rec: dict) -> Optional[float]:
    """The median latency of the window's requests (the open loop's)."""
    lat = sorted(rec.get("latency_ms") or [])
    return lat[(len(lat) - 1) // 2] if lat else None


def span_ms(rec: dict, phase: str) -> Optional[float]:
    v = rec["spans"].get(phase) or []
    return sum(v) / len(v) if v else None


def match_roofline(rec: dict) -> Optional[float]:
    t, launches = seconds(rec, ("match_kernel",))
    pairs = rec.get("match_pairs") or []
    if t <= 0 or launches == 0 or not pairs:
        return None
    bound_ms = sum(counts.match_bound_ms(rec["batch"], rec["anchors"],
                                         rec["max_gt"], p)[0]
                   for p in pairs) / len(pairs)
    return 100.0 * bound_ms * launches / 1e3 / t
