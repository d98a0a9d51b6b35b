"""bottleneck_fwd_roofline.serve_closed: The fused forward's bound over
y1_kernel + fwd_tile_kernel time."""

from benchmark.metrics import _read


def read(rec):
    return _read.fused_roofline(rec, backward=False)
