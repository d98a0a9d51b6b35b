"""bottleneck_bwd_roofline.train: The fused backward's bound over its five
kernels' time."""

from benchmark.metrics import _read


def read(rec):
    return _read.fused_roofline(rec, backward=True)
