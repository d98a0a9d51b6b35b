"""mfu.serve_closed: Forward FLOPs of the answered images over the window
and the bf16 peak."""

from benchmark.metrics import _read


def read(rec):
    return _read.mfu(rec, 1.0)
