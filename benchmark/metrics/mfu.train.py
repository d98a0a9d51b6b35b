"""mfu.train: Forward FLOPs x 3 (every parameter trains) of the traced
steps' images over the window and the bf16 peak."""

from benchmark.metrics import _read


def read(rec):
    return _read.mfu(rec, 3.0)
