"""mfu.serve_rate: Forward FLOPs of the answered images over the
window's device-busy time and the bf16 peak: at a fixed offered rate the
wall time is the rate's."""

from benchmark.metrics import _read


def read(rec):
    return _read.mfu(rec, 1.0, over_busy=True)
