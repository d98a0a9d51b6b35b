"""backward_ms.train: Mean ms of the backward, by CUDA events."""

from benchmark.metrics import _read


def read(rec):
    return _read.span_ms(rec, "backward")
