"""update_ms.train: Mean ms of the clip and the optimizer, by CUDA events."""

from benchmark.metrics import _read


def read(rec):
    return _read.span_ms(rec, "update")
