"""forward_ms.train: Mean ms from a step's start to its forward's end
(augment included), by CUDA events through train_step(record=)."""

from benchmark.metrics import _read


def read(rec):
    return _read.span_ms(rec, "forward")
