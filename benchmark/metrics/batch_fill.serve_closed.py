"""batch_fill.serve_closed: requests answered in the traced window over the
device batches they came in times the batch."""

from benchmark.metrics import _read


def read(rec):
    return _read.batch_fill(rec)
