"""serve_p50_ms.serve_rate: the median latency of the window's requests,
each from its due time to its answer, beside the 95th percentile."""

from benchmark.metrics import _read


def read(rec):
    return _read.latency_p50_ms(rec)
