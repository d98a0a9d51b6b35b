"""dispatch_ms.serve_rate: Mean host ms of the worker's serve.dispatch
spans (the upload, the normalize and the enqueue of detect) that start
in the traced window."""

from benchmark.metrics import _serve_spans


def read(rec):
    return _serve_spans.dispatch_ms(rec)
