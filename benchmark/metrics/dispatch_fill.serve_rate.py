"""dispatch_fill.serve_rate: The requests of the serve.dispatch spans that
start in the traced window (their ``n``) over their count times the
batch, percent."""

from benchmark.metrics import _serve_spans


def read(rec):
    return _serve_spans.dispatch_fill(rec)
