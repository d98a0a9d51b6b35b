"""idle_dispatch_pct.serve_closed: Percent of the traced window in which
the device ran nothing and the server's worker dispatched a batch
(serve.dispatch)."""

from benchmark.metrics import _serve_spans


def read(rec):
    return _serve_spans.idle_pct(rec, "dispatch")
