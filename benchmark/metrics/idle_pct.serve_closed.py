"""idle_pct.serve_closed: One minus the union of device operations'
intervals over the window."""

from benchmark.metrics import _read


def read(rec):
    return _read.idle(rec)
