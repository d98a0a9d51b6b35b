"""idle_assemble_pct.serve_rate: Percent of the traced window in which the
device ran nothing and the server's worker assembled a padded batch
(serve.assemble)."""

from benchmark.metrics import _serve_spans


def read(rec):
    return _serve_spans.idle_pct(rec, "assemble")
