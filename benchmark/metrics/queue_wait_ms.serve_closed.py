"""queue_wait_ms.serve_closed: Mean ms of the requests' serve.queue_wait
spans (submit's put to the worker's get) that end in the traced window."""

from benchmark.metrics import _serve_spans


def read(rec):
    return _serve_spans.queue_wait_ms(rec)
