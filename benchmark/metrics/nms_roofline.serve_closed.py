"""nms_roofline.serve_closed: the NMS kernel's bound (a lower one: the
pairs each kept detection needed) over nms_kernel time."""

from benchmark.metrics import _read


def read(rec):
    return _read.nms_roofline(rec)
