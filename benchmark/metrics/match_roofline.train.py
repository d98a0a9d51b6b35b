"""match_roofline.train: The matching kernel's bound (the culled pairs of
each traced step, over bytes and fp32 operations) over match_kernel's
device time."""

from benchmark.metrics import _read


def read(rec):
    return _read.match_roofline(rec)
