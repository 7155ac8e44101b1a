"""Percent of its roofline K1 (the pruned verify) ran at over the
traced stretch: the least time of its launches (``roofline/k1.py``)
over the device time the profiler recorded for them."""

from tracing import roofline_share

LAYER = "kernels"
UNIT = "%"
MOVES = "pose_p90_s"


def read(rec):
    return roofline_share(rec["trace"], "k1")
