"""Percent of its roofline K2 (the row-capped band capture and its
prep) ran at over the traced stretch: the least time of its launches
(``roofline/k2.py``) over the device time the profiler recorded."""

from tracing import roofline_share

LAYER = "kernels"
UNIT = "%"
MOVES = "pose_p90_s"


def read(rec):
    return roofline_share(rec["trace"], "k2")
