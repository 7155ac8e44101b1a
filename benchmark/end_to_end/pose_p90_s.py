"""90th percentile of the seconds from a pair's call to its returned
pose, over every pair registered in the window (the same samples as
``pose_p50_s``; ``statistics.quantiles``, inclusive)."""

import statistics

UNIT = "s"


def read(rec):
    s = rec["pose_s"]
    if len(s) < 2:
        return s[0] if s else None
    return statistics.quantiles(s, n=10, method="inclusive")[8]
