"""Scan pairs registered correctly (their pose within the
configuration's gates, LCP at or above its threshold) over the
window's seconds, the window ending with the call in flight."""

UNIT = "pairs/s"


def read(rec):
    return rec["good"] / rec["window_s"] if rec["window_s"] > 0 else None
