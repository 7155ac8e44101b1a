"""Median seconds from a pair's call to its returned pose, over every
pair registered in the window (each pair of a batch takes its call's
wall)."""

import statistics

UNIT = "s"


def read(rec):
    return statistics.median(rec["pose_s"]) if rec["pose_s"] else None
