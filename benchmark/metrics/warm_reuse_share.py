"""The share of the window's warm-ups that reused what the process had
already warmed (a kind's first warm-up in the process runs a step and a
refine whose outputs are thrown away; a later one builds the verify
indexes and captures alone): the counters ``warm_reused`` and
``warm_full`` of each call's span table, one a warm-up (a single pair's
set-up and each escalation, a batch's set-up and each straggler's),
summed over the window's calls, in percent. None from a program that
keeps no such counters."""

from spans import tables

LAYER = "call set-up and final refine"
UNIT = "%"
MOVES = "pairs_per_s"


def read(rec):
    got = tables(rec)
    if got is None:
        return None
    reused = sum(t.get("warm_reused", 0) for t in got)
    total = reused + sum(t.get("warm_full", 0) for t in got)
    return 100.0 * reused / total if total else None
