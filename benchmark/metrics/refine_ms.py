"""Milliseconds of refine a pair: every call of
``ops.refine.refine_transform`` in the window (in-loop, coarse-rank and
final), timed by the host clock between two device synchronisations,
summed and divided by the pairs of those calls (the calls outside the
profiled stretch)."""

LAYER = "refine"
UNIT = "ms"
MOVES = "pairs_per_s"


def read(rec):
    refine = sum(c["refine_s"] for c in rec["calls"])
    pairs = sum(c["pairs"] for c in rec["calls"])
    return 1e3 * refine / pairs if refine > 0 and pairs else None
