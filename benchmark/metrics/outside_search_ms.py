"""Milliseconds a pair spends outside the search: each call's host wall
less its search seconds (``stats["search_seconds"]``, a batch's once),
summed over the window and divided by its pairs. Sampling, the verify
index, the off-clock warm step and graph capture, the final refine."""

LAYER = "call set-up and final refine"
UNIT = "ms"
MOVES = "pairs_per_s"


def read(rec):
    calls = rec["calls"]
    pairs = sum(c["pairs"] for c in calls)
    if not pairs:
        return None
    return 1e3 * sum(c["wall_s"] - c["search_s"] for c in calls) / pairs
