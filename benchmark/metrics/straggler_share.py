"""The share of the window's pairs that a batch left below its stop:
the counter ``stragglers`` of each call's table (the length of
straggler redemption's list, the same in every process of a run over
several cards), summed over the window's calls and divided by their
pairs, in percent. None from a program that keeps no such counter."""

from spans import tables

LAYER = "anytime loop"
UNIT = "%"
MOVES = "pairs_per_s"


def read(rec):
    got = tables(rec)
    if got is None or not any("stragglers" in t for t in got):
        return None
    pairs = sum(c["pairs"] for c in rec["calls"])
    return 100.0 * sum(t.get("stragglers", 0) for t in got) / pairs
