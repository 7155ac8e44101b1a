"""The port's span tables as the readers see them. Each registration
keeps one (``stats["spans"]``, ``super4pcs_tpu_torch/utils/profiling.py``;
a batch's once), and the port keeps the tables of its last
registrations (``profiling.recent``). The window's calls (``rec
["calls"]``: those that returned, outside the profiled stretch when any
is) are the last calls of the run, so their tables are the last ones
the port kept; each must match its call's pairs and fit in its wall.
From a program that keeps no tables the readers return None."""

from __future__ import annotations

import sys

PROFILING = "super4pcs_tpu_torch.utils.profiling"


def tables(rec):
    """The span table of each of the window's calls, in order, or None
    when the program keeps none or they do not line up with the calls."""
    recent = getattr(sys.modules.get(PROFILING), "recent", None)
    calls = rec["calls"]
    if recent is None or not calls:
        return None
    got = recent(len(calls))
    if len(got) != len(calls):
        return None
    for table, c in zip(got, calls):
        if (table.get("pairs") != c["pairs"]
                or table["spans"]["call"]["host_s"] > c["wall_s"]):
            return None
    return got


def per_pair(rec, value):
    """``value(table)`` summed over the window's calls' tables, divided
    by their pairs; None without tables or when ``value`` gives None for
    every table."""
    got = tables(rec)
    if got is None:
        return None
    values = [value(t) for t in got]
    if all(v is None for v in values):
        return None
    pairs = sum(c["pairs"] for c in rec["calls"])
    return sum(v or 0.0 for v in values) / pairs if pairs else None


def device_seconds(table, keep):
    """The device seconds of the paths that ``keep(path)`` selects, or
    None when none of them has device seconds (a run off the card)."""
    secs = [row["device_s"] for path, row in table["spans"].items()
            if keep(path) and row["device_s"] is not None]
    return sum(secs) if secs else None
