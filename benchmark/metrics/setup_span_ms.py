"""Host milliseconds a pair of the registrations' set-up: the span
"setup" of each call's span table (sampling and kd order, the builds,
the warm step and graph capture, the initial verify; a batch's
``BatchRun``), summed over the window's calls and divided by their
pairs."""

from spans import per_pair

LAYER = "call set-up and final refine"
UNIT = "ms"
MOVES = "pairs_per_s"


def read(rec):
    ms = per_pair(rec, lambda t: sum(
        row["host_s"] for path, row in t["spans"].items()
        if path == "setup"))
    return None if ms is None else 1e3 * ms
