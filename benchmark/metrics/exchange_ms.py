"""Host milliseconds a pair that process 0 spends inside the port's
``torch.distributed`` collectives during its calls (each step's
per-pair results, ``all_gather_object``, and process 0's clock,
``broadcast``; the waits for the other processes included), summed over
the window's calls and divided by their pairs. The harness's own
collectives are not counted. None from a run in one process."""

LAYER = "exchange"
UNIT = "ms"
MOVES = "pairs_per_s"


def read(rec):
    calls = rec["calls"]
    if not calls or any("exchange_s" not in c for c in calls):
        return None
    pairs = sum(c["pairs"] for c in calls)
    return 1e3 * sum(c["exchange_s"] for c in calls) / pairs
