"""Host milliseconds a pair of straggler redemption: the span "redeem"
of each call's table (each straggler's registration and, over several
processes, the one gather of the redeemed answers, "redeem/exchange",
its wait for the other cards included: the wall that redemption adds to
a call), summed over the window's calls and divided by their pairs. 0.0
when the tables hold no redemption."""

from spans import per_pair

LAYER = "anytime loop"
UNIT = "ms"
MOVES = "pairs_per_s"


def read(rec):
    ms = per_pair(rec, lambda t: t["spans"].get("redeem",
                                                {"host_s": 0.0})["host_s"])
    return None if ms is None else 1e3 * ms
