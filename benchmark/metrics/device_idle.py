"""Percent of the traced stretch in which the card ran no operation:
1 less the union of the device's operation intervals over the
stretch's wall, averaged over the cards."""

LAYER = "device"
UNIT = "%"
MOVES = "pairs_per_s"


def read(rec):
    t = rec["trace"]
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
