"""Device milliseconds a step of the call's own search: the device
seconds of the span "search/step" (CUDA events on the stream around each
replay, eager step or batched step) over the steps it counts, summed
over the window's calls; a straggler's search ("redeem/call/search/step")
is left out."""

from spans import tables

LAYER = "anytime loop"
UNIT = "ms"
MOVES = "pose_p90_s"


def read(rec):
    rows = [t["spans"].get("search/step") for t in tables(rec) or ()]
    rows = [r for r in rows if r and r["device_s"] is not None]
    steps = sum(r["count"] for r in rows)
    return 1e3 * sum(r["device_s"] for r in rows) / steps if steps else None
