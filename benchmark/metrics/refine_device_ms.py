"""Device milliseconds of refine a pair: the device seconds (CUDA
events on the stream around each refine) of every span "refine" of each
call's table, in-loop, coarse-rank, warm-up, final and a straggler's,
summed over the window's calls and divided by their pairs."""

from spans import device_seconds, per_pair

LAYER = "refine"
UNIT = "ms"
MOVES = "pairs_per_s"


def read(rec):
    ms = per_pair(rec, lambda t: device_seconds(
        t, lambda path: path.rpartition("/")[2] == "refine"))
    return None if ms is None else 1e3 * ms
