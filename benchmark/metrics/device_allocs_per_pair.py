"""Device allocations a pair: the ``num_device_alloc`` of
``torch.cuda.memory_stats`` that each call added (its span table's
``device_allocs``: ``cudaMalloc`` calls of the caching allocator, the
captured graphs' pools among them), summed over the window's calls and
divided by their pairs."""

from spans import per_pair

LAYER = "call set-up and final refine"
UNIT = "allocs"
MOVES = "pairs_per_s"


def read(rec):
    return per_pair(rec, lambda t: t.get("device_allocs"))
