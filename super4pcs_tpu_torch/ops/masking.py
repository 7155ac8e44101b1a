"""Static-shape compaction helpers.

PyTorch counterparts of ``super4pcs_tpu.ops.masking``: the port keeps
the JAX package's fixed-capacity buffers plus validity masks (the
reference grows ``std::vector``s), so the buffer sizes, and what
overflows them, stay the same in both packages. Compaction is a prefix
sum plus a binary search per output slot, which needs no host sync.
"""

from __future__ import annotations

import torch


def masked_indices(mask: torch.Tensor, capacity: int):
    """Indices of True entries of a flat bool mask, compacted to a
    ``(capacity,)`` buffer (ascending order; surplus entries dropped).
    A mask with leading axes (..., N) is compacted row by row, each row
    on its own, into (..., capacity).

    Returns (idx, valid, count): ``idx`` int64 (0 in dead slots, safe
    for gathers), ``valid`` bool marks live slots, ``count`` (int64, one
    per row) the true number of set bits (may exceed capacity — callers
    use it to report overflow).
    """
    dev = mask.device
    lead = mask.shape[:-1]
    if mask.shape[-1] == 0:
        z = torch.zeros(lead + (capacity,), dtype=torch.int64, device=dev)
        return z, z.bool(), torch.zeros(lead, dtype=torch.int64,
                                        device=dev)
    n = mask.shape[-1]
    s = torch.arange(1, capacity + 1, device=dev)
    if not lead:
        csum = torch.cumsum(mask, dim=0)
        count = csum[-1]
        idx = torch.searchsorted(csum, s, side="left")
        valid = s <= count
        return torch.where(valid, idx, 0), valid, count
    # every row in one flat prefix sum (a scan along a batched last axis
    # runs a row per thread block on a card, slow for a few long rows):
    # slot s of row r is the first flat position where the sum reaches
    # the rows before r's total plus s, which lies in row r iff s <= its
    # count
    rows = mask.reshape(-1, n)
    csum = torch.cumsum(rows.reshape(-1), dim=0)
    count = rows.sum(dim=1)
    before = csum[n - 1::n] - count
    idx = (torch.searchsorted(csum, (before[:, None] + s).reshape(-1),
                              side="left").view(-1, capacity)
           - (torch.arange(rows.shape[0], device=dev) * n)[:, None])
    valid = s <= count[:, None]
    return (torch.where(valid, idx, 0).view(lead + (capacity,)),
            valid.view(lead + (capacity,)), count.view(lead))


#: elements of one chunk's (T, rows, cols) planes in the batched dense
#: extraction and join and the grid join's (T, candidates, probes)
#: planes, by device type: the live planes of a chunk take ~16-40 bytes
#: an element (the dense join's ~13, the grid join's ~100), so a chunk
#: stays within a few GB on a card and a few hundred MB on the host
CHUNK_ELEMS = {"cuda": {"extract": 1 << 26, "join": 1 << 28,
                        "grid": 1 << 25},
               "cpu": {"extract": 1 << 22, "join": 1 << 24,
                       "grid": 1 << 21}}


def trial_chunk(nt: int, per_trial: int, device, kind: str) -> int:
    """Trials per chunk of a batched plane computation of ``nt`` trials
    of ``per_trial`` elements each (``kind`` "extract", "join" or "grid", see
    :data:`CHUNK_ELEMS`): the chunks are as even as the budget allows,
    and at least one trial each. A trial's result never depends on its
    chunk."""
    budget = CHUNK_ELEMS.get(torch.device(device).type,
                             CHUNK_ELEMS["cpu"])[kind]
    per = max(budget // max(per_trial, 1), 1)
    n_chunks = -(-nt // per)
    return -(-nt // n_chunks)


def over_chunks(nt: int, chunk: int, fn):
    """``fn(start, stop)`` over the trials [0, nt) a chunk at a time,
    its outputs (a tuple of tensors with a leading trial axis) joined
    along that axis."""
    outs = [fn(s, min(s + chunk, nt)) for s in range(0, nt, chunk)]
    return (outs[0] if len(outs) == 1
            else tuple(torch.cat(parts) for parts in zip(*outs)))
