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
    csum = torch.cumsum(mask, dim=-1)
    count = csum[..., -1]
    s = torch.arange(1, capacity + 1, device=dev)
    if lead:
        s = s.expand(lead + (capacity,)).contiguous()
    idx = torch.searchsorted(csum, s, side="left")
    valid = s <= count[..., None]
    return torch.where(valid, idx, 0), valid, count


def masked_indices_2d(mask: torch.Tensor, capacity: int):
    """:func:`masked_indices` over a 2-D mask in row-major order: flat
    indices ``row * k2 + col`` (the JAX package's hierarchical form
    returns the same values)."""
    return masked_indices(mask.reshape(-1), capacity)
