"""LCP (Largest Common Pointset) verification.

PyTorch counterpart of ``super4pcs_tpu.ops.lcp`` (the reference's
``Match4PCSBase::Verify``, ref:src/super4pcs/algorithms/
match4pcsBase.cc:504-567): all candidate transforms of a step are scored
in one batched min-distance pass,

    lcp(c) = (1/|Q|) * #{ i : min_j || T_c q_i - p_j ||^2 <= delta^2 },

where the min-distance core is kernel K1 (``kernels/lcp.py``), in its
grid-pruned form ``lcp_min_d2_within``: it returns the min only where it
is within epsilon, which is all the hit test reads. The threshold and
mean stay outside the kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.lcp import lcp_min_d2_within

# Q-side padding sentinel: rows with |x| >= Q_PAD are excluded from the
# LCP denominator, so a padded cloud's LCP equals its unpadded LCP
# exactly (the JAX package's batched registration pads ragged Q clouds
# with it).
Q_PAD = 1.0e17


def q_valid_mask(q_pos):
    """(Nq,) bool — False on Q_PAD padding rows."""
    return q_pos[:, 0].abs() < Q_PAD


def _masked_lcp_mean(hits, q_pos):
    """Fraction of hits over *real* Q rows: ``hits`` (..., Nq) bool."""
    qm = q_valid_mask(q_pos)
    denom = torch.clamp(qm.sum(dtype=torch.float32), min=1.0)
    return (hits & qm).sum(dim=-1, dtype=torch.float32) / denom


def lcp_scores(transforms, q_pos, p_pos, epsilon):
    """(C,) float32 LCP fractions of ``transforms`` (C, 4, 4) mapping
    the centered Q samples onto the centered P samples; a query counts
    when its nearest P point lies within ``epsilon`` (options.delta,
    ref:cc:517)."""
    d2 = lcp_min_d2_within(transforms, q_pos, p_pos, epsilon)
    eps2 = float(np.float32(epsilon) * np.float32(epsilon))
    return _masked_lcp_mean(d2 <= eps2, q_pos)


def lcp_score_single(transform, q_pos, p_pos, epsilon):
    """Scalar form (the reference's initial ``Verify(identity)``,
    ref:match4pcsBase.hpp:201)."""
    return lcp_scores(transform[None], q_pos, p_pos, epsilon)[0]


def _top_k(x, k: int):
    """Indices of the ``k`` largest values, descending, ties toward the
    lower index (the order ``jax.lax.top_k`` gives; ``torch.topk``
    promises no tie order, and dead slots all tie at -1)."""
    return torch.sort(x, descending=True, stable=True).indices[:k]


def lcp_scores_two_stage(transforms, q_pos, p_pos, epsilon,
                         coarse_q: int = 64, coarse_p: int = 2048,
                         top_k: int = 2048, live=None):
    """Two-stage LCP: coarse rank on subsampled clouds, exact score for
    the ``top_k`` survivors (with a mid-resolution stage above
    nq = 1024 that keeps the best 64).

    The batched analog of the reference Verify's early exit
    (ref:match4pcsBase.cc:520-558). ``live`` masks dead buffer slots to
    -1 before each selection, so they cannot flood it.

    Returns (scores, scored_idx): exact scores and their indices into
    ``transforms``; non-selected candidates are not scored.
    """
    c = transforms.shape[0]
    if c <= top_k:
        return (lcp_scores(transforms, q_pos, p_pos, epsilon),
                torch.arange(c, device=transforms.device))

    sq = max(1, -(-q_pos.shape[0] // coarse_q))
    sp = max(1, -(-p_pos.shape[0] // coarse_p))
    coarse = lcp_scores(transforms, q_pos[::sq], p_pos[::sp], epsilon)
    if live is not None:
        coarse = torch.where(live, coarse, -1.0)
    idx = _top_k(coarse, top_k)

    if q_pos.shape[0] > 1024:
        mq = max(1, -(-q_pos.shape[0] // 512))
        mp = max(1, -(-p_pos.shape[0] // 8192))
        mid = lcp_scores(transforms[idx], q_pos[::mq], p_pos[::mp],
                         epsilon)
        if live is not None:
            mid = torch.where(live[idx], mid, -1.0)
        idx = idx[_top_k(mid, min(64, top_k))]

    exact = lcp_scores(transforms[idx], q_pos, p_pos, epsilon)
    return exact, idx
