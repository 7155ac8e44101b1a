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

Every function takes one cloud pair, or G pairs at once (the JAX
package's pairs-axis ``vmap``): ``transforms`` (G, C, 4, 4), ``q_pos``
(G, nq, 3), ``p_pos`` (G, np, 3), one K1 launch for all of them, each
pair's scores and selections its own. P's cell indexes come from a
:class:`VerifyIndex`, built once per run.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.lcp import build_index, lcp_min_d2_within, pair_tests

# Q-side padding sentinel: rows with |x| >= Q_PAD are excluded from the
# LCP denominator, so a padded cloud's LCP equals its unpadded LCP
# exactly (the JAX package's batched registration pads ragged Q clouds
# with it).
Q_PAD = 1.0e17


class VerifyIndex:
    """The cell indexes of one run's P (np, 3) or (G, np, 3) for the
    verify's stage views (``p[..., ::stride, :]``) and radii, each built
    at its first use and kept: within a run P is fixed, so the verify
    never rebuilds one (a new radius, as after an escalation, builds its
    own). ``builds`` counts the indexes built."""

    def __init__(self, p_pos):
        self.p_pos = p_pos if p_pos.ndim == 3 else p_pos[None]
        self._cache = {}
        self.builds = 0

    def get(self, stride: int, eps):
        key = (int(stride), float(np.float32(eps)))
        if key not in self._cache:
            self._cache[key] = build_index(
                self.p_pos[:, ::stride], eps)
            self.builds += 1
        return self._cache[key]


def _stage_index(index, stride: int, eps):
    return None if index is None else index.get(stride, eps)


def q_valid_mask(q_pos):
    """(..., Nq) bool — False on Q_PAD padding rows."""
    return q_pos[..., 0].abs() < Q_PAD


def _masked_lcp_mean(hits, q_pos):
    """Fraction of hits over *real* Q rows: ``hits`` (..., Nq) bool, per
    pair with the pairs axis (``q_pos`` (G, Nq, 3), ``hits`` (G, C,
    Nq)): each pair's own count of real rows is its denominator."""
    qm = q_valid_mask(q_pos)
    denom = torch.clamp(qm.sum(dim=-1, dtype=torch.float32), min=1.0)
    if q_pos.ndim == 3:
        qm, denom = qm[:, None, :], denom[:, None]
    return (hits & qm).sum(dim=-1, dtype=torch.float32) / denom


def lcp_scores(transforms, q_pos, p_pos, epsilon, index=None,
               stages=None):
    """(C,) float32 LCP fractions of ``transforms`` (C, 4, 4) mapping
    the centered Q samples onto the centered P samples ((G, C) for G
    pairs); a query counts when its nearest P point lies within
    ``epsilon`` (options.delta, ref:cc:517). ``index``: P's cell index
    for ``epsilon`` (``VerifyIndex.get``), or None to build it here.
    ``stages``: a list to which the K1 launch's inputs are appended
    (see :func:`stage_tests`), or None."""
    if stages is not None:
        stages.append((transforms, q_pos, p_pos, epsilon, index))
    d2 = lcp_min_d2_within(transforms, q_pos, p_pos, epsilon, index)
    eps2 = float(np.float32(epsilon) * np.float32(epsilon))
    return _masked_lcp_mean(d2 <= eps2, q_pos)


def stage_tests(stages) -> list:
    """``(G, C, nq, np, pair tests)`` of each K1 launch recorded by
    ``lcp_scores(..., stages=)``: its shape and the pair tests the
    pruned kernel makes (``kernels.lcp.pair_tests``), for the step's
    cost model."""
    out = []
    for tr, q, p, eps, index in stages:
        g = 1 if q.ndim == 2 else q.shape[0]
        out.append((g, tr.shape[-3], q.shape[-2], p.shape[-2],
                    pair_tests(tr, q, p, eps, index)))
    return out


def lcp_score_single(transform, q_pos, p_pos, epsilon, index=None):
    """Scalar form (the reference's initial ``Verify(identity)``,
    ref:match4pcsBase.hpp:201)."""
    return lcp_scores(transform[None], q_pos, p_pos, epsilon, index)[0]


def _top_k(x, k: int):
    """Indices of the ``k`` largest values along the last axis,
    descending, ties toward the lower index (the order
    ``jax.lax.top_k`` gives; ``torch.topk`` promises no tie order, and
    dead slots all tie at -1)."""
    return torch.sort(x, dim=-1, descending=True, stable=True) \
        .indices[..., :k]


def _rows(x, idx):
    """``x[idx]``, per pair with the pairs axis (``x`` (G, C, ...),
    ``idx`` (G, K))."""
    if idx.ndim == 1:
        return x[idx]
    return x[torch.arange(idx.shape[0], device=idx.device)[:, None], idx]


def two_stage_strides(c: int, nq: int, np_: int, coarse_q: int = 64,
                      coarse_p: int = 2048, top_k: int = 2048) -> list:
    """The strides of P's stage views (``p[..., ::stride, :]``) that
    :func:`lcp_scores_two_stage` verifies ``c`` candidates against, in
    the order it reads their indexes."""
    if c <= top_k:
        return [1]
    sp = max(1, -(-np_ // coarse_p))
    mid = [max(1, -(-np_ // 8192))] if nq > 1024 else []
    return [sp, *mid, 1]


def lcp_scores_two_stage(transforms, q_pos, p_pos, epsilon,
                         coarse_q: int = 64, coarse_p: int = 2048,
                         top_k: int = 2048, live=None,
                         index: VerifyIndex | None = None, stages=None):
    """Two-stage LCP: coarse rank on subsampled clouds, exact score for
    the ``top_k`` survivors (with a mid-resolution stage above
    nq = 1024 that keeps the best 64).

    The batched analog of the reference Verify's early exit
    (ref:match4pcsBase.cc:520-558). ``live`` masks dead buffer slots to
    -1 before each selection, so they cannot flood it. With the pairs
    axis each pair selects its own survivors, and each stage is one
    verify launch for all pairs. ``index``: the run's
    :class:`VerifyIndex` of ``p_pos`` (None builds each stage's index
    on its call). ``stages``: as in :func:`lcp_scores`.

    Returns (scores, scored_idx): exact scores and their indices into
    ``transforms`` (per pair: (G, k) each); non-selected candidates are
    not scored.
    """
    c = transforms.shape[-3]
    nq, np_ = q_pos.shape[-2], p_pos.shape[-2]
    strides = two_stage_strides(c, nq, np_, coarse_q, coarse_p, top_k)
    if len(strides) == 1:
        idx = torch.arange(c, device=transforms.device)
        if transforms.ndim == 4:
            idx = idx.expand(transforms.shape[0], c)
        return (lcp_scores(transforms, q_pos, p_pos, epsilon,
                           _stage_index(index, 1, epsilon), stages), idx)

    sq = max(1, -(-nq // coarse_q))
    sp = strides[0]
    coarse = lcp_scores(transforms, q_pos[..., ::sq, :],
                        p_pos[..., ::sp, :], epsilon,
                        _stage_index(index, sp, epsilon), stages)
    if live is not None:
        coarse = torch.where(live, coarse, -1.0)
    idx = _top_k(coarse, top_k)

    if nq > 1024:
        mq = max(1, -(-nq // 512))
        mp = strides[1]
        mid = lcp_scores(_rows(transforms, idx), q_pos[..., ::mq, :],
                         p_pos[..., ::mp, :], epsilon,
                         _stage_index(index, mp, epsilon), stages)
        if live is not None:
            mid = torch.where(_rows(live, idx), mid, -1.0)
        idx = _rows(idx, _top_k(mid, min(64, top_k)))

    exact = lcp_scores(_rows(transforms, idx), q_pos, p_pos, epsilon,
                       _stage_index(index, 1, epsilon), stages)
    return exact, idx
