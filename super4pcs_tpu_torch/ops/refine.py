"""Rigid/similarity-transform refinement (trimmed point-to-point ICP).

PyTorch counterpart of ``super4pcs_tpu.ops.refine``: a quality stage
the reference does not have. A few trimmed-ICP iterations on the sampled
clouds close the gap between RANSAC's 4-point fit and the achievable
LCP; the caller keeps the refined pose only when its LCP does not drop.
The weighted Kabsch fit is a 3x3 SVD with the reflection repaired; in
similarity mode it is the Umeyama fit on the same SVD.

Nearest neighbours: only a query whose d^2 is within the iteration's
trim radius carries weight, and one of zero weight adds nothing, so
the loop needs the nearest point within the largest trim radius
(:func:`trim_radius`). On the card that is one launch an iteration of
a walk over P's cell index at that radius
(``kernels/lcp.py::nearest_within``; a span table counter
``refine_walks``). On the CPU the loop keeps the JAX package's rule:
the argmin over all of P under the |a|^2 + |b|^2 - 2ab expansion, its
distance recomputed exactly (:func:`_nearest`). The two agree but where
two points are within rounding of equally near.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.lcp import grid_index, nearest_within
from ..utils import profiling


def _nearest(tq, p_pos, p_block: int = 4096):
    """argmin_j ||tq_i - p_j||^2 -> (idx (N,), d2 (N,)); exact d2.
    Ties keep the lower index."""
    n = tq.shape[0]
    tq_sq = (tq * tq).sum(-1)
    best_d2 = torch.full((n,), float("inf"), dtype=torch.float32,
                         device=tq.device)
    best_i = torch.zeros(n, dtype=torch.int64, device=tq.device)
    for p0 in range(0, p_pos.shape[0], p_block):
        pb = p_pos[p0:p0 + p_block]
        d2 = tq_sq[:, None] + (pb * pb).sum(-1)[None, :] - 2.0 * (tq @ pb.T)
        mn, arg = d2.min(dim=1)
        better = mn < best_d2
        best_d2 = torch.where(better, mn, best_d2)
        best_i = torch.where(better, arg + p0, best_i)
    diff = tq - p_pos[best_i]
    return best_i, (diff * diff).sum(-1)


def _radii(delta, iters: int, start_factor: float) -> np.ndarray:
    """(iters,) float32 trim radii, annealing geometrically from ``2 *
    delta * start_factor`` down to ``2 * delta``."""
    base = 2.0 * np.float32(delta)
    if iters > 1:
        sched = np.float32(start_factor) ** (
            np.float32(1.0) - np.arange(iters, dtype=np.float32)
            / np.float32(iters - 1))
    else:
        sched = np.ones((iters,), np.float32)
    return base * sched


def trim_radius(delta, iters: int = 8, start_factor: float = 1.0) -> float:
    """The largest trim radius of a refine, ``2 * delta * max(1,
    start_factor)`` in float32: the radius of the cell index of P that
    its walk reads on the card."""
    radii = _radii(delta, iters, start_factor)
    return float(np.max(radii, initial=2.0 * np.float32(delta)))


def walks(device) -> bool:
    """Whether a refine on ``device`` takes its neighbours from the walk
    of P's cell index (the card) rather than the brute force (the CPU):
    callers build the index only where it is read."""
    return torch.device(device).type == "cuda"


def _brute(q_pos, p_pos):
    """The neighbour step of the CPU: ``nearest(mat) -> (targets (nq,
    3), d2 (nq,))`` by :func:`_nearest` over all of P."""
    def nearest(mat):
        idx, d2 = _nearest(q_pos @ mat[:3, :3].T + mat[:3, 3], p_pos)
        return p_pos[idx], d2
    return nearest


def _walk(q_pos, p_pos, radius: float, index):
    """The neighbour step of the card: the nearest point within
    ``radius`` from a walk of P's cell ``index`` at that radius (built
    here when None), ``(0, 0, 0)`` and ``+inf`` where there is none."""
    if index is None:
        index = grid_index(p_pos, radius)

    def nearest(mat):
        out = nearest_within(mat, q_pos, p_pos, radius, index)
        profiling.count("refine_walks", 1)
        return out[:, :3], out[:, 3]
    return nearest


def refine_transform(transform, q_pos, p_pos, delta, iters: int = 8,
                     start_factor: float = 1.0,
                     estimate_scale: bool = False, index=None):
    """Trimmed ICP from ``transform`` (centered-Q -> centered-P frame).

    Correspondences within the trim radius get weight 1; the weighted
    Kabsch fit updates the pose each iteration. With ``estimate_scale``
    the fit is Umeyama's similarity instead: scale
    ``c = trace(diag(1, 1, d) S) / sum w ||q - mu_q||^2`` from the same
    SVD, re-estimated from the original ``q_pos`` each iteration (1
    where the weighted variance is <= 1e-20). The radius anneals
    geometrically from ``2 * delta * start_factor`` down to
    ``2 * delta`` (constant at ``start_factor`` 1.0).

    ``index``: P's cell index at :func:`trim_radius`, one cloud's
    ``(pts, keys, grid)`` (``kernels/lcp.py::grid_index``), which the
    neighbour step reads on the card (:func:`walks`); built on this call
    when None there, and not read elsewhere. The input's device picks
    the neighbour step (see the module doc).

    Returns the refined (4, 4) transform; callers re-verify LCP and keep
    the better of the two.
    """
    radii = _radii(delta, iters, start_factor)
    if walks(q_pos.device):
        nearest = _walk(q_pos, p_pos, trim_radius(delta, iters,
                                                  start_factor), index)
    else:
        nearest = _brute(q_pos, p_pos)
    return _icp(transform, q_pos, radii, nearest, estimate_scale)


def _icp(transform, q_pos, radii, nearest, estimate_scale: bool = False):
    """The loop of :func:`refine_transform` over the trim ``radii``, its
    neighbours from ``nearest(mat) -> (targets (nq, 3), d2 (nq,))``."""
    dev = q_pos.device
    thr2 = torch.as_tensor(radii ** 2, device=dev)
    mat = transform.to(torch.float32)
    eye = torch.eye(3, dtype=torch.float32, device=dev)
    for i in range(len(radii)):
        tgt, d2 = nearest(mat)
        w = (d2 <= thr2[i]).to(torch.float32)
        wsum = torch.clamp(w.sum(), min=1.0)
        mu_q = (q_pos * w[:, None]).sum(0) / wsum
        mu_p = (tgt * w[:, None]).sum(0) / wsum
        qc = (q_pos - mu_q) * w[:, None]
        pc = tgt - mu_p
        h = qc.T @ pc                                  # (3, 3)
        u, s, vt = torch.linalg.svd(h)
        d = torch.sign(torch.linalg.det(vt.T @ u.T))
        diag = eye.clone()
        diag[2, 2] = d
        rot = vt.T @ diag @ u.T
        if estimate_scale:
            var_q = (qc * (q_pos - mu_q)).sum()
            c = torch.where(var_q > 1e-20,
                            (s[0] + s[1] + d * s[2])
                            / torch.clamp(var_q, min=1e-20),
                            torch.ones_like(var_q))
            rot = c * rot
        t = mu_p - rot @ mu_q
        mat = torch.eye(4, dtype=torch.float32, device=dev)
        mat[:3, :3] = rot
        mat[:3, 3] = t
    return mat
