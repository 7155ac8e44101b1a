"""Plain reference of what a registration reports: its samples, its
LCP score at a transform, and the pose error against the drawn pose.

It imports nothing of the program. The score a registration reports is
the largest common pointset (LCP) of its samples: the share of the
source's samples that a transform brings within ``delta`` of a sample
of the target. The samples follow the port's stated rule (Super4PCS's
``Match4PCSBase::init``): a cloud of at most ``sample_size`` points is
used whole; otherwise it is decimated on a voxel grid of size
``delta``, keeping the first point of each voxel in input order; the
source's decimated set, when larger than ``sample_size``, is cut to the
first ``sample_size`` of a permutation drawn from
``numpy.random.default_rng(random_seed)``. One registration draws from
its own generator; a batch of pairs draws from one generator, pair
after pair.

The LCP runs in float64 on whichever device it is given, a block of
source samples at a time. ``precision="tf32"`` computes the same
arithmetic in float32 with the matrix products' operands rounded to
TF32 (10 explicit mantissa bits, as the tensor cores take them): the
control, the precision just below the port's float32 with TF32 off.
cuBLAS runs these products (an inner size of 3) without the tensor
cores, so the rounding is made here rather than asked of it.
"""

from __future__ import annotations

import numpy as np
import torch


def voxel_first(pos: np.ndarray, voxel: float) -> np.ndarray:
    """Indices, ascending, of the first point of each occupied voxel of
    size ``voxel`` (cell ``floor(p / voxel)``, computed in float64)."""
    cells = np.floor(pos.astype(np.float64) / voxel).astype(np.int64)
    cells -= cells.min(axis=0)
    span = cells.max(axis=0) + 1
    if np.prod(span.astype(np.float64)) < 2.0 ** 62:
        key = (cells[:, 0] * span[1] + cells[:, 1]) * span[2] + cells[:, 2]
        order = np.argsort(key, kind="stable")    # input order kept
        key = key[order]
        first = np.ones(len(order), bool)
        first[1:] = key[1:] != key[:-1]
    else:
        order = np.lexsort(cells.T[::-1])
        key = cells[order]
        first = np.ones(len(order), bool)
        first[1:] = np.any(key[1:] != key[:-1], axis=1)
    return np.sort(order[first])


def sample(pos: np.ndarray, delta: float, sample_size: int, cut: bool,
           rng: np.random.Generator) -> np.ndarray:
    """The sampled points of one cloud; ``cut`` on the source side."""
    if len(pos) <= sample_size:
        return pos
    kept = pos[voxel_first(pos, delta)]
    if not cut or len(kept) <= sample_size:
        return kept
    return kept[rng.permutation(len(kept))[:sample_size]]


def samples(pairs: list, delta: float, sample_size: int,
            random_seed: int) -> list:
    """[(target samples, source samples)] of the pairs of one call drawn
    from one generator, pair after pair (one pair: a registration)."""
    rng = np.random.default_rng(random_seed)
    out = []
    for pair in pairs:
        q = sample(pair["source"], delta, sample_size, True, rng)
        out.append((sample(pair["target"], delta, sample_size, False, rng),
                    q))
    return out


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32's 10 explicit mantissa bits
    (to nearest, ties away from zero)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def lcp(transform: np.ndarray, q: np.ndarray, p: np.ndarray, delta: float,
        device="cpu", precision: str = "float64", block: int = 2048) -> float:
    """Share of ``q`` that ``transform`` (4, 4) brings within ``delta`` of
    some point of ``p``: squared distances ``|a|^2 + |b|^2 - 2 a.b``
    against ``delta^2``, the minimum over ``p`` per row."""
    if precision not in ("float64", "tf32"):
        raise ValueError(f"unknown precision {precision!r}")
    low = precision == "tf32"
    dt = torch.float32 if low else torch.float64
    mm = tf32 if low else (lambda x: x)
    t = torch.as_tensor(np.asarray(transform, np.float64), dtype=dt,
                        device=device)
    qd = torch.as_tensor(np.asarray(q), dtype=dt, device=device)
    pd = torch.as_tensor(np.asarray(p), dtype=dt, device=device)
    moved = mm(qd) @ mm(t[:3, :3]).T + t[:3, 3]
    pn = (pd * pd).sum(dim=1)
    pt = mm(pd).T
    lim = float(np.float32(delta)) ** 2
    hits = 0
    for rows in moved.split(block):
        d2 = (rows * rows).sum(dim=1, keepdim=True) + pn - 2 * (mm(rows) @ pt)
        hits += int((d2.amin(dim=1) <= lim).sum())
    return hits / max(len(q), 1)


def _quaternion(r: np.ndarray) -> np.ndarray:
    """Unit quaternion (w, x, y, z) of a rotation matrix."""
    r = np.asarray(r, np.float64)
    tr = np.trace(r)
    if tr > 0:
        s = 2.0 * np.sqrt(tr + 1.0)
        q = [0.25 * s, (r[2, 1] - r[1, 2]) / s, (r[0, 2] - r[2, 0]) / s,
             (r[1, 0] - r[0, 1]) / s]
    else:
        i = int(np.argmax(np.diag(r)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = 2.0 * np.sqrt(max(1.0 + r[i, i] - r[j, j] - r[k, k], 1e-12))
        q = np.zeros(4)
        q[0] = (r[k, j] - r[j, k]) / s
        q[1 + i] = 0.25 * s
        q[1 + j] = (r[j, i] + r[i, j]) / s
        q[1 + k] = (r[k, i] + r[i, k]) / s
    q = np.asarray(q, np.float64)
    return q / np.linalg.norm(q)


def pose_errors(est: np.ndarray, truth: np.ndarray) -> tuple:
    """(rot_diff, tr_err) of ``est`` against ``truth``, both (4, 4):
    Super4PCS's rotDiff (the summed absolute differences of the two
    rotations' quaternions, each taken component-wise absolute) and the
    distance between the two translations."""
    qa = np.abs(_quaternion(np.asarray(est)[:3, :3]))
    qb = np.abs(_quaternion(np.asarray(truth)[:3, :3]))
    tr = np.asarray(est, np.float64)[:3, 3] - np.asarray(truth)[:3, 3]
    return float(np.abs(qa - qb).sum()), float(np.linalg.norm(tr))
