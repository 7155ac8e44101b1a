"""Inputs of the grid-pruned verify's tests (``lcp_min_d2_within``),
shared by the CPU tests and the card's. Numpy only: the card's tests
run without jax."""

import numpy as np

from super4pcs_tpu_torch.ops.lcp import Q_PAD

#: the cases of :func:`case`
NAMES = ["random", "at_eps", "at_eps_inexact", "q_pad", "nan_transform",
         "empty_p", "eps_above_extent"]


def transforms(rng, c, max_shift=0.05):
    """(c, 4, 4) float32 random rotations with shifts up to
    ``max_shift``."""
    out = np.tile(np.eye(4, dtype=np.float32), (c, 1, 1))
    for i in range(c):
        qm, r = np.linalg.qr(rng.normal(size=(3, 3)))
        out[i, :3, :3] = qm * np.sign(np.diag(r))
        out[i, :3, 3] = rng.uniform(-max_shift, max_shift, 3)
    return out


def shifts(offsets):
    """Identity rotations translated by each row of ``offsets``."""
    out = np.tile(np.eye(4, dtype=np.float32), (len(offsets), 1, 1))
    out[:, :3, 3] = offsets
    return out


def near_cloud(rng, n, m, noise):
    """(P (n, 3), Q (m, 3)): Q is P's first m points plus noise."""
    p = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    q = (p[:m] + rng.normal(scale=noise, size=(m, 3))).astype(np.float32)
    return p, q


def case(name):
    """(transforms, q, p, eps) of one named case, as numpy."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "random":
        p, q = near_cloud(rng, 3000, 400, 0.01)
        return transforms(rng, 6), q, p, 0.03
    if name in ("at_eps", "at_eps_inexact"):
        # P on a lattice of step eps from lo = -1: every point sits on a
        # cell boundary; each query is a P point moved by +-eps along one
        # axis, so its nearest d^2 is eps^2 (exactly for eps = 0.25,
        # within rounding of it for eps = 0.1)
        eps = 0.25 if name == "at_eps" else 0.1
        ax = np.arange(-1.0, 1.0 + eps / 2, eps, dtype=np.float32)
        p = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"),
                     -1).reshape(-1, 3).astype(np.float32)
        q = p[rng.choice(len(p), 200, replace=False)]
        off = np.concatenate([np.eye(3), -np.eye(3)]).astype(np.float32)
        return shifts(eps * off), q, p, eps
    if name == "q_pad":
        p, q = near_cloud(rng, 2000, 300, 0.01)
        q[::5] = Q_PAD
        q[1, 2] = -2.0e17
        return transforms(rng, 4), q, p, 0.03
    if name == "nan_transform":
        p, q = near_cloud(rng, 2000, 300, 0.01)
        tr = transforms(rng, 4)
        tr[1, 0, 0] = np.nan
        tr[2, 2, 3] = np.inf
        return tr, q, p, 0.03
    if name == "empty_p":
        _, q = near_cloud(rng, 100, 50, 0.01)
        return transforms(rng, 3), q, np.zeros((0, 3), np.float32), 0.03
    if name == "eps_above_extent":
        p = rng.uniform(-0.1, 0.1, (500, 3)).astype(np.float32)
        q = rng.uniform(-0.3, 0.3, (200, 3)).astype(np.float32)
        return transforms(rng, 5), q, p, 0.5
    raise KeyError(name)
