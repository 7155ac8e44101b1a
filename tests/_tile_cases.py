"""Inputs of the tiled brute force's tests (``lcp_min_d2`` and its index
``tile_index``), shared by the CPU tests and the card's. Numpy and torch
only: the card's tests run without jax."""

import numpy as np
import torch

from super4pcs_tpu_torch.ops.lcp import Q_PAD
from super4pcs_tpu_torch.ops.sampling import kd_argsort

#: the cases of :func:`case`
NAMES = ["sphere", "random", "faces", "equidistant", "np_1", "np_31",
         "np_32", "np_33", "np_1025", "q_pad", "nonfinite", "wide",
         "no_candidates", "no_queries", "empty_p"]


def transforms(rng, c, max_shift=0.2):
    """(c, 4, 4) float32 random rotations with shifts up to
    ``max_shift`` (the card tests' ``_transforms``)."""
    out = np.tile(np.eye(4, dtype=np.float32), (c, 1, 1))
    for i in range(c):
        qm, r = np.linalg.qr(rng.normal(size=(3, 3)))
        out[i, :3, :3] = qm * np.sign(np.diag(r))
        out[i, :3, 3] = rng.uniform(-max_shift, max_shift, 3)
    return out


def near_identity(rng, c, max_angle=0.05, max_shift=0.02):
    """(c, 4, 4) float32 small rigid motions: near-true poses."""
    out = np.tile(np.eye(4, dtype=np.float32), (c, 1, 1))
    for i in range(c):
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                      [-axis[1], axis[0], 0]])
        ang = rng.uniform(0.0, max_angle)
        out[i, :3, :3] = (np.eye(3) + np.sin(ang) * k
                          + (1 - np.cos(ang)) * k @ k)
        out[i, :3, 3] = rng.uniform(-max_shift, max_shift, 3)
    return out


def shifts(offsets):
    """Identity rotations translated by each row of ``offsets``."""
    out = np.tile(np.eye(4, dtype=np.float32), (len(offsets), 1, 1))
    out[:, :3, 3] = offsets
    return out


def kd_sphere(rng, n):
    """A bumpy sphere of ``n`` points in kd order (the matcher's Q
    order)."""
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    pos = (v * (1 + 0.2 * np.sin(4 * v[:, :1]))).astype(np.float32)
    return pos[kd_argsort(pos)]


def case(name):
    """(transforms, q, p) of one named case, as numpy float32."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "sphere":
        # kd-ordered samples of one surface under near-true poses
        return near_identity(rng, 6), kd_sphere(rng, 600), kd_sphere(
            rng, 3000)
    if name == "random":
        p = rng.uniform(-1, 1, (2000, 3)).astype(np.float32)
        q = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
        return transforms(rng, 5), q, p
    if name == "faces":
        # a lattice (every tile's and group's box has points on its
        # faces), 200 of its points twice; queries on the lattice (d2 0),
        # and moved by half a step (on the planes between cells)
        ax = np.arange(-1.0, 1.0 + 1e-6, 0.25, dtype=np.float32)
        lat = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"),
                       -1).reshape(-1, 3).astype(np.float32)
        p = np.concatenate([lat, lat[rng.choice(len(lat), 200)]])
        q = lat[rng.choice(len(lat), 256, replace=False)]
        off = np.array([[0, 0, 0], [0.125, 0, 0], [0, 0.125, -0.125],
                        [0.125, 0.125, 0.125]], np.float32)
        return shifts(off), q, p
    if name == "equidistant":
        # P and its mirror image across x = 0 (far apart, so in different
        # tiles); queries on the plane x = 0 are exactly as far from a
        # point as from its mirror
        half = rng.uniform([0.5, -1, -1], [1, 1, 1], (700, 3)).astype(
            np.float32)
        p = np.concatenate([half, half * np.float32([-1, 1, 1])])
        q = np.concatenate([np.zeros((200, 1), np.float32),
                            rng.uniform(-1, 1, (200, 2)).astype(np.float32)],
                           1)
        q[:50, 1:] = half[:50, 1:]       # mirror pairs at equal distance
        return shifts(np.zeros((2, 3), np.float32)), q, p
    if name.startswith("np_"):
        n = int(name[3:])
        p = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
        q = rng.uniform(-1.2, 1.2, (97, 3)).astype(np.float32)
        return transforms(rng, 3), q, p
    if name == "q_pad":
        p = kd_sphere(rng, 2000)
        q = kd_sphere(rng, 300)
        q[::5] = Q_PAD
        q[1, 2] = -2.0e17
        return near_identity(rng, 4), q, p
    if name == "nonfinite":
        p = kd_sphere(rng, 2000)
        tr = near_identity(rng, 5)
        tr[1, 0, 0] = np.nan
        tr[2, 2, 3] = np.inf
        tr[3, 1, 3] = -np.inf
        return tr, kd_sphere(rng, 300), p
    if name == "wide":
        # 1200 queries: the kernel's slots run over the queries (over the
        # candidates below 1024), with Q_PAD rows and non-finite
        # transforms among them
        p = kd_sphere(rng, 3000)
        q = kd_sphere(rng, 1200)
        q[::7] = Q_PAD
        tr = near_identity(rng, 3)
        tr[1, 2, 2] = np.nan
        tr[2, 0, 3] = -np.inf
        return tr, q, p
    if name == "no_candidates":
        return (np.zeros((0, 4, 4), np.float32), kd_sphere(rng, 50),
                kd_sphere(rng, 100))
    if name == "no_queries":
        return transforms(rng, 3), np.zeros((0, 3), np.float32), kd_sphere(
            rng, 100)
    if name == "empty_p":
        return transforms(rng, 3), kd_sphere(rng, 50), np.zeros(
            (0, 3), np.float32)
    raise KeyError(name)


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal shapes, NaN at the same entries, and the same float32 bits
    everywhere else (two NaNs may differ in sign and payload)."""
    if a.shape != b.shape:
        return False
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(
        a[~na].view(torch.int32), b[~nb].view(torch.int32))
