"""Leica PTX range-map reader.

The port's copy of ``super4pcs_tpu.io.ptx``. Mirrors
ref:src/super4pcs/io/io.cc:83-138: first two lines are the column and
row counts, the next 8 lines are scanner/registration matrices
(skipped), then ``cols * rows`` records of ``x y z intensity [r g b]``.
Returns colors when present; the read fails (ValueError) when fewer
than ``cols * rows`` points parse, like the reference's
``vertex.size() == numOfVertices`` check.
"""

from __future__ import annotations

import numpy as np

from ..cloud import PointCloud


def read_ptx(path: str) -> PointCloud:
    with open(path, "r", errors="replace") as f:
        cols = int(f.readline().split()[0])
        rows = int(f.readline().split()[0])
        for _ in range(8):
            f.readline()
        n = cols * rows
        data = np.loadtxt(f, dtype=np.float64, max_rows=n, ndmin=2)
    if data.shape[0] != n:
        raise ValueError(
            f"(PTX) expected {n} points, parsed {data.shape[0]}")
    pos = data[:, :3].astype(np.float32)
    rgb = None
    if data.shape[1] >= 7:
        rgb = data[:, 4:7].astype(np.float32)
    return PointCloud(pos=pos, rgb=rgb)
