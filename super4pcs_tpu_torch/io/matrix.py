"""Transform-matrix writer (Polyworks format).

The port's copy of ``super4pcs_tpu.io.matrix``. Mirrors
``IOManager::WriteMatrix`` / ``formatPolyworksMatrix``
(ref:src/super4pcs/io/io.cc:304-326, 460-481): a ``VERSION/MATRIX``
header and four rows of six-decimal values, positives padded with a
leading space (the reference's std::to_string default formatting).
"""

from __future__ import annotations

import numpy as np

POLYWORKS = "polyworks"


def format_polyworks_matrix(mat: np.ndarray) -> str:
    mat = np.asarray(mat, dtype=np.float64)

    def fmt(v: float) -> str:
        s = f"{v:.6f}"
        return " " + s if v >= 0 else s

    lines = ["VERSION\t=\t1", "MATRIX\t="]
    for j in range(4):
        lines.append("  ".join(fmt(float(mat[j, k])) for k in range(4)))
    return "\n".join(lines) + "\n"


def write_matrix(path: str, mat: np.ndarray, mode: str = POLYWORKS) -> bool:
    """Write ``mat`` to ``path``; only the Polyworks mode exists, other
    modes return False with an empty file, as the reference's switch
    default does (ref:io.cc:313-323)."""
    with open(path, "w") as f:
        if mode != POLYWORKS:
            return False
        f.write(format_polyworks_matrix(mat))
    return True
