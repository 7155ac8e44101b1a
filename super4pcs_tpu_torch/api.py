"""Array-first registration API of the PyTorch port — the adapter
surface for third-party stacks (the analog of the reference's PCL wrapper,
ref:demos/PCLWrapper/pcl/registration/super4pcs.h:64-110, which copies
`pcl::PointCloud` into `Point3D` vectors and runs `MatchSuper4PCS`).

Anything that can produce numpy arrays (Open3D, PCL python bindings,
trimesh, raw scans) calls :func:`register` directly.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .cloud import PointCloud
from .matcher import Match4PCS, MatchSuper4PCS, RegistrationResult
from .options import Options


def register(
    target_pos: np.ndarray,
    source_pos: np.ndarray,
    *,
    target_normal: Optional[np.ndarray] = None,
    source_normal: Optional[np.ndarray] = None,
    target_rgb: Optional[np.ndarray] = None,
    source_rgb: Optional[np.ndarray] = None,
    options: Optional[Options] = None,
    overlap: Optional[float] = None,
    delta: Optional[float] = None,
    sample_size: Optional[int] = None,
    max_time_seconds: Optional[int] = None,
    algorithm: str = "super4pcs",
    visitor=None,
    mesh=None,
    device="cuda",
    **option_overrides,
) -> RegistrationResult:
    """Globally register ``source`` onto ``target``.

    Matches the reference convention: the returned transform maps the
    *source* (the reference CLI's ``input2``) onto the *target*
    (``input1``), and ``result.transformed_q`` is the moved source.

    Args:
      target_pos / source_pos: (N, 3) arrays.
      *_normal / *_rgb: optional (N, 3) attribute arrays.
      options: full Options; the keyword shortcuts below override it.
      overlap: estimated overlap fraction (reference ``-o``).
      delta: LCP distance threshold (reference ``-d``).
      sample_size: working sample count (reference ``-n``).
      max_time_seconds: anytime budget (reference ``-t``).
      algorithm: "super4pcs" (smart indexing) or "4pcs" (quadratic).
      mesh: optional mesh (``parallel.make_mesh``) — shards each
        device step's RANSAC trials across its devices
        (parallel/sharded.py); its first device takes ``device``'s
        place.
      device: where the registration runs ("cuda" by default; "cpu"
        runs the kernels' plain PyTorch versions).
      **option_overrides: any further Options field (e.g.
        ``phase_timing=True``, ``bases_per_step=32``); unknown names
        raise TypeError via dataclasses.replace.
    """
    opts = options or Options()
    if overlap is not None:
        opts = opts.configure_overlap(overlap)
    kw = dict(option_overrides)
    if delta is not None:
        kw["delta"] = float(delta)
    if sample_size is not None:
        kw["sample_size"] = int(sample_size)
    if max_time_seconds is not None:
        kw["max_time_seconds"] = int(max_time_seconds)
    if kw:
        opts = opts.replace(**kw)

    target = PointCloud(pos=np.asarray(target_pos),
                        normal=target_normal, rgb=target_rgb)
    source = PointCloud(pos=np.asarray(source_pos),
                        normal=source_normal, rgb=source_rgb)

    if algorithm == "super4pcs":
        matcher = MatchSuper4PCS(opts, device=device, mesh=mesh)
    elif algorithm == "4pcs":
        matcher = Match4PCS(opts, device=device, mesh=mesh)
    else:
        raise ValueError(f"unknown algorithm {algorithm!r}; "
                         "expected 'super4pcs' or '4pcs'")
    return matcher.compute_transformation(target, source, visitor=visitor)
