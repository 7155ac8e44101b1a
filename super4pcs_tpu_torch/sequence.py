"""Multi-scan sequence registration of the PyTorch port — the
Stanford-repository protocol.

The port's copy of ``super4pcs_tpu.sequence``, the rebuild of the
reference's real-data integration harness (ref:tests/matching.cc:137-202
conf parsing, :204-348 merged-set protocol): scans listed in a Stanford
``.conf`` file are registered incrementally, each scan j matched against
the union of all previous scans placed by their ground-truth poses
(GT-inverse-transformed), so per-pair matching quality is tested without
accumulating estimation error. Without ground truth the merged set is
built from the *estimated* poses instead (the guarded trimmed-ICP
refinement keeps per-pair error small).

Conf format (Stanford 3D scanning repository):

    bmesh <file> tx ty tz qx qy qz qw

Every ``bmesh`` line yields the transform the reference builds at
matching.cc:183-193: ``T = Rotate(q) @ Translate(-t)`` with the
quaternion normalized and w the LAST token.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence, Union

import numpy as np

from .cloud import PointCloud
from .io import read_object
from .matcher import Match4PCS, MatchSuper4PCS, RegistrationResult
from .options import Options
from .utils import Logger


def _quat_to_rot(w, x, y, z):
    """Rotation matrix of a normalized quaternion (w, x, y, z)."""
    n = np.sqrt(w * w + x * x + y * y + z * z)
    if n == 0:
        raise ValueError("zero quaternion in conf file")
    w, x, y, z = w / n, x / n, y / n, z / n
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], dtype=np.float64)


def parse_stanford_conf(path: str):
    """Parse a Stanford ``.conf`` file.

    Returns (files, transforms): absolute scan paths and their (4, 4)
    float32 ground-truth transforms, in file order. Mirrors
    ref:tests/matching.cc:137-202: only 9-token ``bmesh`` lines count;
    tokens are file, translation (3), quaternion x y z w; the transform
    is rotate-then-translate(-t), i.e. ``T(p) = R (p - t)``.
    """
    base = os.path.dirname(os.path.abspath(path))
    files: List[str] = []
    transforms: List[np.ndarray] = []
    with open(path, "r") as fh:
        for line in fh:
            tokens = line.split()
            if len(tokens) != 9 or tokens[0] != "bmesh":
                continue
            fname = os.path.join(base, tokens[1])
            tr = np.asarray([float(t) for t in tokens[2:5]], np.float64)
            qx, qy, qz, qw = (float(t) for t in tokens[5:9])
            rot = _quat_to_rot(qw, qx, qy, qz)
            mat = np.eye(4, dtype=np.float64)
            mat[:3, :3] = rot
            mat[:3, 3] = -rot @ tr          # rotate() then translate(-tr)
            files.append(fname)
            transforms.append(mat.astype(np.float32))
    return files, transforms


def reference_pose_diff(est: np.ndarray, gt: np.ndarray):
    """The reference's pose-comparison metrics (ref:matching.cc:315-330):

    - rotDiff: sum of |abs-differences| of quaternion components (both
      quaternions taken component-wise absolute, so the metric is
      insensitive to quaternion sign AND to transform inversion);
    - trDiff: |dot(t_est, t_gt)| — a reference quirk (meaningful only
      for the small GT translations of the Stanford sequences), kept
      verbatim because the published thresholds (0.2 / 0.1) are defined
      against it.

    Returns (rot_diff, tr_diff).
    """
    def quat_abs(m):
        r = m[:3, :3].astype(np.float64)
        t = np.trace(r)
        if t > 0:
            s = np.sqrt(t + 1.0) * 2
            q = np.array([0.25 * s, (r[2, 1] - r[1, 2]) / s,
                          (r[0, 2] - r[2, 0]) / s,
                          (r[1, 0] - r[0, 1]) / s])
        else:
            i = int(np.argmax(np.diag(r)))
            j, k = (i + 1) % 3, (i + 2) % 3
            s = np.sqrt(max(r[i, i] - r[j, j] - r[k, k] + 1.0, 1e-12)) * 2
            q = np.zeros(4)
            q[0] = (r[k, j] - r[j, k]) / s
            q[i + 1] = 0.25 * s
            q[j + 1] = (r[j, i] + r[i, j]) / s
            q[k + 1] = (r[k, i] + r[i, k]) / s
        return np.abs(q / np.linalg.norm(q))

    qa, qb = quat_abs(est), quat_abs(gt)
    rot_diff = float(np.abs(qa - qb).sum())
    tr_diff = float(abs(np.dot(est[:3, 3].astype(np.float64),
                               gt[:3, 3].astype(np.float64))))
    return rot_diff, tr_diff


@dataclasses.dataclass
class SequenceStepResult:
    """Outcome of one incremental step (scan ``index`` vs the merged
    union of scans 0..index-1)."""
    index: int
    result: RegistrationResult
    #: estimated transform mapping scan ``index`` into the merged frame
    transform: np.ndarray
    #: reference-metric diffs vs ground truth (None without GT)
    rot_diff: Optional[float] = None
    tr_diff: Optional[float] = None


def _as_cloud(scan) -> PointCloud:
    if isinstance(scan, PointCloud):
        return scan
    cloud, _mesh = read_object(str(scan))
    return cloud


def _merge(a: Optional[PointCloud], b: PointCloud) -> PointCloud:
    if a is None:
        return b
    normal = None
    if a.normal is not None and b.normal is not None:
        normal = np.concatenate([a.normal, b.normal])
    rgb = None
    if a.rgb is not None and b.rgb is not None:
        rgb = np.concatenate([a.rgb, b.rgb])
    return PointCloud(pos=np.concatenate([a.pos, b.pos]),
                      normal=normal, rgb=rgb)


def register_sequence(
    scans: Sequence[Union[PointCloud, str]],
    options: Optional[Options] = None,
    gt_transforms: Optional[Sequence[np.ndarray]] = None,
    algorithm: str = "super4pcs",
    logger: Optional[Logger] = None,
    mesh=None,
    device="cuda",
) -> List[SequenceStepResult]:
    """Incrementally register a scan sequence against the growing merged
    set (the reference integration-test protocol,
    ref:tests/matching.cc:236-279 and :381-388).

    Args:
      scans: point clouds or file paths, in sequence order.
      gt_transforms: optional per-scan ground-truth transforms (e.g.
        from :func:`parse_stanford_conf`). When given, scan j-1 enters
        the merged set GT-inverse-transformed (no error accumulation,
        reference semantics) and each step reports the reference
        rot/tr diffs. Without GT, the *estimated* transform places each
        scan — the practical odometry mode.
      options / algorithm / mesh: forwarded to the matcher per step.
      device: where each step's registration runs ("cuda" by default;
        "cpu" runs the kernels' plain versions).

    Returns one :class:`SequenceStepResult` per step j = 1..len-1.
    """
    opts = options or Options()
    cls = {"super4pcs": MatchSuper4PCS, "4pcs": Match4PCS}.get(algorithm)
    if cls is None:
        raise ValueError(f"unknown algorithm {algorithm!r}; "
                         "expected 'super4pcs' or '4pcs'")
    clouds = [_as_cloud(s) for s in scans]
    if gt_transforms is not None and len(gt_transforms) != len(clouds):
        raise ValueError("gt_transforms must match scans 1:1")

    merged: Optional[PointCloud] = None
    results: List[SequenceStepResult] = []
    prev_est = np.eye(4, dtype=np.float32)
    for j in range(1, len(clouds)):
        prev = clouds[j - 1]
        if gt_transforms is not None:
            place = np.linalg.inv(gt_transforms[j - 1].astype(np.float64))
        else:
            place = prev_est.astype(np.float64)
        merged = _merge(merged, prev.transformed(place.astype(np.float32)))

        matcher = cls(opts, logger=logger, device=device, mesh=mesh)
        res = matcher.compute_transformation(merged, clouds[j])
        rot_diff = tr_diff = None
        if gt_transforms is not None:
            rot_diff, tr_diff = reference_pose_diff(
                res.transform, gt_transforms[j])
        prev_est = res.transform
        results.append(SequenceStepResult(
            index=j, result=res, transform=res.transform,
            rot_diff=rot_diff, tr_diff=tr_diff))
    return results
