"""Geometry of the port: invariants, rigid fit, cloud statistics.

PyTorch counterparts of ``super4pcs_tpu.ops.geometry`` — the scalar
routines of ref:src/super4pcs/algorithms/match4pcsBase.cc as batched
tensor functions. The numpy helpers (``clean_invalid_normals``,
``estimate_diameter``) are copies.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..options import K_LARGE_NUMBER

_K_SMALL = 1e-4   # kSmallNumber, ref:match4pcsBase.cc:70

#: Similarity-mode scale-consistency gate: the two segment-length ratios
#: of a candidate quad may deviate at most this much from each other
#: (ref:match4pcsBase.cc:402 ``ratioDev > 0.1 -> reject``). The
#: congruent joins apply the same gate before their capacity compaction.
SCALE_RATIO_DEV = 0.1


def clean_invalid_normals(normal: np.ndarray) -> tuple[np.ndarray, int]:
    """Zero out degenerate normals, normalize the rest.

    Vectorized ``Utils::CleanInvalidNormals``
    (ref:src/super4pcs/utils/geometry.h:57-82): normals with
    ``|n|^2 < 0.01`` become zero (and are counted), others are unit
    normalized. Host-side numpy — runs once at load time.
    """
    sq = (normal * normal).sum(axis=1, keepdims=True)
    bad = sq < 0.01
    safe = np.where(bad, 1.0, np.sqrt(sq))
    out = np.where(bad, 0.0, normal / safe).astype(np.float32)
    return out, int(bad.sum())


def _dot(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) \
        + a[..., 2] * b[..., 2]


def dist_segment_to_segment(p1, p2, q1, q2):
    """Closest approach of two 3D segments and the two parametric
    invariants at the closest points.

    Branchless form of the clamped closest-point computation in
    ref:match4pcsBase.cc:64-131 (same kSmallNumber=1e-4 degeneracy
    gates), batched over leading dimensions.

    Returns ``(invariant1, invariant2, distance)``.
    """
    u = p2 - p1
    v = q2 - q1
    w = p1 - q1
    a = _dot(u, u)
    b = _dot(u, v)
    c = _dot(v, v)
    d = _dot(u, w)
    e = _dot(v, w)
    f = a * c - b * b
    where = torch.where
    zero = torch.zeros_like(f)

    # --- s-branch (ref:cc:87-104) ---
    parallel = f < _K_SMALL
    s1_g = b * e - c * d
    t1_g = a * e - b * d
    s_neg = s1_g < 0.0
    s_big = s1_g > f
    s1_np = where(s_neg, zero, where(s_big, f, s1_g))
    t1_np = where(s_neg, e, where(s_big, e + b, t1_g))
    t2_np = where(s_neg | s_big, c, f)
    s2_np = f

    s1 = where(parallel, zero, s1_np)
    s2 = where(parallel, torch.ones_like(f), s2_np)
    t1 = where(parallel, e, t1_np)
    t2 = where(parallel, c, t2_np)

    # --- t-branch (ref:cc:106-126) ---
    t_neg = t1 < 0.0
    t_big = t1 > t2
    nd = -d
    s1_tneg = where(nd < 0.0, zero, where(nd > a, s2, nd))
    s2_tneg = where((nd >= 0.0) & (nd <= a), a, s2)
    db = nd + b
    s1_tbig = where(db < 0.0, zero, where(db > a, s2, db))
    s2_tbig = where((db >= 0.0) & (db <= a), a, s2)

    s1 = where(t_neg, s1_tneg, where(t_big, s1_tbig, s1))
    s2 = where(t_neg, s2_tneg, where(t_big, s2_tbig, s2))
    t1 = where(t_neg, zero, where(t_big, t2, t1))

    def _safe_div(num, den):
        ok = den.abs() > 1e-30
        return where(ok, num / where(ok, den, torch.ones_like(den)), zero)

    invariant1 = where(s1.abs() < _K_SMALL, zero, _safe_div(s1, s2))
    invariant2 = where(t1.abs() < _K_SMALL, zero, _safe_div(t1, t2))

    closest = w + invariant1[..., None] * u - invariant2[..., None] * v
    dist = torch.sqrt(_dot(closest, closest))
    return invariant1, invariant2, dist


# The 12 (i, j, k, l) orderings scanned by TryQuadrilateral
# (ref:match4pcsBase.cc:231-238): all ordered (i, j) with i != j, and
# (k, l) the remaining indices in ascending order.
_QUAD_ORDERINGS = np.array(
    [(i, j, k, l)
     for i in range(4) for j in range(4) if i != j
     for k in [next(x for x in range(4) if x not in (i, j))]
     for l in [next(x for x in range(4) if x not in (i, j, k))]],
    dtype=np.int64,
)  # (12, 4)


@functools.lru_cache(maxsize=None)
def _orderings(device: torch.device) -> torch.Tensor:
    # one copy per device: a host-to-device copy synchronizes the stream
    return torch.as_tensor(_QUAD_ORDERINGS, device=device)


def try_quadrilateral(quad_pos: torch.Tensor):
    """Best pairing of 4-point bases into two segments.

    Vectorized ``TryQuadrilateral`` (ref:match4pcsBase.cc:225-274): all
    12 orderings evaluated at once, the one whose two segments pass
    closest is kept (first minimum on ties).

    Args:
      quad_pos: (..., 4, 3) base point positions.
    Returns:
      (perm (..., 4), invariant1 (...), invariant2 (...)): ``perm`` is
      the index permutation to apply to the base ids/points.
    """
    orderings = _orderings(quad_pos.device)
    pts = quad_pos[..., orderings, :]                   # (..., 12, 4, 3)
    inv1, inv2, dist = dist_segment_to_segment(
        pts[..., 0, :], pts[..., 1, :], pts[..., 2, :], pts[..., 3, :])
    best = torch.argmin(dist, dim=-1, keepdim=True)
    return (orderings[best[..., 0]],
            inv1.gather(-1, best)[..., 0], inv2.gather(-1, best)[..., 0])


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]],
                       dim=-1)


def _sum3(terms):
    """``(terms[0] + terms[1]) + terms[2]``."""
    return (terms[0] + terms[1]) + terms[2]


def batched_rigid_fit(ref_quad, cand_quads, centroid1, centroid2,
                      max_angle_rad: float, estimate_scale: bool = False):
    """Fit rigid transforms aligning each candidate quad onto its base.

    Batched ``ComputeRigidTransformation`` (ref:match4pcsBase.cc:365-500),
    closed form with no SVD: orthonormal frames from the first three
    points of each quad, R = Rp^T Rq, the same orthogonality / max-angle
    gates, and the same 3-point RMS divided by 4. With
    ``estimate_scale`` (the reference's MULTISCALE path, ref:cc:390-414)
    each candidate is scaled by the mean of its two segment-length
    ratios before the frames are built, rejected when the ratios deviate
    more than ``SCALE_RATIO_DEV`` from each other, and its linear part
    is ``scale * R``.

    Args:
      ref_quad:   (B, 4, 3) base points (centered-P frame).
      cand_quads: (B, C, 4, 3) candidate points (centered-Q frame).
      centroid1:  (B, 3) centroid of each base's first three points.
      centroid2:  (B, C, 3) centroid of each candidate's first three.
      max_angle_rad: negative disables the angle gate (ref:cc:457-472).
    Returns:
      (transform (B, C, 4, 4), rms (B, C), valid (B, C)). Invalid
      candidates get rms = kLargeNumber.
    """
    eps = 1e-6  # kSmallNumber, ref:cc:377

    if estimate_scale:
        def seg_len(a, b):
            d = a - b
            return torch.sqrt(_dot(d, d))

        r1 = seg_len(ref_quad[:, 1], ref_quad[:, 0])[:, None] / torch.clamp(
            seg_len(cand_quads[:, :, 1], cand_quads[:, :, 0]), min=1e-30)
        r2 = seg_len(ref_quad[:, 3], ref_quad[:, 2])[:, None] / torch.clamp(
            seg_len(cand_quads[:, :, 3], cand_quads[:, :, 2]), min=1e-30)
        scale_ok = ((r1 / torch.clamp(r2, min=1e-30) - 1.0).abs()
                    <= SCALE_RATIO_DEV)
        scale = 0.5 * (r1 + r2)                             # (B, C)
        cand_quads = cand_quads * scale[..., None, None]
        centroid2 = centroid2 * scale[..., None]

    def frame(p0, p1, p2):
        # exact 1/sqrt: the (R R)_ii - 1 <= 1e-6 gate below needs it
        def unit(v):
            n = _dot(v, v)
            return v / torch.sqrt(torch.clamp(n, min=1e-30))[..., None], n

        v1, n1 = unit(p1 - p0)
        v2, n2 = unit((p2 - p0) - _dot(p2 - p0, v1)[..., None] * v1)
        v3, n3 = unit(_cross(v1, v2))
        ok = (n1 > 0) & (n2 > 0) & (n3 > 0)
        return torch.stack([v1, v2, v3], dim=-2), ok   # rows: the frame

    rot_p, ok_p = frame(ref_quad[:, 0], ref_quad[:, 1], ref_quad[:, 2])
    rot_q, ok_q = frame(cand_quads[:, :, 0], cand_quads[:, :, 1],
                        cand_quads[:, :, 2])                # (B, C, 3, 3)

    # R = Rp^T Rq  (ref:cc:449). The 3-term sums of these small products
    # are written out in a fixed order, ((x0 y0 + x1 y1) + x2 y2): a
    # batched matrix product may pick its kernel, and so its rounding,
    # by the batch's size, and a trial's fit must not depend on which
    # other trials (or pairs) share its step.
    rp = rot_p[:, None]                                   # (B, 1, 3, 3)
    rotation = _sum3([rp[..., i, :, None] * rot_q[..., i, None, :]
                      for i in range(3)])                 # (B, C, 3, 3)

    # Orthogonality gate exactly as written in the reference:
    # diag(R @ R) - 1 > eps  (ref:cc:453 uses rotation*rotation).
    rr_diag = _sum3([rotation[..., :, j] * rotation[..., j, :]
                     for j in range(3)])
    ortho_ok = torch.all(rr_diag - 1.0 <= eps, dim=-1)

    # Euler-angle gate (ref:cc:457-472), active when max_angle >= 0.
    if max_angle_rad >= 0:
        r = rotation
        ang_x = torch.atan2(r[..., 2, 1], r[..., 2, 2]).abs()
        ang_y = torch.atan2(-r[..., 2, 0], torch.sqrt(
            r[..., 2, 1] ** 2 + r[..., 2, 2] ** 2)).abs()
        ang_z = torch.atan2(r[..., 1, 0], r[..., 0, 0]).abs()
        angle_ok = ((ang_x <= max_angle_rad) & (ang_y <= max_angle_rad)
                    & (ang_z <= max_angle_rad))
    else:
        angle_ok = torch.ones_like(ortho_ok)

    # RMS over the first three points (ref:cc:477-489; sum / 4).
    first = cand_quads[:, :, :3, :] - centroid2[:, :, None, :]
    transformed = _sum3([rotation[..., None, :, j] * first[..., :, j, None]
                         for j in range(3)])              # (B, C, 3, 3)
    resid = transformed - (ref_quad[:, None, :3, :]
                           - centroid1[:, None, None, :])
    rms = torch.sqrt(_dot(resid, resid)).sum(dim=-1) / 4.0

    # transform: x -> R (x - c2) + c1  (ref:cc:491-497, scale = 1)
    t = centroid1[:, None, :] - _sum3([rotation[..., j] * centroid2[..., j,
                                                                    None]
                                       for j in range(3)])
    transform = torch.zeros(rotation.shape[:2] + (4, 4),
                            dtype=rotation.dtype, device=rotation.device)
    transform[..., :3, :3] = rotation
    transform[..., :3, 3] = t
    transform[..., 3, 3] = 1.0
    valid = ok_p[:, None] & ok_q & ortho_ok & angle_ok

    if estimate_scale:
        # linear part scale * R; the translation already used the
        # scaled centroid (transform = T(c1) R S T(-c2), ref:cc:491-497)
        transform[..., :3, :3] *= scale[..., None, None]
        valid &= scale_ok
    rms = torch.where(valid, rms, torch.full_like(rms, K_LARGE_NUMBER))
    return transform, rms, valid


def transform_points(mat, pos):
    """Apply homogeneous 4x4 ``mat`` to (N, 3) positions."""
    return pos @ mat[:3, :3].T + mat[:3, 3]


def global_transform(transform, qcentroid1, qcentroid2,
                     centroid_p, centroid_q):
    """Recompose the centered-frame transform into original coordinates.

    Mirrors the getGlobalTransform lambdas
    (ref:match4pcsBase.hpp:224-229, 449-456): keep the rotation block,
    rebuild the translation as ``qc1 + cP - R (qc2 + cQ)`` (scale = 1).
    Works on numpy arrays and on tensors.
    """
    out = transform.clone() if torch.is_tensor(transform) \
        else np.array(transform)
    rot = out[..., :3, :3]
    out[..., :3, 3] = (qcentroid1 + centroid_p
                       - (rot @ (qcentroid2 + centroid_q)[..., None])[..., 0])
    return out


def estimate_diameter(pos: np.ndarray, n_trials: int,
                      rng: np.random.Generator) -> float:
    """Randomized diameter estimate: max distance over random pairs
    (ref:match4pcsBase.hpp:155-164 — note the reference draws the pairs
    from the *Q* samples; the caller decides which cloud to pass)."""
    n = pos.shape[0]
    a = rng.integers(0, n, size=n_trials)
    b = rng.integers(0, n, size=n_trials)
    d = np.linalg.norm(pos[a] - pos[b], axis=1)
    return float(d.max())
