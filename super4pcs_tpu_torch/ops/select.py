"""Base (planar 4-point) selection — the batched RANSAC front end.

PyTorch counterpart of ``super4pcs_tpu.ops.select`` (the reference's
``SelectQuadrilateral`` / ``SelectRandomTriangle``,
ref:src/super4pcs/algorithms/match4pcsBase.cc:185-351): each base draw
is one fixed-shape program returning a validity flag, batched over the
bases of a step. The random draws are inputs of :func:`select_base`, so
a test can feed it the JAX package's draws; :func:`draw_base_indices`
takes them from a ``torch.Generator``.
"""

from __future__ import annotations

import numpy as np
import torch

from .geometry import try_quadrilateral, _cross, _dot

_K_BASE_TOO_SMALL = 0.2          # ref:match4pcsBase.cc:283


def draw_base_indices(gen: torch.Generator, n: int, n_bases: int,
                      n_triangle_trials: int):
    """The random draws of ``n_bases`` base selections: ``first``
    (B,), ``seconds`` and ``thirds`` (B, n_triangle_trials), uniform
    indices into the ``n`` P samples, on the generator's device."""
    dev = gen.device
    first = torch.randint(0, n, (n_bases,), generator=gen, device=dev)
    seconds = torch.randint(0, n, (n_bases, n_triangle_trials),
                            generator=gen, device=dev)
    thirds = torch.randint(0, n, (n_bases, n_triangle_trials),
                           generator=gen, device=dev)
    return first, seconds, thirds


def _diameters(max_base_diameter, n_sets: int, dev) -> torch.Tensor:
    """(G,) float32 max base diameters on ``dev``: a number (one set),
    or one value per set (a sequence or a tensor)."""
    if torch.is_tensor(max_base_diameter):
        d = max_base_diameter.to(device=dev, dtype=torch.float32)
    elif np.ndim(max_base_diameter) == 0:
        d = torch.full((), float(np.float32(max_base_diameter)),
                       dtype=torch.float32, device=dev)
    else:
        d = torch.as_tensor(np.asarray(max_base_diameter, np.float32),
                            device=dev)
    return d.reshape(-1).expand(n_sets)


def select_base(p_pos, max_base_diameter, first, seconds, thirds):
    """Select one planar 4-point base per draw from the (centered) P
    samples, for one cloud or for G clouds at once.

    Pipeline (mirrors ref:cc:279-351):
      1. wide triangle: of the (first, seconds[t], thirds[t]) draws keep
         the widest whose two edges stay under max_base_diameter
         (ref:cc:185-218);
      2. plane fit A x + B y + C z = 1 through it (ref:cc:310-319);
      3. 4th point: the most coplanar sample not too close to the first
         three (ref:cc:323-338);
      4. best segment pairing + invariants via ``try_quadrilateral``.

    Args:
      p_pos: (Np, 3) P samples, or (G, Np, 3) for G clouds (the JAX
        package's pairs-axis vmap). max_base_diameter: a number, or (G,)
        one per cloud. first: (B,); seconds, thirds: (B,
        n_triangle_trials) int64 draws, each with a leading G for G
        clouds.
    Returns:
      ids (B, 4) int64 into p_pos, invariant1 (B,), invariant2 (B,),
      valid (B,) bool; each with a leading G for G clouds.
    """
    single = p_pos.ndim == 2
    if single:
        p_pos, first, seconds, thirds = (
            t[None] for t in (p_pos, first, seconds, thirds))
    dev = p_pos.device
    n_sets = p_pos.shape[0]
    diam = _diameters(max_base_diameter, n_sets, dev)
    gi = torch.arange(n_sets, device=dev)

    def at(idx):
        # the points of per-cloud indices (G, ...) -> (G, ..., 3)
        return p_pos[gi.view((n_sets,) + (1,) * (idx.ndim - 1)), idx]

    p0 = at(first)                                        # (G, B, 3)
    u = at(seconds) - p0[:, :, None]
    w = at(thirds) - p0[:, :, None]
    cr = _cross(u, w)
    wide = torch.sqrt(_dot(cr, cr))
    # float32 products, as the reference's float arithmetic rounds them
    sq_max = (diam * diam)[:, None, None]
    ok = (_dot(u, u) < sq_max) & (_dot(w, w) < sq_max)
    wide = torch.where(ok, wide, torch.zeros_like(wide))
    best_t = torch.argmax(wide, dim=2, keepdim=True)
    # the reference keeps a candidate only when how_wide > best_wide (0)
    tri_valid = wide.gather(2, best_t)[..., 0] > 0.0
    b1 = first
    b2 = seconds.gather(2, best_t)[..., 0]
    b3 = thirds.gather(2, best_t)[..., 0]

    # Plane through the three points: solve [p1; p2; p3] [A B C]^T = 1
    # via the explicit determinant expansion of ref:cc:310-319.
    x1, y1, z1 = at(b1).unbind(-1)
    x2, y2, z2 = at(b2).unbind(-1)
    x3, y3, z3 = at(b3).unbind(-1)
    denom = (-x3 * y2 * z1 + x2 * y3 * z1 + x3 * y1 * z2 - x1 * y3 * z2
             - x2 * y1 * z3 + x1 * y2 * z3)
    plane_valid = denom != 0.0
    safe = torch.where(plane_valid, denom, torch.ones_like(denom))
    A = (-y2 * z1 + y3 * z1 + y1 * z2 - y3 * z2 - y1 * z3 + y2 * z3) / safe
    B = (x2 * z1 - x3 * z1 - x1 * z2 + x3 * z2 + x1 * z3 - x2 * z3) / safe
    C = (-x2 * y1 + x3 * y1 + x1 * y2 - x3 * y2 - x1 * y3 + x2 * y3) / safe

    # 4th point: most coplanar, not too close to the first three.
    fifth = torch.full((), np.float32(_K_BASE_TOO_SMALL), device=dev)
    too_small = diam * fifth
    too_small = (too_small * too_small)[:, None, None]
    far = torch.ones(p_pos.shape[1], dtype=torch.bool, device=dev)
    far = far[None, None].repeat(n_sets, first.shape[1], 1)
    for bi in (b1, b2, b3):
        d = p_pos[:, None] - at(bi)[:, :, None]
        far &= _dot(d, d) >= too_small
    px = p_pos[:, None]
    plane_dist = (A[..., None] * px[..., 0] + B[..., None] * px[..., 1]
                  + C[..., None] * px[..., 2] - 1.0).abs()
    plane_dist = torch.where(far, plane_dist,
                             torch.full_like(plane_dist, float("inf")))
    b4 = torch.argmin(plane_dist, dim=2, keepdim=True)
    fourth_valid = torch.isfinite(plane_dist.gather(2, b4)[..., 0])

    ids = torch.stack([b1, b2, b3, b4[..., 0]], dim=-1)
    perm, inv1, inv2 = try_quadrilateral(at(ids))
    ids = ids.gather(-1, perm)

    valid = tri_valid & plane_valid & fourth_valid
    out = (ids, inv1, inv2, valid)
    return tuple(o[0] for o in out) if single else out
