"""Pair extraction of the dense engine: all point pairs at a base-edge
distance, filtered.

PyTorch counterpart of the dense part of ``super4pcs_tpu.ops.pairs``
(the reference's ``Match4PCS::ExtractPairs``,
ref:src/super4pcs/algorithms/4pcs.cc:114-198, and the per-pair
predicate of ``PairCreationFunctor``, ref:pairCreationFunctor.h:151-218).
Every filter is an elementwise mask over the (n, n) ordered pairs:

- distance band   | ||qi - qj|| - d_base | <= eps           (ref:4pcs.cc:142)
- normal band     min(| ||ni-nj|| - a |, | ||ni+nj|| - a |)
                  <= 0.5 * max_normal_difference             (ref:4pcs.cc:145-158)
- color distance  vs the base endpoints' colors              (ref:4pcs.cc:161-171)
- translation     vs the base endpoints' positions           (ref:4pcs.cc:173-179)
- rotation angle  per emission direction                     (ref:4pcs.cc:182-195)

The deliberate divergences of the JAX package stay: per-pair filter
semantics in both modes, ordered-form filters, and no unit-cube
normalisation (see the JAX module's docstring). The distance band is
squared-vs-squared with the dot product written out as
``(ux vx + uy vy) + uz vz``, the order the capture kernel uses too.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .masking import masked_indices


@dataclasses.dataclass(frozen=True)
class PairFilterConfig:
    """Static filter configuration."""
    max_normal_difference: float = -1.0
    max_color_distance: float = -1.0
    max_translation_distance: float = -1.0
    max_angle: float = -1.0
    #: disable the distance band (the reference MULTISCALE mode,
    #: ref:4pcs.cc:141-143 — with unknown scale no distance can filter)
    use_distance_filter: bool = True


def _norm(v, dim=-1):
    return torch.sqrt((v * v).sum(dim=dim))


def ordered_pair_mask(
    pos_u, normal_u, rgb_u,        # (bu, 3) row slice (the 'first' point)
    pos, normal, rgb,              # (n, 3) all points (the 'second')
    base_p0_pos, base_p1_pos,
    base_p0_norm, base_p1_norm,
    base_p0_rgb, base_p1_rgb,
    pair_distance, pair_normals_angle, pair_distance_epsilon,
    cfg: PairFilterConfig,
    u_offset: int = 0,
):
    """Ordered-pair predicate on a row block: mask[u, v] is True iff the
    ordered pair (first = u_offset + u, second = v) passes every filter.
    Emission direction is second-minus-first."""
    bu = pos_u.shape[0]
    n = pos.shape[0]
    dev = pos.device
    need_dirs = cfg.max_angle > 0
    u_ids = u_offset + torch.arange(bu, device=dev)
    mask = u_ids[:, None] != torch.arange(n, device=dev)[None, :]
    if need_dirs:
        diff = pos[None, :, :] - pos_u[:, None, :]   # [u, v] = q_v - q_u
        dist = _norm(diff)
    if cfg.use_distance_filter:
        if need_dirs:
            mask &= (dist - pair_distance).abs() <= pair_distance_epsilon
        else:
            su = (pos_u[:, 0] * pos_u[:, 0] + pos_u[:, 1] * pos_u[:, 1]) \
                + pos_u[:, 2] * pos_u[:, 2]
            sv = (pos[:, 0] * pos[:, 0] + pos[:, 1] * pos[:, 1]) \
                + pos[:, 2] * pos[:, 2]
            dot = (pos_u[:, 0:1] * pos[:, 0] + pos_u[:, 1:2] * pos[:, 1]) \
                + pos_u[:, 2:3] * pos[:, 2]
            d2 = (su[:, None] + sv[None, :]) - 2.0 * dot
            lo = torch.clamp(pair_distance - pair_distance_epsilon, min=0.0)
            hi = pair_distance + pair_distance_epsilon
            mask &= (d2 >= lo * lo) & (d2 <= hi * hi)

    if cfg.max_normal_difference > 0:
        nsq_u = (normal_u * normal_u).sum(-1)
        nsq = (normal * normal).sum(-1)
        both = (nsq_u[:, None] > 0) & (nsq[None, :] > 0)
        first_ang = _norm(normal_u[:, None, :] - normal[None, :, :])
        second_ang = _norm(normal_u[:, None, :] + normal[None, :, :])
        ndist = torch.minimum((first_ang - pair_normals_angle).abs(),
                              (second_ang - pair_normals_angle).abs())
        thr = 0.5 * cfg.max_normal_difference * math.pi / 180.0
        mask &= ~both | (ndist <= thr)

    if cfg.max_color_distance > 0:
        has_u = rgb_u[:, 0] >= 0
        has = rgb[:, 0] >= 0
        base_has = (base_p0_rgb[0] >= 0) & (base_p1_rgb[0] >= 0)
        use_rgb = has_u[:, None] & has[None, :] & base_has
        dp = _norm(rgb_u - base_p0_rgb)                 # first vs b0
        dq = _norm(rgb - base_p1_rgb)                   # second vs b1
        good = ((dp[:, None] < cfg.max_color_distance)
                & (dq[None, :] < cfg.max_color_distance))
        mask &= ~use_rgb | good

    if cfg.max_translation_distance > 0:
        tp = _norm(pos_u - base_p0_pos)
        tq = _norm(pos - base_p1_pos)
        mask &= ((tp[:, None] < cfg.max_translation_distance)
                 & (tq[None, :] < cfg.max_translation_distance))

    if need_dirs:
        seg1 = base_p1_pos - base_p0_pos
        seg1 = seg1 / _norm(seg1)
        cosang = torch.clamp(
            (diff / torch.clamp(dist, min=1e-30)[..., None] * seg1).sum(-1),
            -1.0, 1.0)
        mask &= torch.arccos(cosang) <= cfg.max_angle * math.pi / 180.0

    return mask


def pair_emit_masks(
    pos, normal, rgb,
    base_p0_pos, base_p1_pos,
    base_p0_norm, base_p1_norm,
    base_p0_rgb, base_p1_rgb,
    pair_distance, pair_normals_angle, pair_distance_epsilon,
    cfg: PairFilterConfig,
):
    """Dense (n, n) emission mask: ``emit[u, v]`` means the ordered pair
    (first=u, second=v) is produced. Every filter is evaluated in
    ordered form — first vs base endpoint 0, second vs endpoint 1,
    emission direction second-minus-first (the JAX package's contract;
    the reference's emit-both-orders quirk is not reproduced)."""
    return ordered_pair_mask(
        pos, normal, rgb, pos, normal, rgb,
        base_p0_pos, base_p1_pos, base_p0_norm, base_p1_norm,
        base_p0_rgb, base_p1_rgb,
        pair_distance, pair_normals_angle, pair_distance_epsilon, cfg)


def _edge_mask(pos, normal, rgb, base_pos, base_norm, base_rgb,
               edge0: int, edge1: int, pair_distance_epsilon,
               cfg: PairFilterConfig):
    b0p, b1p = base_pos[edge0], base_pos[edge1]
    return pair_emit_masks(
        pos, normal, rgb, b0p, b1p, base_norm[edge0], base_norm[edge1],
        base_rgb[edge0], base_rgb[edge1],
        _norm(b0p - b1p), _norm(base_norm[edge0] - base_norm[edge1]),
        pair_distance_epsilon, cfg)


def _rotate_rows(emit, row_offset):
    """``emit`` with its rows rolled so that row ``row_offset`` comes
    first (``jnp.roll(emit, -off, axis=0)``), and the offset reduced
    mod n. The offset may be a device tensor: the roll is a gather, so
    nothing waits for its value."""
    n = emit.shape[0]
    off = torch.remainder(torch.as_tensor(row_offset, device=emit.device),
                          n)
    return emit[torch.remainder(torch.arange(n, device=emit.device) + off,
                                n)], off


def extract_pairs(pos, normal, rgb, base_pos, base_norm, base_rgb,
                  edge0: int, edge1: int, pair_distance_epsilon,
                  cfg: PairFilterConfig, capacity: int, row_offset=None):
    """Ordered pairs matching one base edge, compacted in row-major
    order to a ``capacity`` buffer.

    ``row_offset`` (an int or 0-d tensor) rotates the capture: hits are
    kept in row-major order starting at that row, wrapping. It matters
    only under overflow, where the kept prefix would otherwise be the
    same low rows every trial (scale mode, where every pair is a hit).

    Returns (pairs (capacity, 2) int64, valid (capacity,), count,
    dropped): ``count`` is the exact number of pairs pre-cap and
    ``dropped`` the number missing from the buffer.
    """
    n = pos.shape[0]
    emit = _edge_mask(pos, normal, rgb, base_pos, base_norm, base_rgb,
                      edge0, edge1, pair_distance_epsilon, cfg)
    if row_offset is not None:
        emit, off = _rotate_rows(emit, row_offset)
    flat_idx, valid, count = masked_indices(emit.reshape(-1), capacity)
    u = flat_idx // n
    if row_offset is not None:
        u = torch.remainder(u + off, n)
    pairs = torch.stack([u, flat_idx % n], dim=-1)
    return pairs, valid, count, torch.clamp(count - capacity, min=0)


def extract_pairs_dense_rowcap(pos, normal, rgb, base_pos, base_norm,
                               base_rgb, edge0: int, edge1: int,
                               pair_distance_epsilon,
                               cfg: PairFilterConfig, capacity: int,
                               row_offset=None):
    """Dense-mask extraction with a per-row capture: each row keeps its
    first ``row_cap = capacity // n`` hits in column order (overflow
    drops the tail of each row — row-fair, like the reference's
    per-point pair vectors, ref:pairCreationFunctor.h:120-129).
    ``row_offset`` rotates the first-point axis as in
    :func:`extract_pairs`.

    Returns (pairs (n * row_cap, 2) int64, valid, count, dropped) —
    slot ``s`` belongs to row ``s // row_cap``; ``count`` is the exact
    pre-cap hit count and ``dropped`` the hits beyond the caps.
    """
    n = pos.shape[0]
    row_cap = max(capacity // n, 1)
    emit = _edge_mask(pos, normal, rgb, base_pos, base_norm, base_rgb,
                      edge0, edge1, pair_distance_epsilon, cfg)
    if row_offset is not None:
        emit, off = _rotate_rows(emit, row_offset)
    col = torch.arange(n, device=pos.device)
    key = torch.where(emit, col, n)
    k = min(row_cap, n)
    first = torch.topk(key, k, dim=1, largest=False, sorted=True).values
    cols = torch.full((n, row_cap), -1, dtype=torch.int64,
                      device=pos.device)
    cols[:, :k] = torch.where(first < n, first, -1)
    cols = cols.reshape(-1)
    valid = cols >= 0
    u = torch.arange(n * row_cap, device=pos.device) // row_cap
    if row_offset is not None:
        u = torch.remainder(u + off, n)
    pairs = torch.stack([torch.where(valid, u, 0), cols.clamp(min=0)],
                        dim=-1)
    count = emit.sum()
    return pairs, valid, count, count - valid.sum()
