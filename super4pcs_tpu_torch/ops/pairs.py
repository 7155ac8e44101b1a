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
``(ux vx + uy vy) + uz vz``, and every 3-term sum and norm as ``(v0 +
v1) + v2``, the order the capture kernels use too.

The rowcap engine's XLA route (``extract_pairs_rowcap_layout`` and
``_both``, the JAX package's ``approx_max_k`` capture) keeps each row's
first hits in a rotated column order, through K2x
(kernels/rowcap_layout.py) on the card and its plain version on the
CPU.

The extractions take a step's trials at once (the JAX package's
``vmap`` over bases): T bases against the G pairs' clouds, the (T, n,
n) masks formed a chunk of trials at a time within a memory budget
(``masking.trial_chunk``). Every plane is elementwise and the
compaction runs row by row, so a trial's outputs are those of its own
call, whatever the batch or the chunking.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from . import masking as _masking
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


def _sum3(v):
    """Sum over the last axis of size 3, as ``(v0 + v1) + v2``: the order
    the capture kernels write out (and torch's own sum takes on the
    CPU)."""
    return (v[..., 0] + v[..., 1]) + v[..., 2]


def _norm(v):
    return torch.sqrt(_sum3(v * v))


def band_bounds(pair_distance, pair_distance_epsilon):
    """(lo^2, hi^2) of the squared distance band around
    ``pair_distance``, with lo clamped at 0."""
    lo = torch.clamp(pair_distance - pair_distance_epsilon, min=0.0)
    hi = pair_distance + pair_distance_epsilon
    return lo * lo, hi * hi


def unit_segment(base_p0_pos, base_p1_pos):
    """The unit vector from base point 0 to base point 1 (the angle
    filter's reference direction)."""
    seg1 = base_p1_pos - base_p0_pos
    return seg1 / _norm(seg1)[..., None]


def _plane(x):
    """A per-trial value (...,) against (..., rows, cols) planes (a
    number passes as it is)."""
    return x[..., None, None] if torch.is_tensor(x) else x


def ordered_pair_mask(
    pos_u, normal_u, rgb_u,        # (..., bu, 3) row slice (the 'first')
    pos, normal, rgb,              # (..., n, 3) all points (the 'second')
    base_p0_pos, base_p1_pos,      # (..., 3) each
    base_p0_norm, base_p1_norm,
    base_p0_rgb, base_p1_rgb,
    pair_distance, pair_normals_angle, pair_distance_epsilon,  # (...,)
    cfg: PairFilterConfig,
    u_offset: int = 0,
):
    """Ordered-pair predicate on a row block: mask[..., u, v] is True
    iff the ordered pair (first = u_offset + u, second = v) passes every
    filter. Emission direction is second-minus-first. Leading axes (the
    trial axis) carry one base each; every plane is elementwise, so a
    trial's mask does not depend on them."""
    bu = pos_u.shape[-2]
    n = pos.shape[-2]
    dev = pos.device
    need_dirs = cfg.max_angle > 0
    u_ids = u_offset + torch.arange(bu, device=dev)
    mask = u_ids[:, None] != torch.arange(n, device=dev)[None, :]
    if need_dirs:
        # [..., u, v] = q_v - q_u
        diff = pos[..., None, :, :] - pos_u[..., :, None, :]
        dist = _norm(diff)
    if cfg.use_distance_filter:
        if need_dirs:
            mask = mask & ((dist - _plane(pair_distance)).abs()
                           <= pair_distance_epsilon)
        else:
            su = (pos_u[..., 0] * pos_u[..., 0]
                  + pos_u[..., 1] * pos_u[..., 1]) \
                + pos_u[..., 2] * pos_u[..., 2]
            sv = (pos[..., 0] * pos[..., 0] + pos[..., 1] * pos[..., 1]) \
                + pos[..., 2] * pos[..., 2]
            dot = (pos_u[..., :, 0:1] * pos[..., None, :, 0]
                   + pos_u[..., :, 1:2] * pos[..., None, :, 1]) \
                + pos_u[..., :, 2:3] * pos[..., None, :, 2]
            d2 = (su[..., :, None] + sv[..., None, :]) - 2.0 * dot
            del dot
            lo2, hi2 = band_bounds(pair_distance, pair_distance_epsilon)
            mask = mask & (d2 >= _plane(lo2)) & (d2 <= _plane(hi2))
            del d2

    if cfg.max_normal_difference > 0:
        nsq_u = _sum3(normal_u * normal_u)
        nsq = _sum3(normal * normal)
        both = (nsq_u[..., :, None] > 0) & (nsq[..., None, :] > 0)
        first_ang = _norm(normal_u[..., :, None, :] - normal[..., None, :, :])
        second_ang = _norm(normal_u[..., :, None, :]
                           + normal[..., None, :, :])
        a = _plane(pair_normals_angle)
        ndist = torch.minimum((first_ang - a).abs(), (second_ang - a).abs())
        del first_ang, second_ang
        thr = 0.5 * cfg.max_normal_difference * math.pi / 180.0
        mask = mask & (~both | (ndist <= thr))

    if cfg.max_color_distance > 0:
        has_u = rgb_u[..., 0] >= 0
        has = rgb[..., 0] >= 0
        base_has = (base_p0_rgb[..., 0] >= 0) & (base_p1_rgb[..., 0] >= 0)
        use_rgb = (has_u[..., :, None] & has[..., None, :]
                   & _plane(base_has))
        dp = _norm(rgb_u - base_p0_rgb[..., None, :])     # first vs b0
        dq = _norm(rgb - base_p1_rgb[..., None, :])       # second vs b1
        good = ((dp[..., :, None] < cfg.max_color_distance)
                & (dq[..., None, :] < cfg.max_color_distance))
        mask = mask & (~use_rgb | good)

    if cfg.max_translation_distance > 0:
        tp = _norm(pos_u - base_p0_pos[..., None, :])
        tq = _norm(pos - base_p1_pos[..., None, :])
        mask = mask & ((tp[..., :, None] < cfg.max_translation_distance)
                       & (tq[..., None, :] < cfg.max_translation_distance))

    if need_dirs:
        seg1 = unit_segment(base_p0_pos, base_p1_pos)
        cosang = torch.clamp(
            _sum3(diff / torch.clamp(dist, min=1e-30)[..., None]
                  * seg1[..., None, None, :]), -1.0, 1.0)
        mask = mask & (torch.arccos(cosang) <= cfg.max_angle * math.pi / 180.0)

    # with no filter on, the mask is the trials' shared diagonal
    return mask.expand(torch.broadcast_shapes(mask.shape,
                                              pos_u.shape[:-1] + (n,)))


def pair_emit_masks(
    pos, normal, rgb,
    base_p0_pos, base_p1_pos,
    base_p0_norm, base_p1_norm,
    base_p0_rgb, base_p1_rgb,
    pair_distance, pair_normals_angle, pair_distance_epsilon,
    cfg: PairFilterConfig,
):
    """Dense (..., n, n) emission mask: ``emit[..., u, v]`` means the
    ordered pair (first=u, second=v) is produced. Every filter is
    evaluated in ordered form — first vs base endpoint 0, second vs
    endpoint 1, emission direction second-minus-first (the JAX package's
    contract; the reference's emit-both-orders quirk is not
    reproduced)."""
    return ordered_pair_mask(
        pos, normal, rgb, pos, normal, rgb,
        base_p0_pos, base_p1_pos, base_p0_norm, base_p1_norm,
        base_p0_rgb, base_p1_rgb,
        pair_distance, pair_normals_angle, pair_distance_epsilon, cfg)


def _edge_mask(pos, normal, rgb, base_pos, base_norm, base_rgb,
               edge0: int, edge1: int, pair_distance_epsilon,
               cfg: PairFilterConfig):
    """The (T, n, n) emission masks of one base edge of T trials:
    clouds (T, n, 3), bases (T, 4, 3)."""
    b0p, b1p = base_pos[:, edge0], base_pos[:, edge1]
    return pair_emit_masks(
        pos, normal, rgb, b0p, b1p, base_norm[:, edge0], base_norm[:, edge1],
        base_rgb[:, edge0], base_rgb[:, edge1],
        _norm(b0p - b1p), _norm(base_norm[:, edge0] - base_norm[:, edge1]),
        pair_distance_epsilon, cfg)


def _rotate_rows(emit, row_offset):
    """(T, n, n) masks ``emit`` with each trial's rows rolled so that
    its row ``row_offset[t]`` comes first (``jnp.roll(emit, -off,
    axis=0)`` per trial), and the (T,) offsets reduced mod n. The roll
    is a gather, so nothing waits for the offsets' values."""
    nt, n = emit.shape[:2]
    off = torch.remainder(row_offset, n)
    rows = torch.remainder(
        torch.arange(n, device=emit.device)[None, :] + off[:, None], n)
    return torch.gather(emit, 1, rows[:, :, None].expand(nt, n, n)), off


def _over_trials(one, kind, pos, normal, rgb, base_pos, base_norm,
                 base_rgb, row_offset, trial_chunk):
    """Run ``one(pos, normal, rgb, base_pos, base_norm, base_rgb,
    row_offset)`` on every trial, a chunk of trials at a time, with each
    chunk's clouds (Tc, n, 3), bases (Tc, 4, 3) and offsets (Tc,) or
    None, and join the chunks' outputs along the trial axis.

    One base (``base_pos`` (4, 3), clouds (n, 3), an int or 0-d offset)
    runs as T = 1 and returns its outputs without the trial axis.
    ``trial_chunk``: trials per chunk (default: the device's element
    budget, ``masking.trial_chunk``)."""
    single = base_pos.ndim == 2
    dev = pos.device
    if single:
        pos, normal, rgb, base_pos, base_norm, base_rgb = (
            t[None] for t in (pos, normal, rgb, base_pos, base_norm,
                              base_rgb))
    nt, n = base_pos.shape[0], pos.shape[1]
    if row_offset is not None:
        row_offset = torch.as_tensor(row_offset, device=dev).reshape(nt)
    n_sets = pos.shape[0]
    set_of = torch.arange(nt, device=dev) // (nt // n_sets)
    chunk = trial_chunk or _masking.trial_chunk(nt, n * n, dev, kind)

    def run(s, e):
        if n_sets == 1:
            clouds = [c.expand(e - s, n, 3) for c in (pos, normal, rgb)]
        else:
            clouds = [c[set_of[s:e]] for c in (pos, normal, rgb)]
        return one(*clouds, base_pos[s:e], base_norm[s:e], base_rgb[s:e],
                   None if row_offset is None else row_offset[s:e])

    out = _masking.over_chunks(nt, chunk, run)
    return tuple(o[0] for o in out) if single else tuple(out)


def extract_pairs(pos, normal, rgb, base_pos, base_norm, base_rgb,
                  edge0: int, edge1: int, pair_distance_epsilon,
                  cfg: PairFilterConfig, capacity: int, row_offset=None,
                  trial_chunk=None):
    """Ordered pairs matching one base edge, compacted in row-major
    order to a ``capacity`` buffer.

    ``row_offset`` rotates the capture: hits are kept in row-major order
    starting at that row, wrapping. It matters only under overflow,
    where the kept prefix would otherwise be the same low rows every
    trial (scale mode, where every pair is a hit).

    Trial axis (the JAX package's ``vmap`` over a step's bases): with
    ``base_*`` (T, 4, 3), the clouds are the G pairs' (G, n, 3), trial
    ``t`` on cloud ``t // (T // G)``, ``row_offset`` a (T,) tensor, and
    every output gains a leading T; the (T, n, n) masks are formed a
    chunk of ``trial_chunk`` trials at a time. One base ((4, 3), the
    clouds (n, 3), an int or 0-d offset) is the T = 1 call.

    Returns (pairs (capacity, 2) int64, valid (capacity,), count,
    dropped): ``count`` is the exact number of pairs pre-cap and
    ``dropped`` the number missing from the buffer.
    """
    n = pos.shape[-2]

    def one(pos, normal, rgb, base_pos, base_norm, base_rgb, off):
        emit = _edge_mask(pos, normal, rgb, base_pos, base_norm, base_rgb,
                          edge0, edge1, pair_distance_epsilon, cfg)
        if off is not None:
            emit, off = _rotate_rows(emit, off)
        flat_idx, valid, count = masked_indices(
            emit.reshape(emit.shape[0], -1), capacity)
        u = flat_idx // n
        if off is not None:
            u = torch.remainder(u + off[:, None], n)
        pairs = torch.stack([u, flat_idx % n], dim=-1)
        return pairs, valid, count, torch.clamp(count - capacity, min=0)

    return _over_trials(one, "extract", pos, normal, rgb, base_pos,
                        base_norm, base_rgb, row_offset, trial_chunk)


def extract_pairs_dense_rowcap(pos, normal, rgb, base_pos, base_norm,
                               base_rgb, edge0: int, edge1: int,
                               pair_distance_epsilon,
                               cfg: PairFilterConfig, capacity: int,
                               row_offset=None, trial_chunk=None):
    """Dense-mask extraction with a per-row capture: each row keeps its
    first ``row_cap = capacity // n`` hits in column order (overflow
    drops the tail of each row — row-fair, like the reference's
    per-point pair vectors, ref:pairCreationFunctor.h:120-129).
    ``row_offset`` rotates the first-point axis, and the trial axis is
    taken, as in :func:`extract_pairs`.

    Returns (pairs (n * row_cap, 2) int64, valid, count, dropped) —
    slot ``s`` belongs to row ``s // row_cap``; ``count`` is the exact
    pre-cap hit count and ``dropped`` the hits beyond the caps.
    """
    n = pos.shape[-2]
    row_cap = max(capacity // n, 1)
    k = min(row_cap, n)

    def one(pos, normal, rgb, base_pos, base_norm, base_rgb, off):
        nt = base_pos.shape[0]
        dev = pos.device
        emit = _edge_mask(pos, normal, rgb, base_pos, base_norm, base_rgb,
                          edge0, edge1, pair_distance_epsilon, cfg)
        if off is not None:
            emit, off = _rotate_rows(emit, off)
        key = torch.where(emit, torch.arange(n, device=dev), n)
        first = torch.topk(key, k, dim=-1, largest=False,
                           sorted=True).values
        del key
        cols = torch.full((nt, n, row_cap), -1, dtype=torch.int64,
                          device=dev)
        cols[..., :k] = torch.where(first < n, first, -1)
        cols = cols.reshape(nt, -1)
        valid = cols >= 0
        u = (torch.arange(n * row_cap, device=dev) // row_cap)[None, :]
        if off is not None:
            u = torch.remainder(u + off[:, None], n)
        pairs = torch.stack([torch.where(valid, u, 0), cols.clamp(min=0)],
                            dim=-1)
        count = emit.sum(dim=(1, 2))
        return pairs, valid, count, count - valid.sum(dim=1)

    return _over_trials(one, "extract", pos, normal, rgb, base_pos,
                        base_norm, base_rgb, row_offset, trial_chunk)


def _rowcap_layout_edges(pos, normal, rgb, base_pos, base_norm, base_rgb,
                         pair_distance_epsilon, cfg, row_cap, row_block,
                         col_offset, edges, tile_reject, bounds):
    """The K2x captures (kernels/rowcap_layout.py) of ``edges``, for one
    base (clouds (n, 3), base (4, 3), an int or 0-d offset) or the trial
    axis; returns (per edge (cols, hit, rc) with a leading T, one base or
    not)."""
    from ..kernels.rowcap_layout import rowcap_layout
    single = base_pos.ndim == 2
    if single:
        pos, normal, rgb, base_pos, base_norm, base_rgb = (
            t[None] for t in (pos, normal, rgb, base_pos, base_norm,
                              base_rgb))
        if bounds is not None:
            bounds = type(bounds)(*(b[None] for b in bounds))
    return rowcap_layout(pos, normal, rgb, base_pos, base_norm, base_rgb,
                         pair_distance_epsilon, cfg, row_cap, row_block,
                         col_offset, edges, tile_reject=tile_reject,
                         bounds=bounds), single


def _layout_result(cols, hit, rc, row_cap: int, cols_only: bool):
    """One edge's (table, valid, count, dropped) from its capture, with a
    leading T: the table is the flat cols (0 in empty slots), or with
    ``cols_only`` False the (n_pad * row_cap, 2) pairs (s // row_cap,
    cols[s])."""
    nt = cols.shape[0]
    flat = cols.reshape(nt, -1).clamp(min=0)
    if cols_only:
        table = flat
    else:
        u = torch.arange(flat.shape[1], device=flat.device) // row_cap
        table = torch.stack([u.expand(nt, -1), flat.long()], dim=-1)
    count = rc.sum(dim=-1, dtype=torch.int64)
    found = hit.reshape(nt, -1).sum(dim=-1)
    return table, hit.reshape(nt, -1), count, count - found


def extract_pairs_rowcap_layout(pos, normal, rgb, base_pos, base_norm,
                                base_rgb, edge0: int, edge1: int,
                                pair_distance_epsilon,
                                cfg: PairFilterConfig, row_cap: int,
                                row_block: int = 2048,
                                recall_target: float = 0.9,
                                col_offset=None, tile_reject: bool = True,
                                bounds=None):
    """Row-capped extraction of one base edge, without a global
    compaction (the JAX package's contract): each row keeps its first
    ``row_cap`` hits in the rotated column order ``col_offset,
    col_offset + 1, ...`` (mod n), and counts all of them.

    Returns ``(pairs (n_pad * row_cap, 2) int64, valid, count,
    dropped)`` with ``n_pad = round_up(n, row_block)``: slot ``s`` holds
    the ordered pair ``(s // row_cap, cols[s])`` where ``valid``;
    ``count`` is the exact pre-cap hit count and ``dropped = count -
    found``. The capture is exact (K2x, kernels/rowcap_layout.py), so
    ``recall_target`` (the JAX package's approx_max_k knob) is met at
    any value: recall is 1, as in the JAX package on the CPU.

    Trial axis as :func:`extract_pairs`: bases (T, 4, 3) against the G
    clouds (G, n, 3), trial ``t`` on cloud ``t // (T // G)``, a (T,)
    ``col_offset``, outputs with a leading T.

    ``tile_reject`` turns the kernel's rejection on, with ``bounds``
    (``rowcap_layout.reject_bounds`` of ``pos``, computed once per run by
    the matcher) computed on the call when not given; the output is the
    same either way.
    """
    outs, single = _rowcap_layout_edges(
        pos, normal, rgb, base_pos, base_norm, base_rgb,
        pair_distance_epsilon, cfg, row_cap, row_block, col_offset,
        ((edge0, edge1),), tile_reject, bounds)
    res = _layout_result(*outs[0], row_cap, cols_only=False)
    return tuple(o[0] for o in res) if single else res


def extract_pairs_rowcap_layout_both(pos, normal, rgb, base_pos,
                                     base_norm, base_rgb,
                                     pair_distance_epsilon,
                                     cfg: PairFilterConfig, row_cap: int,
                                     row_block: int = 2048,
                                     recall_target: float = 0.9,
                                     col_offset=None,
                                     cols_only: bool = False,
                                     tile_reject: bool = True,
                                     bounds=None):
    """Both base edges' row-capped extractions ((0, 1) and (2, 3)) in one
    K2x launch on the card, each equal to
    :func:`extract_pairs_rowcap_layout` of its edge. ``cols_only``:
    each table is the flat (n_pad * row_cap,) int32 cols (0 in empty
    slots; slot ``s`` is row ``s // row_cap``), the form the grid join
    takes with ``row_cap``. ``tile_reject`` and ``bounds`` as in
    :func:`extract_pairs_rowcap_layout`. Returns ((table, valid, count,
    dropped) of edge (0, 1), the same of edge (2, 3))."""
    outs, single = _rowcap_layout_edges(
        pos, normal, rgb, base_pos, base_norm, base_rgb,
        pair_distance_epsilon, cfg, row_cap, row_block, col_offset,
        ((0, 1), (2, 3)), tile_reject, bounds)
    res = [_layout_result(*o, row_cap, cols_only) for o in outs]
    if single:
        res = [tuple(x[0] for x in r) for r in res]
    return tuple(tuple(r) for r in res)
