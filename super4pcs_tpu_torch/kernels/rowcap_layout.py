"""K2x: the row-capped capture of the rowcap engine's XLA route
(``Options(rowcap_kernel="xla")``, and the rowcap engine in similarity
mode), both base edges of a step's trials in one launch.

The CUDA kernel (``csrc/rowcap_layout.cu``) replaces the JAX package's
XLA capture ``super4pcs_tpu/ops/pairs.py::_rowcap_scan_edges`` (the scan
under ``extract_pairs_rowcap_layout`` and
``extract_pairs_rowcap_layout_both``); its note says what bounds it and
how it is laid out. The contract is the JAX function's:

- ``n_pad = round_up(n, row_block)``; padded rows hold no hit;
- row ``i`` of an edge keeps its first ``row_cap`` hits of
  ``ops/pairs.py::ordered_pair_mask`` in the rotated column order
  ``col_offset, col_offset + 1, ...`` (mod n), the order of
  ``approx_max_k`` over the keys ``-((col - col_offset) mod n)``, which
  is an exact top-k on the CPU (recall 1, whatever
  ``pair_recall_target`` asks);
- ``rc`` counts every hit of the row, kept or not.

A call captures the given edges (both by default) of T trials over G
point sets, trial ``t`` on set ``t // (T // G)``, with one column offset
per trial. It returns, per edge, ``(cols (T, n_pad, row_cap) int32, hit
(T, n_pad, row_cap) bool, rc (T, n_pad) int32)``, with ``cols`` -1 where
``hit`` is False.

:func:`rowcap_layout` sends a CPU tensor to :func:`rowcap_layout_plain`
(the JAX algorithm in torch ops: the mask, the keys, ``torch.topk``) and
launches the kernel for a CUDA tensor, or raises. The wrapper computes
each trial's band, segment and filter scores with the plain version's
own torch expressions, so the two agree bit for bit (the kernel's note
names the one exception, ``acosf`` at the angle gate).

The kernel's walk has torch mirrors here, for the CPU tests:
:func:`reject_bounds` (the rows' kd order and the bounding spheres of
each warp's 32 rows), :func:`pre_band` and :func:`q_band` (each
trial's interval of a pair's squared distance), :func:`reject_limits`
and :func:`column_reject_plain` (the rejection of a column for a warp's
rows), :func:`walk_chunks` (the rotated walk over aligned tiles),
:func:`rowcap_layout_walk` (the whole walk, rejection included) and
:func:`rowcap_layout_all_plain` (the closed form without a predicate).
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from . import _build
from .rowcap import filter_scores
from ..ops import masking as _masking
from ..ops.pairs import (PairFilterConfig, _norm, _sum3, band_bounds,
                         ordered_pair_mask, unit_segment)
from ..utils.graphs import launch_counter

#: the base edges of a 4PCS base
EDGES = ((0, 1), (2, 3))
#: rows a warp, each group with its bounding sphere
SPHERE = 32
#: columns per staged tile (with a filter on: FILTER_TILE)
TILE = 512
FILTER_TILE = 256
#: the kernel's relative widenings and its error factor 2^-18 of a
#: pair's computed squared distance
_UP = np.float32(1.00001)
_DN = np.float32(0.99999)
_ERR = np.float32(2.0 ** -18)


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _offsets(col_offset, nt: int, n: int, dev) -> torch.Tensor:
    """(T,) int64 column offsets reduced mod n (0 when None)."""
    if col_offset is None:
        return torch.zeros(nt, dtype=torch.int64, device=dev)
    off = torch.as_tensor(col_offset, device=dev).reshape(-1)
    return torch.remainder(off.to(torch.int64).expand(nt), n)


def _check(pos, normal, rgb, base_pos, base_norm, base_rgb, row_cap):
    """(G, n, T) of a call, after the checks of its shapes."""
    if pos.ndim != 3 or pos.shape[-1] != 3 or pos.dtype != torch.float32:
        raise ValueError(f"rowcap_layout: pos must be float32 (G, n, 3), "
                         f"got {pos.dtype} {tuple(pos.shape)}")
    g, n = pos.shape[:2]
    nt = base_pos.shape[0]
    for name, t, shape in (("normal", normal, (g, n, 3)),
                           ("rgb", rgb, (g, n, 3)),
                           ("base_pos", base_pos, (nt, 4, 3)),
                           ("base_norm", base_norm, (nt, 4, 3)),
                           ("base_rgb", base_rgb, (nt, 4, 3))):
        if tuple(t.shape) != shape or t.device != pos.device:
            raise ValueError(f"rowcap_layout: {name} must be {shape} on "
                             f"{pos.device}, got {tuple(t.shape)} on "
                             f"{t.device}")
    if nt % g:
        raise ValueError(f"rowcap_layout: {nt} trials over {g} point sets")
    if not 0 < row_cap <= n:
        raise ValueError(f"rowcap_layout: row_cap {row_cap} for n = {n}")
    return g, n, nt


def rowcap_layout_plain(pos, normal, rgb, base_pos, base_norm, base_rgb,
                        pair_distance_epsilon, cfg: PairFilterConfig,
                        row_cap: int, row_block: int = 2048,
                        col_offset=None, edges=EDGES, trial_chunk=None):
    """Plain PyTorch version of the kernel, with :func:`rowcap_layout`'s
    arguments: per (trial chunk, row block), the ordered-pair mask of
    each edge, the keys ``-rank`` (``-inf`` off the mask) and
    ``torch.topk(keys, row_cap)``, as the JAX package's
    ``_rowcap_scan_edges`` does with ``approx_max_k``. Hit columns have
    distinct keys, so they come first and in rank order; the misses'
    slots get -1. ``trial_chunk``: trials per chunk (default: the
    device's element budget, ``masking.CHUNK_ELEMS["extract"]``)."""
    g, n, nt = _check(pos, normal, rgb, base_pos, base_norm, base_rgb,
                      row_cap)
    dev = pos.device
    n_pad = _round_up(n, row_block)
    per_set = nt // g
    set_of = torch.arange(nt, device=dev) // per_set
    off = _offsets(col_offset, nt, n, dev)
    col = torch.arange(n, device=dev)
    neg_rank = -torch.remainder(col[None, :] - off[:, None], n).float()
    tc = trial_chunk or _masking.trial_chunk(nt, n * n, dev, "extract")
    budget = _masking.CHUNK_ELEMS.get(dev.type,
                                      _masking.CHUNK_ELEMS["cpu"])["extract"]
    rb = min(n, max(1, budget // (tc * n)))
    outs = []
    for e0, e1 in edges:
        b0p, b1p = base_pos[:, e0], base_pos[:, e1]
        pd = _norm(b0p - b1p)
        pnang = _norm(base_norm[:, e0] - base_norm[:, e1])
        cols = torch.full((nt, n_pad, row_cap), -1, dtype=torch.int32,
                          device=dev)
        rc = torch.zeros((nt, n_pad), dtype=torch.int32, device=dev)
        for s in range(0, nt, tc):
            e = min(s + tc, nt)
            p, nr, rg = (c[set_of[s:e]] for c in (pos, normal, rgb))
            for r0 in range(0, n, rb):
                r1 = min(r0 + rb, n)
                mask = ordered_pair_mask(
                    p[:, r0:r1], nr[:, r0:r1], rg[:, r0:r1], p, nr, rg,
                    b0p[s:e], b1p[s:e], base_norm[s:e, e0],
                    base_norm[s:e, e1], base_rgb[s:e, e0],
                    base_rgb[s:e, e1], pd[s:e], pnang[s:e],
                    pair_distance_epsilon, cfg, u_offset=r0)
                keys = torch.where(mask, neg_rank[s:e, None, :],
                                   -math.inf)
                vals, idx = torch.topk(keys, row_cap, dim=-1)
                del keys
                cols[s:e, r0:r1] = torch.where(vals > -math.inf, idx,
                                               -1).to(torch.int32)
                rc[s:e, r0:r1] = mask.sum(dim=-1, dtype=torch.int32)
        outs.append((cols, cols >= 0, rc))
    return outs


def gate_edge_rows(pos, base_pos, pair_distance_epsilon,
                   cfg: PairFilterConfig, row_block: int = 2048,
                   edges=EDGES, ulps: int = 4, angle_tol: float = 1e-6):
    """The rows whose captures may differ between the kernel and the
    plain version by rounding, for the comparisons of the two: (band
    (E, T, n_pad) bool, angle (E, T, n_pad) bool), a row marked when it
    holds a pair (j != i) within ``ulps`` float32 ulps of an edge of its
    distance band (the squared band, or |dist - d| against eps with the
    angle filter), or, with the angle filter, whose angle lies within
    ``angle_tol`` radians of the gate (``acosf`` and ``torch.arccos`` may
    round apart). Each test uses ordered_pair_mask's expressions; the
    arguments are :func:`rowcap_layout`'s."""
    g, n = pos.shape[:2]
    nt = base_pos.shape[0]
    dev = pos.device
    n_pad = _round_up(n, row_block)
    set_of = torch.arange(nt, device=dev) // (nt // g)
    band = torch.zeros((len(edges), nt, n_pad), dtype=torch.bool,
                       device=dev)
    angle = torch.zeros_like(band)
    dirs = cfg.max_angle > 0
    athr = torch.full((), cfg.max_angle * math.pi / 180.0,
                      dtype=torch.float32, device=dev)
    budget = _masking.CHUNK_ELEMS.get(dev.type,
                                      _masking.CHUNK_ELEMS["cpu"])["extract"]
    rb = min(n, max(1, budget // n))

    def near(x, edge):
        # within ``ulps`` ulps of ``edge``
        ulp = torch.nextafter(edge, torch.full_like(edge, math.inf)) - edge
        return (x - edge).abs() <= ulps * ulp

    for e, (e0, e1) in enumerate(edges):
        b0p, b1p = base_pos[:, e0], base_pos[:, e1]
        pd = _norm(b0p - b1p)
        lo2, hi2 = band_bounds(pd, pair_distance_epsilon)
        eps = torch.full((), float(pair_distance_epsilon),
                         dtype=torch.float32, device=dev)
        seg = unit_segment(b0p, b1p)
        for t in range(nt):
            q = pos[set_of[t]]
            for r0 in range(0, n, rb):
                u = q[r0:r0 + rb]
                diag = (torch.arange(u.shape[0], device=dev)[:, None]
                        + r0) == torch.arange(n, device=dev)[None, :]
                if dirs:
                    diff = q[None, :, :] - u[:, None, :]
                    dist = _norm(diff)
                    hit = near((dist - pd[t]).abs(), eps)
                    cos = torch.clamp(_sum3(
                        diff / torch.clamp(dist, min=1e-30)[..., None]
                        * seg[t]), -1.0, 1.0)
                    gate = (torch.arccos(cos) - athr).abs() <= angle_tol
                    angle[e, t, r0:r0 + u.shape[0]] = (gate & ~diag).any(1)
                else:
                    su, sv = _sum3(u * u), _sum3(q * q)
                    dot = (u[:, 0:1] * q[None, :, 0]
                           + u[:, 1:2] * q[None, :, 1]) \
                        + u[:, 2:3] * q[None, :, 2]
                    d2 = (su[:, None] + sv[None, :]) - 2.0 * dot
                    hit = near(d2, lo2[t]) | near(d2, hi2[t])
                if cfg.use_distance_filter:
                    band[e, t, r0:r0 + u.shape[0]] = (hit & ~diag).any(1)
    return band, angle


class LayoutBounds(NamedTuple):
    """What the kernel's rejection reads of each point set (G of them),
    from :func:`reject_bounds`: the rows' walk order, grouped 32 a warp,
    each group's bounding sphere, and a bound of the set's squared
    norms."""
    perm: torch.Tensor     # (G, n) int32: slot s walks row perm[s]
    spheres: torch.Tensor  # (G, ceil(n / 32), 4) f32 [cx, cy, cz, r]
    mag2: torch.Tensor     # (G,) f32: >= every |p|^2 of the set


def kd_groups(pos: np.ndarray, group: int = SPHERE) -> np.ndarray:
    """(n,) int64: a permutation of the points ``pos`` (n, 3) in groups
    of ``group`` consecutive points that are kd cells: recursive splits
    along the longest axis, the first part a whole number of groups and
    at least half the points, so every group but the last holds exactly
    ``group`` points of one cell."""
    pos = np.asarray(pos, np.float64)
    out = np.empty(len(pos), np.int64)

    def rec(ids, lo):
        if len(ids) <= group:
            out[lo:lo + len(ids)] = ids
            return
        p = pos[ids]
        ax = int(np.argmax(p.max(axis=0) - p.min(axis=0)))
        k = group * -(-len(ids) // (2 * group))
        part = np.argpartition(p[:, ax], k - 1)
        rec(ids[part[:k]], lo)
        rec(ids[part[k:]], lo + k)

    rec(np.arange(len(pos)), 0)
    return out


def reject_bounds(pos: torch.Tensor) -> LayoutBounds:
    """The rejection's bounds of ``pos`` (G, n, 3) (or (n, 3): no leading
    G): the rows in :func:`kd_groups` order (any order of the rows gives
    the same captures), so that each warp's 32 rows are one kd cell;
    the bounding sphere of each 32-row group, its center the group's
    mean and its radius the largest distance from that float32 center,
    taken in float64 and rounded up past it, so every row lies inside;
    and ``mag2``, the largest ``|p|^2`` of the set widened by 1e-5. The
    order is taken on the host (one copy of ``pos``, which synchronizes
    the stream); Q is fixed for a run, so a caller computes them once,
    before its timed steps."""
    if pos.ndim == 2:
        b = reject_bounds(pos[None])
        return LayoutBounds(*(x[0] for x in b))
    g, n = pos.shape[:2]
    dev = pos.device
    m = -(-n // SPHERE)
    perm = torch.as_tensor(np.stack([kd_groups(p) for p in
                                     pos.detach().cpu().numpy()])
                           if n else np.zeros((g, 0), np.int64),
                           device=dev)
    pp = torch.zeros((g, m * SPHERE, 3), dtype=torch.float64, device=dev)
    pp[:, :n] = torch.gather(pos, 1, perm[..., None].expand(-1, -1, 3)
                             ).double()
    live = (torch.arange(m * SPHERE, device=dev) < n).view(m, SPHERE)
    p4 = pp.view(g, m, SPHERE, 3)
    c = ((p4 * live[..., None]).sum(dim=2)
         / live.sum(dim=1).to(torch.float64)[:, None]).float()
    r = (torch.linalg.vector_norm(p4 - c.double()[:, :, None], dim=-1)
         * live).amax(dim=-1)
    r = torch.nextafter(r.float(), torch.tensor(math.inf, device=dev))
    mag2 = (_sum3(pos * pos).amax(dim=1) if n else
            torch.zeros(g, dtype=torch.float32, device=dev)) * _UP
    return LayoutBounds(perm.to(torch.int32).contiguous(),
                        torch.cat([c, r[..., None]], dim=-1).contiguous(),
                        mag2.contiguous())


def pre_band(d: torch.Tensor, eps: torch.Tensor):
    """The angle path's pre-band, the kernel's ``pre_band`` in float32:
    ``(lo, hi)`` such that a pair whose ``s = (dx^2 + dy^2) + dz^2``
    lies outside ``[lo, hi]`` fails ``|sqrt(s) - d| <= eps`` (the
    plain version's float32 operations). ``lo`` is -inf when ``d -
    eps`` leaves no lower bound."""
    e_up = eps * _UP
    xh = (d + e_up) * _UP
    hi = (xh * xh) * _UP
    xl = (d - e_up) * _DN
    lo = torch.where(xl > 0, (xl * xl) * _DN,
                     torch.full_like(xl, -math.inf))
    return lo, hi


def q_band(geo: torch.Tensor, dirs: bool):
    """Each (edge, trial)'s interval of a pair's computed squared
    distance in the kernel, from :func:`layout_args`' ``geo`` (E, T,
    8): ``[lo^2, hi^2]``, or with the angle filter the pre-band of its
    ``d`` and ``eps``. Returns (lo, hi), each (E, T)."""
    if dirs:
        return pre_band(geo[..., 2], geo[..., 3])
    return geo[..., 0], geo[..., 1]


def reject_limits(spheres: torch.Tensor, mag2: torch.Tensor,
                  lo: torch.Tensor, hi: torch.Tensor):
    """The kernel's ``reject_limits`` in float32 torch: for each row
    group's sphere (``spheres`` (..., m, 4)) and its set's ``mag2``
    (...,), and each edge's interval ``[lo, hi]`` of a pair's computed
    squared distance (broadcast against (..., m)), the thresholds
    ``(far2, near2)`` on a column's ``s_b = |b - c|^2``: a column with
    ``s_b > far2`` or ``s_b < near2`` holds no hit of the group. A
    pair's computed value lies within 2^-18 (M^2 + mag2) of its true
    squared distance (M = |c| + r); every step is widened by a relative
    1e-5."""
    c, r = spheres[..., :3], spheres[..., 3]
    m = _norm(c) + r
    err = _ERR * (m * m + mag2[..., None])
    r_hi = torch.sqrt(hi + err) * _UP
    far = (r_hi + r) * _UP
    far2 = (far * far) * _UP
    lo_e = lo - err
    r_lo = torch.where(lo_e > 0, torch.sqrt(lo_e.clamp(min=0)) * _DN,
                       torch.zeros_like(lo_e))
    nr = (r_lo * _DN - r) * _DN
    near2 = torch.where(nr > 0, (nr * nr) * _DN, torch.full_like(nr, -1.0))
    return far2, near2


def column_reject_plain(pos: torch.Tensor, bounds: LayoutBounds,
                        lo: torch.Tensor, hi: torch.Tensor,
                        per_set: int) -> torch.Tensor:
    """The kernel's rejection in float32 torch: (E, T, m, n) bool, True
    where column j of trial t's set holds no hit of edge e for any row
    of group i (the rows ``perm[32 i : 32 i + 32]``), for ``pos`` (G,
    n, 3), its :func:`reject_bounds` and each (edge, trial)'s interval
    ``[lo, hi]`` (each (E, T), :func:`q_band`), trial ``t`` on set ``t //
    per_set``. NaN anywhere rejects nothing."""
    nt = lo.shape[1]
    gs = torch.arange(nt, device=pos.device) // per_set
    sph, mag2 = bounds.spheres[gs], bounds.mag2[gs]
    far2, near2 = reject_limits(sph, mag2, lo[..., None], hi[..., None])
    dv = pos[gs][:, None, :, :] - sph[:, :, None, :3]
    sb = _sum3(dv * dv)
    return (sb > far2[..., None]) | (sb < near2[..., None])


def walk_chunks(n: int, off: int, tile: int = TILE):
    """The kernel's walk of one trial's columns: a list of (c0, bits),
    one per 32-column chunk in walk order, column ``c0 + i`` taken where
    bit ``i`` of ``bits`` is set. The parts are the columns >= off of
    the tile holding ``off``, the whole tiles after it (wrapping past
    n, the last one cut at n), and the columns < off of that tile; each
    part's chunks run in column order."""
    ntiles = -(-n // tile)
    t0 = off // tile
    parts = [(t0, off, min(t0 * tile + tile, n))]
    for p in range(1, ntiles):
        tl = (t0 + p) % ntiles
        parts.append((tl, tl * tile, min(tl * tile + tile, n)))
    if off > t0 * tile:
        parts.append((t0, t0 * tile, off))
    out = []
    for tl, lo, hi in parts:
        base = tl * tile
        for k in range((lo - base) // 32, (hi - 1 - base) // 32 + 1):
            c0 = base + 32 * k
            blo, bhi = max(lo - c0, 0), min(hi - c0, 32)
            out.append((c0, ((1 << bhi) - 1) & ~((1 << blo) - 1)))
    return out


def walk_order(n: int, off: int, tile: int = TILE) -> torch.Tensor:
    """The columns of :func:`walk_chunks` in the order the kernel takes
    them: the rotated order ``off, ..., n - 1, 0, ..., off - 1``."""
    cols = [c0 + i for c0, bits in walk_chunks(n, off, tile)
            for i in range(32) if bits >> i & 1]
    return torch.tensor(cols, dtype=torch.int64)


def rowcap_layout_walk(pos, normal, rgb, base_pos, base_norm, base_rgb,
                       pair_distance_epsilon, cfg: PairFilterConfig,
                       row_cap: int, row_block: int = 2048,
                       col_offset=None, edges=EDGES,
                       bounds: LayoutBounds | None = None) -> list:
    """The kernel's walk in torch (for tests at small n), with
    :func:`rowcap_layout`'s arguments and outputs: per trial and warp of
    32 rows (in ``bounds.perm`` order with ``bounds``), the chunks of
    :func:`walk_chunks` (tiles of ``TILE``, or ``FILTER_TILE`` with a
    filter), each edge testing only the columns that
    :func:`column_reject_plain` leaves it (with ``bounds``, the distance
    band only): the band bits of the kernel's computed squared distance
    against :func:`q_band`, and, with the angle filter or any other
    filter, those bits and the plain version's mask (the candidates'
    exact tests); each row's bits appended in walk order, stored while
    the row holds fewer than ``row_cap``, counted always."""
    g, n, nt = _check(pos, normal, rgb, base_pos, base_norm, base_rgb,
                      row_cap)
    dev = pos.device
    n_pad = _round_up(n, row_block)
    per_set = nt // g
    dirs = cfg.max_angle > 0
    filt = dirs or (cfg.max_normal_difference > 0
                    or cfg.max_color_distance > 0
                    or cfg.max_translation_distance > 0)
    tile = FILTER_TILE if filt else TILE
    off = _offsets(col_offset, nt, n, dev)
    geo = layout_args(pos, normal, rgb, base_pos, base_norm, base_rgb,
                      pair_distance_epsilon, cfg, edges)["geo"]
    lo, hi = q_band(geo, dirs)
    rej = None
    if bounds is not None and cfg.use_distance_filter:
        rej = column_reject_plain(pos, bounds, lo, hi, per_set)
    outs = []
    for e, (e0, e1) in enumerate(edges):
        cols = torch.full((nt, n_pad, row_cap), -1, dtype=torch.int32,
                          device=dev)
        rc = torch.zeros((nt, n_pad), dtype=torch.int32, device=dev)
        pd = _norm(base_pos[:, e0] - base_pos[:, e1])
        pnang = _norm(base_norm[:, e0] - base_norm[:, e1])
        for t in range(nt):
            p, nr, rg = (c[t // per_set] for c in (pos, normal, rgb))
            mask = ordered_pair_mask(
                p, nr, rg, p, nr, rg, base_pos[t, e0], base_pos[t, e1],
                base_norm[t, e0], base_norm[t, e1], base_rgb[t, e0],
                base_rgb[t, e1], pd[t], pnang[t], pair_distance_epsilon,
                cfg)
            chunks = walk_chunks(n, int(off[t]), tile)
            for r0 in range(0, n, SPHERE):
                rows = torch.arange(r0, min(r0 + SPHERE, n), device=dev)
                if bounds is not None:
                    rows = bounds.perm[t // per_set, rows].long()
                a = p[rows]
                cnt = torch.zeros(len(rows), dtype=torch.int64, device=dev)
                for c0, bits in chunks:
                    k = torch.arange(32, device=dev)
                    take = ((bits >> k) & 1).bool() & (c0 + k < n)
                    if rej is not None:
                        # the kernel tests at least the columns that the
                        # rejection leaves this edge
                        kept = ~rej[e, t, r0 // SPHERE, c0:c0 + 32]
                        take &= torch.nn.functional.pad(
                            kept, (0, 32 - kept.numel()))
                    cc = (c0 + k)[take]
                    valid = cc[None, :] != rows[:, None]
                    if cfg.use_distance_filter:
                        b = p[cc]
                        if dirs:
                            dv = b[None, :, :] - a[:, None, :]
                            q = _sum3(dv * dv)
                        else:
                            q = (_sum3(a * a)[:, None] + _sum3(b * b)[None]
                                 ) - 2.0 * ((a[:, 0:1] * b[None, :, 0]
                                             + a[:, 1:2] * b[None, :, 1])
                                            + a[:, 2:3] * b[None, :, 2])
                        valid &= (q >= lo[e, t]) & (q <= hi[e, t])
                    hit = valid & mask[rows][:, cc] if filt else valid
                    rank = cnt[:, None] + torch.cumsum(hit.long(), 1) - 1
                    keep = hit & (rank < row_cap)
                    ri, ci = keep.nonzero(as_tuple=True)
                    cols[t, rows[ri], rank[ri, ci]] = cc[ci].to(torch.int32)
                    cnt += hit.sum(1)
                rc[t, rows] = cnt.to(torch.int32)
        outs.append((cols, cols >= 0, rc))
    return outs


def rowcap_layout_all_plain(n: int, n_pad: int, row_cap: int,
                            col_offset) -> tuple:
    """The closed form of a capture with no predicate (every pair ``j !=
    i`` of the n live rows a hit), as the kernel's
    ``rowcap_layout_kernel_closed`` writes it: ``cols`` (T, n_pad,
    row_cap), row i's first ``row_cap`` columns of the rotated order
    ``off, off + 1, ...`` (mod n) with column i skipped, -1 after them
    and on padded rows; ``rc`` (T, n_pad), n - 1 on live rows."""
    off = torch.as_tensor(col_offset).reshape(-1).to(torch.int64)
    nt = off.numel()
    row = torch.arange(n_pad)[None, :, None]
    s = torch.arange(row_cap)[None, None, :]
    ki = torch.remainder(row - off[:, None, None], n)
    k = torch.where(s < ki, s, s + 1)
    j = torch.remainder(off[:, None, None] + k, n)
    cols = torch.where((k < n) & (row < n), j, -1).to(torch.int32)
    rc = torch.where(torch.arange(n_pad) < n, n - 1, 0).to(torch.int32)
    return cols, rc[None].expand(nt, -1).contiguous()


def layout_args(pos, normal, rgb, base_pos, base_norm, base_rgb,
                pair_distance_epsilon, cfg: PairFilterConfig,
                edges=EDGES) -> dict:
    """The kernel's inputs besides the offsets, as tensors on pos's
    device: ``pts`` (G, n, 4) [x, y, z, |p|^2], ``nrm`` (G, n, 4) [n,
    |n|^2] with the normal filter, ``scores`` (E, T, 2, n) with the color
    or translation filter (kernels/rowcap.py::filter_scores), and ``geo``
    (E, T, 8) [lo^2, hi^2, d, eps, nang, unit segment] per edge and
    trial, each from the torch expressions that ordered_pair_mask
    evaluates."""
    dev = pos.device
    nt = base_pos.shape[0]
    set_of = torch.arange(nt, device=dev) // (nt // pos.shape[0])
    out = dict(pts=torch.cat([pos, _sum3(pos * pos)[..., None]], dim=-1)
               .contiguous(), nrm=None, scores=None)
    if cfg.max_normal_difference > 0:
        out["nrm"] = torch.cat([normal, _sum3(normal * normal)[..., None]],
                               dim=-1).contiguous()
    if cfg.max_color_distance > 0 or cfg.max_translation_distance > 0:
        tpos, trgb = pos[set_of], rgb[set_of]
        out["scores"] = torch.stack([
            filter_scores(tpos, trgb, base_pos, base_rgb, e0, e1,
                          cfg.max_color_distance,
                          cfg.max_translation_distance)
            for e0, e1 in edges]).contiguous()
    # a number is filled on the device (a tensor made from host memory
    # would synchronize the stream)
    eps = (pair_distance_epsilon.to(device=dev, dtype=torch.float32)
           .expand(nt) if torch.is_tensor(pair_distance_epsilon)
           else torch.full((nt,), float(pair_distance_epsilon),
                           dtype=torch.float32, device=dev))
    geo = []
    for e0, e1 in edges:
        b0p, b1p = base_pos[:, e0], base_pos[:, e1]
        pd = _norm(b0p - b1p)
        lo2, hi2 = band_bounds(pd, pair_distance_epsilon)
        seg = (unit_segment(b0p, b1p) if cfg.max_angle > 0
               else torch.zeros_like(b0p))
        geo.append(torch.stack(
            [lo2, hi2, pd, eps, _norm(base_norm[:, e0] - base_norm[:, e1]),
             seg[:, 0], seg[:, 1], seg[:, 2]], dim=1))
    out["geo"] = torch.stack(geo).contiguous()
    return out


def has_predicate(cfg: PairFilterConfig) -> bool:
    """Whether a capture tests anything besides ``j != i``: the distance
    band or a filter. Without one (similarity mode's rowcap engine) the
    kernel writes the closed form (:func:`rowcap_layout_all_plain`)."""
    return (cfg.use_distance_filter or cfg.max_angle > 0
            or cfg.max_normal_difference > 0 or cfg.max_color_distance > 0
            or cfg.max_translation_distance > 0)


def rowcap_layout(pos, normal, rgb, base_pos, base_norm, base_rgb,
                  pair_distance_epsilon, cfg: PairFilterConfig,
                  row_cap: int, row_block: int = 2048, col_offset=None,
                  edges=EDGES, tile_reject: bool = True, bounds=None):
    """The row-capped captures of ``edges`` (both base edges by default)
    of T trials: ``pos``/``normal``/``rgb`` (G, n, 3) float32 point
    sets, ``base_pos``/``base_norm``/``base_rgb`` (T, 4, 3) one base per
    trial, trial ``t`` on set ``t // (T // G)``; ``col_offset`` an int
    or a (T,) tensor of column offsets, or None (0). One launch on the
    card for all edges and trials (``rowcap_layout.launches``; the
    trials x edges it captured in ``captures``). Returns per edge
    ``(cols, hit, rc)`` (see the module docstring); without a predicate
    (:func:`has_predicate`) every edge gets the same tensors.

    ``tile_reject`` turns the kernel's rejection on (with the distance
    band only), with ``bounds`` (:func:`reject_bounds` of ``pos``, which
    copies ``pos`` to the host) computed here when not given; the output
    is the same either way. The CPU path rejects nothing."""
    g, n, nt = _check(pos, normal, rgb, base_pos, base_norm, base_rgb,
                      row_cap)
    dev = pos.device
    if dev.type == "cpu":
        return rowcap_layout_plain(pos, normal, rgb, base_pos, base_norm,
                                   base_rgb, pair_distance_epsilon, cfg,
                                   row_cap, row_block, col_offset, edges)
    if dev.type != "cuda":
        raise ValueError(f"rowcap_layout: unsupported device {dev}")
    n_pad = _round_up(n, row_block)
    ne = len(edges)
    pred = has_predicate(cfg)
    rb = None
    if tile_reject and cfg.use_distance_filter:
        rb = reject_bounds(pos) if bounds is None else bounds
        for name, x, shape, dtype in (
                ("perm", rb.perm, (g, n), torch.int32),
                ("spheres", rb.spheres, (g, -(-n // SPHERE), 4),
                 torch.float32),
                ("mag2", rb.mag2, (g,), torch.float32)):
            if (tuple(x.shape) != shape or x.device != dev
                    or x.dtype != dtype or not x.is_contiguous()):
                raise ValueError(f"rowcap_layout: bounds.{name} must be "
                                 f"contiguous {dtype} {shape} on {dev}, "
                                 f"got {x.dtype} {tuple(x.shape)} on "
                                 f"{x.device}")
    args = (layout_args(pos, normal, rgb, base_pos, base_norm, base_rgb,
                        pair_distance_epsilon, cfg, edges) if pred
            else dict(pts=pos, nrm=None, scores=None, geo=pos))
    offs = _offsets(col_offset, nt, n, dev).to(torch.int32)
    tables = ne if pred else 1
    cols = torch.empty((tables, nt, n_pad, row_cap), dtype=torch.int32,
                       device=dev)
    rc = torch.empty((tables, nt, n_pad), dtype=torch.int32, device=dev)
    nthr = np.float32(0.5 * cfg.max_normal_difference * math.pi / 180.0)
    athr = np.float32(cfg.max_angle * math.pi / 180.0)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(lib.rowcap_layout(
            args["pts"].data_ptr(),
            None if args["nrm"] is None else args["nrm"].data_ptr(),
            None if args["scores"] is None else args["scores"].data_ptr(),
            args["geo"].data_ptr(), offs.data_ptr(),
            *((None, None, None) if rb is None else
              (rb.perm.data_ptr(), rb.spheres.data_ptr(),
               rb.mag2.data_ptr())),
            n, n_pad, nt, nt // g, ne, row_cap,
            int(cfg.use_distance_filter), int(cfg.max_angle > 0),
            int(args["nrm"] is not None), int(args["scores"] is not None),
            float(nthr), float(athr), cols.data_ptr(), rc.data_ptr(),
            stream), "rowcap_layout")
    rowcap_layout.launches += 1
    rowcap_layout.captures += nt * ne
    if not pred:
        hit = cols[0] >= 0
        return [(cols[0], hit, rc[0])] * ne
    return [(cols[e], cols[e] >= 0, rc[e]) for e in range(ne)]


#: kernel launches since the count was last reset (CUDA path only); a
#: launch covers both edges of every trial of its call
rowcap_layout.launches = 0
#: the (trial, edge) captures those launches covered
rowcap_layout.captures = 0
launch_counter(rowcap_layout, "launches", "captures")


def _lib():
    lib = _build.load("rowcap_layout")
    fn = lib.rowcap_layout
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i,
                       i, f, f, p, p, p]
        fn.restype = ctypes.c_int
    return lib
