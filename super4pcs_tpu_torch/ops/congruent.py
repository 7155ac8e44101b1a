"""Congruent 4-point set search: invariant-point join of two pair sets.

PyTorch counterpart of ``super4pcs_tpu.ops.congruent`` (the reference's
``FindCongruentQuadrilaterals`` of 4PCS, ref:src/super4pcs/algorithms/
4pcs.cc:62-109, and of Super4PCS, ref:algorithms/super4pcs.cc:80-177):

- :func:`find_congruent_quads`, the dense K1 x K2 join (the oracle, and
  the fast form at toy scale);
- :func:`find_congruent_quads_grid`, the sorted spatial-hash join, over
  extracted pairs, the capture kernel's row-capped tables, or the
  implicit full-pair table of the scale-mode "allpairs" engine.

Both keep the JAX package's squared-vs-squared join threshold
(``d^2 <= threshold^2``; the reference compares a squared distance with
an unsquared radius). In Super4PCS mode both apply a direction filter:
the exact cone mask ``|dir1 . dir2 - cos(alpha)| <= tol`` (the default)
or the HEALPix bins of the reference's ``IndexedNormalHealSet``
(:func:`healpix_circle_pixels`). In similarity mode both also apply the
reference's MULTISCALE ratio gate (``scale_band``, see
:func:`find_congruent_quads`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import healpix as _healpix
from . import masking as _masking
from .masking import masked_indices
from ..kernels import join as _join
from ..kernels.rowcap import SENT, cell_hash_of


def _norm3(v):
    return torch.sqrt((v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1])
                      + v[..., 2] * v[..., 2])


# ---------------------------------------------------------------------------
# HEALPix direction filter: the reference's deprecated
# ``IndexedNormalHealSet`` (ref:src/super4pcs/accelerators/
# normalHealSet.h:270-321). The circle of directions at angle alpha
# around each query direction is sampled and rasterized into ring-scheme
# pixels; a candidate passes iff its direction's pixel is among them.
# Tolerance is implicit in the bin resolution (nside), as in the
# reference.
# ---------------------------------------------------------------------------


def healpix_circle_pixels(dirs, cos_alpha, nside: int, samples: int = 32):
    """Ring-scheme pixels rasterized by the circle of directions at angle
    ``alpha`` (given as its cosine) around each row of ``dirs`` (K, 3).

    Returns (K, samples) int32 pixel ids (duplicates possible — callers
    use membership, not counts). The circle is sampled at the angles
    ``t`` the JAX package uses (``linspace(0, 2 pi, samples,
    endpoint=False)`` in float32: ``2 pi * (i / samples)``).
    """
    dirs = torch.as_tensor(dirs, dtype=torch.float32)
    dev = dirs.device
    cos_a = torch.clamp(torch.as_tensor(cos_alpha, dtype=torch.float32,
                                        device=dev), -1.0, 1.0)
    sin_a = torch.sqrt(torch.clamp(1.0 - cos_a * cos_a, min=0.0))

    # orthonormal frame (u, v) perpendicular to each direction; seed with
    # the least-aligned coordinate axis for stability
    ax = torch.argmin(dirs.abs(), dim=-1)                      # (K,)
    seed = torch.eye(3, dtype=torch.float32, device=dev)[ax]   # (K, 3)
    u = torch.linalg.cross(dirs, seed)
    u = u / torch.clamp(torch.linalg.vector_norm(u, dim=-1, keepdim=True),
                        min=1e-30)
    v = torch.linalg.cross(dirs, u)

    # the step i / samples divides by a device tensor: on CUDA a host
    # scalar divisor becomes a multiply by its reciprocal
    step = (torch.arange(samples, dtype=torch.float32, device=dev)
            / torch.full((), samples, dtype=torch.float32, device=dev))
    t = (2.0 * math.pi) * step
    circ = (cos_a * dirs[:, None, :]
            + sin_a * (torch.cos(t)[None, :, None] * u[:, None, :]
                       + torch.sin(t)[None, :, None] * v[:, None, :]))
    return _healpix.vec2pix_ring(nside, circ)                  # (K, S)


def _healpix_membership(pix_cand, circle_pix):
    """``pix_cand`` (...,) vs per-candidate pixel sets ``circle_pix``
    (..., S): True where the candidate pixel appears in the set. One
    sample at a time, so no (..., S) comparison tensor is formed."""
    hit = torch.zeros(torch.broadcast_shapes(pix_cand.shape,
                                             circle_pix.shape[:-1]),
                      dtype=torch.bool, device=pix_cand.device)
    for s in range(circle_pix.shape[-1]):
        hit |= pix_cand == circle_pix[..., s]
    return hit


def _gather_rows(x, idx):
    """``x[t, idx[t]]`` for (T, n, 3) points and (T, K) indices."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[2]))


def find_congruent_quads(pos, pairs1, valid1, pairs2, valid2,
                         invariant1, invariant2, distance_threshold,
                         base_cos_alpha, cone_cos_tolerance,
                         capacity: int, direction_bins: str = "cone",
                         healpix_nside: int = 4, seg_ratio=None,
                         scale_band: float = -1.0, trial_chunk=None):
    """Dense join of the two pair sets on invariant-point proximity.

    ``direction_bins`` selects the Super4PCS direction filter: "cone"
    (exact mask, the default) or "healpix" (rasterized ring-scheme bins,
    see :func:`healpix_circle_pixels`). Ignored when
    ``cone_cos_tolerance < 0`` (4PCS mode). The cone's cosine is written
    out as ``(x1 x2 + y1 y2) + z1 z2`` (no GEMM, whose order may change
    with the batch).

    ``scale_band`` >= 0 turns on similarity mode's scale-consistency
    mask (the reference's MULTISCALE ratio gate, ref:match4pcsBase.cc:
    390-414, applied there at fit time only): a candidate passes iff
    ``|seg_ratio * len2 / len1 - 1| <= scale_band``, with ``seg_ratio``
    the base's segment-length ratio d1 / d2 and len1, len2 the lengths
    of its two pairs. Masking here keeps the scale-inconsistent
    collisions, which the fit would reject, out of ``capacity``.

    Trial axis (the JAX package's ``vmap`` over a step's bases): with
    ``valid1`` (T, K1) the tables are (T, K, 2), ``pos`` the G pairs'
    (G, n, 3) with trial ``t`` on set ``t // (T // G)``, and
    ``invariant1``, ``invariant2``, ``base_cos_alpha`` and ``seg_ratio``
    (T,) tensors or shared numbers. The (T, K1, K2) planes are formed a
    chunk of ``trial_chunk`` trials at a time (default: the device's
    element budget, ``masking.trial_chunk``); each trial is compacted on
    its own, so its outputs equal its own call's.

    Returns (quads (capacity, 4) int64 = (a, b, c, d), valid
    (capacity,), count), with a leading T on the trial axis. Quad layout
    matches ref:super4pcs.cc:172-173: (P_pair.first, P_pair.second,
    Q_pair.first, Q_pair.second).
    """
    single = valid1.ndim == 1
    if single:
        pos, pairs1, valid1, pairs2, valid2 = (
            t[None] for t in (pos, pairs1, valid1, pairs2, valid2))
    dev = pos.device
    nt, k1 = valid1.shape
    k2 = valid2.shape[1]
    n_sets, n = pos.shape[:2]
    set_of = torch.arange(nt, device=dev) // (nt // n_sets)
    inv1 = _per_trial(invariant1, nt, dev)
    inv2 = _per_trial(invariant2, nt, dev)
    cone = cone_cos_tolerance >= 0
    cos_a = _per_trial(base_cos_alpha, nt, dev) if cone else None
    ratio = (_per_trial(seg_ratio, nt, dev) if scale_band >= 0 else None)
    r2 = distance_threshold * distance_threshold
    chunk = trial_chunk or _masking.trial_chunk(nt, k1 * k2, dev, "join")

    def one(s, e):
        tc = e - s
        pts = (pos.expand(tc, n, 3) if n_sets == 1 else pos[set_of[s:e]])
        p1, p2 = pairs1[s:e].long(), pairs2[s:e].long()
        a1, b1 = _gather_rows(pts, p1[..., 0]), _gather_rows(pts, p1[..., 1])
        a2, b2 = _gather_rows(pts, p2[..., 0]), _gather_rows(pts, p2[..., 1])
        e1 = a1 + inv1[s:e, None, None] * (b1 - a1)          # (Tc, K1, 3)
        e2 = a2 + inv2[s:e, None, None] * (b2 - a2)          # (Tc, K2, 3)
        # d2 = (dx dx + dy dy) + dz dz, one difference plane live at once
        d = e1[:, :, None, 0] - e2[:, None, :, 0]
        d2 = d * d
        for c in (1, 2):
            d = e1[:, :, None, c] - e2[:, None, :, c]
            d2 += d * d
        del d
        mask = d2 <= r2
        del d2
        mask &= valid1[s:e, :, None] & valid2[s:e, None, :]
        if scale_band >= 0:
            len1 = _norm3(b1 - a1)                           # (Tc, K1)
            len2 = _norm3(b2 - a2)                           # (Tc, K2)
            rr = (ratio[s:e, None, None] * len2[:, None, :]
                  / torch.clamp(len1[:, :, None], min=1e-30))
            mask &= (rr - 1.0).abs() <= scale_band
            del rr
        if cone:
            dir1 = (b1 - a1) / torch.clamp(_norm3(b1 - a1),
                                           min=1e-30)[..., None]
            dir2 = (b2 - a2) / torch.clamp(_norm3(b2 - a2),
                                           min=1e-30)[..., None]
            if direction_bins == "healpix":
                pix1 = _healpix.vec2pix_ring(healpix_nside,
                                             dir1.reshape(-1, 3))
                circ = healpix_circle_pixels(
                    dir2.reshape(-1, 3),
                    cos_a[s:e, None].expand(tc, k2).reshape(-1, 1, 1),
                    healpix_nside).view(tc, k2, -1)
                mask &= _healpix_membership(pix1.view(tc, k1, 1),
                                            circ[:, None])
            else:
                cos12 = dir1[:, :, None, 0] * dir2[:, None, :, 0]
                cos12 += dir1[:, :, None, 1] * dir2[:, None, :, 1]
                cos12 += dir1[:, :, None, 2] * dir2[:, None, :, 2]
                mask &= ((cos12 - cos_a[s:e, None, None]).abs()
                         <= cone_cos_tolerance)
                del cos12
        flat_idx, valid, count = masked_indices(mask.view(tc, -1), capacity)
        del mask
        quads = torch.cat(
            [torch.gather(pairs1[s:e], 1, (flat_idx // k2)[..., None]
                          .expand(-1, -1, 2)),
             torch.gather(pairs2[s:e], 1, (flat_idx % k2)[..., None]
                          .expand(-1, -1, 2))], dim=-1)
        return quads, valid, count

    out = _masking.over_chunks(nt, chunk, one)
    return tuple(o[0] for o in out) if single else out


def probe_window(radius: float, cell: float | None) -> int:
    """Cells per axis the grid join probes: a radius-r ball intersects
    at most ceil(2r / cell) + 1 cells per axis."""
    cell = cell if cell is not None else 2.0 * radius
    return int(np.ceil(2.0 * radius / cell - 1e-6)) + 1


def _window_offsets(w: int, device=None):
    """(w^3, 3) cell offsets (i, j, k), k fastest."""
    i = torch.arange(w ** 3, device=device)
    return torch.stack([i // (w * w), (i // w) % w, i % w], dim=-1)


def _cell_hash(cells):
    """int32 spatial hash of (..., 3) integer cell coordinates, with
    int32 wrap-around (the JAX package's ``_cell_hash``)."""
    h = ((cells[..., 0] * 73856093) ^ (cells[..., 1] * 19349669)
         ^ (cells[..., 2] * 83492791)) & 0xFFFFFFFF
    return torch.where(h >= 1 << 31, h - (1 << 32), h)


def _wrap32(x):
    x = x & 0xFFFFFFFF
    return torch.where(x >= 1 << 31, x - (1 << 32), x)


def _take(table, idx):
    """``table[t, idx[t, ...]]`` for a (T, K) table and (T, ...) indices."""
    return torch.gather(table, 1, idx.reshape(idx.shape[0], -1)) \
        .view(idx.shape)


def _per_trial(v, nt: int, dev, dtype=torch.float32):
    """(T,) values of a per-trial argument (a number or a tensor of one
    value is shared by every trial)."""
    v = torch.as_tensor(v, dtype=dtype, device=dev).reshape(-1)
    return v.expand(nt) if v.numel() == 1 else v


def find_congruent_quads_grid(
    pos, pairs1, valid1, pairs2, valid2, invariant1, invariant2,
    distance_threshold, base_cos_alpha, cone_cos_tolerance,
    capacity: int, cell_candidates: int = 16, q_budget: int | None = None,
    direction_bins: str = "cone", healpix_nside: int = 4,
    row_cap: int | None = None,
    probe_budget: int | None = None, cell_size: float | None = None,
    table_hash=None, allpairs_cols: bool = False, q_uniform: bool = False,
    q_rot=None, seg_ratio=None, scale_band: float = -1.0,
    trial_chunk=None,
):
    """Output-sensitive congruent-set join via a sorted spatial hash, for
    one trial or for T trials at once.

    The first pair set's invariant points are hashed into cells of
    ``cell_size`` (default ``2 * distance_threshold``) and sorted by
    hash (low bit cleared, stable, so ties keep index order); each
    second-set invariant point probes the w^3 window cells covering its
    radius-r ball, takes up to ``cell_candidates`` table entries per
    cell, and validates them exactly (distance, then the direction
    filter of ``direction_bins`` as in :func:`find_congruent_quads`).

    Inputs as in the JAX package: ``pairs1``/``pairs2`` are (K, 2)
    pairs, or 1-D cols-only tables in the row-capped layout (slot ``s``
    is the pair ``(s // row_cap, cols[s])``, needs ``row_cap``).
    ``table_hash`` is the table's precomputed (K1,) int32 cell hash (the
    capture kernel emits it; empty slots carry the sentinel).
    ``q_budget`` bounds the valid second-side pairs probed (default all,
    up to 8192); ``probe_budget`` compacts the probes that hit a
    non-empty cell before the candidate gather.

    Trial axis (the JAX package's ``vmap`` over a step's bases): with
    ``valid1`` (T, K1) every table, mask and hash gains a leading T,
    ``pos`` is (G, n, 3) with trial ``t`` on set ``t // (T // G)``, and
    ``invariant1``, ``invariant2``, ``base_cos_alpha``, ``seg_ratio``
    and ``q_rot`` may be (T,) tensors. All T tables go through one sort
    on the int64 key ``(t << 32) | (group + 2^31)``, which orders each
    trial's groups as their int32 values do; caps and counters stay per
    trial, and each trial's outputs equal its own call's.

    Range search: each probe's cell range is found with
    ``torch.searchsorted`` at full depth. The JAX package seeds a
    bounded binary search from a bucket table; its rounds reach full
    depth at small tables (every CPU test size), where both give the
    same quads. At large tables (the headline size) a bounded search can
    stop short in a cell denser than 2^rounds, so there the port may
    find a superset of the JAX package's candidates.

    ``allpairs_cols`` (needs ``row_cap``) declares the implicit full
    ordered-pair table of the scale-mode "allpairs" engine: table row
    ``t`` is the pair ``(t // row_cap, t % row_cap)``, ``pairs1`` and
    ``pairs2`` may be None, and the hash stage reads ``pos`` by
    broadcast, with no table-sized gather.

    ``q_uniform`` replaces the first-``qb``-valid-slots probe selection
    by a strided walk over the whole second-side buffer, rotated by
    ``q_rot`` (an int or 0-d tensor drawn per trial); the stride is
    ``k2 // qb`` raised to the next value coprime with ``k2``, so the
    walk visits ``qb`` distinct slots spread over every first endpoint.
    The slot arithmetic is int64 (the JAX package's is int32, equal
    wherever that does not overflow).

    ``scale_band`` >= 0 applies the scale-consistency mask of
    :func:`find_congruent_quads` to each candidate in the validation.

    ``trial_chunk``: trials per call; by default the trials whose
    (T, cell_candidates, probes) candidate planes fit the device's
    element budget (``masking.trial_chunk``, "grid"), so a step of many
    trials at a wide probe window is joined in a few calls, each with
    its own sort, with every trial's outputs unchanged.

    On a CUDA device the inputs of the capture kernel's route (its
    table hash over cols-only tables, a probe budget, the cone test or
    none, no scale band: ``kernels/join.py::takes``) go to the join
    kernel (``kernels/join.py::grid_join``), which has no sort and gives
    the same outputs, every trial in one launch. Every other join, and
    every join on the CPU, runs the body below.

    Returns (quads (capacity, 4) int64, valid, count, dropped,
    q_subsampled): ``dropped`` counts per-cell cap and probe-budget
    drops, ``q_subsampled`` the second-side pairs beyond the budget (in
    probe units). With the trial axis: (T, capacity, 4), (T, capacity)
    and (T,) counters.
    """
    if allpairs_cols and row_cap is None:
        raise ValueError("allpairs_cols requires row_cap")
    if pos.device.type == "cuda" and _join.takes(
            pairs1, valid1, pairs2, valid2, table_hash, row_cap,
            direction_bins,
            cone_cos_tolerance, scale_band, allpairs_cols, q_uniform,
            probe_budget, cell_candidates):
        return _join.grid_join(
            pos, pairs1, valid1, pairs2, valid2, table_hash, invariant1,
            invariant2, distance_threshold, base_cos_alpha,
            cone_cos_tolerance, capacity, cell_candidates, q_budget,
            row_cap, probe_budget, cell_size)
    single = valid1.ndim == 1
    if single:
        pos = pos[None]
        pairs1, valid1, pairs2, valid2, table_hash = (
            None if t is None else t[None]
            for t in (pairs1, valid1, pairs2, valid2, table_hash))
    dev = pos.device
    r = distance_threshold
    cell = cell_size if cell_size is not None else 2.0 * r
    nt = valid1.shape[0]
    if trial_chunk is None:
        per_trial = cell_candidates * (
            probe_budget if probe_budget is not None
            else min(q_budget or 8192, valid2.shape[1])
            * probe_window(r, cell) ** 3)
        trial_chunk = _masking.trial_chunk(nt, per_trial, dev, "grid")
    if trial_chunk < nt:
        n_sets = pos.shape[0]
        set_of = torch.arange(nt, device=dev) // (nt // n_sets)

        def part(v, s, e, dtype=torch.float32):
            if v is None:
                return None
            if torch.is_tensor(v) and v.ndim > 1:
                return v[s:e]
            return _per_trial(v, nt, dev, dtype)[s:e]

        def run(s, e):
            return find_congruent_quads_grid(
                pos if n_sets == 1 else pos[set_of[s:e]],
                part(pairs1, s, e), valid1[s:e], part(pairs2, s, e),
                valid2[s:e], part(invariant1, s, e),
                part(invariant2, s, e), distance_threshold,
                part(base_cos_alpha, s, e), cone_cos_tolerance,
                capacity, cell_candidates, q_budget, direction_bins,
                healpix_nside, row_cap, probe_budget, cell_size,
                part(table_hash, s, e), allpairs_cols, q_uniform,
                part(q_rot, s, e, torch.int64),
                part(seg_ratio, s, e), scale_band, trial_chunk=e - s)

        return _masking.over_chunks(nt, trial_chunk, run)
    # scalars and constants are made on the device: a tensor created
    # from host memory synchronizes the stream
    cell_t = torch.full((), cell, dtype=torch.float32, device=dev)
    w = probe_window(r, cell)
    n_probe = w * w * w
    nt, k1 = valid1.shape
    k2 = valid2.shape[1]
    n = pos.shape[1]
    L = cell_candidates
    tt = torch.arange(nt, device=dev)
    # trial t reads the points of its set: flat point ids offset by
    # the set's start
    off = (tt // (nt // pos.shape[0])) * n
    px = [pos[..., c].reshape(-1) for c in range(3)]

    inv1 = _per_trial(invariant1, nt, dev)
    inv2 = _per_trial(invariant2, nt, dev)

    def bcast(v, ndim):
        # a (T,) per-trial value against (T, ...) operands
        return v.view((nt,) + (1,) * (ndim - 1))

    if allpairs_cols:
        cols1 = rows1 = None
    elif pairs1.ndim == 2:
        if row_cap is None:
            raise ValueError("1-D pairs require the row_cap layout")
        cols1 = pairs1
        rows1 = None
    else:
        cols1 = pairs1[..., 1]
        rows1 = pairs1[..., 0]

    def table_rows(t):
        if rows1 is None:
            return torch.clamp(t // row_cap, max=n - 1)
        return _take(rows1, t)

    def table_cols(t):
        return t % row_cap if allpairs_cols else _take(cols1, t)

    def e1_components(rows, cols):
        """Invariant-point components of table pairs (rows, cols) of
        shape (T, ...): (a, b, a + inv1 * (b - a)) per coordinate."""
        o = bcast(off, rows.ndim)
        i1 = bcast(inv1, rows.ndim)
        out = []
        for c in range(3):
            ac = px[c][rows + o]
            bc = px[c][cols + o]
            out.append((ac, bc, ac + i1 * (bc - ac)))
        return out

    if table_hash is not None:
        if row_cap is None:
            raise ValueError("table_hash requires the row_cap layout")
        h1 = table_hash.long()
    elif allpairs_cols:
        # the implicit table as an (n_rows, row_cap) grid: endpoint a
        # varies down the rows, b across them (the JAX package's
        # broadcast columns, same arithmetic per element)
        n_rows = k1 // row_cap
        rows = torch.clamp(torch.arange(n_rows, device=dev), max=n - 1)
        cols = torch.clamp(torch.arange(row_cap, device=dev), max=n - 1)
        e1c = []
        for c in range(3):
            ac = px[c][rows[None, :] + off[:, None]][:, :, None]
            bc = px[c][cols[None, :] + off[:, None]][:, None, :]
            e1c.append((ac + bcast(inv1, 3) * (bc - ac)).reshape(nt, -1))
        h1 = torch.where(valid1, cell_hash_of(e1c, cell_t).long(), SENT)
        del e1c
    else:
        e1c = [e for (_, _, e) in e1_components(
            table_rows(torch.arange(k1, device=dev).expand(nt, k1)), cols1)]
        h1 = torch.where(valid1, cell_hash_of(e1c, cell_t).long(), SENT)

    # Q-side budget: the first qb valid second-side pairs, or (q_uniform)
    # a rotated walk with a stride coprime with k2
    qb = min(q_budget or 8192, k2)
    if q_uniform:
        stride = max(k2 // qb, 1)
        while math.gcd(stride, k2) != 1:
            stride += 1
        rot = (torch.zeros(nt, dtype=torch.int64, device=dev)
               if q_rot is None else _per_trial(q_rot, nt, dev, torch.int64))
        sel2 = torch.remainder(
            torch.arange(qb, device=dev)[None, :] * stride + rot[:, None],
            k2)
        sel2_valid = _take(valid2, sel2)
        n2 = valid2.sum(dim=1)
    else:
        sel2, sel2_valid, n2 = masked_indices(valid2, qb)
    if allpairs_cols and pairs2 is None:
        pairs2b = torch.stack([sel2 // row_cap, sel2 % row_cap], dim=-1)
    elif pairs2.ndim == 2:
        pairs2b = torch.stack([sel2 // row_cap, _take(pairs2, sel2).long()],
                              dim=-1)
    else:
        pairs2b = torch.gather(
            pairs2, 1, sel2[..., None].expand(-1, -1, 2))      # (T, QB, 2)
    o2 = off[:, None]
    a2 = torch.stack([px[c][pairs2b[..., 0] + o2] for c in range(3)], -1)
    b2 = torch.stack([px[c][pairs2b[..., 1] + o2] for c in range(3)], -1)
    e2 = a2 + bcast(inv2, 3) * (b2 - a2)                       # (T, QB, 3)

    # w^3 window cells per query; [group, group + 2) key ranges
    base_cell = torch.floor((e2 - r) / cell_t).long()          # (T, QB, 3)
    probe = base_cell[:, :, None, :] + _window_offsets(w, dev)
    hq = _cell_hash(probe).reshape(nt, -1)                     # (T, QB*w^3)

    # sort every trial's table by its group key (cell hash with the low
    # bit cleared: merges cells h and h^1 — a superset, removed by the
    # exact distance mask like any other collision), all trials in one
    # sort: the key (t << 32) | (group + 2^31) keeps the trials apart and
    # orders each one's groups as their int32 values do
    tkey = (tt << 32)[:, None]
    sk, order = torch.sort((tkey | ((h1 & ~1) + (1 << 31))).reshape(-1),
                           stable=True)
    order = order.view(nt, k1) - tt[:, None] * k1              # local ids
    start = tt[:, None] * k1

    def search(group):
        # positions in the trial's own sorted table of int32-valued keys
        return (torch.searchsorted(sk, tkey | (group + (1 << 31)))
                - start)

    groupq = hq & ~1
    # the sentinel zone (invalid rows, hash int32-max) is never probed:
    # both range ends are clamped to its start
    slo = search(torch.full((nt, 1), 2147483646, dtype=torch.int64,
                            device=dev))
    lo_all = torch.minimum(search(groupq), slo)
    # a cell in the top group wraps to an empty range (as in the JAX
    # package's int32 arithmetic)
    hi_all = torch.minimum(search(_wrap32(groupq + 2)), slo)

    pvalid = sel2_valid[:, :, None].expand(nt, qb, n_probe).reshape(nt, -1)
    counts = torch.where(pvalid, torch.clamp(hi_all - lo_all, min=0), 0)
    hi_c = torch.where(pvalid, hi_all, lo_all)
    lo_c = lo_all
    total_cells = counts.sum(dim=1)

    if probe_budget is not None:
        pmask = (hi_c > lo_c) & pvalid
        psel, psv, _ = masked_indices(pmask, probe_budget)
        lo_c = _take(lo_c, psel)
        hi_c = torch.where(psv, _take(hi_c, psel), lo_c)
        qi = psel // n_probe                           # e2 row
        pvalid = psv
        counts = torch.where(psv, _take(counts, psel), 0)
        kept_cells = counts.sum(dim=1)
    else:
        qi = (torch.arange(qb * n_probe, device=dev) // n_probe) \
            .expand(nt, -1)
        kept_cells = total_cells
    pb = qi.shape[1]

    # up to L sorted-order slots per probe, laid out (T, L, PB)
    slot = lo_c[:, None, :] + torch.arange(L, device=dev)[None, :, None]
    in_cell = (slot < hi_c[:, None, :]) & pvalid[:, None, :]
    slot = torch.clamp(slot, 0, k1 - 1)
    orid = torch.clamp(_take(order, slot), max=k1 - 1)       # (T, L, PB)
    trow = table_rows(orid)
    tcol = table_cols(orid)

    # exact validation: invariant-point distance, then the direction
    # filter
    e2_c = [_take(e2[..., c], qi)[:, None, :] for c in range(3)]
    g = e1_components(trow, tcol)
    dd = [ec - e2_c[c] for c, (_, _, ec) in enumerate(g)]
    d2 = (dd[0] * dd[0] + dd[1] * dd[1]) + dd[2] * dd[2]
    mask = in_cell & (d2 <= r * r)

    if cone_cos_tolerance >= 0 or scale_band >= 0:
        d2v = b2 - a2                                         # (T, QB, 3)
        dxc = [bc - ac for (ac, bc, _) in g]                  # (T, L, PB)
        n1g = torch.clamp(torch.sqrt(
            (dxc[0] * dxc[0] + dxc[1] * dxc[1]) + dxc[2] * dxc[2]),
            min=1e-30)
    if scale_band >= 0:
        ratio = bcast(_per_trial(seg_ratio, nt, dev), 3)
        rr = ratio * _take(_norm3(d2v), qi)[:, None, :] / n1g
        mask &= (rr - 1.0).abs() <= scale_band
    if cone_cos_tolerance >= 0:
        cos_a = _per_trial(base_cos_alpha, nt, dev)
        dir2 = d2v / torch.clamp(_norm3(d2v), min=1e-30)[..., None]
        if direction_bins == "healpix":
            circ = healpix_circle_pixels(
                dir2.reshape(-1, 3),
                cos_a[:, None].expand(nt, qb).reshape(-1, 1, 1),
                healpix_nside).view(nt, qb, -1)
            pix_cand = _healpix.ang2pix_ring(
                healpix_nside, dxc[2] / n1g, torch.atan2(dxc[1], dxc[0]))
            circ_q = torch.gather(
                circ, 1, qi[..., None].expand(-1, -1, circ.shape[2]))
            mask &= _healpix_membership(pix_cand, circ_q[:, None])
        else:
            d2q = [_take(dir2[..., c], qi)[:, None, :] for c in range(3)]
            cos12 = ((dxc[0] * d2q[0] + dxc[1] * d2q[1])
                     + dxc[2] * d2q[2]) / n1g
            mask &= (cos12 - bcast(cos_a, 3)).abs() <= cone_cos_tolerance

    sel, valid, count = masked_indices(mask.reshape(nt, -1), capacity)
    orid_sel = _take(orid.reshape(nt, -1), sel)
    if rows1 is None:
        q1 = torch.stack([orid_sel // row_cap,
                          table_cols(orid_sel).long()], dim=-1)
    else:
        q1 = torch.gather(pairs1, 1, orid_sel[..., None].expand(-1, -1, 2))
    q2 = torch.gather(pairs2b, 1,
                      _take(qi, sel % pb)[..., None].expand(-1, -1, 2))
    quads = torch.cat([q1.long(), q2.long()], dim=-1)
    dropped = (torch.clamp(counts - L, min=0).sum(dim=1)
               + total_cells - kept_cells)
    q_subsampled = n_probe * torch.clamp(n2 - qb, min=0)
    out = (quads, valid, count, dropped, q_subsampled)
    return tuple(o[0] for o in out) if single else out
