"""Output-sensitive pair extraction: the sorted cell-pair distance table.

PyTorch counterpart of ``super4pcs_tpu.ops.band_extract`` (the "banded"
pair engine, the JAX package's redesign of the reference's sphere-shell
rasterization, ref:src/super4pcs/accelerators/pairExtraction/
intersectionFunctor.h:105-233). Its work grows with its output, not
with nq^2:

- **once per run** (Q is fixed for the whole search) the Q samples are
  bucketed on the host into at most ``cell_budget`` voxels (the cell
  size doubles from ``2 * delta`` until the occupied cells fit), and
  every ordered pair of cell centers is sorted by distance on the device
  into one table of ``M^2`` pair ids (:func:`build_band_index`);
- **per base edge** two binary searches find the band of table entries
  whose center distance lies within ``d +- (eps + sqrt(3) g)``; a
  scrambled strided window of ``cell_pair_cap`` entries walks the whole
  band, rotated per trial; every window entry gets a fixed budget of
  ``expand_cap // cell_pair_cap`` candidate slots enumerated over its
  members' pairs; each candidate is checked with the exact predicate of
  ``ops/pairs.py`` (:func:`extract_pairs_banded`).

The JAX package's extraction is all XLA ops (no Pallas kernel), and so
is this one's: torch ops on the card, with no kernel of its own.

Trial axis: one call extracts one base edge for every trial of a step
(bases (T, 4, 3), rotations (T,)), the JAX package's ``vmap`` over
bases, and over pairs when the index is batched (a leading G on every
tensor, :func:`build_batched_band_index`; trial ``t`` reads set
``t // (T // G)``). Each trial's outputs equal its own call's. When a
step's (T, es, CP) candidate planes would pass a third of the device's
memory, the trials run in chunks, each trial's result unchanged.

Arithmetic follows the JAX function as it runs op by op (its own tests
call it unjitted): the candidate planes are float32 sums in the order
the JAX code writes them. The three-term norms the JAX code takes with
``jnp.linalg.norm`` (the base edge's length, the binary search's center
distances) are computed as XLA's CPU backend computes them,
``sqrt(fma(z, z, fma(y, y, x * x)))``, with each fma written out in
float64 (exact products, so one rounding in all but ties of the float64
sum), the same on both devices. Where the port differs:

- ``_pick``'s TPU gather modes (``SUPER4PCS_TPU_BAND_PICK``) are not
  ported: the port gathers point ids and coordinates directly (the
  JAX package's "flat" mode, the same values);
- the table's center distances are computed once per index
  (``BandIndex.table_dist``), not at every probe;
- in a batched index, the pairs with a padding cell sort after every
  real pair (key +inf): the JAX package keys them by a float32 d2 whose
  ~1e24 terms cancel to noise, so they land among the real pairs and
  its binary search, which needs an ascending table, can miss the band;
- counts are int64 (the JAX package's int32 sums wrap past 2^31);
- ``torch.acos`` may differ from ``jnp.arccos`` in the last bit, so a
  candidate within float32 rounding of the ``max_angle`` gate may be
  decided the other way.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from .lcp import Q_PAD
from .masking import masked_indices
from .pairs import PairFilterConfig

_SQRT3 = math.sqrt(3.0)


def _f32(x: float) -> float:
    """``x`` rounded to float32, as a Python float: a tensor op with it
    computes what the JAX package's weakly typed scalar gives."""
    return float(np.float32(x))


@dataclasses.dataclass
class BandIndex:
    """Once-per-run spatial index over the (centered) Q samples, or G
    such indexes padded to one shape and stacked (a leading G on every
    tensor, see :func:`build_batched_band_index`).

    Tensors:
      members:     (M_cap, pc) int32 — point ids per occupied cell,
                   padded with ``n`` (valid through ``occ``).
      occ:         (M_cap,) int32 — true member count per cell (may
                   exceed pc; the excess is counted in member_dropped).
      centers:     (M_cap, 3) float32 — geometric cell centers (padding
                   rows carry huge distinct coordinates, so their pair
                   distances sort to the table's tail).
      sorted_pair: (M_cap * M_cap,) int32 — ordered cell-pair ids
                   ``a * M_cap + b`` by ascending center distance.
      g:           float32 scalar — the cell size.
      table_dist:  (M_cap * M_cap,) float32 — the center distance of
                   each table entry as the binary search reads it
                   (:func:`_entry_dists`), computed once when the index
                   is made. The JAX package recomputes it at every probe
                   to save the TPU's memory; stored, a probe is one
                   gather, with the same values.
    Meta: ``m`` the table stride (padded cell count), ``m_real`` the
    occupied cells, ``n`` the point count, ``pc`` member slots per cell,
    ``member_dropped`` points beyond ``pc`` (whole run), and the build's
    ``host_seconds`` (bucketing) and ``sort_seconds`` (the device's
    table sort).
    """
    members: torch.Tensor
    occ: torch.Tensor
    centers: torch.Tensor
    sorted_pair: torch.Tensor
    g: torch.Tensor
    m: int
    n: int
    pc: int
    member_dropped: int
    m_real: int = 0
    host_seconds: float = 0.0
    sort_seconds: float = 0.0
    table_dist: torch.Tensor | None = None

    def __post_init__(self):
        if self.table_dist is None:
            if self.batched:
                self.table_dist = torch.stack([
                    _entry_dists(sp, c, o, self.m) for sp, c, o in
                    zip(self.sorted_pair, self.centers, self.occ)])
            else:
                self.table_dist = _entry_dists(
                    self.sorted_pair, self.centers, self.occ, self.m)

    @property
    def batched(self) -> bool:
        return self.members.ndim == 3

    def to(self, device, pairs: slice = slice(None)) -> "BandIndex":
        """A copy with every tensor on ``device``, and of a batched
        index only the pairs ``pairs`` (a shard's); the meta stays the
        whole index's, so a step sized by it is sized alike."""
        def part(t):
            return (t[pairs] if self.batched else t).to(device)

        return dataclasses.replace(self, **{
            k: part(getattr(self, k))
            for k in ("members", "occ", "centers", "sorted_pair", "g",
                      "table_dist")})


def band_index_from_jax(arrays: dict, device="cpu") -> BandIndex:
    """A :class:`BandIndex` of the JAX package's index, given as a dict
    of its leaves (``members``, ``occ``, ``centers``, ``sorted_pair``,
    ``g``: numpy arrays, or anything ``np.asarray`` takes) and meta
    (``m``, ``n``, ``pc``, ``member_dropped``, ``m_real``): the same
    table in both packages."""
    t = {k: torch.as_tensor(np.array(arrays[k]), device=device)
         for k in ("members", "occ", "centers", "sorted_pair", "g")}
    return BandIndex(**t, **{k: int(arrays[k]) for k in
                             ("m", "n", "pc", "member_dropped")},
                     m_real=int(arrays.get("m_real", 0)))


def _host_bucket(q_pos: np.ndarray, delta: float, cell_budget: int):
    """Voxel-bucket the samples on host (cheap): the g-doubling fit to
    the cell budget, unique cells, member ordering, geometric centers.
    (A copy of the JAX package's numpy code.)"""
    q = np.asarray(q_pos, np.float32)
    g = 2.0 * float(delta)
    for _ in range(40):
        cells = np.floor(q / g).astype(np.int64)
        # pack to a unique key (same packed-int scheme as the sampler)
        mn = cells.min(axis=0)
        c = cells - mn
        span = int(c.max()) + 2
        key = (c[:, 0] * span + c[:, 1]) * span + c[:, 2]
        uniq, inv_idx, counts = np.unique(
            key, return_inverse=True, return_counts=True)
        if len(uniq) <= cell_budget:
            break
        g *= 2.0
    order = np.argsort(inv_idx, kind="stable")
    starts = np.zeros(len(uniq), np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    # geometric centers of occupied cells (original coordinates)
    cell_coords = np.stack([(uniq // (span * span)),
                            (uniq // span) % span,
                            uniq % span], axis=1).astype(np.float64)
    centers = ((cell_coords + mn + 0.5) * g).astype(np.float32)
    return g, counts, order, starts, centers


def _device_sort_table(centers: torch.Tensor, m_real: int) -> torch.Tensor:
    """All ordered cell-pair ids sorted by ascending center distance
    (stable: equal distances keep id order, as ``lax.sort`` does).

    ``d2 = |a|^2 + |b|^2 - 2 a.b`` clamped at 0, the cross term written
    out elementwise in a fixed order: a matrix product would pick its
    kernel (and TF32) by size and move the last bit. Pairs with a
    padding cell (rows ``m_real`` on) take the key +inf, so they sort to
    the tail after every real pair, in id order. (The JAX package keys
    them by their float32 d2 too, whose ~1e24 terms cancel to noise of
    ~3e17: they then sort among the real pairs, and the binary search,
    which needs an ascending table, lands off the band.)"""
    m_cap = centers.shape[0]
    c = [centers[:, k] for k in range(3)]
    sq = (c[0] * c[0] + c[1] * c[1]) + c[2] * c[2]
    cross = ((c[0][:, None] * c[0][None, :] + c[1][:, None] * c[1][None, :])
             + c[2][:, None] * c[2][None, :])
    d2 = (sq[:, None] + sq[None, :]) - 2.0 * cross
    del cross
    d2 = torch.clamp(d2, min=0.0)
    if m_real < m_cap:
        d2[m_real:] = float("inf")
        d2[:, m_real:] = float("inf")
    _, order = torch.sort(d2.reshape(m_cap * m_cap), stable=True)
    return order.to(torch.int32)


def build_band_index(q_pos: np.ndarray, delta: float,
                     cell_budget: int = 8192,
                     pc: int | None = None,
                     m_pad: int | None = None,
                     n_override: int | None = None,
                     device="cpu") -> BandIndex:
    """Build the index of ``q_pos`` (n, 3): bucketing on the host, the
    O(M^2) table sorted on ``device``.

    ``cell_budget``: cap on occupied cells (the cell size g starts at
    ``2 * delta`` and doubles until the occupied count fits). ``pc``:
    member slots per cell (default: the observed max occupancy, capped
    at 32). ``m_pad`` / ``n_override``: pad the cell table to a shared
    shape / clamp target, so that a batch of indexes can stack (padding
    cells have occ 0 and huge distinct centers: their pair distances
    sort past every band, and a pad-pad pair is never at distance 0).
    """
    dev = torch.device(device)
    t0 = time.perf_counter()
    q = np.asarray(q_pos, np.float32)
    n = int(n_override) if n_override is not None else q.shape[0]
    g, counts, order, starts, centers = _host_bucket(
        q, delta, cell_budget)
    m = len(counts)
    m_cap = int(m_pad) if m_pad is not None else m
    if m_cap < m:
        raise ValueError(f"m_pad ({m_cap}) < occupied cells ({m})")

    if pc is None:
        pc = int(min(max(counts.max(), 1), 32))
    members = np.full((m_cap, pc), n, np.int32)
    occ = np.zeros(m_cap, np.int32)
    occ[:m] = counts.astype(np.int32)
    member_dropped = int(np.maximum(counts - pc, 0).sum())
    take = np.minimum(counts, pc)
    for s in range(pc):
        rows = np.zeros(m_cap, bool)
        rows[:m] = take > s
        members[rows, s] = order[starts[take > s] + s]

    if m_cap > m:
        # distinct far-away padding centers: pairwise distances among
        # pads and to real cells are ~1e12+, beyond any band query
        pad = 1.0e12 + 1.0e6 * np.arange(m_cap - m, dtype=np.float64)
        centers = np.concatenate(
            [centers, np.stack([pad, pad, pad], 1).astype(np.float32)])
    d_centers = torch.as_tensor(centers, device=dev)
    d_occ = torch.as_tensor(occ, device=dev)
    t1 = time.perf_counter()
    sorted_pair = _device_sort_table(d_centers, m)
    table_dist = _entry_dists(sorted_pair, d_centers, d_occ, m_cap)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t2 = time.perf_counter()
    return BandIndex(
        members=torch.as_tensor(members, device=dev), occ=d_occ,
        centers=d_centers, sorted_pair=sorted_pair,
        g=torch.tensor(g, dtype=torch.float32, device=dev),
        m=m_cap, n=n, pc=pc, member_dropped=member_dropped, m_real=m,
        host_seconds=t1 - t0, sort_seconds=t2 - t1, table_dist=table_dist)


def build_batched_band_index(q_pos_list, delta: float,
                             cell_budget: int = 8192,
                             device="cpu") -> BandIndex:
    """Per-pair band indexes padded to one shared shape and stacked
    along a leading pairs axis (the banded engine in register_batch).

    ``q_pos_list``: per-pair (centered, possibly sentinel-padded) Q
    positions, all with the same row count. Sentinel rows (|x| >=
    ops.lcp.Q_PAD) are left out of the index: they never appear in a
    member list, so banded extraction never emits a sentinel pair.
    ``member_dropped`` is summed over pairs, ``m_real`` is the largest
    pair's, and the build times are summed.
    """
    qs = [np.asarray(q, np.float32) for q in q_pos_list]
    n = qs[0].shape[0]
    if not all(q.shape[0] == n for q in qs):
        raise ValueError("the batch must pad Q to one size first")
    # point ids refer to the padded row space: the real prefix is
    # bucketed and the ids clamp to n
    reals = [q[np.abs(q[:, 0]) < Q_PAD] for q in qs]
    if not all(len(r) > 0 for r in reals):
        raise ValueError("all-sentinel Q cloud")
    # a cheap host pre-pass finds the shared padded shape
    buckets = [_host_bucket(q, delta, cell_budget) for q in reals]
    m_cap = max(len(c) for (_, c, _, _, _) in buckets)
    pc_cap = int(min(max(max(int(c.max()) for (_, c, _, _, _) in buckets),
                         1), 32))
    idxs = [build_band_index(q, delta, cell_budget, pc=pc_cap, m_pad=m_cap,
                             n_override=n, device=device) for q in reals]
    stacked = {k: torch.stack([getattr(i, k) for i in idxs])
               for k in ("members", "occ", "centers", "sorted_pair", "g",
                         "table_dist")}
    return BandIndex(
        **stacked, m=m_cap, n=n, pc=pc_cap,
        member_dropped=sum(i.member_dropped for i in idxs),
        m_real=max(i.m_real for i in idxs),
        host_seconds=sum(i.host_seconds for i in idxs),
        sort_seconds=sum(i.sort_seconds for i in idxs))


def _fma(a, b, c):
    """``a * b + c`` rounded once to float32 (float64 arithmetic: the
    product of two float32 values is exact there)."""
    return (a.double() * b.double() + c.double()).float()


def _norm3(v):
    """``jnp.linalg.norm(v, axis=-1)`` of (..., 3) float32 vectors as
    XLA's CPU backend computes it: ``sqrt(fma(z, z, fma(y, y, x x)))``."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return torch.sqrt(_fma(z, z, _fma(y, y, x * x)))


def _entry_dists(sorted_pair, centers, occ, m: int, block: int = 1 << 24):
    """The center distance of every entry of one table, in table order,
    as the JAX package's probe recomputes it (``jnp.linalg.norm`` of the
    two centers' difference); an entry with a padding cell (occ 0) is
    at +inf, as its sort key was, so the table's tail stays ascending (a
    pad cell's pair with itself is at distance 0). In blocks of
    ``block`` entries."""
    out = torch.empty(sorted_pair.shape, dtype=torch.float32,
                      device=sorted_pair.device)
    for s in range(0, sorted_pair.shape[0], block):
        pid = sorted_pair[s:s + block].long()
        a, b = pid // m, pid % m
        pad = (occ[a] == 0) | (occ[b] == 0)
        out[s:s + block] = torch.where(pad, float("inf"),
                                       _norm3(centers[a] - centers[b]))
    return out


def _pair_dist(idx: BandIndex, t, sets):
    """Center distance of table entries ``t`` of the index of each
    ``sets`` entry; ``t`` is clamped into the table as XLA clamps a
    gather."""
    t = torch.clamp(t, 0, idx.m * idx.m - 1)
    return idx.table_dist[sets, t] if idx.batched else idx.table_dist[t]


def _searchsorted_table(idx: BandIndex, value, sets):
    """Per entry of ``value`` (N,), the first table position whose
    center distance is >= it: the JAX package's binary search, with its
    fixed ``ceil(log2(M^2)) + 1`` steps and ``<`` test, all N at once."""
    total = idx.m * idx.m
    lo = torch.zeros(value.shape, dtype=torch.int64, device=value.device)
    hi = torch.full(value.shape, total, dtype=torch.int64,
                    device=value.device)
    steps = max(int(math.ceil(math.log2(max(total, 2)))) + 1, 1)
    for _ in range(steps):
        mid = (lo + hi) // 2
        below = _pair_dist(idx, mid, sets) < value
        lo, hi = torch.where(below, mid + 1, lo), torch.where(below, hi, mid)
    return lo


def _scramble_multiplier(cp: int) -> int:
    """Odd multiplier ~512, coprime with ``cp``: ``(s * a) % cp`` is a
    bijection of the window slots whose prefixes are spread uniformly
    (stride-a progressions)."""
    a = 521 if cp > 1024 else max((cp // 2) | 1, 1)
    while math.gcd(a, cp) != 1:
        a += 2
    return a


#: bytes of live candidate planes per (trial, slot) at the peak of
#: :func:`_extract_chunk` (int64 indexes and float32 coordinates),
#: which sizes the trial chunks
_PLANE_BYTES = 128


def _trial_chunk(dev, nt: int, slots: int) -> int:
    """Trials per chunk, so that one chunk's candidate planes stay
    within a third of the device's memory (2 GiB on the CPU)."""
    budget = (torch.cuda.get_device_properties(dev).total_memory // 3
              if dev.type == "cuda" else 2 << 30)
    return max(1, min(nt, budget // max(slots * _PLANE_BYTES, 1)))


def extract_pairs_banded(
    idx: BandIndex,
    pos, normal, rgb,
    base_pos, base_norm, base_rgb,
    edge0: int, edge1: int,
    pair_distance_epsilon,
    cfg: PairFilterConfig,
    cell_pair_cap: int,
    rot_offset=None,
    capacity: int | None = None,
    expand_cap: int | None = None,
):
    """Extract the ordered pairs matching one base edge through the band
    index (the two-level capture of the module docstring), for one
    trial or for T.

    One trial: ``pos``/``normal``/``rgb`` (n, 3), bases (4, 3),
    ``rot_offset`` an int, a 0-d tensor or None. T trials: bases
    (T, 4, 3), ``rot_offset`` (T,) or None; with a batched index the
    clouds are (G, n, 3) and trial ``t`` reads set ``t // (T // G)``.

    Window: ``cell_pair_cap`` band entries, spread uniformly over the
    whole band when it overflows (strided walk rotated by
    ``rot_offset``, order-scrambled). Expansion: ``expand_cap //
    cell_pair_cap`` candidate slots per entry (default every member
    pair, i.e. exact), rotated within the entry. Returns ``(pairs,
    valid, count, dropped)``: with ``capacity`` the validated hits
    compacted to ``(capacity, 2)`` int32, without it the raw
    ``(expand_cap, 2)`` slots and their mask; ``count`` the validated
    hits among the examined candidates; ``dropped``, in candidate-pair
    units, the band entries beyond the window (times their mean
    occupancy product, in float32, capped at 2e9), the candidates beyond
    each entry's budget and the hits beyond ``capacity``. With T
    trials every output gains a leading T.
    """
    single = base_pos.ndim == 2
    if single:
        base_pos, base_norm, base_rgb = (
            base_pos[None], base_norm[None], base_rgb[None])
        if rot_offset is not None:
            rot_offset = torch.as_tensor(rot_offset).reshape(1)
    if pos.ndim == 2:
        pos, normal, rgb = pos[None], normal[None], rgb[None]
    n_sets = pos.shape[0]
    if (idx.members.shape[0] if idx.batched else 1) != n_sets:
        raise ValueError("the clouds and the index need one set each")
    dev = pos.device
    nt = base_pos.shape[0]
    sets = torch.arange(nt, device=dev) // (nt // n_sets)
    off = (torch.zeros(nt, dtype=torch.int64, device=dev)
           if rot_offset is None
           else torch.as_tensor(rot_offset, device=dev).long().reshape(nt))

    b0p, b1p = base_pos[:, edge0], base_pos[:, edge1]
    pair_distance = _norm3(b0p - b1p)                         # (T,)
    pair_normals_angle = _norm3(base_norm[:, edge0] - base_norm[:, edge1])

    # conservative cell-level band: any point pair at distance within
    # d +- eps lives in a cell pair whose center distance is within
    # d +- (eps + sqrt(3) g). With the distance filter off (similarity
    # mode) the band is the whole table
    total = idx.m * idx.m
    g = idx.g[sets] if idx.batched else idx.g.expand(nt)
    if cfg.use_distance_filter:
        slack = _f32(pair_distance_epsilon) + g * _f32(_SQRT3)
        lohi = _searchsorted_table(
            idx, torch.cat([pair_distance - slack, pair_distance + slack]),
            torch.cat([sets, sets]))
        lo, hi = lohi[:nt], lohi[nt:]
    else:
        lo = torch.zeros(nt, dtype=torch.int64, device=dev)
        hi = torch.full((nt,), total, dtype=torch.int64, device=dev)

    cp = cell_pair_cap
    if expand_cap is None:
        expand_cap = cp * idx.pc * idx.pc            # exact: es = pc^2
    es = max(expand_cap // cp, 1)
    geo = dict(pair_distance=pair_distance, pna=pair_normals_angle,
               b0p=b0p, b1p=b1p, brgb0=base_rgb[:, edge0],
               brgb1=base_rgb[:, edge1])
    chunk = _trial_chunk(dev, nt, es * cp)
    outs = []
    for s in range(0, nt, chunk):
        sl = slice(s, min(s + chunk, nt))
        outs.append(_extract_chunk(
            idx, pos, normal, rgb, sets[sl], off[sl], lo[sl], hi[sl],
            {k: v[sl] for k, v in geo.items()}, pair_distance_epsilon, cfg,
            cp, es, capacity))
    out = (outs[0] if len(outs) == 1
           else tuple(torch.cat(parts) for parts in zip(*outs)))
    return tuple(o[0] for o in out) if single else out


def _extract_chunk(idx, pos, normal, rgb, sets, off, lo, hi, geo, eps,
                   cfg, cp, es, capacity):
    """:func:`extract_pairs_banded` for a chunk of trials, on (T, es,
    CP) planes (the large axis minor, as the JAX package lays them)."""
    dev = pos.device
    nt = sets.shape[0]
    n, pc, m = pos.shape[1], idx.pc, idx.m
    total = m * m
    span = hi - lo
    span_m = torch.clamp(span, min=1)
    s = torch.arange(cp, dtype=torch.int64, device=dev)
    # scrambled slot -> band position: p is a bijection of [0, cp)
    p = ((s * _scramble_multiplier(cp)) % cp)[None, :]            # (1, CP)
    # under band overflow, walk the whole band with stride span // cp
    stride = torch.clamp(span // cp, min=1)[:, None]
    rel = (torch.remainder(off, span_m)[:, None] + p * stride) \
        % span_m[:, None]
    take = lo[:, None] + torch.where(
        (span <= cp)[:, None], torch.minimum(p, (span_m - 1)[:, None]), rel)
    take = torch.clamp(take, 0, total - 1)
    live = p < torch.clamp(span, max=cp)[:, None]                 # (T, CP)

    sp = (idx.sorted_pair[sets[:, None], take] if idx.batched
          else idx.sorted_pair[take]).long()
    ca = torch.where(live, sp // m, 0)
    cb = torch.where(live, sp % m, 0)
    # cells and member slots of every set, flattened
    cbase = (sets * m)[:, None] if idx.batched else 0
    occ = idx.occ.reshape(-1)
    occ_u = torch.clamp(occ[ca + cbase], max=pc).long()
    occ_v = torch.clamp(occ[cb + cbase], max=pc).long()

    # fixed-budget expansion: slot q of an entry maps to member pair
    # (q // occ_v, q % occ_v), rotated per trial within the entry
    prod = torch.where(live, occ_u * occ_v, 0)                    # (T, CP)
    q0 = torch.arange(es, dtype=torch.int64, device=dev)[None, :, None]
    prod_m = torch.clamp(prod, min=1)[:, None, :]                 # (T, 1, CP)
    evalid = q0 < prod[:, None, :]                                # (T, es, CP)
    qq = torch.where(evalid, (q0 + off[:, None, None]) % prod_m, 0)
    ov = torch.clamp(occ_v, min=1)[:, None, :]
    u = qq // ov
    v = qq % ov
    del qq

    members = torch.clamp(idx.members.reshape(-1), max=idx.n - 1).long()
    mrow_u = ((ca + cbase) * pc)[:, None, :]
    mrow_v = ((cb + cbase) * pc)[:, None, :]
    iu = members[mrow_u + u]                                      # point ids
    iv = members[mrow_v + v]
    del u, v
    mask = evalid & (iu != iv)
    del evalid

    pbase = (sets * n)[:, None, None]
    fu, fv = iu + pbase, iv + pbase

    def cols(t, flat_ids):
        t = t.reshape(-1, 3)
        return [t[:, c][flat_ids] for c in range(3)]

    def bc(x):
        return x[:, None, None]

    # the exact pair predicate, per coordinate (float32, in the order
    # the JAX code writes it)
    xu, xv = cols(pos, fu), cols(pos, fv)
    dx = [xv[c] - xu[c] for c in range(3)]
    d2 = (dx[0] * dx[0] + dx[1] * dx[1]) + dx[2] * dx[2]
    dist = torch.sqrt(d2)
    del d2
    if cfg.use_distance_filter:
        mask &= (dist - bc(geo["pair_distance"])).abs() <= _f32(eps)

    def sumsq(a):
        return (a[0] * a[0] + a[1] * a[1]) + a[2] * a[2]

    if cfg.max_normal_difference > 0:
        nu, nv = cols(normal, fu), cols(normal, fv)
        both = (sumsq(nu) > 0) & (sumsq(nv) > 0)
        fa = torch.sqrt(sumsq([nu[c] - nv[c] for c in range(3)]))
        sa = torch.sqrt(sumsq([nu[c] + nv[c] for c in range(3)]))
        pna = bc(geo["pna"])
        nd = torch.minimum((fa - pna).abs(), (sa - pna).abs())
        thr = _f32(0.5 * cfg.max_normal_difference * math.pi / 180.0)
        mask &= torch.where(both, nd <= thr, True)
        del nu, nv, fa, sa, nd, both

    if cfg.max_color_distance > 0:
        cu, cv = cols(rgb, fu), cols(rgb, fv)
        r0, r1 = geo["brgb0"], geo["brgb1"]
        base_has = bc((r0[:, 0] >= 0) & (r1[:, 0] >= 0))
        use_rgb = (cu[0] >= 0) & (cv[0] >= 0) & base_has
        du = torch.sqrt(sumsq([cu[c] - bc(r0[:, c]) for c in range(3)]))
        dv = torch.sqrt(sumsq([cv[c] - bc(r1[:, c]) for c in range(3)]))
        mcd = _f32(cfg.max_color_distance)
        mask &= torch.where(use_rgb, (du < mcd) & (dv < mcd), True)
        del cu, cv, du, dv, use_rgb

    if cfg.max_translation_distance > 0:
        b0, b1 = geo["b0p"], geo["b1p"]
        tu = torch.sqrt(sumsq([xu[c] - bc(b0[:, c]) for c in range(3)]))
        tv = torch.sqrt(sumsq([xv[c] - bc(b1[:, c]) for c in range(3)]))
        mtd = _f32(cfg.max_translation_distance)
        mask &= (tu < mtd) & (tv < mtd)
        del tu, tv

    if cfg.max_angle > 0:
        e = geo["b1p"] - geo["b0p"]
        seg1 = e / _norm3(e)[:, None]
        cosang = ((dx[0] * bc(seg1[:, 0]) + dx[1] * bc(seg1[:, 1]))
                  + dx[2] * bc(seg1[:, 2])) / torch.clamp(dist, min=1e-30)
        cosang = torch.clamp(cosang, -1.0, 1.0)
        mask &= torch.acos(cosang) <= _f32(cfg.max_angle * math.pi / 180.0)
        del cosang
    del xu, xv, dx, dist, fu, fv

    flat = mask.reshape(nt, -1)
    count = flat.sum(dim=1)
    iu, iv = iu.reshape(nt, -1), iv.reshape(nt, -1)
    if capacity is not None:
        sel, valid, _ = masked_indices(flat, capacity)
        pairs = torch.stack([torch.where(valid, iu.gather(1, sel), 0),
                             torch.where(valid, iv.gather(1, sel), 0)],
                            dim=-1).to(torch.int32)
        cap_dropped = torch.clamp(count - capacity, min=0)
    else:
        pairs = torch.stack([iu, iv], dim=-1).to(torch.int32)
        valid = flat
        cap_dropped = torch.zeros_like(count)

    # overflow telemetry in candidate-pair units: band entries beyond
    # the window times the mean kept occupancy product (float32, capped
    # at 2e9), the exact candidates beyond each entry's budget, and the
    # validated hits beyond capacity
    over = torch.clamp(span - cp, min=0)
    mean_prod = (prod.sum(dim=1).float()
                 / torch.clamp(live.sum(dim=1), min=1).float())
    band_unexamined = torch.clamp(over.float() * mean_prod,
                                  max=2.0e9).to(torch.int64)
    entry_over = torch.clamp(prod - es, min=0).sum(dim=1)
    dropped = band_unexamined + entry_over + cap_dropped
    return pairs, valid, count, dropped
