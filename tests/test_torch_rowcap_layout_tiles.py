"""The host-side pieces of K2x's walk (kernels/rowcap_layout.py), on the
CPU, each through its torch mirror of the kernel:

- the rejection (``reject_bounds``, ``reject_limits``,
  ``column_reject_plain``) is conservative: no rejected (row group,
  column, trial, edge) holds a hit of the plain version, on kd-ordered
  bumpy spheres with duplicate points and bands placed exactly at the
  group spheres' distances, for the squared band and the angle path's
  band; and it rejects a share of the pairs of a headline-like sample;
- the angle path's pre-band (``pre_band``) holds every float s that
  passes the exact test, enumerated by bit pattern around both of its
  ends;
- the walk over aligned tiles (``walk_chunks``) is the rotated order;
- the closed form without a predicate (``rowcap_layout_all_plain``) is
  the plain version's output;
- the whole walk (``rowcap_layout_walk``: rows in the rejection's order,
  rejected columns skipped, the pre-band, each row's bits appended in
  walk order) equals ``rowcap_layout_plain`` bit for bit."""

import numpy as np
import pytest
import torch

from super4pcs_tpu_torch.kernels import rowcap_layout as k2x
from super4pcs_tpu_torch.ops import sampling
from super4pcs_tpu_torch.ops.pairs import (PairFilterConfig,
                                           ordered_pair_mask)

from _torch_threads import one_torch_thread_per_worker  # noqa: F401

_CFGS = {
    "band": dict(),
    "angle": dict(max_angle=80.0),
    "filters": dict(max_normal_difference=40.0, max_color_distance=60.0,
                    max_translation_distance=1.5),
    "no-distance": dict(use_distance_filter=False),
    "no-distance-angle": dict(use_distance_filter=False, max_angle=90.0),
}


def _bumpy(rng, n):
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    bump = (1 + 0.3 * np.sin(5 * v[:, 0]) * np.cos(3 * v[:, 1])
            + 0.2 * np.sin(4 * v[:, 2]))
    p = (v * bump[:, None]).astype(np.float32)
    return p[sampling.kd_argsort(p)]


def _clouds(rng, g, n, dups=0):
    """G kd-ordered bumpy spheres, the last ``dups`` points of each a
    copy of its first ones (pairs at d2 = 0), with normals (10 missing)
    and colors (20 missing)."""
    pos = np.stack([_bumpy(rng, n) for _ in range(g)])
    if dups:
        pos[:, n - dups:] = pos[:, :dups]
    nrm = rng.normal(size=pos.shape).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    nrm[:, :10] = 0
    rgb = (np.abs(pos) * 200).astype(np.float32)
    rgb[:, :20] = -1
    return [torch.as_tensor(a) for a in (pos, nrm, rgb)]


def _drawn_bases(rng, clouds, nt):
    g, n = clouds[0].shape[:2]
    g_of = np.arange(nt) // (nt // g)
    ids = np.stack([rng.choice(n, 4, replace=False) for _ in range(nt)])
    return [c[torch.as_tensor(g_of)[:, None], torch.as_tensor(ids)]
            for c in clouds]


def _edge_bases(clouds, lengths):
    """Bases whose edges (0, 1) and (2, 3) lie along x with the given
    lengths (T, 2), normals and colors from each trial's cloud."""
    nt = lengths.shape[0]
    bp = torch.zeros((nt, 4, 3))
    bp[:, 1, 0] = lengths[:, 0]
    bp[:, 3, 0] = lengths[:, 1]
    g_of = torch.arange(nt) // (nt // clouds[0].shape[0])
    return [bp, clouds[1][g_of, :4], clouds[2][g_of, :4]]


def _hits(clouds, bases, eps, cfg, e0, e1, t, per_set):
    """Trial t's (n, n) ordered-pair mask of edge (e0, e1)."""
    p, nr, rg = (c[t // per_set] for c in clouds)
    bp, bn, br = (b[t] for b in bases)
    pd = torch.linalg.vector_norm(bp[e0] - bp[e1])
    pn = torch.linalg.vector_norm(bn[e0] - bn[e1])
    return ordered_pair_mask(p, nr, rg, p, nr, rg, bp[e0], bp[e1], bn[e0],
                             bn[e1], br[e0], br[e1], pd, pn, eps, cfg)


@pytest.mark.parametrize("cfg", ["band", "angle"])
def test_rejection_is_conservative(rng, cfg):
    """Bands at the group spheres' exact distances (an edge's far or near
    end on a column's distance to a group's sphere), duplicate points:
    no rejected (group, column, trial, edge) holds a hit of any row of
    the group, and the walk with rejection equals the plain version."""
    g, n, nt, eps = 2, 300, 8, 0.05
    clouds = _clouds(rng, g, n, dups=12)
    bounds = k2x.reject_bounds(clouds[0])
    tcfg = PairFilterConfig(**_CFGS[cfg])
    # lengths: one edge's far end at |b - c| - r of a (group, column) of
    # the trial's set, the other's near end at |b - c| + r
    lengths = torch.empty((nt, 2))
    for t in range(nt):
        s = t // (nt // g)
        i = int(rng.integers(0, bounds.spheres.shape[1]))
        c, r = bounds.spheres[s, i, :3], bounds.spheres[s, i, 3]
        dist = torch.linalg.vector_norm(clouds[0][s] - c, dim=1)
        j = int(rng.integers(0, n))
        lengths[t, 0] = (dist[j] - r - eps).clamp(min=0.0)
        lengths[t, 1] = dist[j] + r + eps
    lengths[0] = torch.tensor([0.0, eps])   # lo = 0 with duplicates
    bases = _edge_bases(clouds, lengths)
    geo = k2x.layout_args(*clouds, *bases, eps, tcfg)["geo"]
    lo, hi = k2x.q_band(geo, tcfg.max_angle > 0)
    rej = k2x.column_reject_plain(clouds[0], bounds, lo, hi, nt // g)
    m = bounds.spheres.shape[1]
    group_of = torch.arange(m * 32)[:n] // 32
    for e, (e0, e1) in enumerate(k2x.EDGES):
        for t in range(nt):
            hit = _hits(clouds, bases, eps, tcfg, e0, e1, t, nt // g)
            rows = bounds.perm[t // (nt // g)].long()
            per_group = torch.zeros((m, n), dtype=torch.bool)
            per_group.index_put_((group_of,), hit[rows], accumulate=True)
            assert not bool((rej[e, t] & per_group).any())
    assert bool(rej.any())
    ref = k2x.rowcap_layout_plain(*clouds, *bases, eps, tcfg, 16,
                                  row_block=64, col_offset=7)
    got = k2x.rowcap_layout_walk(*clouds, *bases, eps, tcfg, 16,
                                 row_block=64, col_offset=7, bounds=bounds)
    assert all(torch.equal(x, y) for r, w in zip(ref, got)
               for x, y in zip(r, w))


def test_reject_bounds_hold_every_row(rng):
    """Every row of a 32-row group lies inside the group's sphere (in
    float64), the order is a permutation, ``mag2`` bounds every
    ``|p|^2``; n not a multiple of 32."""
    clouds = _clouds(rng, 2, 333)
    b = k2x.reject_bounds(clouds[0])
    for s in range(2):
        perm = b.perm[s].long()
        assert torch.equal(torch.sort(perm).values, torch.arange(333))
        p = clouds[0][s][perm].double()
        c = b.spheres[s, torch.arange(333) // 32]
        d = torch.linalg.vector_norm(p - c[:, :3].double(), dim=1)
        assert bool((d <= c[:, 3].double()).all())
        assert float(b.mag2[s]) >= float((p * p).sum(1).max())


def test_rejection_skips_pairs_on_a_headline_like_sample(rng):
    """On a kd-ordered bumpy sphere of 4096 points with bases drawn from
    it and the headline's eps (2 x delta at delta 0.01), the rejection
    skips more than a quarter of the (group, column, trial, edge)
    tests."""
    clouds = _clouds(rng, 1, 4096)
    bases = _drawn_bases(rng, clouds, 4)
    cfg = PairFilterConfig()
    geo = k2x.layout_args(*clouds, *bases, 0.02, cfg)["geo"]
    lo, hi = k2x.q_band(geo, False)
    rej = k2x.column_reject_plain(clouds[0], k2x.reject_bounds(clouds[0]),
                                  lo, hi, 4)
    assert float(rej.float().mean()) > 0.25


@pytest.mark.parametrize("d,eps", [(1.0, 0.02), (0.3, 0.3), (0.01, 0.05),
                                   (0.0, 0.1), (2.5, 1e-4), (1e-3, 1e-3),
                                   (7.25, 0.5)])
def test_pre_band_is_safe(d, eps):
    """Every float s within 4096 ulps of either end of the exact test
    ``|sqrt(s) - d| <= eps`` (float32 operations) that passes lies in
    ``pre_band(d, eps)``; the band is no wider than 1e-4 relative."""
    d32 = torch.tensor(d, dtype=torch.float32)
    e32 = torch.tensor(eps, dtype=torch.float32)
    lo, hi = k2x.pre_band(d32, e32)
    ends = [float(d + eps) ** 2, max(float(d - eps), 0.0) ** 2]
    for end in ends:
        bits = torch.tensor([end], dtype=torch.float32).view(torch.int32)
        cand = (bits + torch.arange(-4096, 4097, dtype=torch.int32)
                ).clamp(min=0).view(torch.float32)
        ok = (torch.sqrt(cand) - d32).abs() <= e32
        assert bool(ok.any()) or end == 0.0
        assert bool(((cand >= lo) & (cand <= hi))[ok].all())
    assert float(hi) <= (d + eps) ** 2 * (1 + 1e-4)
    if d - eps > 0:
        assert float(lo) >= (d - eps) ** 2 * (1 - 1e-4)
    else:
        assert float(lo) == -np.inf


@pytest.mark.parametrize("tile", [k2x.TILE, k2x.FILTER_TILE])
@pytest.mark.parametrize("off", ["0", "n-1", "tile", "tile-1", "tile+1",
                                 "2tile", "mid"])
def test_walk_order_is_the_rotated_order(tile, off):
    """The aligned-tile walk gives ``off, ..., n - 1, 0, ..., off - 1``
    with n not a multiple of the tile; its chunks are 32-aligned and
    lie in one tile."""
    n = 2 * tile + 77
    o = {"0": 0, "n-1": n - 1, "tile": tile, "tile-1": tile - 1,
         "tile+1": tile + 1, "2tile": 2 * tile, "mid": tile + 45}[off]
    order = k2x.walk_order(n, o, tile)
    assert torch.equal(order, (torch.arange(n) + o) % n)
    for c0, bits in k2x.walk_chunks(n, o, tile):
        assert c0 % 32 == 0 and 0 < bits < 1 << 32
        assert c0 // tile == (c0 + bits.bit_length() - 1) // tile


@pytest.mark.parametrize("n,row_cap", [(100, 8), (100, 100), (1, 1),
                                       (70, 69)])
def test_closed_form_equals_the_plain_version(rng, n, row_cap):
    """Without a predicate the plain version's (shared) tables are the
    closed form, for offsets 0, n - 1 and drawn ones."""
    clouds = _clouds(rng, 1, max(n, 4))
    clouds = [c[:, :n] for c in clouds]
    bases = [torch.zeros((3, 4, 3)), torch.zeros((3, 4, 3)),
             torch.full((3, 4, 3), -1.0)]
    offs = torch.tensor([0, n - 1, int(rng.integers(0, n))])
    cfg = PairFilterConfig(use_distance_filter=False)
    assert not k2x.has_predicate(cfg)
    ref = k2x.rowcap_layout_plain(*clouds, *bases, 0.1, cfg, row_cap,
                                  row_block=64, col_offset=offs)
    cols, rc = k2x.rowcap_layout_all_plain(n, 64 * -(-n // 64), row_cap,
                                           offs)
    for c, h, r in ref:
        assert torch.equal(c, cols) and torch.equal(r, rc)


@pytest.mark.parametrize("cfg", list(_CFGS))
def test_walk_equals_the_plain_version(rng, cfg):
    """``rowcap_layout_walk`` over G = 2 clouds (n = 317, duplicates),
    T = 4 drawn bases, drawn offsets, without and with the rejection,
    with a row cap below and above the rows' hit counts: cols, hit and
    rc bit for bit the plain version."""
    clouds = _clouds(rng, 2, 317, dups=5)
    bases = _drawn_bases(rng, clouds, 4)
    offs = torch.as_tensor(rng.integers(0, 317, 4))
    bounds = k2x.reject_bounds(clouds[0])
    tcfg = PairFilterConfig(**_CFGS[cfg])
    for row_cap in (6, 317):
        ref = k2x.rowcap_layout_plain(*clouds, *bases, 0.1, tcfg, row_cap,
                                      row_block=64, col_offset=offs)
        for b in (None, bounds):
            got = k2x.rowcap_layout_walk(*clouds, *bases, 0.1, tcfg,
                                         row_cap, row_block=64,
                                         col_offset=offs, bounds=b)
            assert all(torch.equal(x, y) for r, w in zip(ref, got)
                       for x, y in zip(r, w))
    assert sum(int(r[2].sum()) for r in ref) > 0


@pytest.mark.parametrize("cfg", ["band", "angle"])
def test_walk_at_band_edges_on_a_lattice(cfg):
    """Points of the 1/8 lattice (squared distances exact in float32)
    with duplicates, bands whose edges are lattice distances (d = 0.5
    and 0.75, eps = 0.125): the walk with the rejection equals the plain
    version bit for bit, and pairs lie exactly on the band edges."""
    rng = np.random.default_rng(3)
    grid = np.stack(np.meshgrid(*[np.arange(-6, 7)] * 3), -1).reshape(-1, 3)
    pos = (grid[rng.choice(len(grid), 400, replace=False)] / 8).astype(
        np.float32)
    pos[-10:] = pos[:10]
    clouds = [torch.as_tensor(pos)[None], torch.zeros((1, 400, 3)),
              torch.full((1, 400, 3), -1.0)]
    bp = torch.zeros((2, 4, 3))
    bp[:, 1, 0] = 0.5
    bp[:, 3, 0] = 0.75
    bases = [bp, torch.zeros_like(bp), torch.full_like(bp, -1.0)]
    tcfg = PairFilterConfig(**_CFGS[cfg])
    d2 = ((clouds[0][0][:, None] - clouds[0][0][None]) ** 2).sum(-1)
    assert bool((d2 == 9 / 64).any() and (d2 == 49 / 64).any())
    offs = torch.tensor([0, 333])
    ref = k2x.rowcap_layout_plain(*clouds, *bases, 0.125, tcfg, 40,
                                  row_block=64, col_offset=offs)
    got = k2x.rowcap_layout_walk(*clouds, *bases, 0.125, tcfg, 40,
                                 row_block=64, col_offset=offs,
                                 bounds=k2x.reject_bounds(clouds[0]))
    assert all(torch.equal(x, y) for r, w in zip(ref, got)
               for x, y in zip(r, w))
