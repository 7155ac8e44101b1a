"""K2 (band capture) of the PyTorch port against the JAX package's
Pallas capture kernel run in interpret mode (unfiltered, kd-ordered,
edge 0 with the fused join hash).

cols, rc and h1 must be bit-identical row for row, except rows holding
a pair whose float64 d^2 lies within 4 ulp (float32) of lo^2 or hi^2:
the Pallas kernel forms the dot product with an MXU contraction whose
summation order is XLA's, the port writes it out as
(ax bx + ay by) + az bz, so a pair exactly on a band edge may fall on
either side. Such rows are excluded and counted; they must be rare.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from super4pcs_tpu.kernels import rowcap_pallas
from super4pcs_tpu.ops import sampling as jax_sampling
from super4pcs_tpu_torch.kernels import rowcap as k2


def _cloud(rng, n):
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    bump = 1 + 0.3 * np.sin(5 * v[:, 0]) * np.cos(3 * v[:, 1])
    pos = (v * bump[:, None]).astype(np.float32)
    pos = pos - pos.mean(0)
    return pos[jax_sampling.kd_argsort(pos)]


def _edge_rows(pos, base, eps):
    """Rows with a pair whose float64 d^2 is within 4 float32 ulp of
    lo^2 or hi^2 of either edge."""
    p = pos.astype(np.float64)
    d2 = ((p[:, None, :] - p[None, :, :]) ** 2).sum(-1)
    rows = np.zeros(len(pos), bool)
    for e0, e1 in ((0, 1), (2, 3)):
        d = np.float32(np.linalg.norm(base[e0] - base[e1]))
        for lim in (np.float32(max(d - np.float32(eps), 0)),
                    np.float32(d + np.float32(eps))):
            l2 = np.float32(lim * lim)
            near = np.abs(d2 - l2) <= 4 * np.spacing(l2)
            rows |= near.any(1)
    return rows


@pytest.mark.parametrize("n,target_cap", [(700, 24), (2500, 40)])
def test_capture_bit_identical_to_pallas_interpreted(rng, n, target_cap):
    pos = _cloud(rng, n)
    base = pos[rng.choice(n, 4, replace=False)]
    eps = 0.05
    inv1, cell = 0.37, 0.08
    row_cap = rowcap_pallas.slots_for(n, target_cap)
    assert k2.slots_for(n, target_cap) == row_cap
    ref = rowcap_pallas.extract_pairs_rowcap_pallas_both(
        jnp.asarray(pos), jnp.asarray(base), eps, row_cap,
        interpret=True, invariant1=jnp.float32(inv1), cell_size=cell)
    got = k2.extract_pairs_rowcap_both(
        torch.as_tensor(pos), torch.as_tensor(base), eps, row_cap,
        invariant1=torch.tensor(inv1), cell_size=cell)
    n_pad = ((n + 2047) // 2048) * 2048
    keep = np.ones(n_pad, bool)
    keep[:n] = ~_edge_rows(pos, base, eps)
    assert keep[:n].mean() > 0.97          # excluded rows are rare
    for e in range(2):
        rc_, rv, rcount, rdrop = (np.asarray(x) for x in ref[e])
        gc, gv, gcount, gdrop = (x.numpy() for x in got[e])
        np.testing.assert_array_equal(
            gc.reshape(n_pad, row_cap)[keep],
            rc_.reshape(n_pad, row_cap)[keep])
        np.testing.assert_array_equal(
            gv.reshape(n_pad, row_cap)[keep],
            rv.reshape(n_pad, row_cap)[keep])
        if keep.all():
            assert int(gcount) == int(rcount)
            assert int(gdrop) == int(rdrop)
        assert int(rcount) > 0 and int(rdrop) > 0   # the cap binds
    h_ref = np.asarray(ref[2]).reshape(n_pad, row_cap)
    h_got = got[2].numpy().reshape(n_pad, row_cap)
    np.testing.assert_array_equal(h_got[keep], h_ref[keep])
    assert (h_got == k2.SENT).any() and (h_got != k2.SENT).any()


@pytest.mark.parametrize("n", [700, 2500])
def test_kernel_tables_bit_identical_to_capture_edge(rng, n):
    """Per-row tables of one edge — cols, the exact counts rc and the
    hash h — against the Pallas ``_capture_edge`` (interpret mode, tile
    rejection on, which must not change its output)."""
    pos = _cloud(rng, n)
    b = pos[rng.choice(n, 2, replace=False)]
    d = np.float32(np.linalg.norm(b[0] - b[1]))
    lo2 = np.float32(max(d - np.float32(0.05), 0)) ** 2
    hi2 = np.float32(d + np.float32(0.05)) ** 2
    row_cap = k2.slots_for(n, 24)
    n_pad = ((n + 2047) // 2048) * 2048
    q8t = np.zeros((8, n_pad), np.float32)
    q8t[:3, :n] = pos.T
    q8t[0, n:] = 1.0e18
    geo = np.array([[lo2, hi2, 0.61, 0.07, 0, 0, 0, 0]], np.float32)
    jpos = jnp.asarray(pos)
    ref = rowcap_pallas._capture_edge(
        jnp.asarray(q8t), jnp.zeros((8, 8)), jnp.zeros((2, 8)),
        jnp.zeros((2, 8)), jnp.asarray(geo),
        rowcap_pallas._tile_bounds(jpos, n_pad, 256),
        rowcap_pallas._tile_bounds(jpos, n_pad, 512), row_cap=row_cap,
        n_real=n, emit_hash=True, use_reject=True, interpret=True)
    got = k2.rowcap_capture(torch.as_tensor(pos), float(lo2), float(hi2),
                            row_cap, inv=0.61, cell=0.07, emit_hash=True)
    p64 = pos.astype(np.float64)
    d2 = ((p64[:, None] - p64[None]) ** 2).sum(-1)
    edge = np.zeros(n_pad, bool)
    for l2 in (lo2, hi2):
        edge[:n] |= (np.abs(d2 - l2) <= 4 * np.spacing(l2)).any(1)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy()[~edge],
                                      np.asarray(r)[~edge])
    assert int(got[1].sum()) > int((got[0] >= 0).sum()) > 0


def test_capture_counts_and_order_match_float64_oracle(rng):
    """Exact per-row counts, and each segment's first hits in column
    order, against a float64 oracle of the band (rows on a band edge
    excluded as above)."""
    n = 900
    pos = _cloud(rng, n)
    base = pos[rng.choice(n, 4, replace=False)]
    eps = 0.06
    row_cap = k2.slots_for(n, 8)                 # 4 segments x 2 slots
    (c0, v0, count0, drop0), _ = k2.extract_pairs_rowcap_both(
        torch.as_tensor(pos), torch.as_tensor(base), eps, row_cap)
    p = pos.astype(np.float64)
    d = np.sqrt(((p[:, None] - p[None]) ** 2).sum(-1))
    dd = np.float64(np.linalg.norm(base[0] - base[1]))
    band = (d >= max(dd - eps, 0)) & (d <= dd + eps)
    np.fill_diagonal(band, False)
    ok = ~_edge_rows(pos, base, eps)
    cols = c0.numpy().reshape(-1, row_cap)[:n]
    valid = v0.numpy().reshape(-1, row_cap)[:n]
    for i in np.nonzero(ok)[0]:
        want = []
        for s in range(4):
            hits = np.nonzero(band[i, s * 512:(s + 1) * 512])[0]
            want += [s * 512 + j for j in hits[:2]]
        assert sorted(cols[i][valid[i]].tolist()) == want
    assert int(count0) >= int(band[ok].sum())
    assert int(count0) - int(drop0) == int(valid.sum())


@pytest.mark.parametrize("n,cap", [(10, 1), (2048, 16), (2049, 16),
                                   (8192, 160), (40000, 128),
                                   (65536, 100)])
def test_slots_for_matches_jax(n, cap):
    assert k2.slots_for(n, cap) == rowcap_pallas.slots_for(n, cap)


def test_hash_int32_wrap_matches_jax_cell_hash():
    """cell_hash_of wraps like the JAX package's int32 _cell_hash,
    including cells whose products overflow int32."""
    from super4pcs_tpu.ops import congruent as jax_cong
    rng = np.random.default_rng(1)
    cells = rng.integers(-200000, 200000, size=(500, 3)).astype(np.int32)
    ref = np.asarray(jax_cong._cell_hash(jnp.asarray(cells)))
    e = [torch.as_tensor(cells[:, c].astype(np.float32) + 0.5)
         for c in range(3)]
    got = k2.cell_hash_of(e, torch.tensor(1.0)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert got.dtype == np.int32 and (got < 0).any()


# --- filtered capture (K2d) and tile-pair rejection (K2c) -------------

#: the filter configurations of tests/test_rowcap_pallas.py:199-228
_FILTERS = {
    "normals": dict(max_normal_difference=25.0),
    "color_translation": dict(max_color_distance=120.0,
                              max_translation_distance=1.1),
    "angle": dict(max_angle=70.0),
    "all": dict(max_normal_difference=40.0, max_color_distance=150.0,
                max_translation_distance=1.3, max_angle=80.0),
}

# float32 ulp of the operands' scale (|pos| and |n|^2 sums stay below 2)
_TOL = 4 * float(np.spacing(np.float32(2.0)))


def _sphere700(rng):
    """The 700-point cloud of tests/test_rowcap_pallas.py:29-36."""
    v = rng.normal(size=(700, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    bump = 1 + 0.3 * np.sin(5 * v[:, 0]) * np.cos(3 * v[:, 1])
    pos = (v * bump[:, None]).astype(np.float32)
    return pos - pos.mean(0)


def _filter_inputs(rng, pos, name):
    """Normals and colors of one configuration, as
    tests/test_rowcap_pallas.py:199-228 makes them (zero normals and
    rgb -1 where a configuration has none)."""
    normal = np.zeros_like(pos)
    rgb = np.full_like(pos, -1.0)
    if name in ("normals", "all"):
        normal = rng.normal(size=pos.shape).astype(np.float32)
        normal /= np.linalg.norm(normal, axis=1, keepdims=True)
        if name == "normals":
            normal[::7] = 0.0    # invalid normals take the escape path
    if name in ("color_translation", "all"):
        rgb = rng.uniform(0, 255, size=pos.shape).astype(np.float32)
        if name == "color_translation":
            rgb[::5] = -1.0      # colorless points take the escape path
    return normal, rgb


def _near_threshold_rows(pos, normal, rgb, base, bnorm, brgb, eps, cfg):
    """Rows holding a pair whose float64 test quantity lies within 4
    float32 ulp of a band edge or of a filter threshold, on either edge:
    the band's d^2 against lo^2 / hi^2 (ulp of the limit); the normal
    band's sqrt arguments |n_i -+ n_j|^2 against (a -+ thr)^2, and the
    angle test's (b.seg - a.seg) - cmax |b - a| against 0 (ulp of 2, the
    operands' scale); a color or translation distance against its
    threshold (ulp of the threshold)."""
    p = pos.astype(np.float64)
    d2 = ((p[:, None] - p[None]) ** 2).sum(-1)
    rows = np.zeros(len(pos), bool)
    mnd = cfg.get("max_normal_difference", -1.0)
    mcd = cfg.get("max_color_distance", -1.0)
    mtd = cfg.get("max_translation_distance", -1.0)
    mang = cfg.get("max_angle", -1.0)
    for e0, e1 in ((0, 1), (2, 3)):
        d = np.float32(np.linalg.norm(base[e0] - base[e1]))
        lo2 = np.float32(max(d - np.float32(eps), 0)) ** 2
        hi2 = np.float32(d + np.float32(eps)) ** 2
        near = np.zeros_like(d2, bool)
        for l2 in (lo2, hi2):
            near |= np.abs(d2 - l2) <= 4 * np.spacing(l2)
        band = (d2 >= lo2 - _TOL) & (d2 <= hi2 + _TOL)
        if mnd > 0:
            n = normal.astype(np.float64)
            a = np.linalg.norm(bnorm[e0].astype(np.float64)
                               - bnorm[e1].astype(np.float64))
            thr = np.float32(0.5 * mnd * np.pi / 180.0)
            xs = [((n[:, None] - s * n[None]) ** 2).sum(-1)
                  for s in (1.0, -1.0)]
            for x in xs:
                for lim in ((a - thr) ** 2, (a + thr) ** 2):
                    near |= band & (np.abs(x - lim) <= _TOL)
        for thr, vals, ref in ((mcd, rgb, brgb), (mtd, pos, base)):
            if thr > 0:
                v = vals.astype(np.float64)
                for role, b in ((0, e0), (1, e1)):
                    dist = np.linalg.norm(v - ref[b].astype(np.float64),
                                          axis=1)
                    pt = np.abs(dist - thr) <= 4 * np.spacing(
                        np.float32(thr))
                    near |= band & (pt[:, None] if role == 0
                                    else pt[None, :])
        if mang > 0:
            seg = (base[e1] - base[e0]).astype(np.float64)
            seg /= np.linalg.norm(seg)
            proj = p @ seg
            g = ((proj[None, :] - proj[:, None])
                 - np.cos(mang * np.pi / 180.0) * np.sqrt(d2))
            near |= band & (np.abs(g) <= _TOL)
        np.fill_diagonal(near, False)
        rows |= near.any(1)
    return rows


def _both(pos, base, eps, row_cap, normal, rgb, bnorm, brgb, cfg,
          **kw):
    return k2.extract_pairs_rowcap_both(
        torch.as_tensor(pos), torch.as_tensor(base), eps, row_cap,
        normal=torch.as_tensor(normal), rgb=torch.as_tensor(rgb),
        base_norm=torch.as_tensor(bnorm), base_rgb=torch.as_tensor(brgb),
        **cfg, **kw)


@pytest.mark.parametrize("name", list(_FILTERS))
def test_filtered_capture_bit_identical_to_pallas_interpreted(rng, name):
    """(i) Filtered capture of both edges (edge 0 with the join hash,
    the row cap binding) against the Pallas kernel in interpret mode,
    and edge 0's per-row tables (cols, rc, h) against ``_capture_edge``
    fed the same filter planes: bit-identical outside the rows of
    _near_threshold_rows, which must stay under 3% of all rows. XLA:CPU
    contracts the normal dot and pos . seg into FMAs where the port
    rounds every operation, so a pair that close to a threshold may fall
    on either side."""
    pos = _sphere700(rng)
    normal, rgb = _filter_inputs(rng, pos, name)
    ids = rng.choice(len(pos), 4, replace=False)
    base, bnorm, brgb = pos[ids], normal[ids], rgb[ids]
    cfg = _FILTERS[name]
    eps, inv1, cell = 0.05, 0.37, 0.08
    n = len(pos)
    row_cap = k2.slots_for(n, 24)
    ref = rowcap_pallas.extract_pairs_rowcap_pallas_both(
        jnp.asarray(pos), jnp.asarray(base), eps, row_cap,
        interpret=True, invariant1=jnp.float32(inv1), cell_size=cell,
        normal=jnp.asarray(normal), rgb=jnp.asarray(rgb),
        base_norm=jnp.asarray(bnorm), base_rgb=jnp.asarray(brgb), **cfg)
    got = _both(pos, base, eps, row_cap, normal, rgb, bnorm, brgb, cfg,
                invariant1=torch.tensor(inv1), cell_size=cell)
    n_pad = 2048
    keep = np.ones(n_pad, bool)
    keep[:n] = ~_near_threshold_rows(pos, normal, rgb, base, bnorm, brgb,
                                     eps, cfg)
    assert keep[:n].mean() > 0.97          # excluded rows are rare
    hits = 0
    for e in range(2):
        rcols, rvalid = (np.asarray(x).reshape(n_pad, row_cap)
                         for x in ref[e][:2])
        gcols, gvalid = (x.numpy().reshape(n_pad, row_cap)
                         for x in got[e][:2])
        np.testing.assert_array_equal(gcols[keep], rcols[keep])
        np.testing.assert_array_equal(gvalid[keep], rvalid[keep])
        if keep.all():
            assert int(got[e][2]) == int(ref[e][2])
        hits += int(got[e][2])
    h_ref = np.asarray(ref[2]).reshape(n_pad, row_cap)
    h_got = got[2].numpy().reshape(n_pad, row_cap)
    np.testing.assert_array_equal(h_got[keep], h_ref[keep])
    # per-row tables of edge 0 (cols, the exact counts rc, h) from
    # _capture_edge and rowcap_capture fed the same filter planes
    use_n = "max_normal_difference" in cfg
    use_rc = "max_color_distance" in cfg or "max_translation_distance" in cfg
    use_a = "max_angle" in cfg
    d = np.float32(np.linalg.norm(base[0] - base[1]))
    lo2 = np.float32(max(d - np.float32(eps), 0)) ** 2
    hi2 = np.float32(d + np.float32(eps)) ** 2
    seg = (base[1] - base[0]) / np.linalg.norm(base[1] - base[0])
    aux = np.stack([(pos * seg).sum(1), (normal * normal).sum(1)])
    rcs = np.array(rowcap_pallas._filter_scores(
        jnp.asarray(pos), jnp.asarray(rgb), jnp.asarray(base),
        jnp.asarray(brgb), 0, 1, cfg.get("max_color_distance", -1.0),
        cfg.get("max_translation_distance", -1.0)))
    nang = np.float32(np.linalg.norm(bnorm[0] - bnorm[1]))
    nthr = np.float32(0.5 * cfg.get("max_normal_difference", 0) * np.pi
                      / 180.0)
    cmax = np.float32(np.cos(cfg.get("max_angle", 0) * np.pi / 180.0))

    def padded(rows, k):
        out = np.zeros((k, n_pad), np.float32)
        out[:rows.shape[0], :n] = rows
        return out

    q8t = padded(pos.T, 8)
    q8t[0, n:] = 1.0e18
    jpos = jnp.asarray(pos)
    ref_t = rowcap_pallas._capture_edge(
        jnp.asarray(q8t),
        jnp.asarray(padded(normal.T, 8) if use_n else np.zeros((8, 8))),
        jnp.asarray(padded(aux, 2) if use_n or use_a else np.zeros((2, 8))),
        jnp.asarray(padded(rcs, 2) if use_rc else np.zeros((2, 8))),
        jnp.asarray([[lo2, hi2, inv1, cell, nang, nthr, cmax, 0]],
                    jnp.float32),
        rowcap_pallas._tile_bounds(jpos, n_pad, 256),
        rowcap_pallas._tile_bounds(jpos, n_pad, 512), row_cap=row_cap,
        n_real=n, emit_hash=True, use_normals=use_n, use_rowcol=use_rc,
        use_angle=use_a, interpret=True)
    got_t = k2.rowcap_capture(
        torch.as_tensor(pos), float(lo2), float(hi2), row_cap, inv=inv1,
        cell=cell, emit_hash=True,
        normals=torch.as_tensor(normal) if use_n else None,
        aux=torch.as_tensor(aux.astype(np.float32)),
        rcscore=torch.as_tensor(rcs) if use_rc else None,
        nang=float(nang), nthr=float(nthr),
        cmax=float(cmax) if use_a else None)
    for r, g in zip(ref_t, got_t):
        np.testing.assert_array_equal(g.numpy()[keep], np.asarray(r)[keep])
    # the filters bite: fewer pairs than the unfiltered capture
    plain = k2.extract_pairs_rowcap_both(
        torch.as_tensor(pos), torch.as_tensor(base), eps, row_cap)
    assert 0 < hits < int(plain[0][2]) + int(plain[1][2])


@pytest.mark.parametrize("name", list(_FILTERS))
def test_filtered_capture_matches_dense_oracle(rng, name):
    """(ii) The same captures with an ample per-segment quota against
    the JAX package's dense ``extract_pairs`` with the same filters (the
    check of tests/test_rowcap_pallas.py:144-196): exact counts, equal
    pair sets, and captured + dropped == count."""
    from super4pcs_tpu.ops.pairs import PairFilterConfig, extract_pairs
    pos = _sphere700(rng)
    normal, rgb = _filter_inputs(rng, pos, name)
    n = len(pos)
    ids = rng.choice(n, 4, replace=False)
    base, bnorm, brgb = pos[ids], normal[ids], rgb[ids]
    cfg = _FILTERS[name]
    eps = 0.05
    jcfg = PairFilterConfig(use_distance_filter=True, **cfg)
    oracle = []
    worst = 8
    for e0, e1 in ((0, 1), (2, 3)):
        pairs, valid, count, _ = extract_pairs(
            jnp.asarray(pos), jnp.asarray(normal), jnp.asarray(rgb),
            jnp.asarray(base), jnp.asarray(bnorm), jnp.asarray(brgb),
            e0, e1, eps, jcfg, capacity=n * 256)
        oset = {tuple(p) for p, v in zip(np.asarray(pairs),
                                         np.asarray(valid)) if v}
        oracle.append((oset, int(count)))
        if oset:
            worst = max(worst, int(np.unique([p[0] for p in oset],
                                             return_counts=True)[1].max()))
    row_cap = k2.slots_for(n, worst * 4)
    got = _both(pos, base, eps, row_cap, normal, rgb, bnorm, brgb, cfg)
    for (cols, valid, count, dropped), (oset, ocount) in zip(got, oracle):
        assert int(count) == ocount
        u = np.arange(len(cols)) // row_cap
        pairs = {(int(a), int(b)) for a, b, v in zip(
            u, cols.numpy(), valid.numpy()) if v}
        assert pairs == oset
        assert len(pairs) + int(dropped) == ocount
        assert int(dropped) == 0
    assert oracle[0][1] + oracle[1][1] > 0


def test_tile_rejection_never_drops_a_pair(rng):
    """(iii) On a kd-ordered 2500-point cloud, tile_reject_mask rejects
    a good share of the (row tile, column segment) pairs, no pair in the
    band (the capture's own d^2) lies in a rejected one, and the port's
    capture equals the Pallas kernel's with its rejection on (interpret
    mode, all four filters; rows near a threshold excluded as above).
    The capture with tile_reject on equals the one with it off."""
    pos = _cloud(rng, 2500)
    n, n_pad = len(pos), 4096
    normal, rgb = _filter_inputs(rng, pos, "all")
    ids = rng.choice(n, 4, replace=False)
    base, bnorm, brgb = pos[ids], normal[ids], rgb[ids]
    cfg = _FILTERS["all"]
    eps = 0.03
    tpos = torch.as_tensor(pos)
    rowb, colb = k2.reject_bounds(tpos)
    assert rowb.shape == (16, 4) and colb.shape == (8, 4)
    q = np.zeros((n_pad, 3), np.float32)
    q[:n] = pos
    q[n:, 0] = 1.0e18
    tq = torch.as_tensor(q)
    sq = (tq[:, 0] * tq[:, 0] + tq[:, 1] * tq[:, 1]) + tq[:, 2] * tq[:, 2]
    dot = ((tq[:, None, 0] * tq[None, :, 0] + tq[:, None, 1] * tq[None, :, 1])
           + tq[:, None, 2] * tq[None, :, 2])
    d2 = (sq[:, None] + sq[None, :]) - 2.0 * dot
    fired = 0.0
    for e0, e1 in ((0, 1), (2, 3)):
        d = torch.linalg.vector_norm(torch.as_tensor(base[e0] - base[e1]))
        lo2 = torch.clamp(d - eps, min=0.0) ** 2
        hi2 = (d + eps) ** 2
        mask = k2.tile_reject_mask(rowb, colb, lo2, hi2)
        fired = max(fired, float(mask.float().mean()))
        hit = (d2 >= lo2) & (d2 <= hi2)
        hit[n:] = False
        hit[:, n:] = False
        per_tile = hit.view(16, 256, 8, 512).any(3).any(1)
        assert not (per_tile & mask).any()
    assert fired > 0.3
    row_cap = k2.slots_for(n, 8)
    on = _both(pos, base, eps, row_cap, normal, rgb, bnorm, brgb, cfg,
               tile_reject=True, bounds=(rowb, colb))
    off = _both(pos, base, eps, row_cap, normal, rgb, bnorm, brgb, cfg,
                tile_reject=False)
    for a, b in zip(on, off):
        for xa, xb in zip(a, b):
            assert torch.equal(xa, xb)
    ref = rowcap_pallas.extract_pairs_rowcap_pallas_both(
        jnp.asarray(pos), jnp.asarray(base), eps, row_cap,
        interpret=True, normal=jnp.asarray(normal), rgb=jnp.asarray(rgb),
        base_norm=jnp.asarray(bnorm), base_rgb=jnp.asarray(brgb),
        tile_reject=True, **cfg)
    keep = np.ones(n_pad, bool)
    keep[:n] = ~_near_threshold_rows(pos, normal, rgb, base, bnorm, brgb,
                                     eps, cfg)
    assert keep[:n].mean() > 0.97
    for e in range(2):
        np.testing.assert_array_equal(
            on[e][0].numpy().reshape(n_pad, row_cap)[keep],
            np.asarray(ref[e][0]).reshape(n_pad, row_cap)[keep])
        assert int(on[e][2]) > 0


def test_filter_scores_match_jax(rng):
    """(iv) filter_scores against the JAX package's _filter_scores: the
    same -10 / 0 / 1 / 2 codes for every point, except where a color or
    translation distance lies within 4 float32 ulp of its threshold."""
    pos = _sphere700(rng)
    rgb = rng.uniform(0, 255, size=pos.shape).astype(np.float32)
    rgb[::5] = -1.0
    ids = rng.choice(np.nonzero(rgb[:, 0] >= 0)[0], 4, replace=False)
    base, brgb = pos[ids], rgb[ids]
    brgb[3] = -1.0              # edge (2, 3) takes the no-color escape
    codes = set()
    for e0, e1, mcd, mtd in ((0, 1, 120.0, 1.1), (2, 3, 150.0, 1.0),
                             (0, 1, -1.0, 0.9)):
        ref = np.asarray(rowcap_pallas._filter_scores(
            jnp.asarray(pos), jnp.asarray(rgb), jnp.asarray(base),
            jnp.asarray(brgb), e0, e1, mcd, mtd))
        got = k2.filter_scores(torch.as_tensor(pos), torch.as_tensor(rgb),
                               torch.as_tensor(base), torch.as_tensor(brgb),
                               e0, e1, mcd, mtd).numpy()
        assert got.shape == (2, len(pos)) and got.dtype == np.float32
        near = np.zeros((2, len(pos)), bool)
        for thr, vals, ref_pts in ((mcd, rgb, brgb), (mtd, pos, base)):
            if thr > 0:
                for r, b in enumerate((e0, e1)):
                    dist = np.linalg.norm(vals.astype(np.float64)
                                          - ref_pts[b], axis=1)
                    near[r] |= np.abs(dist - thr) <= 4 * np.spacing(
                        np.float32(thr))
        np.testing.assert_array_equal(got[~near], ref[~near])
        codes |= set(np.unique(got).tolist())
    assert codes == {-10.0, 0.0, 1.0, 2.0}


@pytest.mark.parametrize("n", [700, 2500])
def test_tile_bounds_and_reject_mask_match_jax(rng, n):
    """(iv) tile_bounds against _tile_bounds (empty tiles included:
    c = 1e18, r = 0) to 1e-6, and tile_reject_mask against the Pallas
    kernel's predicate evaluated on the same bounds, except tile pairs
    within 1e-6 of the slack (the reductions round in another order)."""
    pos = _cloud(rng, n)
    n_pad = ((n + 2047) // 2048) * 2048
    for tile in (256, 512):
        ref = np.asarray(rowcap_pallas._tile_bounds(jnp.asarray(pos),
                                                    n_pad, tile))
        got = k2.tile_bounds(torch.as_tensor(pos), n_pad, tile).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
        assert (got[:, 0] == 1e18).any() and (got[:, 3] == 0).any()
    rowb, colb = (k2.tile_bounds(torch.as_tensor(pos), n_pad, t)
                  for t in (256, 512))
    rb, cb = rowb.numpy().astype(np.float64), colb.numpy().astype(np.float64)
    dc = np.linalg.norm(rb[:, None, :3] - cb[None, :, :3], axis=-1)
    rsum = rb[:, None, 3] + cb[None, :, 3]
    for lo, hi in ((0.3, 0.36), (0.0, 0.1), (1.1, 1.2)):
        got = k2.tile_reject_mask(rowb, colb, lo * lo, hi * hi).numpy()
        slack = 1e-5 * (hi + dc) + 1e-12
        far = dc - rsum - (hi + slack)
        close = (lo - slack) - (dc + rsum)
        want = (far > 0) | (close > 0)
        sure = (np.abs(far) > 1e-6) & (np.abs(close) > 1e-6)
        np.testing.assert_array_equal(got[sure], want[sure])
    assert want.any()
