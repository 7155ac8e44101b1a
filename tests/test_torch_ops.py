"""Plain tensor ops of the PyTorch port against the JAX package, on the
same numpy inputs: geometry, base selection (fed the JAX draws),
masking, dense pair extraction, the dense and grid joins, refinement."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from super4pcs_tpu.ops import congruent as jc
from super4pcs_tpu.ops import geometry as jg
from super4pcs_tpu.ops import masking as jm
from super4pcs_tpu.ops import pairs as jp
from super4pcs_tpu.ops import refine as jr
from super4pcs_tpu.ops import select as js
from super4pcs_tpu_torch.kernels import rowcap as k2
from super4pcs_tpu_torch.ops import congruent as tc
from super4pcs_tpu_torch.ops import geometry as tg
from super4pcs_tpu_torch.ops import masking as tm
from super4pcs_tpu_torch.ops import pairs as tp
from super4pcs_tpu_torch.ops import refine as tr
from super4pcs_tpu_torch.ops import select as ts


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _jit(fn, *static):
    """The JAX reference function compiled as one program (eager
    dispatch compiles every primitive apart, which is slower here)."""
    return jax.jit(fn, static_argnames=static)


_grid_join = _jit(jc.find_congruent_quads_grid, "distance_threshold",
                  "cone_cos_tolerance", "capacity", "cell_candidates",
                  "q_budget", "row_cap", "probe_budget", "cell_size")
_dense_join = _jit(jc.find_congruent_quads, "distance_threshold",
                   "cone_cos_tolerance", "capacity")


def _cloud(rng, n, noise=0.0):
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    bump = 1 + 0.3 * np.sin(5 * v[:, 0]) * np.cos(3 * v[:, 1])
    pos = v * bump[:, None] + rng.normal(scale=noise, size=(n, 3))
    return (pos - pos.mean(0)).astype(np.float32)


# ---------------------------------------------------------------- geometry

def test_dist_segment_to_segment(rng):
    """Tolerance 1e-5: float32 rounding of the closed form in another
    summation order; includes parallel and degenerate segments."""
    p1, p2, q1, q2 = (rng.normal(size=(64, 3)).astype(np.float32)
                      for _ in range(4))
    q2[:8] = q1[:8] + 2.0 * (p2[:8] - p1[:8])       # parallel
    p2[8:12] = p1[8:12]                              # degenerate
    ref = jg.dist_segment_to_segment(*(jnp.asarray(a)
                                       for a in (p1, p2, q1, q2)))
    got = tg.dist_segment_to_segment(*(_t(a) for a in (p1, p2, q1, q2)))
    for r, g in zip(ref, got):
        np.testing.assert_allclose(_np(g), np.asarray(r), rtol=1e-5,
                                   atol=1e-5)


def _pairing(ids):
    """The base's two segments, unordered: the 12 orderings come in
    groups of 4 that pair the same segments (swapped or reversed) and so
    tie in exact arithmetic; which of them wins is decided by rounding,
    in the reference as here."""
    ids = [int(i) for i in ids]
    return frozenset((frozenset(ids[:2]), frozenset(ids[2:])))


def _check_choice(quad, perm, inv1, inv2, ref_perm):
    """The port chose the JAX package's segment pairing, and its
    invariants are those of its own ordering (within 1e-5)."""
    assert _pairing(perm) == _pairing(ref_perm)
    pts = jnp.asarray(quad)[jnp.asarray(perm)]
    ri1, ri2, _ = jg.dist_segment_to_segment(pts[0], pts[1], pts[2],
                                             pts[3])
    np.testing.assert_allclose(float(inv1), float(ri1), atol=1e-5)
    np.testing.assert_allclose(float(inv2), float(ri2), atol=1e-5)


def test_try_quadrilateral(rng):
    quads = rng.normal(size=(20, 4, 3)).astype(np.float32)
    perm, inv1, inv2 = tg.try_quadrilateral(_t(quads))
    for i in range(len(quads)):
        rp, _, _ = jg.try_quadrilateral(jnp.asarray(quads[i]))
        _check_choice(quads[i], _np(perm[i]), inv1[i], inv2[i],
                      np.asarray(rp))


@pytest.mark.parametrize("max_angle", [-1.0, 0.6])
def test_batched_rigid_fit(rng, make_transform, max_angle):
    """Transforms within 1e-5, rms within 1e-5, identical validity, on
    exact and perturbed congruent quads."""
    base = rng.normal(size=(4, 3)).astype(np.float32)
    cands = []
    for _ in range(30):
        m = make_transform()
        c = (base - m[:3, 3]) @ m[:3, :3]            # m maps c onto base
        cands.append(c + rng.normal(scale=0.01, size=c.shape))
    cand = np.stack(cands).astype(np.float32)
    cand[3] = cand[3, [0, 0, 1, 2]]                  # degenerate frame
    c1 = base[:3].mean(0)
    c2 = cand[:, :3].mean(1)
    rt, rr, rv = jg.batched_rigid_fit(jnp.asarray(base), jnp.asarray(cand),
                                      jnp.asarray(c1), jnp.asarray(c2),
                                      max_angle)
    gt, gr, gv = tg.batched_rigid_fit(_t(base)[None], _t(cand)[None],
                                      _t(c1)[None], _t(c2)[None],
                                      max_angle)
    np.testing.assert_array_equal(_np(gv[0]), np.asarray(rv))
    ok = np.asarray(rv)
    np.testing.assert_allclose(_np(gt[0])[ok], np.asarray(rt)[ok],
                               atol=1e-5)
    np.testing.assert_allclose(_np(gr[0]), np.asarray(rr), rtol=1e-5,
                               atol=1e-5)
    assert ok.any() and not ok.all()


def test_transform_helpers(rng, make_transform):
    m = make_transform()
    pos = rng.normal(size=(10, 3)).astype(np.float32)
    np.testing.assert_allclose(
        _np(tg.transform_points(_t(m), _t(pos))),
        np.asarray(jg.transform_points(jnp.asarray(m), jnp.asarray(pos))),
        atol=1e-6)
    args = [rng.normal(size=3).astype(np.float32) for _ in range(4)]
    np.testing.assert_allclose(
        tg.global_transform(m, *args),
        np.asarray(jg.global_transform(jnp.asarray(m), *args)), atol=1e-5)
    np.testing.assert_allclose(
        _np(tg.global_transform(_t(m), *(_t(a) for a in args))),
        tg.global_transform(m, *args), atol=1e-6)
    a = rng.normal(size=(50, 3)).astype(np.float32)
    assert (tg.estimate_diameter(a, 100, np.random.default_rng(2))
            == jg.estimate_diameter(a, 100, np.random.default_rng(2)))
    a[:5] = 0
    np.testing.assert_array_equal(tg.clean_invalid_normals(a)[0],
                                  jg.clean_invalid_normals(a)[0])


# ------------------------------------------------------------------ select

def test_select_base_fed_jax_draws(rng):
    """The same draws give the same base points, segment pairing and
    validity, and invariants within 1e-5 (see _pairing)."""
    p = _cloud(rng, 400)
    diam = 1.6
    n_tri = 200
    keys = jax.random.split(jax.random.key(7), 12)
    draws = []
    for key in keys:
        k1, k2_, k3 = jax.random.split(key, 3)
        draws.append((np.asarray(jax.random.randint(k1, (), 0, len(p))),
                      np.asarray(jax.random.randint(k2_, (n_tri,), 0,
                                                    len(p))),
                      np.asarray(jax.random.randint(k3, (n_tri,), 0,
                                                    len(p)))))
    first, seconds, thirds = (torch.as_tensor(np.stack(d)).long()
                              for d in zip(*draws))
    ids, inv1, inv2, valid = ts.select_base(_t(p), diam, first, seconds,
                                            thirds)
    for i, key in enumerate(keys):
        rid, ri1, ri2, rv = js.select_base(key, jnp.asarray(p),
                                           jnp.float32(diam), n_tri)
        assert bool(valid[i]) == bool(rv)
        got_ids = _np(ids[i])
        _check_choice(p, got_ids, inv1[i], inv2[i], np.asarray(rid))
    gen = torch.Generator().manual_seed(3)
    f, s, t = ts.draw_base_indices(gen, len(p), 4, n_tri)
    assert f.shape == (4,) and s.shape == t.shape == (4, n_tri)
    assert int(s.max()) < len(p) and int(s.min()) >= 0


# ----------------------------------------------------------------- masking

@pytest.mark.parametrize("n,cap,frac", [(1000, 64, 0.3), (1000, 512, 0.1),
                                        (5000, 100, 0.5), (10, 16, 0.0)])
def test_masked_indices(rng, n, cap, frac):
    mask = rng.uniform(size=n) < frac
    ref = _jit(jm.masked_indices, "capacity")(jnp.asarray(mask),
                                              capacity=cap)
    got = tm.masked_indices(torch.as_tensor(mask), cap)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(_np(g), np.asarray(r))
    # a mask with a leading axis is compacted row by row (the JAX
    # function vmapped over the rows)
    mask2 = rng.uniform(size=(40, 30)) < frac
    ref = jax.jit(jax.vmap(lambda m: jm.masked_indices(m, cap)))(
        jnp.asarray(mask2))
    got = tm.masked_indices(torch.as_tensor(mask2), cap)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(_np(g), np.asarray(r))


# ------------------------------------------------------------------- pairs

_CFGS = {
    "plain": dict(),
    "normals": dict(max_normal_difference=40.0),
    "color_translation": dict(max_color_distance=0.5,
                              max_translation_distance=1.4),
    "angle": dict(max_angle=60.0),
}


@pytest.mark.parametrize("cfg", sorted(_CFGS))
def test_dense_extraction(rng, cfg):
    """extract_pairs_dense_rowcap and extract_pairs (all five filters)
    give the JAX package's pairs, validity, counts and drops."""
    n = 300
    pos = _cloud(rng, n)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    nrm[:10] = 0                                      # no normal
    rgb = rng.uniform(size=(n, 3)).astype(np.float32)
    rgb[:20] = -1                                     # no color
    ids = rng.choice(n, 4, replace=False)
    jcfg = jp.PairFilterConfig(**_CFGS[cfg])
    tcfg = tp.PairFilterConfig(**_CFGS[cfg])
    jargs = [jnp.asarray(a) for a in (pos, nrm, rgb, pos[ids], nrm[ids],
                                      rgb[ids])]
    targs = [_t(a) for a in (pos, nrm, rgb, pos[ids], nrm[ids], rgb[ids])]
    b0, b1 = ids[0], ids[1]
    ref = jp.pair_emit_masks(
        *jargs[:3], jargs[0][b0], jargs[0][b1], jargs[1][b0], jargs[1][b1],
        jargs[2][b0], jargs[2][b1], jnp.linalg.norm(pos[b0] - pos[b1]),
        jnp.linalg.norm(nrm[b0] - nrm[b1]), 0.1, jcfg)
    got = tp.pair_emit_masks(
        *targs[:3], targs[0][b0], targs[0][b1], targs[1][b0], targs[1][b1],
        targs[2][b0], targs[2][b1], tp._norm(targs[0][b0] - targs[0][b1]),
        tp._norm(targs[1][b0] - targs[1][b1]), 0.1, tcfg)
    np.testing.assert_array_equal(_np(got), np.asarray(ref))
    for cap in (n * 8, 700):
        for e0, e1 in ((0, 1), (2, 3)):
            ref = jp.extract_pairs_dense_rowcap(*jargs, e0, e1, 0.1, jcfg,
                                                capacity=cap)
            got = tp.extract_pairs_dense_rowcap(*targs, e0, e1, 0.1, tcfg,
                                                capacity=cap)
            for r, g in zip(ref, got):
                np.testing.assert_array_equal(_np(g), np.asarray(r))
            ref = jp.extract_pairs(*jargs, e0, e1, 0.1, jcfg, capacity=cap)
            got = tp.extract_pairs(*targs, e0, e1, 0.1, tcfg, capacity=cap)
            for r, g in zip(ref, got):
                np.testing.assert_array_equal(_np(g), np.asarray(r))
    assert int(got[2]) > 0


# ------------------------------------------------------------------- joins

def _quad_set(quads, valid):
    return {tuple(q) for q, v in zip(_np(quads).tolist(), _np(valid)) if v}


@pytest.fixture
def join_case(rng):
    """A base drawn from a noisy copy of Q and its dense-extracted pair
    sets (the dense engine's layout)."""
    n = 400
    q = _cloud(rng, n)
    ids = np.array([3, 150, 280, 371])
    base = q[ids] + rng.normal(scale=0.003, size=(4, 3)).astype(np.float32)
    inv1, inv2, _ = (float(x) for x in jg.dist_segment_to_segment(
        *(jnp.asarray(base[i]) for i in range(4))))
    s1 = base[1] - base[0]
    s2 = base[3] - base[2]
    cos_a = float(np.dot(s1 / np.linalg.norm(s1), s2 / np.linalg.norm(s2)))
    zeros = np.zeros_like(q)
    cfg = tp.PairFilterConfig()
    ex = [tp.extract_pairs_dense_rowcap(
        _t(q), _t(zeros), _t(zeros - 1), _t(base), _t(np.zeros((4, 3))),
        _t(np.full((4, 3), -1.0)), e0, e1, 0.04, cfg, capacity=n * 16)
        for e0, e1 in ((0, 1), (2, 3))]
    return q, ex, inv1, inv2, cos_a


@pytest.mark.parametrize("cone", [0.3, -1.0])
def test_dense_join(join_case, cone):
    q, ((p1, v1, _, _), (p2, v2, _, _)), inv1, inv2, cos_a = join_case
    ref = _dense_join(
        jnp.asarray(q), jnp.asarray(_np(p1)), jnp.asarray(_np(v1)),
        jnp.asarray(_np(p2)), jnp.asarray(_np(v2)), jnp.float32(inv1),
        jnp.float32(inv2), distance_threshold=0.04,
        base_cos_alpha=jnp.float32(cos_a), cone_cos_tolerance=cone,
        capacity=4096)
    got = tc.find_congruent_quads(_t(q), p1, v1, p2, v2, torch.tensor(inv1),
                                  torch.tensor(inv2), 0.04,
                                  torch.tensor(cos_a), cone, 4096)
    assert int(got[2]) == int(ref[2]) > 0
    np.testing.assert_array_equal(_np(got[0]), np.asarray(ref[0]))
    np.testing.assert_array_equal(_np(got[1]), np.asarray(ref[1]))


def test_grid_join_dense_layout(join_case):
    """Grid join over (K, 2) pairs with a probe budget: the JAX quads,
    counts, drops and subsample volume; and a superset-free match with
    the dense oracle (same quads when no cell overflows)."""
    q, ((p1, v1, _, _), (p2, v2, _, _)), inv1, inv2, cos_a = join_case
    kw = dict(cell_candidates=16, q_budget=2048, probe_budget=4096,
              cell_size=0.08)
    ref = _grid_join(
        jnp.asarray(q), jnp.asarray(_np(p1)), jnp.asarray(_np(v1)),
        jnp.asarray(_np(p2)), jnp.asarray(_np(v2)), jnp.float32(inv1),
        jnp.float32(inv2), distance_threshold=0.04,
        base_cos_alpha=jnp.float32(cos_a), cone_cos_tolerance=0.3,
        capacity=4096, **kw)
    got = tc.find_congruent_quads_grid(
        _t(q), p1, v1, p2, v2, torch.tensor(inv1), torch.tensor(inv2),
        0.04, torch.tensor(cos_a), 0.3, 4096, **kw)
    np.testing.assert_array_equal(_np(got[0]), np.asarray(ref[0]))
    np.testing.assert_array_equal(_np(got[1]), np.asarray(ref[1]))
    for i in (2, 3, 4):
        assert int(got[i]) == int(ref[i])
    assert int(got[2]) > 0
    dense = tc.find_congruent_quads(_t(q), p1, v1, p2, v2,
                                    torch.tensor(inv1), torch.tensor(inv2),
                                    0.04, torch.tensor(cos_a), 0.3, 4096)
    if int(got[3]) == 0 and int(got[4]) == 0:
        assert _quad_set(got[0], got[1]) == _quad_set(dense[0], dense[1])


@pytest.mark.parametrize("use_hash", [True, False])
def test_grid_join_rowcap_layout(rng, use_hash):
    """Grid join over the capture kernel's cols-only tables (the
    rowcap engine's layout), with the kernel-emitted table hash on and
    off: the same quads as the JAX join fed the same tables (at these
    table sizes the JAX range search runs at full depth)."""
    n = 700
    q = _cloud(rng, n)
    base = q[[5, 300, 500, 650]]
    inv1, inv2, _ = (float(x) for x in jg.dist_segment_to_segment(
        *(jnp.asarray(base[i]) for i in range(4))))
    s1, s2 = base[1] - base[0], base[3] - base[2]
    cos_a = float(np.dot(s1 / np.linalg.norm(s1), s2 / np.linalg.norm(s2)))
    row_cap = k2.slots_for(n, 32)
    cell = 0.08
    (c1, v1, _, _), (c2, v2, _, _), h1 = k2.extract_pairs_rowcap_both(
        _t(q), _t(base), 0.04, row_cap, invariant1=torch.tensor(inv1),
        cell_size=cell)
    kw = dict(cell_candidates=16, row_cap=row_cap, probe_budget=8192,
              cell_size=cell)
    ref = _grid_join(
        jnp.asarray(q), jnp.asarray(_np(c1).astype(np.int32)),
        jnp.asarray(_np(v1)), jnp.asarray(_np(c2).astype(np.int32)),
        jnp.asarray(_np(v2)), jnp.float32(inv1), jnp.float32(inv2),
        distance_threshold=0.04, base_cos_alpha=jnp.float32(cos_a),
        cone_cos_tolerance=0.3, capacity=4096,
        table_hash=jnp.asarray(_np(h1)) if use_hash else None, **kw)
    got = tc.find_congruent_quads_grid(
        _t(q), c1, v1, c2, v2, torch.tensor(inv1), torch.tensor(inv2),
        0.04, torch.tensor(cos_a), 0.3, 4096,
        table_hash=h1 if use_hash else None, **kw)
    assert _quad_set(got[0], got[1]) == _quad_set(ref[0], ref[1])
    np.testing.assert_array_equal(_np(got[0]), np.asarray(ref[0]))
    for i in (2, 3, 4):
        assert int(got[i]) == int(ref[i])
    assert int(got[2]) > 0


def test_grid_join_hash_on_equals_off(rng):
    """The kernel-emitted table hash gives the join what its own hash
    stage computes: identical outputs with it on and off."""
    n = 2100
    q = _cloud(rng, n)
    base = q[[11, 700, 1300, 1900]]
    inv1, inv2 = 0.4, 0.6
    row_cap = k2.slots_for(n, 32)
    (c1, v1, _, _), (c2, v2, _, _), h1 = k2.extract_pairs_rowcap_both(
        _t(q), _t(base), 0.04, row_cap, invariant1=torch.tensor(inv1),
        cell_size=0.08)
    outs = [tc.find_congruent_quads_grid(
        _t(q), c1, v1, c2, v2, torch.tensor(inv1), torch.tensor(inv2),
        0.04, torch.tensor(0.2), -1.0, 4096, row_cap=row_cap,
        cell_size=0.08, table_hash=h) for h in (h1, None)]
    for a, b in zip(*outs):
        np.testing.assert_array_equal(_np(a), _np(b))


def test_join_helpers(rng):
    pos = rng.normal(size=(30, 3)).astype(np.float32)
    pairs = rng.integers(0, 30, size=(50, 2))
    for r, c in ((0.02, 0.08), (0.04, 0.08), (0.08, 0.08), (0.1, None)):
        assert tc.probe_window(r, c) == jc.probe_window(r, c)
    np.testing.assert_array_equal(tc._window_offsets(3),
                                  jc._window_offsets(3))
    args = (_t(pos), torch.as_tensor(pairs), torch.ones(50, dtype=torch.bool),
            torch.as_tensor(pairs), torch.ones(50, dtype=torch.bool), 0.3,
            0.3, 0.1, 0.5, 0.3, 64)
    # the scale-mode table and probe walk run (parity:
    # tests/test_torch_scale.py); the implicit table needs its row_cap,
    # as in the JAX package
    with pytest.raises(ValueError):
        tc.find_congruent_quads_grid(*args, allpairs_cols=True)
    walk = tc.find_congruent_quads_grid(*args, q_uniform=True, q_rot=7)
    assert walk[0].shape == (64, 4) and int(walk[4]) == 0
    # HEALPix bins run in both joins (parity: tests/test_torch_healpix.py)
    grid = tc.find_congruent_quads_grid(*args, direction_bins="healpix")
    dense = tc.find_congruent_quads(*args, direction_bins="healpix")
    assert grid[0].shape == dense[0].shape == (64, 4)
    assert int(grid[2]) == int(dense[2])


# ------------------------------------------------------------------ refine

def test_refine_transform(rng, make_transform):
    """Trimmed ICP from a perturbed pose: the JAX package's refined
    transform within 1e-4 (float32 SVD and reductions in another
    order), at start_factor 1 and 2."""
    p = _cloud(rng, 900)
    q = p[:600] + rng.normal(scale=0.002, size=(600, 3)).astype(np.float32)
    m = np.eye(4, dtype=np.float32)
    ang = 0.03
    m[:3, :3] = [[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang),
                                                  0], [0, 0, 1]]
    m[:3, 3] = [0.01, -0.005, 0.008]
    for sf in (1.0, 2.0):
        ref = jr.refine_transform(jnp.asarray(m), jnp.asarray(q),
                                  jnp.asarray(p), 0.02, iters=6,
                                  start_factor=sf)
        got = tr.refine_transform(_t(m), _t(q), _t(p), 0.02, iters=6,
                                  start_factor=sf)
        np.testing.assert_allclose(_np(got), np.asarray(ref), atol=1e-4)
    idx, d2 = tr._nearest(_t(q), _t(p), p_block=256)
    ridx, rd2 = jr._nearest(jnp.asarray(q), jnp.asarray(p), p_block=256)
    np.testing.assert_array_equal(_np(idx), np.asarray(ridx))
    np.testing.assert_allclose(_np(d2), np.asarray(rd2), rtol=1e-5,
                               atol=1e-9)


@pytest.mark.parametrize("estimate_scale", [False, True])
@pytest.mark.parametrize("sf", [1.0, 2.0])
def test_refine_walk_loop_against_jax(rng, sf, estimate_scale):
    """The refine as the card runs it, its neighbours from the walk of
    P's cell index at the trim radius (the plain version, bit for bit
    the kernel), held directly to the JAX package's refined transform
    within 1e-4, on test_refine_transform's data (with
    tests/test_torch_scale.py's scale in similarity mode)."""
    s = 1.3 if estimate_scale else 1.0
    p = _cloud(rng, 900)
    q = (p[:600] / s
         + rng.normal(scale=0.002, size=(600, 3))).astype(np.float32)
    m = np.eye(4, dtype=np.float32)
    ang = 0.03
    m[:3, :3] = (1.27 if estimate_scale else 1.0) * np.array(
        [[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0],
         [0, 0, 1]])
    m[:3, 3] = [0.01, -0.005, 0.008]
    ref = jr.refine_transform(jnp.asarray(m), jnp.asarray(q),
                              jnp.asarray(p), 0.02, iters=6,
                              start_factor=sf,
                              estimate_scale=estimate_scale)
    walk = tr._walk(_t(q), _t(p), tr.trim_radius(0.02, 6, sf), None)
    got = tr._icp(_t(m), _t(q), tr._radii(0.02, 6, sf), walk,
                  estimate_scale)
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=1e-4)
