"""Similarity mode (``estimate_scale``) of the PyTorch port against the
JAX package on the CPU: the scaled fit and the Umeyama refine, the
rotated dense capture, both joins with the scale gate, the allpairs
implicit table with its strided probe walk, the resolution of
capacities and engines, end-to-end runs held to the JAX tests' gates on
their fixtures, and a JAX scale-mode state resumed by the port. The
end-to-end runs get a 600 s budget, so their trial estimates (or the
terminate threshold), not the machine's load, end them.

Float32 expressions of the scale gate (``seg_ratio * len2 / len1``,
``r1 / r2``) round apart in the last bit between the packages (XLA on
the CPU contracts the norms' multiply-adds), so where a test compares
gated sets it leaves out the candidates whose ratio lies within 1e-5 of
the gate's edge, and says so."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import super4pcs_tpu as s4j
import super4pcs_tpu_torch as s4t
from super4pcs_tpu import matcher as jmatcher
from super4pcs_tpu.ops import congruent as jc
from super4pcs_tpu.ops import geometry as jg
from super4pcs_tpu.ops import pairs as jp
from super4pcs_tpu.ops import refine as jr
from super4pcs_tpu_torch import matcher as tmatcher
from super4pcs_tpu_torch.ops import congruent as tc
from super4pcs_tpu_torch.ops import geometry as tg
from super4pcs_tpu_torch.ops import pairs as tp
from super4pcs_tpu_torch.ops import refine as tr
from super4pcs_tpu_torch.ops import select as ts

from _torch_threads import one_torch_thread_per_worker  # noqa: F401

#: half-width of the excluded band around the ratio gate's edge
EDGE = 1e-5


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _bumpy(rng, n):
    """The JAX tests' bumpy sphere (tests/test_matcher.py:24-31)."""
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    bump = (1.0 + 0.3 * np.sin(5 * v[:, 0]) * np.cos(3 * v[:, 1])
            + 0.2 * np.sin(4 * v[:, 2]))
    return (v * bump[:, None]).astype(np.float32)


def _cloud(rng, n):
    p = _bumpy(rng, n)
    return p - p.mean(0)


def _near_edge(rr):
    """Ratios whose gate decision float32 rounding may flip."""
    return np.abs(np.abs(np.asarray(rr, np.float64) - 1.0)
                  - geometry_band()) < EDGE


def geometry_band():
    assert tg.SCALE_RATIO_DEV == jg.SCALE_RATIO_DEV == 0.1
    return tg.SCALE_RATIO_DEV


# ------------------------------------------------------------------- fit

def test_batched_rigid_fit_estimate_scale(rng, make_transform):
    """Transforms, rms and validity within 1e-5 of the JAX package for
    similarity-moved quads (scales 0.5-2, some with one segment
    stretched past the gate), leaving out the candidates whose ratio
    r1 / r2 lies within 1e-5 of the gate's edge."""
    base = rng.normal(size=(4, 3)).astype(np.float32)
    cands = []
    for i in range(48):
        m = make_transform()
        s = rng.uniform(0.5, 2.0)
        c = ((base - m[:3, 3]) @ m[:3, :3]) / s        # m s maps c onto base
        c = c + rng.normal(scale=0.003, size=c.shape)
        if i % 4 == 3:                                 # stretch edge (2, 3)
            c[3] = c[2] + (c[3] - c[2]) * rng.uniform(0.7, 1.3)
        cands.append(c)
    cand = np.stack(cands).astype(np.float32)
    cand[5] = cand[5, [0, 0, 1, 2]]                    # degenerate frame
    c1 = base[:3].mean(0)
    c2 = cand[:, :3].mean(1)
    rt, rr_, rv = jax.jit(jg.batched_rigid_fit,
                          static_argnames=("estimate_scale",))(
        jnp.asarray(base), jnp.asarray(cand), jnp.asarray(c1),
        jnp.asarray(c2), -1.0, estimate_scale=True)
    gt, gr, gv = tg.batched_rigid_fit(_t(base)[None], _t(cand)[None],
                                      _t(c1)[None], _t(c2)[None], -1.0,
                                      estimate_scale=True)
    seg = np.linalg.norm
    with np.errstate(divide="ignore", invalid="ignore"):
        r1 = seg(base[1] - base[0]) / seg(cand[:, 1] - cand[:, 0], axis=-1)
        r2 = seg(base[3] - base[2]) / seg(cand[:, 3] - cand[:, 2], axis=-1)
        keep = ~_near_edge(r1 / r2)
    rv, gv = np.asarray(rv), _np(gv[0])
    np.testing.assert_array_equal(gv[keep], rv[keep])
    ok = rv & keep
    np.testing.assert_allclose(_np(gt[0])[ok], np.asarray(rt)[ok],
                               atol=1e-5)
    np.testing.assert_allclose(_np(gr[0])[keep], np.asarray(rr_)[keep],
                               rtol=1e-5, atol=1e-5)
    assert ok.sum() >= 24 and (~rv & keep).sum() >= 6
    # the linear part of a valid fit is s R: its columns have norm s
    lin = _np(gt[0])[ok][:, :3, :3]
    s_cols = np.linalg.norm(lin, axis=1)
    np.testing.assert_allclose(s_cols / s_cols.mean(1, keepdims=True), 1.0,
                               rtol=1e-4)


@pytest.mark.parametrize("sf", [1.0, 2.0])
def test_refine_transform_estimate_scale(rng, sf):
    """Umeyama trimmed ICP from a perturbed similarity: the JAX
    package's refined transform within 1e-4 (float32 SVD and reductions
    in another order, as test_torch_ops.py::test_refine_transform), and
    the recovered scale."""
    p = _cloud(rng, 900)
    s = 1.3
    q = (p[:600] / s
         + rng.normal(scale=0.002, size=(600, 3))).astype(np.float32)
    m = np.eye(4, dtype=np.float32)
    ang = 0.03
    m[:3, :3] = 1.27 * np.array([[np.cos(ang), -np.sin(ang), 0],
                                 [np.sin(ang), np.cos(ang), 0], [0, 0, 1]])
    m[:3, 3] = [0.01, -0.005, 0.008]
    ref = jr.refine_transform(jnp.asarray(m), jnp.asarray(q),
                              jnp.asarray(p), 0.02, iters=6,
                              start_factor=sf, estimate_scale=True)
    got = tr.refine_transform(_t(m), _t(q), _t(p), 0.02, iters=6,
                              start_factor=sf, estimate_scale=True)
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=1e-4)
    assert abs(np.linalg.norm(_np(got)[:3, :3], axis=0).mean() - s) < 0.01


# ----------------------------------------------------------------- pairs

@pytest.mark.parametrize("row_offset", [0, 37, 119, "tensor"])
def test_dense_extraction_row_offset(rng, row_offset):
    """extract_pairs and extract_pairs_dense_rowcap with the distance
    filter off and a rotated capture: bit for bit the JAX package's
    pairs, validity, count and drops, under overflow and without."""
    n = 120
    pos = _cloud(rng, n)
    nrm = np.zeros_like(pos)
    rgb = np.full_like(pos, -1.0)
    ids = rng.choice(n, 4, replace=False)
    jcfg = jp.PairFilterConfig(use_distance_filter=False)
    tcfg = tp.PairFilterConfig(use_distance_filter=False)
    jargs = [jnp.asarray(a) for a in (pos, nrm, rgb, pos[ids], nrm[ids],
                                      rgb[ids])]
    targs = [_t(a) for a in (pos, nrm, rgb, pos[ids], nrm[ids], rgb[ids])]
    off = 53 if row_offset == "tensor" else row_offset
    toff = torch.tensor(off) if row_offset == "tensor" else off
    for cap in (n * (n - 1), 3000):
        for fn in ("extract_pairs", "extract_pairs_dense_rowcap"):
            ref = jax.jit(getattr(jp, fn), static_argnums=(6, 7, 9),
                          static_argnames=("capacity",))(
                *jargs, 0, 1, 0.1, jcfg, capacity=cap, row_offset=off)
            got = getattr(tp, fn)(*targs, 0, 1, 0.1, tcfg, capacity=cap,
                                  row_offset=toff)
            for r, g in zip(ref, got):
                np.testing.assert_array_equal(_np(g), np.asarray(r))
            assert int(got[2]) == n * (n - 1)


# ----------------------------------------------------------------- joins

def _quads_ok(got, ref, rr_of, capacity):
    """The two joins' quads as sets, equal outside the near-edge
    candidates (``rr_of(quad)`` is its float64 ratio); counts within the
    near-edge candidates that differ."""
    gset = {tuple(q) for q, v in zip(_np(got[0]).tolist(), _np(got[1]))
            if v}
    rset = {tuple(q) for q, v in zip(np.asarray(ref[0]).tolist(),
                                     np.asarray(ref[1])) if v}
    diff = gset ^ rset
    assert all(_near_edge(rr_of(q)) for q in diff), diff
    assert abs(int(got[2]) - int(ref[2])) <= len(diff)
    assert int(ref[2]) < capacity            # nothing was cut by capacity
    return gset, diff


def _scale_case(rng, n, s=1.3):
    """Q and a planar base selected (as the matcher selects it) from
    P = s * Q + noise, with its invariants, the base cosine and the
    segment ratio d1 / d2."""
    q = _cloud(rng, n)
    p = (s * q + rng.normal(scale=0.002, size=q.shape)).astype(np.float32)
    gen = torch.Generator().manual_seed(int(rng.integers(1 << 30)))
    ids, inv1, inv2, ok = ts.select_base(
        _t(p), 2.0 * s, *ts.draw_base_indices(gen, n, 8, 200))
    b = int(torch.nonzero(ok)[0])
    base = p[_np(ids[b])]
    inv1, inv2 = float(inv1[b]), float(inv2[b])
    s1, s2 = base[1] - base[0], base[3] - base[2]
    cos_a = float(np.dot(s1 / np.linalg.norm(s1), s2 / np.linalg.norm(s2)))
    ratio = np.float32(np.linalg.norm(s1)) / np.float32(np.linalg.norm(s2))
    return q, base, inv1, inv2, cos_a, float(ratio)


def _rr_of(q, ratio):
    def rr(quad):
        a, b, c, d = quad
        return (ratio * np.linalg.norm(q[d].astype(np.float64) - q[c])
                / np.linalg.norm(q[b].astype(np.float64) - q[a]))
    return rr


@pytest.mark.parametrize("cone", [0.3, -1.0])
def test_dense_join_scale_gate(rng, cone):
    """Dense join over the rotated full-pair capture (the dense scale
    engine's tables) with the scale gate: the JAX package's quads, and
    the gate cuts the ungated join."""
    n = 48
    q, base, inv1, inv2, cos_a, ratio = _scale_case(rng, n)
    cfg = tp.PairFilterConfig(use_distance_filter=False)
    z = np.zeros_like(q)
    cap = tmatcher._round_up(n * (n - 1), 128)
    ex = [tp.extract_pairs(_t(q), _t(z), _t(z - 1), _t(base),
                           _t(np.zeros((4, 3))), _t(np.full((4, 3), -1.0)),
                           e0, e1, 0.1, cfg, capacity=cap, row_offset=17)
          for e0, e1 in ((0, 1), (2, 3))]
    (p1, v1, _, _), (p2, v2, _, _) = ex
    thr = 0.04
    jargs = (jnp.asarray(q), jnp.asarray(_np(p1)), jnp.asarray(_np(v1)),
             jnp.asarray(_np(p2)), jnp.asarray(_np(v2)), jnp.float32(inv1),
             jnp.float32(inv2), thr, jnp.float32(cos_a), cone, 8192)
    ref = jax.jit(jc.find_congruent_quads, static_argnums=(7, 9, 10),
                  static_argnames=("scale_band",))(
        *jargs, seg_ratio=jnp.float32(ratio), scale_band=0.1)
    targs = (_t(q), p1, v1, p2, v2, torch.tensor(inv1), torch.tensor(inv2),
             thr, torch.tensor(cos_a), cone, 8192)
    got = tc.find_congruent_quads(*targs, seg_ratio=torch.tensor(ratio),
                                  scale_band=0.1)
    gset, _ = _quads_ok(got, ref, _rr_of(q, ratio), 8192)
    ungated = tc.find_congruent_quads(*targs)
    assert 0 < len(gset) < int(ungated[2])


def _grid_ref(*args, **kw):
    static = ("distance_threshold", "cone_cos_tolerance", "capacity",
              "cell_candidates", "q_budget", "row_cap", "probe_budget",
              "cell_size", "scale_band", "allpairs_cols", "q_uniform")
    return jax.jit(jc.find_congruent_quads_grid,
                   static_argnames=static)(*args, **kw)


@pytest.mark.parametrize("nq,q_budget,cone", [
    (60, 500, 0.3), (60, None, -1.0), (32, 100, 0.3)])
def test_grid_join_allpairs(rng, nq, q_budget, cone):
    """The allpairs implicit table (no pair arrays) with the strided,
    rotated probe walk and the scale gate, at tables under 2^12 rows
    (the JAX range search then runs at full depth): the JAX package's
    quads as sets, counts, drops and subsample volume. nq = 32 makes
    k2 a power of two, where the raw stride 1024 // 100 = 10 is not
    coprime with k2 and must become 11."""
    q, base, inv1, inv2, cos_a, ratio = _scale_case(rng, nq)
    k1 = nq * nq
    valid = (np.arange(k1) % (nq + 1)) != 0
    q_rot = int(rng.integers(0, k1))
    kw = dict(distance_threshold=0.1, cone_cos_tolerance=cone,
              capacity=8192, cell_candidates=16, q_budget=q_budget,
              row_cap=nq, probe_budget=None, cell_size=0.2,
              allpairs_cols=True, q_uniform=True, scale_band=0.1)
    ref = _grid_ref(jnp.asarray(q), None, jnp.asarray(valid), None,
                    jnp.asarray(valid), jnp.float32(inv1),
                    jnp.float32(inv2), base_cos_alpha=jnp.float32(cos_a),
                    q_rot=jnp.int32(q_rot), seg_ratio=jnp.float32(ratio),
                    **kw)
    got = tc.find_congruent_quads_grid(
        _t(q), None, torch.as_tensor(valid), None, torch.as_tensor(valid),
        torch.tensor(inv1), torch.tensor(inv2),
        base_cos_alpha=torch.tensor(cos_a), q_rot=torch.tensor(q_rot),
        seg_ratio=torch.tensor(ratio), **kw)
    gset, diff = _quads_ok(got, ref, _rr_of(q, ratio), 8192)
    assert len(gset) > 0
    if not diff:
        assert int(got[2]) == int(ref[2])
    for i in (3, 4):
        assert int(got[i]) == int(ref[i])
    if q_budget is not None:
        assert int(got[4]) > 0                   # the walk subsampled
    # the walk's probe pairs start at many first endpoints
    qb = min(q_budget or 8192, k1)
    stride = max(k1 // qb, 1)
    while np.gcd(stride, k1) != 1:
        stride += 1
    if nq == 32:
        assert stride == 11
    sel = (np.arange(qb) * stride + q_rot) % k1
    assert len(np.unique(sel)) == qb
    assert len(np.unique(sel // nq)) >= min(nq, qb) // 2


def test_grid_join_dense_layout_scale_gate(rng):
    """The grid join over the dense scale engine's (K, 2) table (full
    pair capture, rotated) with the scale gate and a probe budget: the
    JAX package's quads as sets, counts and drops."""
    n = 56
    q, base, inv1, inv2, cos_a, ratio = _scale_case(rng, n)
    cfg = tp.PairFilterConfig(use_distance_filter=False)
    z = np.zeros_like(q)
    cap = tmatcher._round_up(n * (n - 1), 128)
    (p1, v1, _, _), (p2, v2, _, _) = [
        tp.extract_pairs(_t(q), _t(z), _t(z - 1), _t(base),
                         _t(np.zeros((4, 3))), _t(np.full((4, 3), -1.0)),
                         e0, e1, 0.1, cfg, capacity=cap, row_offset=29)
        for e0, e1 in ((0, 1), (2, 3))]
    kw = dict(distance_threshold=0.05, cone_cos_tolerance=0.3,
              capacity=8192, cell_candidates=16, q_budget=2048,
              probe_budget=4096, cell_size=0.1, scale_band=0.1)
    ref = _grid_ref(jnp.asarray(q), jnp.asarray(_np(p1).astype(np.int32)),
                    jnp.asarray(_np(v1)),
                    jnp.asarray(_np(p2).astype(np.int32)),
                    jnp.asarray(_np(v2)), jnp.float32(inv1),
                    jnp.float32(inv2), base_cos_alpha=jnp.float32(cos_a),
                    seg_ratio=jnp.float32(ratio), **kw)
    got = tc.find_congruent_quads_grid(
        _t(q), p1, v1, p2, v2, torch.tensor(inv1), torch.tensor(inv2),
        base_cos_alpha=torch.tensor(cos_a), seg_ratio=torch.tensor(ratio),
        **kw)
    gset, _ = _quads_ok(got, ref, _rr_of(q, ratio), 8192)
    assert len(gset) > 0
    for i in (3, 4):
        assert int(got[i]) == int(ref[i])


# ------------------------------------------------------------ resolution

@pytest.mark.parametrize("nq", [80, 2048, 4096])
@pytest.mark.parametrize("kw", [{}, dict(max_pairs=4096, max_quads=2048),
                                dict(pair_engine="allpairs")])
def test_scale_resolution_matches_jax(nq, kw):
    """Bases per step, engine, and the (pairs, quads, candidates)
    capacities of the step equal the JAX package's build_step in
    similarity mode."""
    jo = s4j.Options(estimate_scale=True, **kw)
    to = s4t.Options(estimate_scale=True, **kw)
    assert (tmatcher.resolve_bases_per_step(to, nq)
            == jmatcher.resolve_bases_per_step(jo, nq))
    assert (tmatcher.resolve_pair_engine(to, nq)
            == jmatcher.resolve_pair_engine(jo, nq))
    _, caps = tmatcher.build_step(to, nq, 0.3)
    _, jcaps = jmatcher.build_step(jo, nq, 0.3)
    assert caps == jcaps


def test_scale_engine_refusals():
    """The allpairs engine refuses the pair filters (as in the JAX
    package); the rowcap engine in similarity mode (the JAX package's
    XLA capture) is not ported."""
    for mod, o in ((tmatcher, s4t.Options), (jmatcher, s4j.Options)):
        with pytest.raises(ValueError):
            mod.build_step(o(estimate_scale=True, pair_engine="allpairs",
                             max_normal_difference=20.0), 4096, 0.3)
    with pytest.raises(NotImplementedError):
        tmatcher.resolve_pair_engine(
            s4t.Options(estimate_scale=True, pair_engine="rowcap"), 4096)


# ------------------------------------------------------------ end to end

def _scaled_pair(rng, make_transform, n, s, noise=0.0):
    pos = _bumpy(rng, n)
    mat = make_transform(max_translation=0.3)
    inv = np.linalg.inv(mat)
    q = ((pos @ inv[:3, :3].T + inv[:3, 3]) / s).astype(np.float32)
    if noise:
        q += rng.normal(scale=noise, size=q.shape).astype(np.float32)
    return pos, q


def _gates(res, pos, q, s, lcp, scale_tol, med, relative=False):
    assert res.score > lcp, (res.score, res.stats)
    est = np.linalg.norm(res.transform[:3, :3], axis=0).mean()
    err = abs(est - s) / s if relative else abs(est - s)
    assert err < scale_tol, est
    moved = q @ res.transform[:3, :3].T + res.transform[:3, 3]
    assert np.median(np.linalg.norm(moved - pos, axis=1)) < med


_SIM = dict(delta=0.04, sample_size=80, max_time_seconds=600,
            bases_per_step=8, estimate_scale=True, max_pairs=4096,
            max_quads=2048, max_candidates=8192, random_seed=21)


@pytest.mark.parametrize("algo", ["super4pcs", "4pcs"])
def test_similarity_registration(rng, make_transform, algo):
    """tests/test_matcher.py:291-313 through the port's register, in
    both modes: LCP > 0.8, median error < 0.04, scale within 0.05."""
    pos, q = _scaled_pair(rng, make_transform, 80, 1.25)
    res = s4t.register(pos, q, options=s4t.Options(**_SIM)
                       .configure_overlap(0.9), algorithm=algo,
                       device="cpu")
    _gates(res, pos, q, 1.25, 0.8, 0.05, 0.04)


def test_similarity_sequence_step(rng, make_transform):
    """register_sequence forwards similarity mode: a two-scan sequence
    on the same fixture places the second scan with its scale."""
    pos, q = _scaled_pair(rng, make_transform, 80, 1.25)
    steps = s4t.register_sequence(
        [s4t.PointCloud(pos), s4t.PointCloud(q)],
        s4t.Options(**_SIM).configure_overlap(0.9), device="cpu")
    assert len(steps) == 1
    _gates(steps[0].result, pos, q, 1.25, 0.8, 0.05, 0.04)
    np.testing.assert_array_equal(steps[0].transform,
                                  steps[0].result.transform)


def test_similarity_refinement_recovers_scale(rng, make_transform):
    """tests/test_matcher.py:715-740's noisy scaled pair and gates, with
    the Umeyama refine on. The JAX test searches 40 s towards LCP 0.999
    with the refine on and off; a port step costs ~3 s on the CPU, so
    here the run stops at the gate (terminate threshold 0.8) and ends on
    its trial estimate, not the clock, and seed 1 reaches the gate in
    one step (the JAX test's seed 21: three); the refine's guard holds
    (its last refined LCP never exceeds the kept score)."""
    s = 1.7
    pos, q = _scaled_pair(rng, make_transform, 160, s)
    q += rng.normal(scale=0.01, size=q.shape).astype(np.float32)
    opts = s4t.Options(
        delta=0.04, sample_size=160, max_time_seconds=600,
        bases_per_step=8, estimate_scale=True, max_pairs=8192,
        max_quads=2048, max_candidates=8192,
        random_seed=1).configure_overlap(0.6, 0.8)
    res = s4t.MatchSuper4PCS(opts, device="cpu").compute_transformation(
        s4t.PointCloud(pos), s4t.PointCloud(q))
    assert res.stats["refined_lcp"] <= res.score
    _gates(res, pos, q, s, 0.8, 0.05, 0.04)


def test_scale_mode_allpairs_engine(rng, make_transform):
    """tests/test_matcher.py:767-801: the allpairs engine forced at
    nq = 96 (implicit table, broadcast hash, strided probe walk)."""
    s = 1.4
    pos, q = _scaled_pair(rng, make_transform, 96, s)
    opts = s4t.Options(delta=0.04, sample_size=96, max_time_seconds=600,
                       bases_per_step=8, estimate_scale=True,
                       pair_engine="allpairs", max_quads=2048,
                       max_candidates=8192,
                       random_seed=21).configure_overlap(0.8, 0.9)
    res = s4t.MatchSuper4PCS(opts, device="cpu").compute_transformation(
        s4t.PointCloud(pos), s4t.PointCloud(q))
    _gates(res, pos, q, s, 0.8, 0.05, 0.04)
    assert res.stats["n_pairs"] > 0
    base = s4t.Options(estimate_scale=True)
    assert tmatcher.resolve_pair_engine(base, 1024) == "dense"
    assert tmatcher.resolve_pair_engine(base, 4096) == "allpairs"


def test_scale_mode_q_ceiling(rng, make_transform):
    """tests/test_matcher.py:804-835: with scale_hierarchical off, Q is
    cut to scale_max_q (counted) and the capped run passes the gates.
    Seed 3: the port's draws differ from the JAX package's, and at the
    JAX test's seed 21 the port spends 11 steps (~15 s on the CPU)."""
    s = 1.4
    pos, q = _scaled_pair(rng, make_transform, 2500, s, noise=0.008)
    opts = s4t.Options(delta=0.05, sample_size=2500, max_time_seconds=600,
                       bases_per_step=8, estimate_scale=True,
                       scale_hierarchical=False, scale_max_q=192,
                       max_quads=2048, max_candidates=8192,
                       random_seed=3).configure_overlap(0.6, 0.9)
    m = s4t.MatchSuper4PCS(opts, device="cpu")
    res = m.compute_transformation(s4t.PointCloud(pos), s4t.PointCloud(q))
    assert len(m.get_second_sampled()) <= 192
    assert res.stats["scale_q_capped"] == 2500 - 192
    _gates(res, pos, q, s, 0.7, 0.07, 0.05)


def test_scale_hierarchical_registration(rng, make_transform):
    """tests/test_matcher.py:838-863: above scale_max_q the coarse
    similarity gives s, the fine rigid run on s * Q the pose; composed
    scale within 1% and the visitor's stream spans both halves. Seed 5:
    at the JAX test's seed 21 the port's coarse phase takes 37 steps
    (~40 s on the CPU)."""
    s = 1.4
    pos, q = _scaled_pair(rng, make_transform, 900, s, noise=0.006)
    opts = s4t.Options(delta=0.04, sample_size=900, max_time_seconds=600,
                       bases_per_step=8, estimate_scale=True,
                       scale_max_q=256, max_quads=2048, max_candidates=8192,
                       random_seed=5).configure_overlap(0.6, 0.9)
    fractions = []
    res = s4t.MatchSuper4PCS(opts, device="cpu").compute_transformation(
        s4t.PointCloud(pos), s4t.PointCloud(q),
        visitor=lambda f, lcp, t: fractions.append(f))
    assert "hierarchical_scale" in res.stats
    assert "scale_q_capped" not in res.stats
    assert res.stats["coarse_trials"] > 0 and res.stats["coarse_lcp"] > 0
    _gates(res, pos, q, s, 0.8, 0.01, 0.04, relative=True)
    assert abs(res.stats["hierarchical_scale"] - s) / s < 0.01
    ahead = [f for f in fractions if f >= 0]
    assert min(ahead) == 0.0 and max(ahead) > 0.5


def test_resume_scale_state_from_jax(rng, make_transform):
    """The JAX matcher's exported scale-mode state (linear part s R)
    resumes in the port unchanged: same transform and global
    transform; and a resumed run never takes the hierarchical branch."""
    pos, q = _scaled_pair(rng, make_transform, 80, 1.25)
    jm = s4j.MatchSuper4PCS(s4j.Options(**_SIM).configure_overlap(0.9))
    rj = jm.compute_transformation(s4j.PointCloud(pos), s4j.PointCloud(q))
    state = jm.export_state()
    assert rj.score > 0.8
    tm = s4t.MatchSuper4PCS(
        s4t.Options(**_SIM).configure_overlap(0.9).replace(
            scale_max_q=64), device="cpu")
    rt = tm.compute_transformation(s4t.PointCloud(pos), s4t.PointCloud(q),
                                   resume_state=state)
    assert "hierarchical_scale" not in rt.stats
    assert rt.stats["scale_q_capped"] == 80 - 64
    tm = s4t.MatchSuper4PCS(s4t.Options(**_SIM).configure_overlap(0.9),
                            device="cpu")
    rt = tm.compute_transformation(s4t.PointCloud(pos), s4t.PointCloud(q),
                                   resume_state=state)
    assert rt.n_trials >= state["trial"]
    if state["best_lcp"] == 1.0:
        assert rt.score == rj.score
        np.testing.assert_allclose(rt.transform, rj.transform, atol=1e-6)
    np.testing.assert_allclose(tmatcher.state_from_jax(state)["transform"],
                               np.asarray(state["transform"], np.float32))
    est = np.linalg.norm(rt.transform[:3, :3], axis=0).mean()
    assert abs(est - 1.25) < 0.05
