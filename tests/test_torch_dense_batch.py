"""The dense engine's trial axis on the CPU (nq <= 2048: one extraction
call per base edge and one join over every trial of a step):

- the batched ``extract_pairs`` / ``extract_pairs_dense_rowcap`` against
  ``jax.vmap`` of the JAX functions over the same bases, bit for bit,
  and the T = 1 call against the one-base call;
- the batched dense join (``find_congruent_quads``) against the port's
  per-trial calls bit for bit, chunked and unchunked, and against
  ``jax.vmap`` of the JAX join as quad sets;
- the dense step's trial function over B bases against B one-base
  calls, and ``register_batch`` of two dense pairs against single runs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import super4pcs_tpu_torch as s4t
from super4pcs_tpu.ops import congruent as jc
from super4pcs_tpu.ops import pairs as jp
from super4pcs_tpu_torch import matcher as tmatcher
from super4pcs_tpu_torch.ops import congruent as tc
from super4pcs_tpu_torch.ops import geometry as tg
from super4pcs_tpu_torch.ops import masking as tm
from super4pcs_tpu_torch.ops import pairs as tp
from super4pcs_tpu_torch.parallel import register_batch
from tests._torch_threads import one_torch_thread_per_worker  # noqa: F401
from tests.test_matcher import bumpy_cloud

#: the JAX dense join's float32 ratio-gate rounding: candidates within
#: this of the gate's edge may go either way (tests/test_torch_scale.py)
EDGE = 1e-5


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _cloud(rng, n):
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    bump = 1 + 0.3 * np.sin(5 * v[:, 0]) * np.cos(3 * v[:, 1])
    pos = v * bump[:, None]
    return (pos - pos.mean(0)).astype(np.float32)


def _trial_inputs(rng, n, nt, n_sets):
    """G = ``n_sets`` clouds with normals (10 missing) and colors (20
    missing), and ``nt`` bases, trial t's drawn from cloud t // (nt //
    G) with a little noise: (pos, nrm, rgb) (G, n, 3), (bpos, bnrm,
    brgb) (T, 4, 3)."""
    pos = np.stack([_cloud(rng, n) for _ in range(n_sets)])
    nrm = rng.normal(size=pos.shape).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    nrm[:, :10] = 0
    rgb = rng.uniform(size=pos.shape).astype(np.float32)
    rgb[:, :20] = -1
    g_of = np.arange(nt) // (nt // n_sets)
    ids = np.stack([rng.choice(n, 4, replace=False) for _ in range(nt)])
    bpos = (pos[g_of[:, None], ids]
            + rng.normal(scale=0.002, size=(nt, 4, 3))).astype(np.float32)
    return (pos, nrm, rgb), (bpos, nrm[g_of[:, None], ids],
                             rgb[g_of[:, None], ids]), g_of


_CASES = {
    "rigid": (dict(), None),
    "filters": (dict(max_normal_difference=40.0, max_color_distance=0.5,
                     max_translation_distance=1.4, max_angle=60.0), None),
    "similarity": (dict(use_distance_filter=False), "offsets"),
}
_FNS = ("extract_pairs", "extract_pairs_dense_rowcap")


# ------------------------------------------------------------ extraction

@pytest.mark.parametrize("case", sorted(_CASES))
@pytest.mark.parametrize("fn", _FNS)
def test_batched_extraction_equals_vmapped_jax(rng, case, fn):
    """T = 6 trials over G = 2 clouds in one call: every trial's pairs,
    validity, count and drops equal ``jax.vmap`` of the JAX function over
    the same bases, bit for bit, under overflow and without, for both
    edges; the call a trial at a time (``trial_chunk=1``) equals it."""
    n, nt = 90, 6
    kw, offsets = _CASES[case]
    clouds, bases, g_of = _trial_inputs(rng, n, nt, 2)
    off = (rng.integers(0, n, nt) if offsets else None)
    jcfg, tcfg = jp.PairFilterConfig(**kw), tp.PairFilterConfig(**kw)
    per_trial = [jnp.asarray(c[g_of]) for c in clouds]
    jb = [jnp.asarray(b) for b in bases]
    caps = ((n * (n - 1), 2000) if offsets else (n * 8, 500))
    hits = 0
    for cap in caps:
        for e0, e1 in ((0, 1), (2, 3)):
            def one(p, nr, rg, bp, bn, br, o=None):
                return getattr(jp, fn)(p, nr, rg, bp, bn, br, e0, e1, 0.1,
                                       jcfg, capacity=cap, row_offset=o)
            if off is None:
                ref = jax.jit(jax.vmap(one))(*per_trial, *jb)
            else:
                ref = jax.jit(jax.vmap(one))(*per_trial, *jb,
                                             jnp.asarray(off, jnp.int32))
            targs = [_t(a) for a in (*clouds, *bases)]
            toff = None if off is None else _t(off)
            got = getattr(tp, fn)(*targs, e0, e1, 0.1, tcfg, capacity=cap,
                                  row_offset=toff)
            chunked = getattr(tp, fn)(*targs, e0, e1, 0.1, tcfg,
                                      capacity=cap, row_offset=toff,
                                      trial_chunk=1)
            for r, g, c in zip(ref, got, chunked):
                np.testing.assert_array_equal(_np(g), np.asarray(r))
                assert torch.equal(g, c)
            hits += int(got[2].sum())
    assert hits > 0


@pytest.mark.parametrize("offset", [None, 37])
@pytest.mark.parametrize("fn", _FNS)
def test_t1_extraction_equals_one_base_call(rng, fn, offset):
    """The T = 1 call (base (1, 4, 3), cloud (1, n, 3), offset (1,))
    equals the one-base call (base (4, 3), cloud (n, 3), an int
    offset) with the trial axis added, with every filter on."""
    n = 80
    clouds, bases, _ = _trial_inputs(rng, n, 1, 1)
    cfg = tp.PairFilterConfig(max_normal_difference=40.0,
                              max_color_distance=0.6,
                              use_distance_filter=offset is None)
    batched = getattr(tp, fn)(
        *(_t(a) for a in (*clouds, *bases)), 0, 1, 0.1, cfg,
        capacity=n * 6,
        row_offset=None if offset is None else torch.tensor([offset]))
    single = getattr(tp, fn)(
        *(_t(a[0]) for a in (*clouds, *bases)), 0, 1, 0.1, cfg,
        capacity=n * 6, row_offset=offset)
    for b, s in zip(batched, single):
        assert b.shape == (1,) + s.shape
        assert torch.equal(b[0], s)
    assert int(single[2]) > 0


# ------------------------------------------------------------------ join

def _join_inputs(rng, nt=4, scale=False):
    """T = 4 trials over G = 2 clouds: each trial's dense tables (both
    edges of a base drawn from its cloud; in similarity mode every
    ordered pair, rotated), invariants, base cosine and segment
    ratio."""
    n = 40 if scale else 120
    clouds, bases, g_of = _trial_inputs(rng, n, nt, 2)
    pos = clouds[0]
    bpos = bases[0]
    z = np.zeros_like(pos)
    cfg = tp.PairFilterConfig(use_distance_filter=not scale)
    cap = n * (n - 1) if scale else n * 16
    args = [_t(a) for a in (pos, z, z - 1, bpos, np.zeros_like(bpos),
                            np.full_like(bpos, -1.0))]
    off = _t(rng.integers(0, n, nt)) if scale else None
    (p1, v1, _, _), (p2, v2, _, _) = [
        tp.extract_pairs(*args, e0, e1, 0.05, cfg, capacity=cap,
                         row_offset=off)
        for e0, e1 in ((0, 1), (2, 3))]
    inv1, inv2, _ = tg.dist_segment_to_segment(
        *(_t(bpos[:, i]) for i in range(4)))
    s1 = bpos[:, 1] - bpos[:, 0]
    s2 = bpos[:, 3] - bpos[:, 2]
    n1 = np.linalg.norm(s1, axis=1)
    n2 = np.linalg.norm(s2, axis=1)
    cos_a = ((s1 / n1[:, None]) * (s2 / n2[:, None])).sum(1)
    return (pos, (p1, v1, p2, v2), inv1, inv2,
            _t(cos_a.astype(np.float32)), _t((n1 / n2).astype(np.float32)),
            g_of)


_JOINS = {
    "cone": (0.3, "cone", False),
    "healpix": (0.3, "healpix", False),
    "4pcs": (-1.0, "cone", False),
    "scale-gate": (0.3, "cone", True),
}


@pytest.mark.parametrize("case", sorted(_JOINS))
def test_batched_dense_join_equals_per_trial(rng, case):
    """The dense join over T = 4 trials of G = 2 clouds equals four
    one-trial calls bit for bit (quads, validity, count), and a chunk of
    1 and of 3 trials equal one chunk."""
    cone, bins, scale = _JOINS[case]
    pos, (p1, v1, p2, v2), inv1, inv2, cos_a, ratio, g_of = _join_inputs(
        rng, scale=scale)
    gate = dict(seg_ratio=ratio, scale_band=0.1) if scale else {}
    kw = dict(direction_bins=bins)
    got = tc.find_congruent_quads(_t(pos), p1, v1, p2, v2, inv1, inv2,
                                  0.04, cos_a, cone, 2048, **kw, **gate)
    for chunk in (1, 3):
        again = tc.find_congruent_quads(_t(pos), p1, v1, p2, v2, inv1,
                                        inv2, 0.04, cos_a, cone, 2048,
                                        trial_chunk=chunk, **kw, **gate)
        for a, b in zip(got, again):
            assert torch.equal(a, b)
    for t in range(4):
        gate_t = (dict(seg_ratio=ratio[t], scale_band=0.1) if scale
                  else {})
        one = tc.find_congruent_quads(
            _t(pos[g_of[t]]), p1[t], v1[t], p2[t], v2[t], inv1[t], inv2[t],
            0.04, cos_a[t], cone, 2048, **kw, **gate_t)
        for a, b in zip(got, one):
            assert torch.equal(a[t], b)
    assert int(got[2].sum()) > 0


@pytest.mark.parametrize("bins", ["cone", "healpix"])
def test_grid_join_trial_chunks_equal_one_call(rng, bins):
    """The grid join over the dense engine's T = 4 tables (the join of a
    dense step beyond the dense join's element budget) in chunks of 1
    and 3 trials, each chunk with its own sort, equals one call."""
    pos, (p1, v1, p2, v2), inv1, inv2, cos_a, _, _ = _join_inputs(rng)
    kw = dict(cell_candidates=8, q_budget=512, cell_size=0.08,
              direction_bins=bins)
    got = tc.find_congruent_quads_grid(_t(pos), p1, v1, p2, v2, inv1, inv2,
                                       0.04, cos_a, 0.3, 2048, **kw)
    for chunk in (1, 3):
        again = tc.find_congruent_quads_grid(
            _t(pos), p1, v1, p2, v2, inv1, inv2, 0.04, cos_a, 0.3, 2048,
            trial_chunk=chunk, **kw)
        for a, b in zip(got, again):
            assert torch.equal(a, b)
    assert int(got[2].sum()) > 0


def _near_edge(rr):
    return np.abs(np.abs(np.asarray(rr, np.float64) - 1.0) - 0.1) < EDGE


@pytest.mark.parametrize("case", sorted(_JOINS))
def test_batched_dense_join_equals_vmapped_jax(rng, case):
    """The batched dense join against ``jax.vmap`` of the JAX join over
    the same tables: each trial's quads as sets, equal (with the scale
    gate: outside the candidates within 1e-5 of the ratio gate's edge,
    as tests/test_torch_scale.py states), and the counts equal where the
    sets are."""
    cone, bins, scale = _JOINS[case]
    pos, (p1, v1, p2, v2), inv1, inv2, cos_a, ratio, g_of = _join_inputs(
        rng, scale=scale)
    gate = dict(seg_ratio=ratio, scale_band=0.1) if scale else {}
    got = tc.find_congruent_quads(_t(pos), p1, v1, p2, v2, inv1, inv2,
                                  0.04, cos_a, cone, 2048,
                                  direction_bins=bins, **gate)

    def one(q, a1, b1, a2, b2, i1, i2, ca, sr):
        kw = dict(seg_ratio=sr, scale_band=0.1) if scale else {}
        return jc.find_congruent_quads(q, a1, b1, a2, b2, i1, i2, 0.04, ca,
                                       cone, 2048, direction_bins=bins,
                                       **kw)

    ref = jax.jit(jax.vmap(one))(
        jnp.asarray(pos[g_of]),
        *(jnp.asarray(_np(x)) for x in (p1, v1, p2, v2, inv1, inv2, cos_a,
                                        ratio)))
    q64 = pos.astype(np.float64)
    for t in range(4):
        gset = {tuple(q) for q, v in zip(_np(got[0][t]).tolist(),
                                         _np(got[1][t])) if v}
        rset = {tuple(q) for q, v in zip(np.asarray(ref[0][t]).tolist(),
                                         np.asarray(ref[1][t])) if v}
        diff = gset ^ rset
        if scale:
            x = q64[g_of[t]]
            for a, b, c, d in diff:
                rr = (float(ratio[t]) * np.linalg.norm(x[d] - x[c])
                      / np.linalg.norm(x[b] - x[a]))
                assert _near_edge(rr), (t, (a, b, c, d))
        else:
            assert not diff, (t, diff)
        assert abs(int(got[2][t]) - int(ref[2][t])) <= len(diff)
        assert int(ref[2][t]) < 2048
    assert int(got[2].sum()) > 0


# ------------------------------------------------------------------ step

def _scan_pair(rng, n, normals=False):
    pos = bumpy_cloud(rng, n)
    ang = 0.7
    rot = np.array([[np.cos(ang), -np.sin(ang), 0],
                    [np.sin(ang), np.cos(ang), 0], [0, 0, 1]])
    q = ((pos - [0.1, -0.05, 0.2]) @ rot).astype(np.float32)
    kw = {}
    if normals:
        nrm = pos / np.linalg.norm(pos, axis=1, keepdims=True)
        kw = [dict(normal=nrm.astype(np.float32),
                   rgb=(np.abs(pos) * 200).astype(np.float32)),
              dict(normal=(nrm @ rot).astype(np.float32),
                   rgb=(np.abs(pos) * 200).astype(np.float32))]
        return (s4t.PointCloud(pos, **kw[0]), s4t.PointCloud(q, **kw[1]))
    return s4t.PointCloud(pos), s4t.PointCloud(q)


_STEPS = {
    "rigid": (s4t.MatchSuper4PCS, dict(), False),
    "rigid-grid-join": (s4t.MatchSuper4PCS, dict(force_grid_join=True),
                        False),
    "filtered": (s4t.MatchSuper4PCS, dict(max_normal_difference=30.0,
                                          max_color_distance=60.0), True),
    "similarity": (s4t.MatchSuper4PCS, dict(estimate_scale=True), False),
    "4pcs": (s4t.Match4PCS, dict(), False),
}


@pytest.mark.parametrize("case", sorted(_STEPS))
def test_dense_step_trials_equal_one_base_steps(rng, case):
    """A dense step's trial function over its B = 6 bases (one
    extraction call per edge, one join) equals B calls over one base
    each, drawn by ``step.draw`` and sliced: transform, cvalid, quads
    and counts bit for bit."""
    cls, kw, normals = _STEPS[case]
    P, Q = _scan_pair(rng, 160, normals)
    opts = s4t.Options(delta=0.04, sample_size=120, bases_per_step=6,
                       random_seed=3, **kw).configure_overlap(0.8)
    m = cls(opts, device="cpu")
    m._init(P, Q)
    nq = int(m._d_q_pos.shape[0])
    assert tmatcher.resolve_pair_engine(opts, nq) == "dense"
    tb, _ = tmatcher._build_try_bases(m._opts_eff(), nq, m._cone_mode)
    step = m._step_fn
    args = m._step_args()
    m._gen.manual_seed(11)
    draws = step.draw(m._gen, 1, int(m._d_p_pos.shape[0]))

    def trials(lo, hi):
        rot = tuple(r[:, lo:hi].reshape(-1) for r in draws[3:]) or None
        return tb(tuple(d[:, lo:hi] for d in draws[:3]),
                  m._max_base_diameter, *args[:7], rot)

    full = trials(0, 6)
    for t in range(6):
        one = trials(t, t + 1)
        for k in ("transform", "cvalid", "quads", "counts"):
            a, b = full[k][t], one[k][0]
            assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)) \
                and torch.equal(a.isnan(), b.isnan()), (t, k)
    assert int(full["counts"][:, 0].sum()) > 0
    assert bool(full["cvalid"].any())


def test_register_batch_dense_equals_single_runs(rng, make_transform,
                                                 monkeypatch):
    """``register_batch`` of two dense pairs (B = 8, to the trial
    budget): pair 0 equals the single run of pair 0 (its draws come
    first in either), and the whole batch equals itself with one trial
    per extraction and join chunk (the trials one at a time, as a loop
    over them would run), bit for bit."""
    pos = bumpy_cloud(rng, 100)
    pairs = []
    for _ in range(2):
        inv = np.linalg.inv(make_transform(max_translation=0.4))
        q = (pos @ inv[:3, :3].T + inv[:3, 3]).astype(np.float32)
        q += rng.normal(scale=0.004, size=q.shape).astype(np.float32)
        # outliers keep the LCP below 1, so the run goes to its budget
        q[:20] = rng.uniform(2.0, 3.0, (20, 3))
        pairs.append((s4t.PointCloud(pos), s4t.PointCloud(q)))
    opts = s4t.Options(delta=0.05, sample_size=100, max_time_seconds=600,
                       bases_per_step=8, max_pairs=768, max_candidates=256,
                       random_seed=5,
                       search_escalation_factor=1.0
                       ).configure_overlap(0.9, terminate_threshold=1.0)
    both = register_batch(pairs, opts, device="cpu")
    alone = register_batch(pairs[:1], opts, device="cpu")
    monkeypatch.setitem(tm.CHUNK_ELEMS, "cpu",
                        {"extract": 1, "join": 1})
    looped = register_batch(pairs, opts, device="cpu")
    assert both[0].n_trials == alone[0].n_trials > 8
    assert both[0].score == alone[0].score
    np.testing.assert_array_equal(both[0].transform, alone[0].transform)
    for a, b in zip(both, looped):
        assert a.score == b.score and a.n_trials == b.n_trials
        np.testing.assert_array_equal(a.transform, b.transform)
    assert all(r.score > 0.7 for r in both)
