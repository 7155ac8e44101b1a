"""The port's trial and pairs axes on the CPU (the kernels' plain
versions): the batched band capture (K2) against per-trial captures and
the JAX package's Pallas capture vmapped over bases (interpret mode),
the batched grid join against per-trial joins, the batched verify (K1)
against per-pair verifies, a G = 2 step against two G = 1 steps, and
``register_batch`` held to the JAX package's tests/test_parallel.py
gates on the same fixtures.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import super4pcs_tpu_torch as s4t
from super4pcs_tpu.kernels import rowcap_pallas
from super4pcs_tpu.ops import lcp as jax_lcp
from super4pcs_tpu.ops import sampling as jax_sampling
from super4pcs_tpu.parallel.batch import _Q_SENTINEL as JAX_SENTINEL
from super4pcs_tpu_torch import matcher as tmatcher
from super4pcs_tpu_torch.kernels import lcp as k1
from super4pcs_tpu_torch.kernels import rowcap as k2
from super4pcs_tpu_torch.ops import congruent as tc
from super4pcs_tpu_torch.ops import lcp as tlcp
from super4pcs_tpu_torch.ops import pairs as tpairs
from super4pcs_tpu_torch.parallel import register_batch
from super4pcs_tpu_torch.parallel.batch import _Q_SENTINEL
from tests._torch_threads import one_torch_thread_per_worker  # noqa: F401
from tests.test_matcher import bumpy_cloud, rot_tr_diff


def _cloud(rng, n):
    pos = bumpy_cloud(rng, n)
    pos = pos - pos.mean(0)
    return pos[jax_sampling.kd_argsort(pos)]


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _edge_rows(pos, lo2, hi2):
    """Rows with a pair whose float64 d^2 lies within 4 float32 ulp of
    ``lo2`` or ``hi2`` (see tests/test_torch_rowcap.py)."""
    p = pos.astype(np.float64)
    d2 = ((p[:, None] - p[None]) ** 2).sum(-1)
    rows = np.zeros(len(pos), bool)
    for l2 in (lo2, hi2):
        rows |= (np.abs(d2 - l2) <= 4 * np.spacing(np.float32(l2))).any(1)
    return rows


# ---------------------------------------------------------------------------
# K2 over the trial axis
# ---------------------------------------------------------------------------


def test_batched_capture_equals_vmapped_pallas_and_single(rng):
    """Two bases of one cloud through one batched call: each trial's
    (cols, rc, h) equal its single plain capture bit for bit, and the
    JAX ``_capture_edge`` vmapped over the two bases (interpret mode),
    outside the rows on a band edge."""
    n = 700
    pos = _cloud(rng, n)
    row_cap = k2.slots_for(n, 24)
    n_pad = 2048
    geo = []
    for i, j in ((3, 400), (10, 650)):
        d = np.float32(np.linalg.norm(pos[i] - pos[j]))
        geo.append((np.float32(max(d - np.float32(0.05), 0)) ** 2,
                    np.float32(d + np.float32(0.05)) ** 2))
    geo = np.asarray(geo, np.float32)
    inv = np.asarray([0.61, 0.27], np.float32)
    got = k2.rowcap_capture(_t(pos)[None], _t(geo[:, 0]), _t(geo[:, 1]),
                            row_cap, inv=_t(inv), cell=0.07,
                            emit_hash=True)
    assert [tuple(x.shape) for x in got] == [(2, n_pad, row_cap),
                                             (2, n_pad),
                                             (2, n_pad, row_cap)]
    q8t = np.zeros((8, n_pad), np.float32)
    q8t[:3, :n] = pos.T
    q8t[0, n:] = 1.0e18
    jgeo = np.zeros((2, 1, 8), np.float32)
    jgeo[:, 0, :2] = geo
    jgeo[:, 0, 2] = inv
    jgeo[:, 0, 3] = 0.07
    jpos = jnp.asarray(pos)
    rowb = rowcap_pallas._tile_bounds(jpos, n_pad, 256)
    colb = rowcap_pallas._tile_bounds(jpos, n_pad, 512)
    ref = jax.vmap(lambda g: rowcap_pallas._capture_edge(
        jnp.asarray(q8t), jnp.zeros((8, 8)), jnp.zeros((2, 8)),
        jnp.zeros((2, 8)), g, rowb, colb, row_cap=row_cap, n_real=n,
        emit_hash=True, use_reject=True, interpret=True))(jnp.asarray(jgeo))
    for t in range(2):
        single = k2.rowcap_capture(_t(pos), float(geo[t, 0]),
                                   float(geo[t, 1]), row_cap,
                                   inv=float(inv[t]), cell=0.07,
                                   emit_hash=True)
        edge = np.zeros(n_pad, bool)
        edge[:n] = _edge_rows(pos, geo[t, 0], geo[t, 1])
        assert edge.mean() < 0.03
        for g_, s_, r_ in zip(got, single, ref):
            assert torch.equal(g_[t], s_)
            np.testing.assert_array_equal(g_[t].numpy()[~edge],
                                          np.asarray(r_[t])[~edge])
        assert int(got[1][t].sum()) > int((got[0][t] >= 0).sum()) > 0


@pytest.mark.parametrize("filters", [False, True])
def test_batched_two_edge_capture_equals_per_trial(rng, filters):
    """extract_pairs_rowcap_both over T = 4 trials of G = 2 clouds (2
    per cloud), all four pair filters on or off: every output equals the
    trial's own single-base call, and the edge arguments equal the
    single-base ones."""
    n = 600
    clouds = [_cloud(rng, n) for _ in range(2)]
    pos = np.stack(clouds)
    normal = pos / np.linalg.norm(pos, axis=-1, keepdims=True)
    rgb = (np.abs(pos) * 200).astype(np.float32)
    ids = np.stack([rng.choice(n, 4, replace=False) for _ in range(4)])
    g_of = np.arange(4) // 2
    base = pos[g_of[:, None], ids]
    bnorm = normal[g_of[:, None], ids]
    brgb = rgb[g_of[:, None], ids]
    inv1 = rng.uniform(0.2, 0.8, 4).astype(np.float32)
    kw = (dict(max_normal_difference=20.0, max_color_distance=60.0,
               max_translation_distance=1.5, max_angle=80.0)
          if filters else {})
    row_cap = k2.slots_for(n, 16)
    got = k2.extract_pairs_rowcap_both(
        _t(pos), _t(base), 0.05, row_cap, invariant1=_t(inv1),
        cell_size=0.08, normal=_t(normal), rgb=_t(rgb),
        base_norm=_t(bnorm), base_rgb=_t(brgb), **kw)
    args = k2.edge_args(_t(pos), _t(base), 0.05, _t(normal), _t(rgb),
                        _t(bnorm), _t(brgb), **kw)
    for t in range(4):
        g = g_of[t]
        one = k2.extract_pairs_rowcap_both(
            _t(pos[g]), _t(base[t]), 0.05, row_cap,
            invariant1=torch.tensor(inv1[t]), cell_size=0.08,
            normal=_t(normal[g]), rgb=_t(rgb[g]), base_norm=_t(bnorm[t]),
            base_rgb=_t(brgb[t]), **kw)
        for e in range(2):
            for a, b in zip(got[e], one[e]):
                assert torch.equal(a[t], b)
        assert torch.equal(got[2][t], one[2])
        single = k2.edge_args(_t(pos[g]), _t(base[t]), 0.05,
                              _t(normal[g]), _t(rgb[g]), _t(bnorm[t]),
                              _t(brgb[t]), **kw)
        for kb, ks in zip(args, single):
            assert kb.keys() == ks.keys()
            for name, v in ks.items():
                b = kb[name]
                if name == "normals":
                    b = b[g]
                elif torch.is_tensor(b):
                    b = b[t]
                assert (torch.equal(b, v) if torch.is_tensor(v)
                        else b == v), name
    assert int(got[0][2].sum()) > 0


# ---------------------------------------------------------------------------
# the grid join over the trial axis
# ---------------------------------------------------------------------------


def _gather(tables, t):
    return [None if x is None else x[t] for x in tables]


def _join_both(q, tables, per_trial, kw):
    """The batched join and the T single-trial joins of the same tables
    (``per_trial``: the (T,) arguments)."""
    nt = per_trial["inv1"].shape[0]
    got = tc.find_congruent_quads_grid(
        q, *tables, per_trial["inv1"], per_trial["inv2"], 0.04,
        per_trial["cos_a"], 0.3, 2048, **kw)
    single = []
    for t in range(nt):
        one_kw = dict(kw)
        for name in ("seg_ratio", "q_rot", "table_hash"):
            if name in kw:
                one_kw[name] = kw[name][t]
        single.append(tc.find_congruent_quads_grid(
            q[t // (nt // q.shape[0])], *_gather(tables, t),
            per_trial["inv1"][t], per_trial["inv2"][t], 0.04,
            per_trial["cos_a"][t], 0.3, 2048, **one_kw))
    return got, single


def _per_trial(rng, nt):
    return dict(inv1=_t(rng.uniform(0.2, 0.8, nt).astype(np.float32)),
                inv2=_t(rng.uniform(0.2, 0.8, nt).astype(np.float32)),
                cos_a=_t(rng.uniform(-0.9, 0.9, nt).astype(np.float32)))


@pytest.mark.parametrize("bins", ["cone", "healpix"])
def test_batched_join_rowcap_tables_equal_single(rng, bins):
    """Rowcap-fed tables (cols-only, with the kernel's hash) of T = 3
    trials over one cloud: the batched join's quads, valid slots and
    counters equal three T = 1 joins."""
    n = 500
    q = _t(_cloud(rng, n))
    nt = 3
    base = q[torch.as_tensor(np.stack(
        [rng.choice(n, 4, replace=False) for _ in range(nt)]))]
    pt = _per_trial(rng, nt)
    row_cap = k2.slots_for(n, 16)
    (c1, v1, _, _), (c2, v2, _, _), h1 = k2.extract_pairs_rowcap_both(
        q[None], base, 0.05, row_cap, invariant1=pt["inv1"],
        cell_size=0.08)
    kw = dict(cell_candidates=8, q_budget=1024, probe_budget=2048,
              cell_size=0.08, row_cap=row_cap, table_hash=h1,
              direction_bins=bins)
    got, single = _join_both(q[None], (c1, v1, c2, v2), pt, kw)
    for t in range(nt):
        for a, b in zip(got, single[t]):
            assert torch.equal(a[t], b)
    assert int(got[2].sum()) > 0


@pytest.mark.parametrize("bins", ["cone", "healpix"])
def test_batched_join_dense_tables_equal_single(rng, bins):
    """(K, 2) pair tables of T = 4 trials over G = 2 clouds (trial t on
    cloud t // 2): the batched join equals four T = 1 joins, HEALPix
    bins included."""
    n = 300
    clouds = _t(np.stack([_cloud(rng, n) for _ in range(2)]))
    cfg = tpairs.PairFilterConfig()
    nt = 4
    pt = _per_trial(rng, nt)
    tables = [[], [], [], []]
    for t in range(nt):
        q = clouds[t // 2]
        b = q[torch.as_tensor(rng.choice(n, 4, replace=False))]
        z = torch.zeros_like(q)
        for e, (i, j) in enumerate(((0, 1), (2, 3))):
            p, v, _, _ = tpairs.extract_pairs(q, z, z - 1, b, z[:4],
                                              z[:4] - 1, i, j, 0.05, cfg,
                                              capacity=4096)
            tables[2 * e].append(p)
            tables[2 * e + 1].append(v)
    tables = [torch.stack(x) for x in tables]
    kw = dict(cell_candidates=8, q_budget=512, cell_size=0.08,
              direction_bins=bins)
    got, single = _join_both(clouds, tables, pt, kw)
    for t in range(nt):
        for a, b in zip(got, single[t]):
            assert torch.equal(a[t], b)
    assert int(got[2].sum()) > 0


def test_batched_join_allpairs_scale_gate_equal_single(rng):
    """The allpairs implicit table with the strided probe walk (per
    trial rotations) and the scale gate (per trial ratios), T = 2: the
    batched join equals two T = 1 joins."""
    n = 48
    q = _t(_cloud(rng, n))[None]
    nt = 2
    pt = _per_trial(rng, nt)
    valid = (torch.arange(n * n) % (n + 1)) != 0
    valid = valid.expand(nt, -1)
    kw = dict(cell_candidates=8, q_budget=256, cell_size=0.08,
              row_cap=n, allpairs_cols=True, q_uniform=True,
              q_rot=torch.tensor([5, 300]),
              seg_ratio=_t(np.float32([0.9, 1.2])), scale_band=0.1)
    got, single = _join_both(q, (None, valid, None, valid), pt, kw)
    for t in range(nt):
        for a, b in zip(got, single[t]):
            assert torch.equal(a[t], b)


# ---------------------------------------------------------------------------
# K1 over the pairs axis
# ---------------------------------------------------------------------------


def _transforms(rng, c, shift=0.02):
    out = np.tile(np.eye(4, dtype=np.float32), (c, 1, 1))
    for i in range(c):
        a = rng.normal(size=3) * 0.05
        k = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
        out[i, :3, :3] = np.eye(3) + k + 0.5 * k @ k
        out[i, :3, 3] = rng.uniform(-shift, shift, 3)
    return out


def test_batched_verify_with_run_indexes_equals_per_pair(rng):
    """The plain K1 over two pairs with indexes built once (a
    VerifyIndex of both clouds, full and strided views) equals each
    pair's own lcp_min_d2_within_plain; the two-stage verify selects
    and scores each pair as its own call does; a mismatched index is
    refused."""
    p = np.stack([_cloud(rng, 900), _cloud(rng, 900)])
    q = np.stack([p[0][::2] + 0.003, p[1][1::2] - 0.002])
    q[1, -40:] = _Q_SENTINEL
    tr = np.stack([_transforms(rng, 300), _transforms(rng, 300)])
    eps = 0.03
    index = tlcp.VerifyIndex(_t(p))
    for stride in (1, 3):
        ps = _t(p)[:, ::stride]
        got = k1.lcp_min_d2_within(_t(tr), _t(q), ps, eps,
                                   index.get(stride, eps))
        for g in range(2):
            assert torch.equal(got[g], k1.lcp_min_d2_within_plain(
                _t(tr[g]), _t(q[g]), ps[g].contiguous(), eps))
    assert index.builds == 2
    index.get(1, eps)
    assert index.builds == 2
    live = _t(rng.uniform(size=(2, 300)) > 0.2)
    s, i = tlcp.lcp_scores_two_stage(_t(tr), _t(q), _t(p), eps,
                                     coarse_q=32, coarse_p=300, top_k=40,
                                     live=live, index=index)
    for g in range(2):
        s1, i1 = tlcp.lcp_scores_two_stage(_t(tr[g]), _t(q[g]), _t(p[g]),
                                           eps, coarse_q=32, coarse_p=300,
                                           top_k=40, live=live[g])
        assert torch.equal(s[g], s1) and torch.equal(i[g], i1)
    with pytest.raises(ValueError):
        k1.lcp_min_d2_within(_t(tr), _t(q), _t(p), 0.05,
                             index.get(1, eps))


def test_sentinel_padded_lcp_exact(rng, make_transform):
    """A Q cloud sentinel-padded to a larger batch shape scores exactly
    the LCP of its unpadded form, in the port as in the JAX package on
    the same arrays (tests/test_parallel.py), in a batch of two pairs
    of which one is padded."""
    pos = bumpy_cloud(rng, 150)
    mat = make_transform(max_translation=0.4)
    inv = np.linalg.inv(mat)
    q = (pos @ inv[:3, :3].T + inv[:3, 3]).astype(np.float32)
    assert _Q_SENTINEL == JAX_SENTINEL
    transforms = np.stack([np.eye(4, dtype=np.float32),
                           make_transform(max_translation=0.2),
                           make_transform(max_translation=0.5), mat])
    q_pad = np.concatenate([q, np.full((70, 3), _Q_SENTINEL, np.float32)])
    plain = tlcp.lcp_scores(_t(transforms), _t(q), _t(pos), 0.05)
    padded = tlcp.lcp_scores(_t(transforms), _t(q_pad), _t(pos), 0.05)
    assert torch.equal(plain, padded)
    ref = np.asarray(jax_lcp.lcp_scores(
        jnp.asarray(transforms), jnp.asarray(q_pad), jnp.asarray(pos),
        0.05, use_pallas=False))
    np.testing.assert_array_equal(padded.numpy(), ref)
    assert padded[3] > 0.9
    both = tlcp.lcp_scores(_t(np.stack([transforms, transforms])),
                           _t(np.stack([q_pad, q_pad[::-1].copy()])),
                           _t(np.stack([pos, pos])), 0.05)
    assert torch.equal(both[0], plain) and torch.equal(both[1], plain)
    s_pad, idx_pad = tlcp.lcp_scores_two_stage(
        _t(transforms), _t(q_pad), _t(pos), 0.05, top_k=2)
    assert torch.equal(s_pad, plain[idx_pad])


# ---------------------------------------------------------------------------
# the step over the pairs axis
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine", ["rowcap", "dense"])
def test_step_over_two_pairs_equals_two_single_steps(rng, engine):
    """A G = 2 step's per-pair outputs equal two G = 1 steps given the
    same draws (the G = 2 step draws pair 0's bases, then pair 1's)."""
    n = 200
    opts = s4t.Options(delta=0.04, bases_per_step=3, pair_engine=engine,
                       verify_top_k=64, max_candidates=512, coarse_q=32,
                       coarse_p=256)
    step, _ = tmatcher.build_step(opts, n, 0.3)
    clouds = []
    for _ in range(2):
        p = _cloud(rng, n)
        mat = np.eye(4, dtype=np.float32)
        mat[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        q = (p @ mat[:3, :3].T).astype(np.float32)
        q = q[jax_sampling.kd_argsort(q)]
        z = np.zeros_like(p)
        clouds.append((p, z, z - 1, q, z, z - 1))
    arrs = [_t(np.stack(x)) for x in zip(*clouds)]
    diam = _t(np.float32([2.0, 2.2]))
    index = tlcp.VerifyIndex(arrs[0])
    gen = torch.Generator()
    gen.manual_seed(3)
    both = step(gen, diam, *arrs, None, index)
    for g in range(2):
        gen.manual_seed(3)
        if g == 1:
            # pair 0's draws come first in the G = 2 step
            from super4pcs_tpu_torch.ops import select
            select.draw_base_indices(gen, n, 3, opts.n_triangle_trials)
        one = step(gen, diam[g:g + 1], *(a[g:g + 1] for a in arrs), None,
                   tlcp.VerifyIndex(arrs[0][g:g + 1]))
        for k, v in one.items():
            assert torch.equal(both[k][g], v[0]), k
    assert (both["lcp"] > 0).all()


# ---------------------------------------------------------------------------
# register_batch (tests/test_parallel.py's fixtures and gates)
# ---------------------------------------------------------------------------


def make_pair(rng, make_transform, n=200):
    pos = bumpy_cloud(rng, n)
    mat = make_transform(max_translation=0.4)
    inv = np.linalg.inv(mat)
    q = (pos @ inv[:3, :3].T + inv[:3, 3]).astype(np.float32)
    return pos, q, mat


def _pc(a):
    return s4t.PointCloud(pos=a)


def test_register_batch_unsharded(rng, make_transform):
    pos, q, mat = make_pair(rng, make_transform, n=100)
    opts = s4t.Options(delta=0.05, sample_size=100, max_time_seconds=30,
                       bases_per_step=4, random_seed=5).configure_overlap(0.9)
    results = register_batch([(_pc(pos), _pc(q))] * 2, opts, device="cpu")
    assert len(results) == 2
    for res in results:
        assert res.score > 0.8


def test_register_batch_ragged_sizes(rng, make_transform):
    """Pairs of different cloud sizes in one batch: the smaller Q is
    sentinel-padded; both pairs register, with the single-pair stats
    contract and the padding telemetry."""
    pos_a, q_a, mat_a = make_pair(rng, make_transform, n=140)
    pos_b, q_b, mat_b = make_pair(rng, make_transform, n=90)
    opts = s4t.Options(delta=0.05, sample_size=140, max_time_seconds=40,
                       bases_per_step=4, max_quads=512, max_candidates=512,
                       random_seed=5).configure_overlap(0.9)
    results = register_batch([(_pc(pos_a), _pc(q_a)),
                              (_pc(pos_b), _pc(q_b))], opts, device="cpu")
    assert results[1].stats["q_padded"] > 0
    assert results[0].stats["q_padded"] == 0
    for res, mat in zip(results, (mat_a, mat_b)):
        assert res.score > 0.8, res.score
        rot_diff, tr_diff = rot_tr_diff(res.transform, mat)
        assert rot_diff <= 0.2 and tr_diff <= 0.1
        for k in ("pairs_overflow", "quads_overflow", "cands_overflow",
                  "n_congruent", "cell_dropped", "search_seconds",
                  "compile_seconds"):
            assert k in res.stats, k


def test_register_batch_visitor_stream(rng, make_transform):
    pos, q, _ = make_pair(rng, make_transform, n=100)
    calls = []

    class Recorder:
        def __call__(self, fraction, scores, mats):
            calls.append((fraction, np.array(scores), np.array(mats)))

        def needs_global_transformation(self):
            return True

    opts = s4t.Options(delta=0.05, sample_size=100, max_time_seconds=30,
                       bases_per_step=4, random_seed=5).configure_overlap(0.9)
    register_batch([(_pc(pos), _pc(q))] * 2, opts, visitor=Recorder(),
                   device="cpu")
    assert calls[0][0] == 0.0
    assert any(f == -1.0 for f, _, _ in calls)
    assert calls[-1][1].shape == (2,)
    assert calls[-1][2].shape == (2, 4, 4)
    lcps = np.stack([s for _, s, _ in calls])
    assert (np.diff(lcps, axis=0) >= -1e-9).all()


def test_register_batch_resume(rng, make_transform):
    """An interrupted batch resumed from its exported state reaches the
    same quality as an uninterrupted run (same draw stream); the
    checkpoint hook sees every step's state."""
    pos, q, mat = make_pair(rng, make_transform, n=100)
    pairs = [(_pc(pos), _pc(q))] * 2
    opts = s4t.Options(delta=0.05, sample_size=100, max_time_seconds=40,
                       bases_per_step=4, max_quads=512, max_candidates=512,
                       random_seed=5).configure_overlap(0.6, 0.999)
    full = register_batch(pairs, opts, device="cpu")
    states = []
    part = register_batch(
        pairs, opts.replace(max_time_seconds=1, refine_iterations=0),
        on_checkpoint=states.append, device="cpu")
    state = part[0].stats["batch_state"]
    assert states and states[-1] == state
    resumed = register_batch(pairs, opts, resume_state=state, device="cpu")
    assert resumed[0].n_trials >= full[0].n_trials
    for r_res, f_res in zip(resumed, full):
        assert r_res.score >= f_res.score - 0.05


def test_batch_straggler_escalation(rng, make_transform):
    """One hard pair in a batch (a sparse noisy subsample) reaches the
    pose gates through straggler redemption: the batch step never
    escalates; the pair is re-registered alone at the escalated factor
    by the port's single-pair matcher."""
    pos_e, q_e, mat_e = make_pair(rng, make_transform, n=200)
    pos_h = bumpy_cloud(rng, 500)
    keep = rng.choice(500, 160, replace=False)
    mat_h = make_transform(max_translation=0.4)
    inv = np.linalg.inv(mat_h)
    q_h = (pos_h[keep] @ inv[:3, :3].T + inv[:3, 3]).astype(np.float32)
    q_h += rng.normal(scale=0.008, size=q_h.shape).astype(np.float32)
    # seed 8: the port's batch phase exhausts its estimate at LCP ~0.04
    # on the hard pair (the only such seed of 1-20; the port draws other
    # trials than the JAX package, whose test takes seed 5 for this), so
    # the pair must go through redemption
    opts = s4t.Options(delta=0.025, sample_size=200, max_time_seconds=240,
                       bases_per_step=8, max_quads=2048, max_candidates=4096,
                       random_seed=8, search_escalation_factor=2.0,
                       ).configure_overlap(0.9, terminate_threshold=0.95)
    results = register_batch([(_pc(pos_e), _pc(q_e)),
                              (_pc(pos_h), _pc(q_h))], opts, device="cpu")
    assert results[0].score >= 0.95
    rot_diff, tr_diff = rot_tr_diff(results[0].transform, mat_e)
    assert rot_diff <= 0.2 and tr_diff <= 0.1
    assert results[1].stats.get("straggler_escalated_to") == 2.0
    rot_diff, tr_diff = rot_tr_diff(results[1].transform, mat_h)
    assert rot_diff <= 0.2 and tr_diff <= 0.1, (
        rot_diff, tr_diff, results[1].score)


def test_register_batch_refuses_mesh_and_banded(rng, make_transform):
    # mesh= and the banded engine are ported (tests/test_torch_sharded.py,
    # tests/test_torch_band_extract.py): a mesh that divides the pairs
    # runs them, one that does not is refused with a ValueError
    from super4pcs_tpu_torch.parallel import make_mesh
    pos, q, _ = make_pair(rng, make_transform, n=60)
    pairs = [(_pc(pos), _pc(q))] * 2
    opts = s4t.Options(delta=0.05, sample_size=60, max_time_seconds=30,
                       bases_per_step=4, random_seed=5).configure_overlap(0.9)
    res = register_batch(pairs, opts,
                         mesh=make_mesh(["cpu"] * 2, axis="pairs"))
    assert len(res) == 2 and all(r.score > 0.8 for r in res)
    with pytest.raises(ValueError, match="divisible"):
        register_batch(pairs, opts, mesh=make_mesh(["cpu"] * 3))
    assert register_batch([], device="cpu") == []
