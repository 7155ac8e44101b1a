"""The port's dispatch layer on the CPU: ``steps_per_dispatch`` and its
fused dispatch against the JAX package's rule, packing and contracts,
the per-step loop's two steps in flight against one, the launch
accounting of captured steps, and the step's ops held to what a CUDA
graph capture allows (no host read of a device value, no copy of host
memory to the device). The captures themselves run on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 5q).

On the CPU every comparison here is exact: the fused and per-step runs
draw the same trials (each step reseeds the generator from its index)
and make the same decisions, so no tolerance is needed beyond the JAX
test's own (1e-3, kept where its assertions are mirrored)."""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import super4pcs_tpu as s4j
import super4pcs_tpu_torch as s4t
from super4pcs_tpu.matcher import (
    resolve_steps_per_dispatch as jax_resolve)
from super4pcs_tpu_torch import matcher as tmatcher
from super4pcs_tpu_torch.kernels import lcp as k1
from super4pcs_tpu_torch.kernels import rowcap as k2
from super4pcs_tpu_torch.kernels import rowcap_layout as k2x
from super4pcs_tpu_torch.ops import lcp as olcp
from super4pcs_tpu_torch.utils.graphs import COUNTERS, LaunchRecord

from _torch_threads import one_torch_thread_per_worker  # noqa: F401


def _bumpy(rng, n):
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    bump = (1.0 + 0.3 * np.sin(5 * v[:, 0]) * np.cos(3 * v[:, 1])
            + 0.2 * np.sin(4 * v[:, 2]))
    return (v * bump[:, None]).astype(np.float32)


class _Recorder:
    """tests/test_matcher.py's visitor recorder."""

    def __init__(self):
        self.improvements = []
        self.fractions = []

    def __call__(self, fraction, best_lcp, transform):
        if fraction < 0:
            self.improvements.append(float(best_lcp))
        else:
            self.fractions.append(float(fraction))

    def needs_global_transformation(self):
        return False


# ----------------------------------------------------------------------
# the rule and the packing, against the JAX package
# ----------------------------------------------------------------------

@pytest.mark.parametrize("k", [None, 1, 3, 8])
@pytest.mark.parametrize("sf", [1.0, 2.0])
def test_resolve_steps_per_dispatch_is_the_jax_rule(k, sf):
    for nq in (200, 1024, 1025, 8192):
        for mesh_size in (1, 4):
            kw = dict(steps_per_dispatch=k, search_delta_factor=sf)
            got = tmatcher.resolve_steps_per_dispatch(
                s4t.Options(**kw), nq, mesh_size)
            want = jax_resolve(s4j.Options(**kw), nq, mesh_size)
            assert got == want, (nq, mesh_size, kw, got, want)


def test_fused_state_of_a_resumed_run_is_the_jax_packing():
    """A port matcher resumed from a JAX matcher's exported state packs
    the JAX ``_fused_state`` arrays exactly (values and dtypes)."""
    rng = np.random.default_rng(3)
    p = _bumpy(rng, 120)
    q = p + np.float32(0.1)
    opts = dict(delta=0.05, sample_size=120)
    jm = s4j.MatchSuper4PCS(s4j.Options(**opts))
    jm._init(s4j.PointCloud(pos=p), s4j.PointCloud(pos=q))
    # a best-so-far as a search leaves it
    tr = np.eye(4, dtype=np.float32)
    tr[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    tr[:3, 3] = rng.normal(size=3)
    jm._best_lcp = float(np.float32(0.6171875))
    jm._transform = tr
    jm._qcentroid1 = rng.normal(size=3).astype(np.float32)
    jm._qcentroid2 = rng.normal(size=3).astype(np.float32)
    jm._base_ids = np.array([3, 17, 64, 101], np.int32)
    jm._congruent_ids = np.array([5, 9, 77, 118], np.int32)
    jm._trial = 3 * jm._b_eff
    tm = s4t.MatchSuper4PCS(s4t.Options(**opts), device="cpu")
    tm._init(s4t.PointCloud(p), s4t.PointCloud(q))
    tm._import_state(tmatcher.state_from_jax(jm.export_state()))
    assert tm._b_eff == jm._b_eff
    for got, want in zip(tm._fused_state(), jm._fused_state()):
        want = np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    # the packed device form round-trips them
    f, i = tm._fused_state()
    uf, ui, row, cont, rank = tmatcher.unpack_fused(
        tmatcher.pack_fused(f, i, 5, True, 0.5))
    np.testing.assert_array_equal(uf, f)
    np.testing.assert_array_equal(ui, i)
    assert not row.any() and cont and rank == 0.5


# ----------------------------------------------------------------------
# the fused dispatch's device body
# ----------------------------------------------------------------------

def _step_out(lcp, seed, big=False):
    """A step's outputs for one pair (G = 1, B = 3), as step.run
    returns them."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 1000, size=(1, 3, 6))
    if big:
        counts[..., 3] = 2_000_000_000      # beyond int32 in a sum
    return dict(
        lcp=torch.tensor([lcp], dtype=torch.float32),
        rank_lcp=torch.tensor([lcp], dtype=torch.float32),
        transform=torch.as_tensor(rng.normal(size=(1, 4, 4)),
                                  dtype=torch.float32),
        qcentroid1=torch.as_tensor(rng.normal(size=(1, 3)),
                                   dtype=torch.float32),
        qcentroid2=torch.as_tensor(rng.normal(size=(1, 3)),
                                   dtype=torch.float32),
        base_ids=torch.as_tensor(rng.integers(0, 99, (1, 4))),
        congruent_ids=torch.as_tensor(rng.integers(0, 99, (1, 4))),
        n_congruent=torch.tensor([7]),
        cands_dropped=torch.tensor([2]),
        pair_counts=torch.as_tensor(counts))


def _packed(best, k_limit=8, cont=True, step=4):
    f = np.zeros(23, np.float32)
    f[0] = best
    i = np.arange(9, dtype=np.int32)
    i[0] = step
    return torch.from_numpy(tmatcher.pack_fused(f, i, k_limit, cont))


@pytest.mark.parametrize("polish", [False, True])
def test_fused_body_adopts_counts_and_exits_like_the_jax_loop(polish):
    """``build_multi_step``'s body: a step counts its telemetry (int64:
    no wrap at 2^31) and adopts a winner that beats the best; the flag
    it leaves is the JAX loop's condition, cleared after an adopting
    step when the polish is on; a step run with the flag clear (the one
    enqueued past the exit) changes nothing."""
    opts = s4t.Options(refine_iterations=8 if polish else 0,
                       terminate_threshold=0.9)
    body = tmatcher.build_multi_step(opts, k_quads=100)

    # a winner below the best: counted, not adopted, the loop goes on
    st = _packed(0.5)
    out = _step_out(0.25, 1, big=True)
    body(out, st)
    f, i, row, cont, rank = tmatcher.unpack_fused(st.numpy())
    c = out["pair_counts"][0].numpy().astype(np.int64)
    assert row.tolist() == [
        1, c[:, 4].sum(), np.maximum(c[:, 2] - 100, 0).sum(),
        c[:, 3].sum(), c[:, 5].sum(), 7, 2, c[:, :2].sum()]
    assert row[3] > 2 ** 31
    assert f[0] == np.float32(0.5) and i[0] == 5 and cont
    assert rank == 0.25                     # the best step rank

    # a winner above the best: adopted (transform, centroids, ids)
    out = _step_out(0.75, 2)
    body(out, st)
    f, i, row, cont, rank = tmatcher.unpack_fused(st.numpy())
    assert f[0] == np.float32(0.75) and row[0] == 2 and i[0] == 6
    assert rank == 0.75
    np.testing.assert_array_equal(f[1:17], out["transform"][0].reshape(16))
    np.testing.assert_array_equal(f[17:20], out["qcentroid1"][0])
    np.testing.assert_array_equal(f[20:23], out["qcentroid2"][0])
    np.testing.assert_array_equal(i[1:5], out["base_ids"][0])
    np.testing.assert_array_equal(i[5:9], out["congruent_ids"][0])
    assert cont == (not polish)

    # a step with the flag clear: nothing moves
    before = st.clone()
    st.view(torch.int32)[32] = 0
    before.view(torch.int32)[32] = 0
    body(_step_out(0.875, 3, big=True), st)
    assert torch.equal(st, before)

    # the exit conditions: the step budget, the threshold, LCP 1
    for best_after, k_limit, want in ((0.8, 2, False), (0.8, 3, True),
                                      (0.95, 8, False), (1.0, 8, False)):
        st = _packed(0.1, k_limit=k_limit, step=0)
        st[_ROW0] = 1                       # one step already done
        body(_step_out(best_after, 4), st)
        assert tmatcher.unpack_fused(st.numpy())[3] == (want
                                                        and not polish)


_ROW0 = tmatcher._ROW.start


# ----------------------------------------------------------------------
# whole runs: fused against per-step, two in flight against one
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def runs_150():
    """tests/test_matcher.py:620-700's fixture (its ``rng`` seed 42, the
    150-point bumpy cloud, the same options but 8 bases a step where
    the JAX test takes the default 64: a 64-trial dense step takes ~18
    s on one CPU thread), run fused (the default K = 8 at nq = 150)
    and at steps_per_dispatch=1, with visitors."""
    from conftest import random_rigid_transform
    rng = np.random.default_rng(42)
    pos = _bumpy(rng, 150)
    mat = random_rigid_transform(rng, max_translation=0.4)
    inv = np.linalg.inv(mat)
    q_pos = (pos @ inv[:3, :3].T + inv[:3, 3]).astype(np.float32)
    base = s4t.Options(delta=0.05, sample_size=150, max_time_seconds=60,
                       max_quads=512, max_candidates=1024,
                       random_seed=7, bases_per_step=8
                       ).configure_overlap(0.9)
    out = {}
    for name, opts in (("fused", base),
                       ("plain", base.replace(steps_per_dispatch=1))):
        m = s4t.MatchSuper4PCS(opts, device="cpu")
        vis = _Recorder()
        res = m.compute_transformation(s4t.PointCloud(pos),
                                       s4t.PointCloud(q_pos), visitor=vis)
        out[name] = (m, res, vis)
    return out


def test_fused_dispatch_matches_unfused(runs_150):
    """tests/test_matcher.py::test_fused_dispatch_matches_unfused on the
    port: the same rule, the fused path active, and the same n_trials,
    score and transform within the JAX test's 1e-3 (equal here)."""
    o = s4t.Options()
    assert tmatcher.resolve_steps_per_dispatch(o, 512) == 8
    assert tmatcher.resolve_steps_per_dispatch(o, 4096) == 1
    assert tmatcher.resolve_steps_per_dispatch(o, 512, mesh_size=4) == 1
    assert tmatcher.resolve_steps_per_dispatch(
        o.replace(search_delta_factor=2.0), 512) == 1
    m_fused, res_fused, _ = runs_150["fused"]
    m_plain, res_plain, _ = runs_150["plain"]
    assert m_fused._multi_fn is not None
    assert m_plain._multi_fn is None
    assert res_fused.stats["fused_dispatches"] >= 1
    assert "fused_dispatches" not in res_plain.stats
    assert res_fused.n_trials == res_plain.n_trials
    assert abs(res_fused.score - res_plain.score) < 1e-3
    np.testing.assert_allclose(res_fused.transform, res_plain.transform,
                               atol=1e-3)
    assert res_fused.score == res_plain.score
    np.testing.assert_array_equal(res_fused.transform, res_plain.transform)


def test_fused_dispatch_visitor_contract(runs_150):
    """tests/test_matcher.py::test_fused_dispatch_visitor_contract on
    the port: both streams open with fraction 0, and the fused one
    coalesces improvements (at least one, never more than the per-step
    stream's), each a value the per-step stream reaches."""
    _, res_f, vis_f = runs_150["fused"]
    _, res_p, vis_p = runs_150["plain"]
    assert abs(res_f.score - res_p.score) < 1e-3
    assert vis_f.fractions[0] == 0.0 and vis_p.fractions[0] == 0.0
    assert 1 <= len(vis_f.improvements) <= len(vis_p.improvements)
    assert set(vis_f.improvements) <= set(vis_p.improvements)


def _run_small(threshold=0.99, n=80, inflight=None, **kw):
    """An ``n``-point noisy pair whose search improves over several
    steps (B = 2), at ``terminate_threshold=threshold``; kw over its
    options. Returns (matcher, result, visitor). With ``inflight`` the
    search alone runs (``_perform_steps(..., inflight)``) and the result
    is None: compare the matcher's state."""
    rng = np.random.default_rng(42)
    pos = _bumpy(rng, 150)[:n]
    ang = 0.9
    rot = np.array([[np.cos(ang), -np.sin(ang), 0],
                    [np.sin(ang), np.cos(ang), 0], [0, 0, 1]], np.float32)
    q = (pos @ rot.T + np.float32([0.2, -0.1, 0.3])
         + np.random.default_rng(1).normal(scale=0.03, size=pos.shape)
         ).astype(np.float32)
    opts = s4t.Options(delta=0.05, sample_size=n, max_time_seconds=600,
                       max_quads=512, max_candidates=1024, random_seed=7,
                       bases_per_step=2, search_escalation_stages=0)
    opts = opts.configure_overlap(min(0.9, threshold),
                                  terminate_threshold=threshold)
    m = s4t.MatchSuper4PCS(opts.replace(**kw), device="cpu")
    vis = _Recorder()
    P, Q = s4t.PointCloud(pos), s4t.PointCloud(q)
    if inflight is None:
        return m, m.compute_transformation(P, Q, visitor=vis), vis
    with torch.no_grad():
        m._init(P, Q)
        m._perform_steps(vis, inflight=inflight)
    return m, None, vis


def _same_registration(a, b):
    """The same trials, score, transform and ids: of the results where
    both runs have one, and always of the matchers' best-so-far."""
    (ma, ra, _), (mb, rb, _) = a, b
    if ra is not None and rb is not None:
        assert ra.n_trials == rb.n_trials
        assert ra.score == rb.score
        np.testing.assert_array_equal(ra.transform, rb.transform)
    assert ma._trial == mb._trial
    assert ma._best_lcp == mb._best_lcp
    np.testing.assert_array_equal(ma._transform, mb._transform)
    np.testing.assert_array_equal(ma._base_ids, mb._base_ids)
    np.testing.assert_array_equal(ma._congruent_ids, mb._congruent_ids)


def test_fused_run_with_polish_equals_per_step_run():
    """Refine on, both runs ending on the trial estimate after several
    improvements: the fused run (dispatches ending at each improving
    step, the polish on the host) lands the per-step run's registration
    bit for bit, in fewer visitor callbacks."""
    fused = _run_small(steps_per_dispatch=8)
    plain = _run_small(steps_per_dispatch=1)
    _same_registration(fused, plain)
    m, res, vis = fused
    assert res.n_trials >= 8 * m._b_eff        # it ran many steps
    assert res.stats["fused_dispatches"] > 1
    assert len(plain[2].improvements) >= 2
    assert 1 <= len(vis.improvements) <= len(plain[2].improvements)
    assert set(vis.improvements) <= set(plain[2].improvements)
    # a dispatch that ends at an improvement had one step in flight
    assert 0 < res.stats["steps_abandoned"] <= res.stats["fused_dispatches"]


def test_fused_run_that_escalates_equals_per_step_run():
    """The trial estimate runs out below the threshold: the fused loop
    escalates the search factor and hands over to the per-step loop
    (K = 1 at a factor of 2), which runs the steps the per-step run
    runs after its own escalation; both land the same registration bit
    for bit (the best step rank handed over is the per-step loop's)."""
    kw = dict(n=60, max_pairs=512, search_escalation_stages=1)
    fused = _run_small(steps_per_dispatch=8, **kw)
    plain = _run_small(steps_per_dispatch=1, **kw)
    _same_registration(fused, plain)
    for _, res, _ in (fused, plain):
        assert res.stats["escalated_to"] == 2.0
    assert fused[0]._fused_k == 1 and fused[1].stats["fused_dispatches"] > 1


def test_each_escalation_runs_a_step_past_the_old_estimate():
    """A step of 64 trials outruns the trial estimate (35) at every rung:
    the search runs one step at each of the three factors (1, 2, 4), as
    the per-step loop always has, however far the trial count already
    stands past the extended estimate, and enqueues no step that the
    estimate cannot count (none is abandoned). Fused and per-step runs
    alike."""
    for k in (8, 1):
        m, res, _ = _run_small(n=60, max_pairs=512, bases_per_step=64,
                               search_escalation_stages=2,
                               steps_per_dispatch=k)
        assert m.number_of_trials < 64
        assert res.n_trials == 3 * 64, (k, res.n_trials)
        assert res.stats["escalated_to"] == 4.0
        assert res.stats["steps_abandoned"] == 0


def test_threshold_stop_abandons_the_step_in_flight():
    """Refine off, a threshold the search clears mid-run: the per-step
    loop with two steps in flight, the same loop with one, and the fused
    run (its device early exit) land the same registration; the two in
    flight abandon the one step enqueued past the stop, unfetched and
    uncounted, as the fused dispatch does at its exit."""
    kw = dict(refine_iterations=0, threshold=0.66)
    two = _run_small(steps_per_dispatch=1, **kw)
    one = _run_small(steps_per_dispatch=1, inflight=1, **kw)
    fused = _run_small(steps_per_dispatch=8, **kw)
    _same_registration(two, one)
    _same_registration(fused, one)
    assert two[1].score > 0.66
    assert two[1].n_trials < two[0].number_of_trials    # a threshold stop
    assert two[1].stats["steps_abandoned"] == 1
    assert one[0]._stats["steps_abandoned"] == 0
    assert fused[1].stats["steps_abandoned"] <= 1


# ----------------------------------------------------------------------
# launch accounting and capture safety
# ----------------------------------------------------------------------

def test_launch_record_replays_the_captured_increments():
    """A capture records the launches its wrappers counted and takes
    them back (a capture runs nothing); each replay adds them again."""
    added = {(k1.lcp_min_d2_within, "launches"): 3,
             (k1.lcp_min_d2, "launches"): 0,
             (k1.nearest_within, "launches"): 0,
             (k2.rowcap_capture, "launches"): 2,
             (k2.rowcap_capture, "captures"): 32,
             (k2.rowcap_capture, "filtered_launches"): 0,
             (k2x.rowcap_layout, "launches"): 1,
             (k2x.rowcap_layout, "captures"): 32}
    assert set(added) == set(COUNTERS)    # the kernels registered theirs
    start = [getattr(o, a) for o, a in COUNTERS]
    with LaunchRecord() as rec:
        for (o, a), inc in added.items():
            setattr(o, a, getattr(o, a) + inc)
    assert [getattr(o, a) for o, a in COUNTERS] == start
    assert rec.increments == [added[c] for c in COUNTERS]
    rec.replay()
    rec.replay()
    got = [getattr(o, a) - s for (o, a), s in zip(COUNTERS, start)]
    assert got == [2 * added[c] for c in COUNTERS]
    for (o, a), s in zip(COUNTERS, start):
        setattr(o, a, s)


class _HostRoundTrips(TorchDispatchMode):
    """Records the ops that a CUDA graph capture refuses on the card: a
    device value read on the host (``item``/``int``/``bool``/a branch,
    ``nonzero``, boolean-mask indexing, ``unique``, ``repeat_interleave``
    without ``output_size``) and a tensor made from host data (copied
    to the device: ``lift_fresh``). Ops inside ``skip`` depth (the
    kernels' plain CPU versions, which the card does not run) are not
    recorded."""

    def __init__(self):
        super().__init__()
        self.found, self.skip = [], 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = str(func)
        if not self.skip:
            bad = any(s in name for s in (
                "_local_scalar_dense", "lift_fresh", "nonzero",
                "masked_select", "unique"))
            bad |= ("repeat_interleave" in name
                    and kwargs.get("output_size") is None)
            if name.startswith(("aten.index.", "aten.index_put")):
                bad |= any(t is not None and t.dtype == torch.bool
                           for t in args[1])
            if bad:
                self.found.append(name)
        return func(*args, **kwargs)


_LINT_CASES = {
    "rowcap": dict(sample_size=160, pair_engine="rowcap"),
    "rowcap-filtered": dict(sample_size=160, pair_engine="rowcap",
                            max_normal_difference=20.0,
                            max_color_distance=60.0, max_angle=60.0),
    "rowcap-coarse": dict(sample_size=160, pair_engine="rowcap",
                          search_delta_factor=2.0, verify_top_k=16,
                          max_candidates=256),
    "dense-healpix": dict(sample_size=200, direction_bins="healpix",
                          max_translation_distance=0.5),
    "banded": dict(sample_size=160, pair_engine="banded"),
    "similarity-dense": dict(sample_size=40, estimate_scale=True),
    "allpairs": dict(sample_size=120, estimate_scale=True,
                     pair_engine="allpairs"),
}


@pytest.mark.parametrize("case", list(_LINT_CASES))
def test_step_and_fused_body_need_no_host_round_trip(case, monkeypatch):
    """After the warm-up step, a step (``step.run`` on its draws, every
    engine) and the fused dispatch's body make no op that a CUDA graph
    capture refuses: what the card captures (utils/graphs.py) is
    exactly what this CPU run executes, the kernels' plain versions
    aside."""
    lint = _HostRoundTrips()

    def quiet(fn):
        def wrapper(*a, **k):
            lint.skip += 1
            try:
                return fn(*a, **k)
            finally:
                lint.skip -= 1
        return wrapper

    monkeypatch.setattr(olcp, "lcp_min_d2_within",
                        quiet(k1.lcp_min_d2_within))
    monkeypatch.setattr(k2, "rowcap_capture", quiet(k2.rowcap_capture))
    kw = dict(_LINT_CASES[case])
    n = kw.pop("sample_size")
    rng = np.random.default_rng(1)
    p = _bumpy(rng, n)
    nrm = p / np.linalg.norm(p, axis=1, keepdims=True)
    q = p + np.float32(0.05)
    opts = s4t.Options(delta=0.05, sample_size=n, bases_per_step=1,
                       max_time_seconds=5, **kw)
    m = s4t.MatchSuper4PCS(opts, device="cpu")
    m._init(s4t.PointCloud(p, normal=nrm, rgb=np.abs(p) * 200),
            s4t.PointCloud(q, normal=nrm, rgb=np.abs(q) * 200))
    draws = m._draws(0)
    args = (draws, m._max_base_diameter) + m._step_args()
    m._step_fn.run(*args)                      # the warm-up
    body = tmatcher.build_multi_step(opts, m._k_quads)
    st = _packed(0.1)
    with lint:
        out = m._step_fn.run(*args)
        body(out, st)
    assert lint.found == []
