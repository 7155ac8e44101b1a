"""The port's bases-axis sharding (parallel/sharded.py) and its
single-process pairs-axis sharding (register_batch with a mesh), on the
CPU: a mesh names the CPU several times (``make_mesh(["cpu"] * 8)``),
standing in for the JAX tests' 8 virtual devices (tests/conftest.py).
The reduction is held to the JAX ``sharded_step`` on the same stub and
inputs, the width rule to the JAX ``resolve_bases_per_step``, sharded
runs to unsharded ones bit for bit where no candidate is dropped, and
both to tests/test_parallel.py's fixtures and gates."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import super4pcs_tpu as s4j
import super4pcs_tpu_torch as s4t
from super4pcs_tpu import matcher as jmatcher
from super4pcs_tpu.parallel import make_mesh as jax_make_mesh
from super4pcs_tpu.parallel import sharded_step as jax_sharded_step
from super4pcs_tpu_torch import matcher as tmatcher
from super4pcs_tpu_torch.parallel import (make_mesh, register_batch,
                                          sharded_step)
from super4pcs_tpu_torch.parallel.sharded import Mesh
from tests._torch_threads import one_torch_thread_per_worker  # noqa: F401
from tests.test_matcher import rot_tr_diff
from tests.test_parallel import make_pair


def _pc(pos):
    return s4t.PointCloud(pos=pos)


# ---------------------------------------------------------------------------
# the mesh and the reduction
# ---------------------------------------------------------------------------


def test_make_mesh():
    mesh = make_mesh(["cpu"] * 8)
    assert mesh.size == 8 and mesh.axis == "bases"
    assert mesh.world_size == 1 and list(mesh.local_shards()) == list(range(8))
    assert mesh.bounds(16, 3) == (6, 8)
    with pytest.raises(ValueError):
        mesh.bounds(12, 0)
    assert make_mesh(["cpu"], axis="pairs").axis == "pairs"
    with pytest.raises(ValueError, match="one type"):
        make_mesh(["cpu", "meta"])


def _jax_stub(keys, *replicated):
    """A step whose outputs are a function of its (b, 2) uint32 keys:
    the local best is the first key of the highest ``k0 % 5`` (so shards
    tie), every output names it, and the counters sum over the keys."""
    k = keys.astype(jnp.int32)
    score = (k[:, 0] % 5).astype(jnp.float32) / 4.0
    i = jnp.argmax(score)
    w = k[i].astype(jnp.float32)
    return dict(
        lcp=score[i] * 0.5, rank_lcp=score[i],
        transform=jnp.eye(4, dtype=jnp.float32) * w[1],
        qcentroid1=jnp.stack([w[0], w[1], w[0] + w[1]]),
        qcentroid2=jnp.stack([w[1], w[0], w[0] - w[1]]),
        base_ids=jnp.stack([k[i, 0], k[i, 1], k[i, 0] % 7, k[i, 1] % 7]),
        congruent_ids=jnp.stack([k[i, 1], k[i, 0], k[i, 1] % 3,
                                 k[i, 0] % 3]),
        n_congruent=jnp.sum(k[:, 0] % 3),
        cands_dropped=jnp.sum(k[:, 1] % 2),
        pair_counts=jnp.stack([k[:, 0] % (j + 2) for j in range(6)], 1))


def _torch_stub(k):
    """:func:`_jax_stub` in torch (int64 keys)."""
    score = (k[:, 0] % 5).to(torch.float32) / 4.0
    i = int(torch.argmax(score))
    w = k[i].to(torch.float32)
    return dict(
        lcp=score[i] * 0.5, rank_lcp=score[i],
        transform=torch.eye(4) * w[1],
        qcentroid1=torch.stack([w[0], w[1], w[0] + w[1]]),
        qcentroid2=torch.stack([w[1], w[0], w[0] - w[1]]),
        base_ids=torch.stack([k[i, 0], k[i, 1], k[i, 0] % 7, k[i, 1] % 7]),
        congruent_ids=torch.stack([k[i, 1], k[i, 0], k[i, 1] % 3,
                                   k[i, 0] % 3]),
        n_congruent=torch.sum(k[:, 0] % 3),
        cands_dropped=torch.sum(k[:, 1] % 2),
        pair_counts=torch.stack([k[:, 0] % (j + 2) for j in range(6)], 1))


@pytest.mark.parametrize("gather", [True, False])
def test_sharded_step_reduction_equals_jax(gather):
    """The JAX ``sharded_step`` on the 8 virtual devices and the port's
    on ``make_mesh(["cpu"] * 8)`` reduce the same stub over the same
    keys to the same outputs (the first shard wins a tie), with the
    per-base table gathered in the step or read lazily."""
    rng = np.random.default_rng(7)
    assert len(jax.devices()) == 8
    z = jnp.zeros((4, 3), jnp.float32)
    for trial in range(4):
        keys = rng.integers(0, 2 ** 20, size=(16, 2)).astype(np.uint32)
        if trial == 0:
            keys[:, 0] = 5 * (keys[:, 0] // 5)   # every shard ties
        want = jax_sharded_step(_jax_stub, jax_make_mesh(),
                                gather_telemetry=gather)(
            jnp.asarray(keys), jnp.float32(1.0), z, z, z, z, z, z)
        got = sharded_step(lambda k, dev: _torch_stub(k),
                           make_mesh(["cpu"] * 8), gather_telemetry=gather)(
            torch.as_tensor(keys.astype(np.int64)))
        assert set(got) == set(want)
        assert torch.is_tensor(got["pair_counts"]) == (not gather)
        for name, w in want.items():
            np.testing.assert_array_equal(np.asarray(got[name]),
                                          np.asarray(w), err_msg=name)


def test_resolve_bases_per_step_equals_jax():
    for kw in ({}, {"estimate_scale": True}, {"bases_per_step": 24}):
        for nq in (500, 1024, 1025, 3000, 70000):
            for m in (1, 2, 3, 5, 8):
                assert tmatcher.resolve_bases_per_step(
                    s4t.Options(**kw), nq, m) == \
                    jmatcher.resolve_bases_per_step(
                        s4j.Options(**kw), nq, m), (kw, nq, m)


# ---------------------------------------------------------------------------
# the sharded matcher
# ---------------------------------------------------------------------------


def test_sharded_matcher_recovers_transform(rng, make_transform):
    """tests/test_parallel.py's gates, over 8 shards of one base each."""
    pos, q, mat = make_pair(rng, make_transform)
    opts = s4t.Options(delta=0.05, sample_size=200, max_time_seconds=30,
                       bases_per_step=8, max_quads=1024, max_candidates=2048,
                       random_seed=7).configure_overlap(0.9)
    res = s4t.MatchSuper4PCS(opts, mesh=make_mesh(["cpu"] * 8)) \
        .compute_transformation(_pc(pos), _pc(q))
    assert res.score > 0.9
    rot_diff, tr_diff = rot_tr_diff(res.transform, mat)
    assert rot_diff <= 0.2 and tr_diff <= 0.1


def test_sharded_matches_single_device(rng, make_transform):
    """tests/test_parallel.py: the same seed finds the same best LCP
    within 0.05 (the compaction cap is split over the shards), and the
    lazy telemetry gives the gathered path's numbers."""
    pos, q, _ = make_pair(rng, make_transform, n=150)
    opts = s4t.Options(delta=0.05, sample_size=150, max_time_seconds=30,
                       bases_per_step=8, max_quads=1024, max_candidates=2048,
                       random_seed=11).configure_overlap(0.9)
    single = s4t.MatchSuper4PCS(opts, device="cpu").compute_transformation(
        _pc(pos), _pc(q))
    gather = s4t.MatchSuper4PCS(opts, mesh=make_mesh(["cpu"] * 8)) \
        .compute_transformation(_pc(pos), _pc(q))
    lazy = s4t.MatchSuper4PCS(
        opts.replace(sharded_gather_telemetry=False),
        mesh=make_mesh(["cpu"] * 8)).compute_transformation(_pc(pos),
                                                            _pc(q))
    assert abs(single.score - gather.score) < 0.05
    assert lazy.score == gather.score
    for key in ("pairs_overflow", "quads_overflow", "cell_dropped",
                "n_congruent", "n_pairs", "cands_overflow"):
        assert lazy.stats[key] == gather.stats[key], key


@pytest.mark.parametrize("engine,m", [("dense", 4), ("rowcap", 2)])
def test_sharded_equals_unsharded_bit_for_bit(rng, make_transform, engine,
                                              m):
    """Where no shard drops a candidate and every candidate is scored
    exactly (no more than verify_top_k of them), a sharded run draws and
    tries the same bases and picks the same candidate: the same trials,
    LCP, transform and telemetry, bit for bit. The fixture's noise keeps
    the LCP below the threshold, so the search runs its whole trial
    estimate (escalation off: it stops on the trials, not the clock)."""
    pos, q, _ = make_pair(rng, make_transform, n=80)
    q = (q + rng.normal(scale=0.02, size=q.shape)).astype(np.float32)
    opts = s4t.Options(delta=0.05, sample_size=80, max_time_seconds=60,
                       bases_per_step=4, max_quads=512,
                       max_candidates=4096, verify_top_k=4096,
                       pair_engine=engine, random_seed=4,
                       search_escalation_stages=0).configure_overlap(0.95)
    single = s4t.MatchSuper4PCS(opts, device="cpu").compute_transformation(
        _pc(pos), _pc(q))
    shard = s4t.MatchSuper4PCS(opts, mesh=make_mesh(["cpu"] * m)) \
        .compute_transformation(_pc(pos), _pc(q))
    assert single.stats["cands_overflow"] == 0
    assert shard.stats["cands_overflow"] == 0
    assert single.n_trials >= 12 and single.score < 1.0
    assert shard.n_trials == single.n_trials
    assert shard.score == single.score
    np.testing.assert_array_equal(shard.transform, single.transform)
    for key in ("n_pairs", "n_congruent", "pairs_overflow",
                "quads_overflow", "cell_dropped", "q_sampled_out"):
        assert shard.stats[key] == single.stats[key], key


def test_sharded_api_and_validation(rng, make_transform):
    """``register(mesh=)`` runs the sharded matcher; bases_per_step must
    divide over the mesh (tests/test_parallel.py), the automatic width
    rounds up to it, and a mesh across processes is register_batch's."""
    pos, q, _ = make_pair(rng, make_transform, n=100)
    res = s4t.register(pos, q, overlap=0.9, delta=0.05, sample_size=100,
                       max_time_seconds=30, bases_per_step=4,
                       mesh=make_mesh(["cpu"] * 2))
    assert res.score > 0.9
    with pytest.raises(ValueError, match="divisible"):
        s4t.MatchSuper4PCS(s4t.Options(bases_per_step=6),
                           mesh=make_mesh(["cpu"] * 8))
    with pytest.raises(ValueError, match="divisible"):
        s4t.register(pos, q, bases_per_step=6, mesh=make_mesh(["cpu"] * 4))
    with pytest.raises(ValueError, match="processes"):
        s4t.Match4PCS(s4t.Options(), mesh=Mesh(
            devices=(torch.device("cpu"),) * 2, group=object()))
    m = s4t.MatchSuper4PCS(s4t.Options(delta=0.05, sample_size=100),
                           mesh=make_mesh(["cpu"] * 3))
    m._init(_pc(pos), _pc(q))
    assert m._b_eff == 66


def test_hierarchical_scale_gives_both_phases_the_mesh():
    """The two phases of the hierarchical similarity solve run on the
    caller's mesh (the JAX matcher passes it to both)."""
    seen = []

    class Recording(s4t.MatchSuper4PCS):
        def compute_transformation(self, P, Q, visitor=None,
                                   resume_state=None):
            o = self.options
            if o.estimate_scale and o.sample_size > o.scale_max_q:
                return super().compute_transformation(P, Q, visitor)
            seen.append((self._mesh, self.options.estimate_scale))
            mat = np.diag([1.5, 1.5, 1.5, 1.0]).astype(np.float32)
            return tmatcher.RegistrationResult(
                score=0.9, transform=mat, transformed_q=None, n_trials=4,
                improved=True, stats={})

    mesh = make_mesh(["cpu"] * 2)
    pts = np.random.default_rng(0).normal(size=(300, 3)).astype(np.float32)
    res = Recording(s4t.Options(estimate_scale=True, sample_size=300,
                                scale_max_q=64), mesh=mesh) \
        .compute_transformation(_pc(pts), _pc(pts))
    assert seen == [(mesh, True), (mesh, False)]
    assert res.stats["hierarchical_scale"] == pytest.approx(1.5)


def test_register_sequence_forwards_the_mesh(monkeypatch):
    """``register_sequence(mesh=)`` builds every step's matcher on the
    mesh (the matcher is replaced by a stub, as
    tests/test_torch_sequence.py does)."""
    from super4pcs_tpu_torch import sequence
    seen = []

    class Stub:
        def __init__(self, opts, logger=None, device="cuda", mesh=None):
            seen.append(mesh)

        def compute_transformation(self, P, Q):
            return tmatcher.RegistrationResult(
                score=1.0, transform=np.eye(4, dtype=np.float32),
                transformed_q=None, n_trials=4, improved=True, stats={})

    monkeypatch.setattr(sequence, "MatchSuper4PCS", Stub)
    mesh = make_mesh(["cpu"] * 2)
    views = [s4t.PointCloud(pos=np.random.default_rng(i).normal(
        size=(20, 3)).astype(np.float32)) for i in range(3)]
    steps = s4t.register_sequence(views, mesh=mesh, device="cpu")
    assert len(steps) == 2 and seen == [mesh, mesh]


# ---------------------------------------------------------------------------
# register_batch with a mesh on the pairs axis
# ---------------------------------------------------------------------------


def test_register_batch_sharded(rng, make_transform):
    """tests/test_parallel.py: 8 pairs over 8 devices."""
    pairs, mats = [], []
    for _ in range(8):
        pos, q, mat = make_pair(rng, make_transform, n=120)
        pairs.append((_pc(pos), _pc(q)))
        mats.append(mat)
    opts = s4t.Options(delta=0.05, sample_size=120, max_time_seconds=60,
                       bases_per_step=4, max_quads=512, max_candidates=512,
                       random_seed=3).configure_overlap(0.9)
    results = register_batch(pairs, opts,
                             mesh=make_mesh(["cpu"] * 8, axis="pairs"))
    assert len(results) == 8
    ok = sum(1 for res, mat in zip(results, mats)
             if res.score > 0.8 and max(rot_tr_diff(res.transform, mat))
             <= 0.2 and rot_tr_diff(res.transform, mat)[1] <= 0.1)
    assert ok >= 6, f"only {ok}/8 pairs registered"
    with pytest.raises(ValueError, match="divisible"):
        register_batch(pairs[:3], opts,
                       mesh=make_mesh(["cpu"] * 2, axis="pairs"))


def test_register_batch_sharded_equals_unsharded(rng, make_transform):
    """Each pair's trials are its own, whatever else its batch holds:
    two pairs over two devices give the unsharded run's results and
    state bit for bit, refine included, on the banded engine, whose
    shards read their pairs' part of the one stacked index (the dense
    engine: test_register_batch_resumes_across_meshes; the rowcap
    engine's trials: test_sharded_equals_unsharded_bit_for_bit). The
    pairs
    are ragged (sentinel padding) and noisy (the search runs its trial
    estimate; straggler redemption, which runs on the clock, is off)."""
    pairs = []
    for n in (90, 70):
        pos, q, _ = make_pair(rng, make_transform, n=n)
        q = (q + rng.normal(scale=0.02, size=q.shape)).astype(np.float32)
        pairs.append((_pc(pos), _pc(q)))
    opts = s4t.Options(delta=0.05, sample_size=90, max_time_seconds=60,
                       bases_per_step=4, max_quads=512, max_candidates=512,
                       random_seed=3, pair_engine="banded",
                       search_escalation_factor=1.0).configure_overlap(0.95)
    single = register_batch(pairs, opts, device="cpu")
    shard = register_batch(pairs, opts,
                           mesh=make_mesh(["cpu"] * 2, axis="pairs"))
    assert single[0].n_trials >= 8
    for a, b in zip(single, shard):
        assert a.score == b.score and a.n_trials == b.n_trials
        np.testing.assert_array_equal(a.transform, b.transform)
        assert a.stats["batch_state"] == b.stats["batch_state"]
    assert all(r.score > 0.6 for r in shard)
    assert shard[0].stats["band_cells"] > 0


def test_register_batch_resumes_across_meshes(rng, make_transform):
    """An unsharded run's state resumes on a mesh (and goes on with the
    same draws: the resumed run equals an unsharded resume)."""
    pos, q, _ = make_pair(rng, make_transform, n=100)
    pairs = [(_pc(pos), _pc(q))] * 2
    opts = s4t.Options(delta=0.05, sample_size=100, max_time_seconds=40,
                       bases_per_step=4, max_quads=512, max_candidates=512,
                       random_seed=5, search_escalation_factor=1.0,
                       ).configure_overlap(0.6, 0.999)
    states = []
    register_batch(pairs, opts.replace(refine_iterations=0), device="cpu",
                   on_checkpoint=states.append)
    state = states[0]
    a = register_batch(pairs, opts, device="cpu", resume_state=state)
    b = register_batch(pairs, opts, resume_state=state,
                       mesh=make_mesh(["cpu"] * 2, axis="pairs"))
    assert a[0].n_trials == b[0].n_trials > state["trial"]
    for x, y in zip(a, b):
        assert x.score == y.score
        np.testing.assert_array_equal(x.transform, y.transform)
