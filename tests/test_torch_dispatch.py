"""The port's dispatch layer on the CPU: its one anytime loop
(``_perform_steps``) with two steps in flight against one, the visitor
stream it gives, a resumed run's steps against an uninterrupted run's,
the launch accounting of captured steps, and the step's ops held to
what a CUDA graph capture allows (no host read of a device value, no
copy of host memory to the device). The captures themselves run on the
card (tests/test_torch_cuda.py, chip_smoke.py phase 5q).

On the CPU every comparison here is exact: each step reseeds the
generator from its index, so the runs compared draw the same trials and
make the same decisions."""

import dataclasses
import functools
import json
import math

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import super4pcs_tpu as s4j
import super4pcs_tpu_torch as s4t
from super4pcs_tpu_torch import cli as tcli
from super4pcs_tpu_torch.kernels import join as kj
from super4pcs_tpu_torch.kernels import lcp as k1
from super4pcs_tpu_torch.kernels import rowcap as k2
from super4pcs_tpu_torch.kernels import rowcap_layout as k2x
from super4pcs_tpu_torch.ops import lcp as olcp
from super4pcs_tpu_torch.utils.graphs import COUNTERS, LaunchRecord

from _torch_threads import one_torch_thread_per_worker  # noqa: F401
from test_torch_package import _JAX_ONLY_FIELDS


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
# whole runs: two steps in flight against one, the visitor stream
# ----------------------------------------------------------------------

def _fixture_150():
    """tests/test_matcher.py:620-700's fixture (its ``rng`` seed 42, the
    150-point bumpy cloud, the same options but 8 bases a step where
    the JAX test takes the default 64: a 64-trial dense step takes ~18
    s on one CPU thread): (options, P, Q)."""
    from conftest import random_rigid_transform
    rng = np.random.default_rng(42)
    pos = _bumpy(rng, 150)
    mat = random_rigid_transform(rng, max_translation=0.4)
    inv = np.linalg.inv(mat)
    q_pos = (pos @ inv[:3, :3].T + inv[:3, 3]).astype(np.float32)
    opts = s4t.Options(delta=0.05, sample_size=150, max_time_seconds=60,
                       max_quads=512, max_candidates=1024,
                       random_seed=7, bases_per_step=8
                       ).configure_overlap(0.9)
    return opts, s4t.PointCloud(pos), s4t.PointCloud(q_pos)


def _small(threshold=0.99, n=80, **kw):
    """An ``n``-point noisy pair whose search improves over several
    steps (B = 2), at ``terminate_threshold=threshold``; kw over its
    options: (options, P, Q)."""
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
    return opts.replace(**kw), s4t.PointCloud(pos), s4t.PointCloud(q)


def _register(opts, P, Q, inflight=2, **kw):
    """A registration on the CPU whose search keeps ``inflight`` steps
    enqueued; kw to ``compute_transformation``. Returns (matcher,
    result, visitor)."""
    m = s4t.MatchSuper4PCS(opts, device="cpu")
    m._perform_steps = functools.partial(m._perform_steps,
                                         inflight=inflight)
    vis = _Recorder()
    return m, m.compute_transformation(P, Q, visitor=vis, **kw), vis


def _same_registration(a, b):
    """The same trials, score, transform and ids."""
    (ma, ra, _), (mb, rb, _) = a, b
    assert ra.n_trials == rb.n_trials
    assert ra.score == rb.score
    np.testing.assert_array_equal(ra.transform, rb.transform)
    np.testing.assert_array_equal(ma._base_ids, mb._base_ids)
    np.testing.assert_array_equal(ma._congruent_ids, mb._congruent_ids)


#: the runs compared, each with the search factor it ends at: the
#: fixture, a search refining several improvements (polish), one that
#: escalates one rung, and one that climbs every rung
_CASES = {
    "fixture-150": (_fixture_150, {}, 1.0),
    "polish": (_small, {}, 1.0),
    "one-rung": (_small, dict(n=60, max_pairs=512,
                              search_escalation_stages=1), 2.0),
    "every-rung": (_small, dict(n=60, max_pairs=512,
                                search_escalation_stages=2), 4.0),
}


@pytest.fixture(scope="module")
def runs():
    """The registration of each case at each ``inflight``, made once."""
    made = {}

    def get(case, inflight):
        if (case, inflight) not in made:
            make, kw, _ = _CASES[case]
            made[case, inflight] = _register(*make(**kw), inflight=inflight)
        return made[case, inflight]
    return get


@pytest.mark.parametrize("case", list(_CASES))
def test_two_in_flight_land_the_one_in_flight_registration(runs, case):
    """Two steps in flight (the loop every registration runs) and one
    land the same registration bit for bit: the step enqueued ahead
    never changes what the host adopts, refines or escalates on."""
    two, one = runs(case, 2), runs(case, 1)
    _same_registration(two, one)
    want_sf = _CASES[case][2]
    for _, res, _ in (two, one):
        assert res.stats.get("escalated_to", 1.0) == want_sf
    assert one[1].stats["steps_abandoned"] == 0


@pytest.mark.parametrize("inflight", [2, 1])
@pytest.mark.parametrize("case", list(_CASES))
def test_the_visitor_stream_is_per_step(runs, case, inflight):
    """The visitor stream of the one loop: it opens at fraction 0, has
    one progress call a counted step, improvements that rise strictly
    to the result's score, and progress fractions of at most 1 that
    never fall but where an escalation extends the trial budget: once a
    rung climbed, right after the estimate ran out."""
    m, res, vis = runs(case, inflight)
    f = vis.fractions
    assert f[0] == 0.0
    assert len(f) == 1 + res.n_trials // m._b_eff
    assert vis.improvements
    assert all(a < b for a, b in zip(vis.improvements,
                                     vis.improvements[1:]))
    assert vis.improvements[-1] == res.score
    assert max(f) <= 1.0
    falls = [i for i in range(len(f) - 1) if f[i + 1] < f[i]]
    assert len(falls) == round(math.log2(_CASES[case][2]))
    assert all(f[i] >= 0.99 for i in falls)


@pytest.mark.parametrize("how", ["Options", "replace", "register", "cli"])
def test_the_port_options_reject_the_jax_only_fields(how):
    """The port has one loop, so no option selects another: the JAX
    package's fused-dispatch depth (a field the port leaves out,
    tests/test_torch_package.py) is refused wherever options come in."""
    pts = _bumpy(np.random.default_rng(0), 40)
    for name in _JAX_ONLY_FIELDS:
        kw = {name: 8}
        calls = {
            "Options": lambda: s4t.Options(**kw),
            "replace": lambda: s4t.Options().replace(**kw),
            "register": lambda: s4t.register(pts, pts, delta=0.05,
                                             sample_size=40, device="cpu",
                                             **kw),
            "cli": lambda: tcli.parse_tpu_opts(f"{name}=8"),
        }
        with pytest.raises((TypeError, ValueError), match=name):
            calls[how]()


def _recorded(m):
    """Record matcher ``m``'s fetched steps by index (the CPU's handles
    run their step when fetched)."""
    seen = {}
    launch = m._launch_step

    def recording(i, eager=False):
        handle = launch(i, eager)

        def fetch():
            seen[i] = out = handle()
            return out
        return fetch
    m._launch_step = recording
    return seen


@pytest.mark.parametrize("steps_done", [1, 3])
def test_a_resumed_run_continues_the_step_stream(steps_done):
    """A run resumed from the JAX package's exported state after
    ``steps_done`` steps draws, from there on, the steps an uninterrupted
    run draws: the same step indexes, each with the same outputs bit for
    bit."""
    opts, P, Q = _small(refine_iterations=0)
    whole = s4t.MatchSuper4PCS(opts, device="cpu")
    whole_steps = _recorded(whole)
    whole.compute_transformation(P, Q)
    assert len(whole_steps) > steps_done + 2

    jm = s4j.MatchSuper4PCS(s4j.Options(**dataclasses.asdict(opts)))
    jm._init(s4j.PointCloud(pos=P.pos), s4j.PointCloud(pos=Q.pos))
    assert jm._b_eff == opts.bases_per_step
    jm._trial = steps_done * jm._b_eff
    state = json.loads(json.dumps(jm.export_state()))

    resumed = s4t.MatchSuper4PCS(opts, device="cpu")
    resumed_steps = _recorded(resumed)
    resumed.compute_transformation(P, Q, resume_state=state)
    assert min(resumed_steps) == steps_done
    assert set(resumed_steps) <= set(whole_steps)
    for i, out in resumed_steps.items():
        want = whole_steps[i]
        assert set(out) == set(want)
        for k in out:
            np.testing.assert_array_equal(out[k], want[k], err_msg=k)


def test_each_escalation_runs_a_step_past_the_old_estimate():
    """A step of 64 trials outruns the trial estimate (35) at every rung:
    the search runs one step at each of the three factors (1, 2, 4), as
    the loop always has, however far the trial count already stands
    past the extended estimate, and enqueues no step that the estimate
    cannot count (none is abandoned)."""
    m, res, _ = _register(*_small(n=60, max_pairs=512, bases_per_step=64,
                                  search_escalation_stages=2))
    assert m.number_of_trials < 64
    assert res.n_trials == 3 * 64
    assert res.stats["escalated_to"] == 4.0
    assert res.stats["steps_abandoned"] == 0


def test_threshold_stop_abandons_the_step_in_flight():
    """Refine off, a threshold the search clears mid-run: the loop with
    two steps in flight and the same loop with one land the same
    registration; the two in flight abandon the one step enqueued past
    the stop, unfetched and uncounted."""
    args = _small(refine_iterations=0, threshold=0.66)
    two = _register(*args)
    one = _register(*args, inflight=1)
    _same_registration(two, one)
    assert two[1].score > 0.66
    assert two[1].n_trials < two[0].number_of_trials    # a threshold stop
    assert two[1].stats["steps_abandoned"] == 1
    assert one[1].stats["steps_abandoned"] == 0


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
             (k2x.rowcap_layout, "captures"): 32,
             (kj.grid_join, "launches"): 1,
             (kj.grid_join, "trials"): 16}
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
def test_step_needs_no_host_round_trip(case, monkeypatch):
    """After the warm-up step, a step (``step.run`` on its draws, every
    engine) makes no op that a CUDA graph capture refuses: what the card
    captures (utils/graphs.py) is exactly what this CPU run executes,
    the kernels' plain versions aside."""
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
    with lint:
        m._step_fn.run(*args)
    assert lint.found == []
