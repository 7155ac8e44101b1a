"""The port's phase timing on the CPU: ``utils/roofline.py`` held to the
JAX package's ``attribute`` and ``table`` on the same inputs and peaks,
the step's cost model held to the JAX ``step.cost_model`` term by term
(all but the join's sort and the verify, which count the port's own
code), ``Options.phase_timing`` filling ``stats["phase_seconds"]`` and
``stats["phase_roofline"]`` under the JAX keys, and ``utils/profiling``
(``trace``, ``span``, ``PhaseMarks``)."""

import math

import numpy as np
import pytest
import torch

import super4pcs_tpu as s4j
import super4pcs_tpu_torch as s4t
from super4pcs_tpu import matcher as jmatcher
from super4pcs_tpu.kernels import rowcap_pallas
from super4pcs_tpu.ops import band_extract as jband
from super4pcs_tpu.utils import roofline as jroof
from super4pcs_tpu_torch import matcher as tmatcher
from super4pcs_tpu_torch.kernels import lcp as k1
from super4pcs_tpu_torch.ops import band_extract as tband
from super4pcs_tpu_torch.ops import lcp as tlcp
from super4pcs_tpu_torch.utils import PhaseTimers, profiling
from super4pcs_tpu_torch.utils import roofline as troof
from tests._torch_threads import one_torch_thread_per_worker  # noqa: F401
from tests.test_matcher import bumpy_cloud

#: the JAX package's phase names (matcher._measure_phases)
_JAX_PHASES = ("select_extract", "join", "fit", "verify", "step_total")
#: the JAX package's roofline row keys (utils/roofline.attribute)
_JAX_ROW = ("seconds", "gflops", "gbps", "compute_pct", "memory_pct",
            "bound", "headroom_x")


@pytest.mark.parametrize("floor", [troof.DISPATCH_FLOOR_S,
                                   jroof.DISPATCH_FLOOR_S])
@pytest.mark.parametrize("peaks", ["tpu", "h100"])
def test_attribute_and_table_equal_jax(monkeypatch, floor, peaks):
    """Both functions on the same costs, seconds and peaks (with the same
    dispatch floor: the port's comes from the card) give the same rows
    and the same table: dispatch-, memory- and compute-bound phases,
    "mxu" and "vpu" units, and a phase without seconds."""
    peaks = jroof.TPU_V5E if peaks == "tpu" else troof.H100
    monkeypatch.setattr(jroof, "DISPATCH_FLOOR_S", floor)
    monkeypatch.setattr(troof, "DISPATCH_FLOOR_S", floor)
    rng = np.random.default_rng(3)
    for _ in range(20):
        costs, seconds = {}, {}
        for i in range(6):
            costs[f"p{i}"] = dict(flops=float(10 ** rng.uniform(6, 14)),
                                  hbm_bytes=float(10 ** rng.uniform(4, 12)),
                                  unit=("mxu" if i == 2 else "vpu"))
            if i != 5:
                seconds[f"p{i}"] = float(10 ** rng.uniform(-5, 0))
        seconds["step_total"] = 1.0
        want = jroof.attribute(costs, seconds, peaks)
        got = troof.attribute(costs, seconds, peaks)
        assert got == want
        assert set(got) == {f"p{i}" for i in range(5)}
        assert all(tuple(r) == _JAX_ROW for r in got.values())
        assert troof.table(got) == jroof.table(want)


def test_h100_peaks_carry_the_card():
    assert "H100" in troof.H100["name"]
    assert troof.H100["vpu_f32_flops"] == 67e12
    assert troof.H100["hbm_bytes_per_s"] == 3.35e12
    assert 0 < troof.DISPATCH_FLOOR_S < 1e-2


def _sort_terms(k1_rows, b, port):
    """The join's sort: the JAX package's bitonic network (flops,
    bytes), or the port's torch.sort (the int64 keys read once, the
    sorted keys and their int64 permutation written once)."""
    if port:
        return 0.0, b * k1_rows * 24.0
    lg = max(math.log2(max(k1_rows, 2.0)), 1.0)
    passes = lg * (lg + 1.0) / 2.0
    return b * k1_rows * passes * 2.0, b * k1_rows * 8.0 * passes


_CONFIGS = {
    "dense": (dict(delta=0.05, bases_per_step=8), 500),
    "dense-grid": (dict(delta=0.05, bases_per_step=8,
                        force_grid_join=True), 500),
    "rowcap": (dict(delta=0.02, bases_per_step=16, pair_engine="rowcap"),
               3000),
    "rowcap-wide": (dict(delta=0.02, bases_per_step=4, pair_engine="rowcap",
                         search_delta_factor=2.0), 40000),
    "rowcap-xla": (dict(delta=0.02, bases_per_step=16, pair_engine="rowcap",
                        rowcap_kernel="xla"), 3000),
    "banded": (dict(delta=0.05, bases_per_step=16, pair_engine="banded"),
               600),
    "allpairs": (dict(delta=0.05, estimate_scale=True), 3000),
}


@pytest.mark.parametrize("name", sorted(_CONFIGS))
def test_cost_model_equals_jax_but_sort_and_verify(monkeypatch, name):
    """The port's ``step.cost_model`` equals the JAX ``step.cost_model``
    on selection + extraction and fit, and on the join but for its sort;
    on the rowcap engine against the JAX package's Pallas capture
    kernel's terms (the kernel the port's K2 replaces), on its XLA route
    against its approx_max_k terms (K2x replaces that op). The verify
    counts the pruned K1's pair tests instead of the brute force."""
    kw, nq = _CONFIGS[name]
    np_ = 1234
    # the JAX rowcap engine takes its Pallas capture on a TPU only
    monkeypatch.setattr(rowcap_pallas, "supported", lambda n, filtered=False:
                        True)
    jband_idx = tband_idx = None
    if kw.get("pair_engine") == "banded":
        q = bumpy_cloud(np.random.default_rng(1), nq)
        jband_idx = jband.build_band_index(q, kw["delta"])
        tband_idx = tband.build_band_index(q, kw["delta"])
        assert (tband_idx.m, tband_idx.n, tband_idx.pc) == \
            (jband_idx.m, jband_idx.n, jband_idx.pc)
    jstep, jcaps = jmatcher.build_step(s4j.Options(**kw), nq, 0.3,
                                       band_index=jband_idx)
    tstep, tcaps = tmatcher.build_step(s4t.Options(**kw), nq, 0.3,
                                       band_index=tband_idx)
    assert tcaps == jcaps
    want = jstep.cost_model(np_)
    stage = (1, 64, nq, np_, 98765)
    got = tstep.cost_model(np_, [stage, stage])
    assert set(got) == set(want) == {"select_extract", "join", "fit",
                                     "verify"}
    for phase in ("select_extract", "fit"):
        assert got[phase] == want[phase], phase
    b = tmatcher.resolve_bases_per_step(s4t.Options(**kw), nq)
    opts = s4t.Options(**kw).replace(bases_per_step=b)
    dense_join = (name == "dense")
    if dense_join:
        assert got["join"] == want["join"]
    else:
        engine = tmatcher.resolve_pair_engine(opts, nq)
        if engine == "rowcap":
            k_pairs, _, _ = tcaps
            cap = opts.pair_row_cap or min(nq, max(32, tmatcher._round_up(
                5 * k_pairs // (2 * nq), 32)))
            if not tmatcher.uses_capture_kernel(opts, engine):
                k1_rows = float(nq) * cap      # the XLA route (K2x)
            else:
                if nq > 32768:
                    cap = min(cap, 128)
                k1_rows = float(nq) * s4t.kernels.rowcap.slots_for(nq, cap)
        elif engine == "allpairs":
            k1_rows = float(nq) * nq
        else:
            k1_rows = float(tcaps[0])
        jf, jb = _sort_terms(k1_rows, b, port=False)
        tf, tb = _sort_terms(k1_rows, b, port=True)
        assert got["join"]["flops"] == pytest.approx(
            want["join"]["flops"] - jf + tf, rel=1e-12)
        assert got["join"]["hbm_bytes"] == pytest.approx(
            want["join"]["hbm_bytes"] - jb + tb, rel=1e-12)
    assert got["verify"] == dict(
        flops=2 * 9.0 * 98765,
        hbm_bytes=2 * 4.0 * (16 * 64 + 3 * nq + 5 * np_ + 64 * nq))


def test_stage_tests_count_the_pruned_walk():
    """The verify's recorded launches (``lcp_scores(stages=)``, through
    the two-stage verify) carry their shapes and the pair tests of the
    pruned K1's walk, with the pairs axis."""
    rng = np.random.default_rng(0)
    p = torch.as_tensor(bumpy_cloud(rng, 400))
    q = p[::2].contiguous()
    tr = torch.eye(4).repeat(3000, 1, 1)
    tr[:, :3, 3] = torch.as_tensor(rng.normal(scale=0.02, size=(3000, 3)),
                                   dtype=torch.float32)
    stages = []
    index = tlcp.VerifyIndex(p)
    tlcp.lcp_scores_two_stage(tr, q, p, 0.05, top_k=256, index=index,
                              stages=stages)
    rows = tlcp.stage_tests(stages)
    assert [r[:4] for r in rows] == [(1, 3000, 50, 400), (1, 256, 200, 400)]
    _, keys, grid = k1.grid_index(p, 0.05)
    tx, ty, tz = (t.reshape(-1) for t in k1._transformed(tr[:256], q))
    walk = int(k1.walk_ranges(tx, ty, tz, keys, grid, 0.05)[1].sum())
    assert k1.pair_tests(tr[:256], q, p, 0.05) == walk > 0
    two = tlcp.stage_tests([(tr[None, :256].expand(2, -1, -1, -1),
                             q[None].expand(2, -1, -1),
                             p[None].expand(2, -1, -1), 0.05, None)])
    assert two == [(2, 256, 200, 400, 2 * walk)]


def test_phase_timing_fills_stats():
    """``Options(phase_timing=True)`` fills ``stats["phase_seconds"]``
    and ``stats["phase_roofline"]`` under the JAX keys, before the
    search: the search itself (its trials, LCP and pose) is the run
    without phase timing's. The rowcap engine: the main path's phases
    (the dense engine's per-trial loop marks its phases once a trial,
    as ``test_trace_and_timed_phase`` adds up a recurring mark)."""
    rng = np.random.default_rng(11)
    target = bumpy_cloud(rng, 100)
    ang = 1.1
    R = np.array([[np.cos(ang), -np.sin(ang), 0],
                  [np.sin(ang), np.cos(ang), 0], [0, 0, 1]], np.float32)
    source = ((target - np.float32([.4, -.2, .7])) @ R).astype(np.float32)
    opts = s4t.Options(delta=0.05, sample_size=100, max_time_seconds=30,
                       bases_per_step=4, max_candidates=512,
                       pair_engine="rowcap").configure_overlap(0.9)
    runs = [s4t.MatchSuper4PCS(opts.replace(phase_timing=on),
                               device="cpu").compute_transformation(
        s4t.PointCloud(target), s4t.PointCloud(source)) for on in (0, 1)]
    plain, timed = runs
    assert "phase_seconds" not in plain.stats
    assert timed.score == plain.score and timed.n_trials == plain.n_trials
    np.testing.assert_array_equal(timed.transform, plain.transform)
    ph = timed.stats["phase_seconds"]
    assert tuple(ph) == _JAX_PHASES
    assert all(v > 0 for v in ph.values())
    roof = timed.stats["phase_roofline"]
    assert tuple(roof) == _JAX_PHASES[:4]
    assert all(tuple(r) == _JAX_ROW for r in roof.values())
    assert all(roof[k]["seconds"] == round(ph[k], 6) for k in roof)


def test_trace_and_timed_phase(tmp_path):
    """``trace`` writes a torch.profiler trace file, with a span's
    ``s4p.*`` range in it; ``span`` accumulates a recurring stage's
    count and host seconds into the open table (device seconds only on
    the card); PhaseTimers adds up a recurring phase, and PhaseMarks
    too."""
    x = torch.arange(1000.0)
    with profiling.trace(str(tmp_path)):
        with profiling.call("cpu"), profiling.span("double"):
            (x * 2).sum()
    trace, = tmp_path.glob("*.pt.trace.json")
    assert '"s4p.double"' in trace.read_text()
    with profiling.call("cpu") as table:
        for _ in range(2):
            with profiling.span("sum", device=x.device) as sp:
                (x * 3).sum()
            assert sp.seconds > 0
    assert table["spans"]["sum"]["count"] == 2
    assert table["spans"]["sum"]["device_s"] is None
    assert 0 < table["spans"]["sum"]["host_s"] <= (
        table["spans"]["call"]["host_s"])
    timers = PhaseTimers()
    for _ in range(2):
        timers.add("sum", 0.5)
    assert timers.phases == {"sum": 1.0}
    marks = profiling.PhaseMarks("cpu")
    for name in ("a", "b", "a"):
        marks.mark(name)
        (x * 5).sum()
    marks.stop()
    sec = marks.seconds()
    assert set(sec) == {"a", "b"} and all(v > 0 for v in sec.values())
