"""The port's span tables on the CPU (``utils/profiling.py``): the tree
and counts of ``stats["spans"]`` for ``register`` and
``register_batch`` (a straggler's registration nested under "redeem"),
registrations unchanged under an active ``torch.profiler`` with the
``s4p.*`` ranges in its events, and no profiler range entered without
one. The device seconds and allocations are held on the card in
tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import super4pcs_tpu_torch as s4t
from super4pcs_tpu_torch import matcher as tmatcher
from super4pcs_tpu_torch.ops import refine
from super4pcs_tpu_torch.parallel import batch
from super4pcs_tpu_torch.parallel import register_batch
from super4pcs_tpu_torch.utils import profiling

from _torch_threads import one_torch_thread_per_worker  # noqa: F401

#: the stages every registration opens
_TREE = {"call", "setup", "setup/sample", "setup/build", "setup/warm",
         "setup/verify", "search", "search/step", "finish"}


def _bumpy(rng, n):
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    bump = (1.0 + 0.3 * np.sin(5 * v[:, 0]) * np.cos(3 * v[:, 1])
            + 0.2 * np.sin(4 * v[:, 2]))
    return (v * bump[:, None]).astype(np.float32)


def _pair(n, overlap=0.99):
    """An ``n``-point noisy pair whose search improves
    (tests/test_torch_dispatch.py's pair), and its options: four bases a
    step, refine on, the overlap and stop at ``overlap`` (0.99: three
    steps, 0.999: two)."""
    pos = _bumpy(np.random.default_rng(42), 150)[:n]
    ang = 0.9
    rot = np.array([[np.cos(ang), -np.sin(ang), 0],
                    [np.sin(ang), np.cos(ang), 0], [0, 0, 1]], np.float32)
    q = (pos @ rot.T + np.float32([0.2, -0.1, 0.3])
         + np.random.default_rng(1).normal(scale=0.03, size=pos.shape)
         ).astype(np.float32)
    opts = s4t.Options(delta=0.05, sample_size=n, max_time_seconds=600,
                       max_quads=256, max_candidates=1024, random_seed=7,
                       bases_per_step=4, search_escalation_stages=0,
                       pair_engine="rowcap"
                       ).configure_overlap(overlap,
                                           terminate_threshold=overlap)
    return opts, s4t.PointCloud(pos), s4t.PointCloud(q)


def _register(n=60, overlap=0.99, **kw):
    opts, P, Q = _pair(n, overlap)
    m = s4t.MatchSuper4PCS(opts.replace(**kw), device="cpu")
    return m, m.compute_transformation(P, Q)


def _well_formed(table):
    """Every path's parent is in the table, no child's host seconds
    exceed its parent's, and a path has device seconds only on the
    card."""
    spans = table["spans"]
    assert list(spans)[0] == "call"
    for path, row in spans.items():
        assert set(row) == {"count", "host_s", "device_s"}
        assert row["count"] >= 1 and row["host_s"] >= 0
        assert row["device_s"] is None
        if path != "call":
            assert (path.rpartition("/")[0] or "call") in spans, path
        prefix = "" if path == "call" else path
        children = [r["host_s"] for p, r in spans.items()
                    if p != "call" and p.rpartition("/")[0] == prefix]
        assert sum(children) <= row["host_s"], path
    assert "device_allocs" not in table


def test_register_span_tree_and_counts(monkeypatch):
    """A small rowcap run: the stages' tree, a step span per step run
    (the CPU runs no step past the stop), a refine span per refine made,
    no capture (no graph is built on the CPU), "search" at least the
    search seconds and within 1 ms of them, and the verify index built
    counted."""
    refines = []
    real = refine.refine_transform

    def counted(*args, **kwargs):
        refines.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(refine, "refine_transform", counted)
    m, res = _register()
    table = res.stats["spans"]
    spans = table["spans"]
    _well_formed(table)
    assert _TREE <= set(spans)
    assert all(row["count"] == 1 for p, row in spans.items()
               if p.count("/") == 0 or p.startswith("setup/"))
    assert spans["search/step"]["count"] == res.n_trials // m._b_eff == 3
    assert len(refines) >= 2 and "search/refine" in spans
    assert sum(row["count"] for p, row in spans.items()
               if p.rpartition("/")[2] == "refine") == len(refines)
    assert not any(p.endswith("capture") for p in spans)
    search = spans["search"]["host_s"]
    assert res.stats["search_seconds"] <= search
    assert search - res.stats["search_seconds"] < 1e-3
    assert res.stats["initial_verify_seconds"] == \
        spans["setup/verify"]["host_s"]
    assert res.stats["compile_seconds"] == (
        spans["setup/build"]["host_s"] + spans["setup/warm"]["host_s"])
    assert table["index_builds"] == m._p_index.builds >= 1
    assert "refine_seconds" not in res.stats
    assert table["pairs"] == 1 and profiling.recent(1)[0] is table


class _QuickStraggler(tmatcher.MatchSuper4PCS):
    """A straggler's matcher that registers nothing: its own stages
    only, each opened and closed."""

    def _register(self, P, Q, visitor, resume_state):
        with profiling.span("setup"):
            pass
        with profiling.span("search"):
            pass
        return tmatcher.RegistrationResult(
            score=0.0, transform=np.eye(4, dtype=np.float32),
            transformed_q=Q, n_trials=0, improved=False,
            stats={"search_seconds": 0.0})


def test_register_batch_shares_one_table_with_stragglers_under_redeem(
        monkeypatch):
    """A batch of a posed pair and an unrelated one: every result
    carries the one table of the call, whose straggler registrations
    each sit as a "call" under "redeem", with their own stages."""
    monkeypatch.setattr(batch, "MatchSuper4PCS", _QuickStraggler)
    opts, P, Q = _pair(40)
    other = s4t.PointCloud(_bumpy(np.random.default_rng(5), 40) * 1.3)
    results = register_batch([(P, Q), (P, other)],
                             opts.replace(pair_engine="auto"), device="cpu")
    table = results[0].stats["spans"]
    assert all(r.stats["spans"] is table for r in results)
    _well_formed(table)
    spans = table["spans"]
    stragglers = sum(r.score < opts.terminate_threshold for r in results)
    assert stragglers >= 1
    assert _TREE | {"refine", "redeem", "redeem/call", "redeem/call/setup",
                    "redeem/call/search"} <= set(spans)
    assert spans["redeem"]["count"] == 1
    assert spans["redeem/call"]["count"] == stragglers
    assert spans["search/step"]["count"] == results[0].n_trials // 4
    assert table["index_builds"] >= 1
    # the stragglers' registrations are not outermost: the batch's table
    # alone joins the recent ones
    assert table["pairs"] == 2 and profiling.recent(1)[0] is table


def test_results_equal_with_and_without_a_profiler():
    """A registration under an active ``torch.profiler`` is the one
    without (score, transform, trials), and the profiler's events hold
    its spans as ``s4p.*`` ranges."""
    from torch.profiler import ProfilerActivity, profile
    _, plain = _register(40, 0.999, pair_engine="auto")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, traced = _register(40, 0.999, pair_engine="auto")
    assert traced.score == plain.score
    assert traced.n_trials == plain.n_trials
    np.testing.assert_array_equal(traced.transform, plain.transform)
    names = {e.name for e in prof.events() if e.name.startswith("s4p.")}
    assert {"s4p.call", "s4p.setup", "s4p.setup.sample", "s4p.search",
            "s4p.search.step", "s4p.search.refine", "s4p.refine",
            "s4p.finish"} <= names
    assert set(traced.stats["spans"]["spans"]) == set(
        plain.stats["spans"]["spans"])


def test_no_profiler_range_without_a_profiler(monkeypatch):
    """With no profiler active no span enters a ``record_function``;
    with one, every span does."""
    entered = []
    real = torch.autograd.profiler.record_function

    def counted(name, *args):
        entered.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", counted)
    _, res = _register(40, 0.999, pair_engine="auto")
    assert entered == []
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        _, res = _register(40, 0.999, pair_engine="auto")
    spans = res.stats["spans"]["spans"]
    assert len([n for n in entered if n.startswith("s4p.")]) == sum(
        row["count"] for row in spans.values())


@pytest.mark.parametrize("nested", [False, True])
def test_span_outside_a_registration_times_and_records_nothing(nested):
    """``span`` keeps its host seconds with or without a table; within
    ``call`` it adds to the table under the open span's path, and a
    second ``call`` inside is a span "call" of the same table."""
    with profiling.span("alone") as sp:
        sum(range(1000))
    assert sp.seconds > 0
    with profiling.call("cpu") as table:
        with profiling.span("a"):
            for _ in range(2):
                with profiling.span("b"):
                    profiling.count("index_builds", 2)
            if nested:
                with profiling.call("cpu") as inner:
                    with profiling.span("c"):
                        pass
                assert inner is table
    spans = table["spans"]
    assert spans["a/b"]["count"] == 2 and table["index_builds"] == 4
    assert ("a/call/c" in spans) == nested
    _well_formed(table)


def test_recent_keeps_the_tables_of_the_registrations_that_returned():
    """Outermost registrations that returned join ``recent`` in order,
    with their pairs; a nested one and one that raised do not, and the
    ring keeps the last ``RECENT_TABLES``."""
    with profiling.call("cpu", 3) as first:
        with profiling.call("cpu") as inner:
            pass
    assert inner is first and first["pairs"] == 3
    with pytest.raises(ValueError):
        with profiling.call("cpu"):
            raise ValueError
    with profiling.call("cpu") as second:
        pass
    assert [t["call"] for t in profiling.recent(2)] == [first["call"],
                                                         second["call"]]
    assert profiling.recent(0) == []
    for _ in range(profiling.RECENT_TABLES):
        with profiling.call("cpu"):
            pass
    kept = profiling.recent(profiling.RECENT_TABLES + 5)
    assert len(kept) == profiling.RECENT_TABLES
    assert second["call"] not in {t["call"] for t in kept}
