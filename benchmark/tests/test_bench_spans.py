"""The readers of the port's span tables on synthetic records and tables,
the span report's idle split by stage on synthetic profiler events, and
the readers that were there before them reading the same with or
without the port's tables."""

import collections
import copy
import io
import json
import os
from types import SimpleNamespace

import pytest
import torch

import harness
import span_report
import super4pcs_tpu_torch.utils.profiling as profiling
from conftest import BENCH, ROOT

NEW = ("setup_span_ms", "device_allocs_per_pair", "refine_device_ms",
       "step_device_ms")
#: the per-layer metrics from before the span tables, which read none
BEFORE = ("outside_search_ms", "trials_per_search_s", "refine_ms",
          "k2_roofline", "k1_roofline", "device_idle")


def _row(count, host, dev=None):
    return {"count": count, "host_s": host, "device_s": dev}


def _table(pairs, setup, refine_dev, steps, step_dev, allocs):
    return {"call": 1, "pairs": pairs, "index_builds": 2,
            "device_allocs": allocs,
            "spans": {
                "call": _row(1, 0.9),
                "setup": _row(1, setup),
                "setup/warm": _row(1, setup / 2),
                "setup/warm/refine": _row(1, 0.01, refine_dev / 2),
                "search": _row(1, 0.4),
                "search/step": _row(steps, 0.3, step_dev),
                "search/refine": _row(2, 0.1, refine_dev / 4),
                "refine": _row(1, 0.1, refine_dev / 4),
                "redeem": _row(1, 0.2),
                "redeem/call": _row(1, 0.2),
                "redeem/call/search/step": _row(5, 0.1, 9.0),
                "finish": _row(1, 0.001)}}


def _record():
    calls = [dict(wall_s=1.0, search_s=0.4, trials=64, pairs=1,
                  refine_s=0.2),
             dict(wall_s=2.0, search_s=0.8, trials=256, pairs=4,
                  refine_s=0.3)]
    trace = {"busy_s": 1.0, "window_s": 4.0, "idle_gaps": [],
             "kernels": {}, "work": {}}
    return dict(calls=calls, window_s=50.0, setup_s=9.0, trace=trace,
                pose_s=[1.0] * 5, pairs=5, good=5)


def _tables():
    """The port's last tables: a warm call's, then the window's two."""
    return [_table(1, 9.0, 9.0, 9, 9.0, 999),
            _table(1, 0.5, 0.2, 4, 0.04, 10),
            _table(4, 0.3, 0.1, 6, 0.06, 30)]


@pytest.fixture
def kept(monkeypatch):
    """The port's ring of recent tables, set to ``_tables()``."""
    ring = collections.deque(_tables())
    monkeypatch.setattr(profiling, "_RECENT", ring)
    return ring


def _read(name, rec):
    return harness.load_reader(BENCH, "metrics", name).read(rec)


def test_the_span_readers_read_the_window_calls_tables(kept):
    rec = _record()
    assert _read("setup_span_ms", rec) == pytest.approx(1e3 * 0.8 / 5)
    assert _read("device_allocs_per_pair", rec) == pytest.approx(40 / 5)
    # every "refine" span, the warm-up's and the in-loop ones included
    assert _read("refine_device_ms", rec) == pytest.approx(1e3 * 0.3 / 5)
    # the call's own steps, not the straggler's
    assert _read("step_device_ms", rec) == pytest.approx(1e3 * 0.1 / 10)


def test_the_span_readers_read_nothing_from_a_program_without_tables(
        kept, monkeypatch):
    """A program without ``profiling.recent``, tables that do not line
    up with the window's calls, and a run off the card (no device
    seconds or allocations) give None, never an error."""
    rec = _record()
    cpu = _tables()
    for t in cpu:
        del t["device_allocs"]
        for row in t["spans"].values():
            row["device_s"] = None
    kept.clear()
    kept.extend(cpu)
    for name in ("device_allocs_per_pair", "refine_device_ms",
                 "step_device_ms"):
        assert _read(name, rec) is None, name
    assert _read("setup_span_ms", rec) > 0
    # the last call's table is not its own: another pair count, or a
    # root longer than the call's wall
    for bad in ({"pairs": 2}, {"spans": dict(cpu[2]["spans"],
                                             call=_row(1, 2.5))}):
        kept.clear()
        kept.extend(cpu[:2] + [dict(cpu[2], **bad)])
        for name in NEW:
            assert _read(name, rec) is None, name
    kept.clear()
    kept.extend(cpu[2:])
    for name in NEW:
        assert _read(name, rec) is None, name
    monkeypatch.delattr(profiling, "recent")
    kept.extend(cpu)
    for name in NEW:
        assert _read(name, rec) is None, name


def test_the_readers_before_read_the_same_with_or_without_tables(
        kept):
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    old = [m["name"] for m in bench["per_layer"] if m["name"] in BEFORE]
    assert len(old) == len(BEFORE)
    with_tables = {}
    for name in old:
        with_tables[name] = _read(name, _record())
    e2e = {m["name"]: harness.load_reader(BENCH, "end_to_end", m["name"])
           for m in bench["end_to_end"]}
    e2e_with = {k: mod.read(_record()) for k, mod in e2e.items()}
    kept.clear()
    for name in old:
        assert _read(name, _record()) == with_tables[name], name
    for k, mod in e2e.items():
        assert mod.read(_record()) == e2e_with[k], k


def _event(name, start, end, device=False):
    cuda = torch.autograd.DeviceType.CUDA
    return SimpleNamespace(
        name=name, time_range=SimpleNamespace(start=start, end=end),
        device_type=cuda if device else torch.autograd.DeviceType.CPU,
        is_user_annotation=False)


def test_idle_by_stage_and_busy_add_up_to_the_stretch():
    """Two registrations in a 1 s stretch (microseconds): the idle time
    inside each stage range is exact, a nested registration's stages
    count in its parent's stage, and the split plus the busy time is
    the stretch."""
    events = [
        _event("register", 50_000, 600_000),
        _event("s4p.call", 100_000, 500_000),
        _event("s4p.setup", 100_000, 300_000),
        _event("s4p.setup.sample", 100_000, 200_000),
        _event("s4p.search", 300_000, 450_000),
        _event("s4p.redeem", 450_000, 490_000),
        _event("s4p.redeem.call", 450_000, 490_000),
        _event("s4p.redeem.call.setup", 450_000, 470_000),
        _event("s4p.call", 700_000, 900_000),
        _event("s4p.setup", 700_000, 800_000),
        # kernels: 50 ms in the first setup, 100 ms in the search (two
        # overlapping), 10 ms in the redemption, 20 ms outside any call
        _event("k", 250_000, 300_000, True),
        _event("k", 320_000, 400_000, True),
        _event("k", 380_000, 420_000, True),
        _event("k", 455_000, 465_000, True),
        _event("k", 600_000, 620_000, True),
    ]
    split = span_report.idle_by_stage(events, 1.0)
    busy = 0.18
    assert split["setup"] == pytest.approx(0.15 + 0.1)
    assert split["search"] == pytest.approx(0.05)
    assert split["redeem"] == pytest.approx(0.03)
    # the second call: 100 ms after its setup
    assert split["call"] == pytest.approx(0.01 + 0.1)
    assert sum(split.values()) + busy == pytest.approx(1.0)
    assert split["outside"] == pytest.approx(1.0 - 0.18 - 0.25 - 0.05
                                             - 0.03 - 0.11)
    assert set(split) == {"setup", "search", "redeem", "call", "outside"}


def test_no_idle_split_without_a_registration_range():
    events = [_event("register", 0, 500_000),
              _event("k", 100_000, 200_000, True)]
    assert span_report.idle_by_stage(events, 1.0) is None


def test_a_cpu_traced_batch_run_reads_its_tables(tiny, monkeypatch):
    """The window's calls find their tables among the port's recent
    ones: a CPU run reads its host spans and no device span, and the
    span report lays them out."""
    root, here = tiny
    seen = {}
    real = harness.record

    def record(*args, **kw):
        seen["rec"] = real(*args, **kw)
        return seen["rec"]

    monkeypatch.setattr(harness, "record", record)
    cell = harness.Cell(root, "tiny.batch", here=here)
    line = harness.run(root, "tiny.batch", 7, 0.1, True, device="cpu",
                       cell=cell)
    assert line["correct"] is True
    assert line["metrics"]["setup_span_ms"]["value"] > 0
    for name in ("device_allocs_per_pair", "refine_device_ms",
                 "step_device_ms"):
        assert name not in line["metrics"], name
    out = io.StringIO()
    span_report.report(copy.deepcopy(seen["rec"]), out=out)
    text = out.getvalue()
    assert "spans over" in text and "  setup " in text
    assert "calls within 1% + 5 ms" in text
