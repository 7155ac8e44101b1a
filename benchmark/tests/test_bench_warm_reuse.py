"""The reader ``warm_reuse_share`` on synthetic records and span tables:
the share of the window's warm-ups that reused the process's, from the
counters ``warm_full`` and ``warm_reused`` of the window's calls'
tables; None from a program without the counters or the tables."""

import collections
import copy

import pytest

import harness
import super4pcs_tpu_torch.utils.profiling as profiling
from conftest import BENCH


def _table(pairs, **counters):
    return dict({"call": 1, "pairs": pairs, "index_builds": 2,
                 "spans": {"call": {"count": 1, "host_s": 0.9,
                                    "device_s": None}}}, **counters)


def _record():
    calls = [dict(wall_s=1.0, search_s=0.4, trials=64, pairs=1,
                  refine_s=0.2),
             dict(wall_s=2.0, search_s=0.8, trials=256, pairs=4,
                  refine_s=0.3)]
    return dict(calls=calls, window_s=50.0, setup_s=9.0, trace=None,
                pose_s=[1.0] * 5, pairs=5, good=5)


#: a warm call's table (outside the window), then the window's two: a
#: pair that escalated once, a batch with one straggler
_TABLES = [_table(1, warm_full=1),
           _table(1, warm_reused=2),
           _table(4, warm_full=1, warm_reused=1)]


@pytest.fixture
def kept(monkeypatch):
    ring = collections.deque(copy.deepcopy(_TABLES))
    monkeypatch.setattr(profiling, "_RECENT", ring)
    return ring


def _read(rec):
    return harness.load_reader(BENCH, "metrics",
                               "warm_reuse_share").read(rec)


def test_the_share_of_the_window_warm_ups_that_reused(kept):
    assert _read(_record()) == pytest.approx(100.0 * 3 / 4)


@pytest.mark.parametrize("tables,want", [
    ([_table(1, warm_full=1), _table(4, warm_full=2)], 0.0),
    ([_table(1, warm_reused=1), _table(4, warm_reused=2)], 100.0),
    # a program that keeps no counters (the parent's, or a CPU run,
    # which warms nothing)
    ([_table(1), _table(4)], None),
    # tables that do not line up with the window's calls
    ([_table(1, warm_reused=1), _table(2, warm_reused=1)], None),
    ([_table(4, warm_reused=1)], None)])
def test_the_share_from_other_tables(kept, tables, want):
    kept.clear()
    kept.extend(tables)
    got = _read(_record())
    assert got == (None if want is None else pytest.approx(want))


def test_nothing_from_a_program_without_tables(kept, monkeypatch):
    monkeypatch.delattr(profiling, "recent")
    assert _read(_record()) is None
