"""Straggler redemption as the benchmark reads it: ``redeem_ms`` and
``straggler_share`` on synthetic span tables, and a run over two CPU
processes whose pairs both stay below the stop, so that every call
splits its straggler list over the processes and gathers the answers:
the readers read it, and ``exchange_left_out`` still turns it
``correct`` false by ``ranks_disagree``."""

import collections
import json
import os
import shutil
import subprocess
import sys

import pytest

import harness
import super4pcs_tpu_torch.utils.profiling as profiling
from conftest import BENCH, ROOT, TINY_OPTIONS

#: seconds a run over two processes may take
LIMIT_S = 600


def _read(name, rec):
    return harness.load_reader(BENCH, "metrics", name).read(rec)


def _table(pairs, redeem_s=None, stragglers=None):
    spans = {"call": {"count": 1, "host_s": 0.5, "device_s": None}}
    if redeem_s is not None:
        spans["redeem"] = {"count": 1, "host_s": redeem_s,
                           "device_s": None}
    table = {"call": 1, "pairs": pairs, "spans": spans}
    if stragglers is not None:
        table["stragglers"] = stragglers
    return table


def _record(*pairs):
    return dict(calls=[dict(wall_s=1.0, pairs=p) for p in pairs])


def test_the_redemption_readers_on_tables(monkeypatch):
    ring = collections.deque()
    monkeypatch.setattr(profiling, "_RECENT", ring)
    rec = _record(4, 4)
    ring.extend([_table(4, 0.2, 3), _table(4, 0.4, 1)])
    assert _read("redeem_ms", rec) == pytest.approx(1e3 * 0.6 / 8)
    assert _read("straggler_share", rec) == pytest.approx(50.0)
    # no call redeemed: redemption's counter 0, no span
    ring.extend([_table(4, stragglers=0), _table(4, stragglers=0)])
    assert _read("redeem_ms", rec) == 0.0
    assert _read("straggler_share", rec) == 0.0
    # a program that keeps no such counter (or redemption off)
    ring.extend([_table(4), _table(4)])
    assert _read("straggler_share", rec) is None
    assert _read("redeem_ms", rec) == 0.0
    # tables that are not the window's calls'
    ring.extend([_table(2, 0.2, 1)])
    for name in ("redeem_ms", "straggler_share"):
        assert _read(name, _record(4, 4)) is None


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """A checkout with the cell ``tiny.mesh2``: 2 pairs a call over two
    processes, whose stop (LCP 0.99) neither pair reaches; its 8 s
    budget leaves redemption less than its 15 s, so each process
    registers no straggler and still gathers once."""
    root = str(tmp_path_factory.mktemp("job"))
    here = os.path.join(root, "benchmark")
    shutil.copytree(BENCH, here, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    cfg = json.load(open(os.path.join(BENCH, "configs", "scan100k.json")))
    cfg["options"] = dict(TINY_OPTIONS, max_time_seconds=8)
    cfg["overlap"] = [0.5, 0.99]
    cfg["checks"]["lcp_gap"] = 0.005
    cfg["data"]["model"]["points"] = 1500
    with open(os.path.join(here, "configs", "tiny.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(here, "traffic", "tmesh2.json"), "w") as f:
        json.dump(dict(entry="register_batch_global_mesh", pairs_per_call=2,
                       calls=1, pool_seed=3), f)
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    bench["configs"] = [dict(name="tiny", source="test", reduced=[],
                             file="benchmark/configs/tiny.json", why="test")]
    bench["workloads"] = [dict(name="tiny.mesh2", config="tiny",
                               traffic="tmesh2", chips=2, why="test")]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = ["tiny.mesh2"]
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root, here


def _line(job, *extra, trace=0):
    root, here = job
    out = subprocess.run(
        [sys.executable, os.path.join(here, "run.py"), "--workload",
         "tiny.mesh2", "--seed", str(2 ** 31 + 11), "--seconds", "0.1",
         "--trace", str(trace), "--device", "cpu", *extra],
        capture_output=True, text=True, timeout=LIMIT_S, cwd=root,
        env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_traced_job_with_stragglers_reads_them(job):
    line = _line(job, trace=1)
    metrics = {k: v["value"] for k, v in line["metrics"].items()}
    assert metrics["straggler_share"] == 100.0
    # the span "redeem" holds the gather and its wait
    assert metrics["redeem_ms"] > 0 and metrics["exchange_ms"] > 0
    assert line["checks"]["ranks_disagree"]["value"] == 0
    # no pair reached the stop
    assert line["checks"]["failed_share"]["value"] == 1.0


def test_exchange_left_out_with_stragglers_turns_correct_false(job):
    line = _line(job, "--fault", "exchange_left_out")
    assert line["correct"] is False
    assert line["checks"]["ranks_disagree"]["value"] >= 1
