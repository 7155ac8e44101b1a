"""A run over several cards, on the CPU: ``run.py`` launches one process
a device (here two, on gloo with ``--device cpu``), each a rank of one
job; process 0 prints the line. Every process runs under the launcher's
time limit, and each test under its own. Also: entry points and data
recipes found by name as files, and ``exchange_ms`` reading the port's
collectives alone."""

import json
import os
import shutil
import subprocess
import sys

import pytest

import harness
from conftest import BENCH, ROOT, TINY_OPTIONS

#: seconds a test's run over two processes may take
LIMIT_S = 600


def _write(path, obj):
    with open(path, "w") as f:
        if isinstance(obj, str):
            f.write(obj)
        else:
            json.dump(obj, f)


#: an entry point that ends process 1 at its first call
BOOM = """import os
import torch.distributed as dist


def call(port, pairs, opts, device):
    if dist.get_rank() == 1:
        os._exit(7)
    dist.barrier()
"""

#: the mesh entry point, process 1 moving pair 0 (not in its shard)
MOVED = """import numpy as np
import torch.distributed as dist

import harness

ENTRY = harness.load_reader(harness.HERE, "entries",
                            "register_batch_global_mesh")


def call(port, pairs, opts, device):
    results = ENTRY.call(port, pairs, opts, device)
    if dist.get_rank() == 1:
        results[0].transform = np.array(results[0].transform)
        results[0].transform[0, 3] += 0.5
    return results
"""


#: the mesh entry point, process 1 loading a module named jax at its
#: first call (a stub: what matters is the name in ``sys.modules``)
JAXED = """import sys
import types

import torch.distributed as dist

import harness

ENTRY = harness.load_reader(harness.HERE, "entries",
                            "register_batch_global_mesh")


def call(port, pairs, opts, device):
    if dist.get_rank() == 1:
        sys.modules.setdefault("jax", types.ModuleType("jax"))
    return ENTRY.call(port, pairs, opts, device)
"""


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """A checkout with the benchmark's code and cells on the CPU:
    ``tiny.mesh2`` (2 pairs a call over two processes), ``tiny.batch2``
    (the same pool in one process), ``tiny.boom2``, ``tiny.moved2`` and
    ``tiny.jaxed2`` (the entry points above)."""
    root = str(tmp_path_factory.mktemp("job"))
    here = os.path.join(root, "benchmark")
    shutil.copytree(BENCH, here, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    cfg = json.load(open(os.path.join(BENCH, "configs", "scan100k.json")))
    cfg["options"] = dict(TINY_OPTIONS, max_time_seconds=8)
    cfg["overlap"] = [0.5, 0.6]
    cfg["checks"]["lcp_gap"] = 0.005
    cfg["data"]["model"]["points"] = 1500
    _write(os.path.join(here, "configs", "tiny.json"), cfg)
    _write(os.path.join(here, "entries", "boom.py"), BOOM)
    _write(os.path.join(here, "entries", "moved.py"), MOVED)
    _write(os.path.join(here, "entries", "jaxed.py"), JAXED)
    traffic = {"tmesh2": "register_batch_global_mesh",
               "tbatch2": "parallel.register_batch",
               "tboom2": "boom", "tmoved2": "moved", "tjaxed2": "jaxed"}
    for name, entry in traffic.items():
        _write(os.path.join(here, "traffic", f"{name}.json"),
               dict(entry=entry, pairs_per_call=2, calls=1, pool_seed=3))
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    bench["configs"] = [dict(name="tiny", source="test",
                             file="benchmark/configs/tiny.json", reduced=[],
                             why="test")]
    bench["workloads"] = [
        dict(name=f"tiny.{t[1:]}", config="tiny", traffic=t,
             chips=1 if t == "tbatch2" else 2, why="test")
        for t in traffic]
    if "exchange_ms" not in {m["name"] for m in bench["per_layer"]}:
        bench["per_layer"].append(dict(
            name="exchange_ms", unit="ms", better="lower",
            source="host_clock", layer="exchange", moves="pairs_per_s",
            workloads=[]))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [w["name"] for w in bench["workloads"]]
    _write(os.path.join(root, "BENCHMARK.json"), bench)
    return root, here


def _run_py(job, cell, *extra, trace=0):
    root, here = job
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run(
        [sys.executable, os.path.join(here, "run.py"), "--workload", cell,
         "--seed", str(2 ** 31 + 9), "--seconds", "0.1", "--trace",
         str(trace), "--device", "cpu", *extra], capture_output=True,
        text=True, timeout=LIMIT_S, cwd=root, env=env)


def _line(out):
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _gone(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    return False


def test_a_job_reads_as_one_process_on_the_same_pool(job):
    root, here = job
    two = _line(_run_py(job, "tiny.mesh2"))
    cell = harness.Cell(root, "tiny.batch2", here=here)
    one = harness.run(root, "tiny.batch2", 2 ** 31 + 9, 0.1, False,
                      device="cpu", cell=cell)
    assert two["correct"] is True and one["correct"] is True
    assert two["device"]["count"] == 2 and one["device"]["count"] == 1
    assert (two["attempted"], two["failed"]) == (one["attempted"],
                                                 one["failed"])
    assert set(two["metrics"]) == set(one["metrics"])
    assert list(two["checks"])[-1] == "ranks_disagree"
    assert two["checks"].pop("ranks_disagree") == {"value": 0, "limit": 0}
    # the same answers: the reference reads the same gaps
    assert two["checks"] == one["checks"]


def test_a_failing_process_ends_the_run_with_no_result(job):
    out = _run_py(job, "tiny.boom2")
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "process 1 exited 7" in out.stderr
    pids = [int(p) for p in out.stderr.split("pids ")[1].split("\n")[0]
            .split()]
    assert len(pids) == 2 and all(_gone(p) for p in pids)


def test_a_process_that_loads_jax_ends_the_run_with_no_result(job):
    out = _run_py(job, "tiny.jaxed2")
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "process 1 exited 3" in out.stderr
    assert "forbidden modules loaded: jax" in out.stderr


def test_a_process_past_the_limit_is_ended():
    import launch
    code, out = launch.launch("-c", ["import time; time.sleep(60)"], 2,
                              limit_s=1.0)
    assert code != 0 and out == ""


def test_results_that_differ_between_processes_are_caught(job):
    line = _line(_run_py(job, "tiny.moved2"))
    assert line["correct"] is False
    assert line["checks"]["ranks_disagree"]["value"] == 1
    # process 1 checks its own pair only: the moved pair 0 is process 0's
    assert line["checks"]["failed_share"]["value"] == 0


@pytest.mark.parametrize("fault", ["exchange_left_out", "half_the_pairs"])
def test_a_fault_over_two_processes_turns_correct_false(job, fault):
    line = _line(_run_py(job, "tiny.mesh2", "--fault", fault))
    assert line["correct"] is False, line["checks"]
    if fault == "exchange_left_out":
        assert line["checks"]["ranks_disagree"]["value"] >= 1
    else:
        assert line["checks"]["failed_share"]["value"] >= 0.5


def test_a_traced_job_reads_the_exchange(job):
    line = _line(_run_py(job, "tiny.mesh2", trace=1))
    assert line["correct"] is True
    assert line["metrics"]["exchange_ms"]["value"] > 0
    # process 0's span tables line up with its calls
    assert line["metrics"]["setup_span_ms"]["value"] > 0


def test_an_entry_and_a_recipe_found_by_name(tiny, tmp_path):
    root, here = tiny
    os.makedirs(os.path.join(here, "entries"), exist_ok=True)
    os.makedirs(os.path.join(here, "recipes"), exist_ok=True)
    seen = tmp_path / "seen"
    _write(os.path.join(here, "entries", "logged.py"), f"""
import harness


def call(port, pairs, opts, device):
    with open({str(seen)!r}, "a") as f:
        f.write("entry\\n")
    return harness.ENTRIES["api.register"](port, pairs, opts, device)
""")
    _write(os.path.join(here, "recipes", "logged_slabs.py"), f"""
import generate


def pair(model, data, rng):
    with open({str(seen)!r}, "a") as f:
        f.write("recipe\\n")
    return generate.slab_views(model, data, rng)
""")
    _write(os.path.join(here, "traffic", "tlogged.json"),
           dict(entry="logged", pairs_per_call=1, calls=1))
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    cfg = json.load(open(os.path.join(root, "configs", "tiny.json")))
    cfg["data"]["kind"] = "logged_slabs"
    _write(os.path.join(root, "configs", "tiny_logged.json"), cfg)
    bench["configs"].append(dict(name="tiny_logged", source="test",
                                 file="configs/tiny_logged.json",
                                 reduced=[], why="test"))
    bench["workloads"].append(dict(name="tiny_logged.tlogged",
                                   config="tiny_logged", traffic="tlogged",
                                   chips=1, why="test"))
    alt = tmp_path / "alt"
    alt.mkdir()
    _write(str(alt / "BENCHMARK.json"), bench)
    os.symlink(os.path.join(root, "configs"), alt / "configs")
    cell = harness.Cell(str(alt), "tiny_logged.tlogged", here=here)
    line = harness.run(str(alt), "tiny_logged.tlogged", 12, 0.1, False,
                       device="cpu", cell=cell)
    assert line["correct"] is True
    calls = line["attempted"]
    # the pool of one call and the warm call, each of one pair; the warm
    # call and each of the window's
    assert seen.read_text().split() == ["recipe"] * 2 + ["entry"] * (
        1 + calls)


def test_exchange_reads_the_port_collectives_not_the_harness(
        tmp_path):
    import torch
    import torch.distributed as dist
    import ranks
    import tracing
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            world_size=1, rank=0)
    try:
        with tracing.Watch(exchange=True) as watch:
            assert ranks._from_rank0(5) == 5
            assert ranks._gathered("x") == ["x"]
            assert watch.exchange_s == []
            got = [None]
            dist.all_gather_object(got, 1)
            dist.broadcast(torch.zeros(1), 0)
            assert len(watch.exchange_s) == 2
        # the proxies are gone
        dist.broadcast(torch.zeros(1), 0)
        assert len(watch.exchange_s) == 2
        assert not isinstance(dist.broadcast, tracing._Proxy)
    finally:
        dist.destroy_process_group()
    rec = dict(calls=[dict(pairs=4, exchange_s=0.02),
                      dict(pairs=4, exchange_s=0.06)])
    reader = harness.load_reader(BENCH, "metrics", "exchange_ms")
    assert reader.read(rec) == pytest.approx(10.0)
    assert reader.read(dict(calls=[dict(pairs=4)])) is None
