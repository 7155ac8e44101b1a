"""The harness: cells, traffic and metrics found by name, the result
line's keys, and no module of jax or the JAX package loaded."""

import json
import os
import subprocess
import sys

import harness
from conftest import BENCH, ROOT

CONTRACT = {"correct", "attempted", "failed", "metrics", "device",
            "breakdown", "checks"}


def test_new_config_traffic_and_metric_are_files(tiny, tmp_path):
    root, here = tiny
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    # a configuration, a traffic mix and a per-layer metric, each a new
    # file, and their entries: no file that was there is edited
    cfg = json.load(open(os.path.join(root, "configs", "tiny.json")))
    cfg["options"]["sample_size"] = 100
    json.dump(cfg, open(os.path.join(root, "configs", "tiny2.json"), "w"))
    json.dump(dict(entry="api.register", pairs_per_call=1, calls=1),
              open(os.path.join(here, "traffic", "tnew.json"), "w"))
    with open(os.path.join(here, "metrics", "calls_seen.py"), "w") as f:
        f.write('LAYER = "test"\nUNIT = "calls"\nMOVES = "pairs_per_s"\n'
                'def read(rec):\n    return float(len(rec["calls"]))\n')
    new = dict(bench)
    new["configs"] = bench["configs"] + [dict(
        name="tiny2", source="test", file="configs/tiny2.json", reduced=[],
        why="test")]
    new["workloads"] = bench["workloads"] + [dict(
        name="tiny2.tnew", config="tiny2", traffic="tnew", chips=1,
        why="test")]
    new["per_layer"] = bench["per_layer"] + [dict(
        name="calls_seen", unit="calls", better="higher",
        source="host_clock", layer="test", moves="pairs_per_s",
        workloads=["tiny2.tnew"])]
    alt = tmp_path / "alt"
    alt.mkdir()
    (alt / "BENCHMARK.json").write_text(json.dumps(new))
    os.symlink(os.path.join(root, "configs"), alt / "configs")
    cell = harness.Cell(str(alt), "tiny2.tnew", here=here)
    assert cell.config["options"]["sample_size"] == 100
    assert cell.traffic["entry"] == "api.register"
    assert [m["name"] for m in cell.per_layer] == ["calls_seen"]
    line = harness.run(str(alt), "tiny2.tnew", 11, 0.1, True, device="cpu",
                       cell=cell)
    assert line["correct"] is True
    assert line["metrics"]["calls_seen"] == {"value": 1.0, "unit": "calls"}


def test_line_has_the_contract_keys_and_checks_last(tiny):
    root, here = tiny
    cell = harness.Cell(root, "tiny.pair", here=here)
    line = harness.run(root, "tiny.pair", 2 ** 31 + 5, 0.1, False,
                       device="cpu", cell=cell)
    assert set(line) <= CONTRACT and list(line)[-1] == "checks"
    assert line["correct"] is True
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["metrics"]) == {"pairs_per_s", "pose_p50_s",
                                    "pose_p90_s", "setup_s"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for check in line["checks"].values():
        assert set(check) == {"value", "limit"}
        assert check["value"] <= check["limit"]


def test_readers_agree_with_benchmark_json():
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    for kind, metrics in (("end_to_end", bench["end_to_end"]),
                          ("metrics", bench["per_layer"])):
        for m in metrics:
            mod = harness.load_reader(BENCH, kind, m["name"])
            assert mod.UNIT == m["unit"]
            if kind == "metrics":
                assert mod.LAYER == m["layer"] and mod.MOVES == m["moves"]


def test_a_dry_run_loads_no_jax_nor_the_jax_package(tiny):
    root, here = tiny
    code = f"""
import sys
sys.path[:0] = [{BENCH!r}, {ROOT!r}]
import run, harness, tracing, faults, generate, control
import roofline.k1, roofline.k2
from reference import lcp
cell = harness.Cell({root!r}, "tiny.pair", here={here!r})
line = harness.run({root!r}, "tiny.pair", 3, 0.1, False, device="cpu",
                   cell=cell)
for m in ("metrics", "end_to_end"):
    for f in __import__("os").listdir({here!r} + "/" + m):
        cell.reader(m, f[:-3])
assert line["correct"], line
print("LOADED", sorted({{k.split(".")[0] for k in sys.modules}}))
print("FORBIDDEN", harness.forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = out.stdout.split("LOADED ")[1].splitlines()[0]
    assert "super4pcs_tpu_torch" in loaded
    for name in ("'jax'", "'jaxlib'", "'flax'", "'super4pcs_tpu'"):
        assert name not in loaded
    assert out.stdout.strip().endswith("FORBIDDEN []")


def test_forbidden_names_are_compared_whole(monkeypatch):
    before = harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "super4pcs_tpu_torch.x", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    assert harness.forbidden_modules() == before
    monkeypatch.setitem(sys.modules, "super4pcs_tpu.options", sys)
    assert "super4pcs_tpu" in harness.forbidden_modules()


def test_run_refuses_without_a_card():
    out = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"),
                          "--workload", "scan100k.pair", "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
