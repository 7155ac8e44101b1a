"""``BENCHMARK.json`` keeps to the shape the benchmark's checker reads:
names, units, lengths, the keys of each entry, and a reader and data
file for everything it names."""

import json
import os
import re

from conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCHMARK = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))


def _line(text):
    assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(BENCHMARK) == {"command", "paths", "run_seconds", "configs",
                              "workloads", "end_to_end", "per_layer"}
    assert BENCHMARK["command"] == ["python3", "benchmark/run.py"]
    assert BENCHMARK["paths"] == ["benchmark"]
    assert 1 <= BENCHMARK["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024


def test_configs_cells_and_metrics_keep_their_shape():
    configs = {c["name"]: c for c in BENCHMARK["configs"]}
    for c in BENCHMARK["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        _line(c["source"])
        _line(c["why"])
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert len(c["reduced"]) <= 16
    cells = set()
    for w in BENCHMARK["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in configs
        assert (w["config"], w["traffic"]) not in cells
        cells.add((w["config"], w["traffic"]))
        assert w["chips"] in (1, 4)
        _line(w["why"])
        assert os.path.isfile(os.path.join(BENCH, "traffic",
                                           f"{w['traffic']}.json"))
    assert sum(w["chips"] == 4 for w in BENCHMARK["workloads"]) <= max(
        1, len(BENCHMARK["workloads"]) // 4)
    used = {w["config"] for w in BENCHMARK["workloads"]}
    assert used == set(configs)
    names = [m["name"] for m in BENCHMARK["end_to_end"]
             + BENCHMARK["per_layer"]]
    assert len(names) == len(set(names))
    e2e = {m["name"] for m in BENCHMARK["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCHMARK["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cell_names = {w["name"] for w in BENCHMARK["workloads"]}
    for m in BENCHMARK["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= cell_names
        assert m["source"] in ("host_clock", "device_trace",
                               "program_span", "program_counter")
        _line(m["layer"])
    for m in BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for w in cell_names:
        assert any(w in m["workloads"] for m in BENCHMARK["per_layer"])
    for w in cell_names:
        e2e_here = {m["name"] for m in BENCHMARK["end_to_end"]
                    if w in m.get("workloads", [w])}
        assert "setup_s" in e2e_here and len(e2e_here) >= 2
