"""Shared set-up of the benchmark's CPU tests: the benchmark's folder on
the import path, and ``tiny``: a copy of the benchmark in a temporary
folder with cells small enough for the CPU (the plain kernels)."""

from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for _p in (BENCH, ROOT):
    if _p not in sys.path:
        sys.path.insert(0, _p)

#: Options and data small enough for a CPU registration in seconds
TINY_OPTIONS = dict(delta=0.06, sample_size=120, max_time_seconds=20,
                    bases_per_step=32)


def make_tiny(tmp) -> tuple:
    """(root, here) of a benchmark copy with the cells ``tiny.pair``
    (one pair a call, a pool of 2) and ``tiny.batch`` (2 pairs a call,
    from the seed)."""
    root, here = str(tmp), os.path.join(str(tmp), "bench")
    for sub in ("metrics", "end_to_end", "traffic"):
        shutil.copytree(os.path.join(BENCH, sub), os.path.join(here, sub))
    os.makedirs(os.path.join(root, "configs"))
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    cfg = json.load(open(os.path.join(BENCH, "configs", "scan100k.json")))
    cfg["options"] = dict(TINY_OPTIONS)
    # 120 samples of a 1500-point view: the stop a CPU search reaches in
    # seconds
    cfg["overlap"] = [0.5, 0.6]
    # one sample of 120 is a gap of 0.0083: the limit sits below it
    cfg["checks"]["lcp_gap"] = 0.005
    cfg["data"]["model"]["points"] = 1500
    json.dump(cfg, open(os.path.join(root, "configs", "tiny.json"), "w"))
    traffic = {
        "tpair": dict(entry="api.register", pairs_per_call=1, calls=2,
                      pool_seed=1),
        "tbatch": dict(entry="parallel.register_batch", pairs_per_call=2,
                       calls=1)}
    for name, t in traffic.items():
        json.dump(t, open(os.path.join(here, "traffic", f"{name}.json"),
                          "w"))
    bench["configs"].append(dict(name="tiny", source="test",
                                 file="configs/tiny.json", reduced=[],
                                 why="test"))
    for cell, tr in (("tiny.pair", "tpair"), ("tiny.batch", "tbatch")):
        bench["workloads"].append(dict(name=cell, config="tiny", traffic=tr,
                                       chips=1, why="test"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] += ["tiny.pair", "tiny.batch"]
    json.dump(bench, open(os.path.join(root, "BENCHMARK.json"), "w"))
    return root, here


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    return make_tiny(tmp_path_factory.mktemp("bench"))
