"""Where a registration's capture spends its host time: recording the
step's launches into the graph (``capture_begin`` to ``capture_end``),
instantiating the graph, and the device allocations made meanwhile
(``num_device_alloc`` of ``torch.cuda.memory_stats``), beside the span
``capture`` of the registration's span table. Registrations of one
benchmark cell's calls run one after another in one process: the first
is its kind's first warm-up in the process (an eager run precedes each
capture), the others reuse it (``utils/graphs.py``).

Usage, from the repo root, on a CUDA card:

    python3 tools/capture_split.py [--cell scan100k.pair] [--calls 8]

Prints the card's nvidia-smi name and power limit, one line a
registration, and one JSON line with the medians of the registrations
after the first.
"""
import _path  # noqa: F401
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch

import super4pcs_tpu_torch as port

sys.path.insert(0, os.path.join(_path._ROOT, "benchmark"))
import generate  # noqa: E402
import harness  # noqa: E402


class _Timed:
    """Host seconds and device allocations of each call of the wrapped
    ``torch.cuda.CUDAGraph`` methods."""

    def __init__(self):
        self.rows = []
        graph = torch.cuda.CUDAGraph
        self._orig = (graph.capture_begin, graph.capture_end,
                      graph.instantiate)
        timed = self

        def begin(g, *a, **k):
            timed._t0 = time.perf_counter()
            timed._a0 = _allocs()
            return timed._orig[0](g, *a, **k)

        def end(g, *a, **k):
            out = timed._orig[1](g, *a, **k)
            timed._rec = (time.perf_counter() - timed._t0,
                          _allocs() - timed._a0)
            return out

        def inst(g, *a, **k):
            t0 = time.perf_counter()
            out = timed._orig[2](g, *a, **k)
            timed.rows.append(dict(record_s=timed._rec[0],
                                   record_allocs=timed._rec[1],
                                   instantiate_s=time.perf_counter() - t0))
            return out

        graph.capture_begin, graph.capture_end, graph.instantiate = (
            begin, end, inst)


def _allocs() -> int:
    return torch.cuda.memory_stats().get("num_device_alloc", 0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", default="scan100k.pair")
    ap.add_argument("--calls", type=int, default=8)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("capture_split: needs a CUDA card")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
        .strip(), flush=True)
    cell = harness.Cell(_path._ROOT, args.cell)
    calls = generate.make_calls(cell.config["data"],
                                dict(cell.traffic, calls=args.calls),
                                cell.traffic.get("pool_seed", 1))
    entry = harness.ENTRIES[cell.traffic["entry"]]
    timed = _Timed()
    out = []
    for i, call in enumerate(calls):
        opts = harness.options(port, cell.config, call["random_seed"])
        timed.rows.clear()
        a0 = _allocs()
        t0 = time.perf_counter()
        res = entry(port, call["pairs"], opts, torch.device("cuda"))
        wall = time.perf_counter() - t0
        table = res[0].stats["spans"]
        spans = table["spans"]
        capture_s = sum(row["host_s"] for path, row in spans.items()
                        if path.endswith("capture"))
        row = dict(
            call=i, wall_s=wall, warm_full=table.get("warm_full", 0),
            warm_reused=table.get("warm_reused", 0),
            captures=len(timed.rows), capture_span_s=capture_s,
            record_s=sum(r["record_s"] for r in timed.rows),
            instantiate_s=sum(r["instantiate_s"] for r in timed.rows),
            capture_allocs=sum(r["record_allocs"] for r in timed.rows),
            call_allocs=_allocs() - a0)
        row["other_s"] = (row["capture_span_s"] - row["record_s"]
                          - row["instantiate_s"])
        out.append(row)
        print(" ".join(f"{k} {v:.4f}" if isinstance(v, float)
                       else f"{k} {v}" for k, v in row.items()), flush=True)
    later = out[1:]
    summary = {k: statistics.median(r[k] / max(r["captures"], 1)
                                    for r in later)
               for k in ("capture_span_s", "record_s", "instantiate_s",
                         "other_s", "capture_allocs")} if later else {}
    print(json.dumps(dict(cell=args.cell, first=out[0],
                          later_median_a_capture=summary)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
