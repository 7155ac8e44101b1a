"""The cost of one span of ``super4pcs_tpu_torch.utils.profiling``: the
host microseconds a ``with span(...)`` adds, outside any registration,
inside one (``call``), inside one on a CUDA card with the two events of
a device span, and each of these under an active ``torch.profiler``
(where a span also opens a ``record_function`` range), against an empty
``with`` of ``contextlib.nullcontext``, ``time.perf_counter()`` and a
``record_function`` alone.

Usage, from the repo root:

    python3 tools/span_cost.py [--n N] [--device cpu|cuda]

Prints one line per case (the median of 5 rounds of ``N`` spans) and one
JSON line; on a card, its nvidia-smi name and power limit first.
"""
import _path  # noqa: F401
import argparse
import contextlib
import json
import statistics
import subprocess
import time

import torch

from super4pcs_tpu_torch.utils import profiling


def _us(fn, n: int) -> float:
    rounds = []
    for _ in range(5):
        t0 = time.perf_counter()
        fn(n)
        rounds.append((time.perf_counter() - t0) / n * 1e6)
    return statistics.median(rounds)


def _cases(device):
    def empty(n):
        for _ in range(n):
            with contextlib.nullcontext():
                pass

    def clock(n):
        for _ in range(n):
            time.perf_counter()

    def alone(n):
        for _ in range(n):
            with profiling.span("s"):
                pass

    def host(n):
        with profiling.call("cpu"):
            for _ in range(n):
                with profiling.span("s"):
                    pass

    def device_span(n):
        with profiling.call(device):
            for _ in range(n):
                with profiling.span("s", device):
                    pass

    def ranges(n):
        for _ in range(n):
            with torch.autograd.profiler.record_function("s4p.s"):
                pass

    out = dict(empty_with=empty, perf_counter=clock, span_alone=alone,
               span_in_call=host)
    if device.type == "cuda":
        out["device_span_in_call"] = device_span
    return out, ranges


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=20000)
    ap.add_argument("--device", default="cuda" if torch.cuda.is_available()
                    else "cpu")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip())
    cases, ranges = _cases(device)
    for fn in cases.values():
        fn(1000)
    result = {f"{k}_us": _us(fn, args.n) for k, fn in cases.items()}
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts):
        # fewer spans: the profiler keeps every range it records
        n = max(args.n // 10, 100)
        result["record_function_profiled_us"] = _us(ranges, n)
        for k, fn in cases.items():
            result[f"{k}_profiled_us"] = _us(fn, n)
    for k, v in result.items():
        print(f"{k:<36} {v:9.3f}")
    print(json.dumps(dict(device=str(device), torch=torch.__version__,
                          **result)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
