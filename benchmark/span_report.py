"""A traced run of one cell with the port's span tables laid out, read
on the card by hand.

    python3 benchmark/span_report.py --workload <cell> --seed <n> \\
        --seconds <s>

runs the cell as ``run.py --trace 1`` does and prints the same result
line, then on standard error: each span path's count, host and device
milliseconds a pair over the window's calls (``spans.tables``), the
calls' counters a pair, each call's root against the harness's wall,
the stages outside the search against the wall less the search seconds,
and the profiled stretch's idle time split by the stage open over it
(:func:`idle_by_stage`) against its idle share. The benchmark's own runs
run none of this.
"""

from __future__ import annotations

import bisect
import sys

import torch

import harness
import run
import spans
import tracing


def idle_by_stage(events, window_s: float):
    """The stretch's idle seconds split by exact overlap with the port's
    stage ranges: {stage: idle seconds while a registration's
    "s4p.<stage>" range was open (the stages under the root "s4p.call";
    a nested registration's stages count in its parent's), "call": in a
    registration between its stages, "outside": outside any
    registration}, or None when the stretch holds no ``s4p.call`` range
    (a program without span tables). With the busy seconds it sums to
    ``window_s``."""
    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    for e in events:
        tr = e.time_range
        if e.device_type == cuda:
            if not getattr(e, "is_user_annotation", False):
                dev.append((tr.start, tr.end))
        else:
            host.append((tr.start, tr.end, e.name))
    calls = tracing._merged([(s, e) for s, e, n in host if n == "s4p.call"])
    if not calls:
        return None
    merged = tracing._merged(dev)
    starts = [s for s, _ in merged]
    covered = [0.0]
    for s, e in merged:
        covered.append(covered[-1] + (e - s))

    def busy_before(t):
        i = bisect.bisect_right(starts, t)
        if i == 0:
            return 0.0
        s, e = merged[i - 1]
        return covered[i - 1] + min(t, e) - s

    def idle(s, e):
        return (e - s) - (busy_before(e) - busy_before(s))

    out = {}
    for s, e, n in host:
        stage = n[4:]
        if n.startswith("s4p.") and "." not in stage and stage != "call":
            out[stage] = out.get(stage, 0.0) + idle(s, e) * 1e-6
    in_calls = sum(idle(s, e) for s, e in calls) * 1e-6
    out["call"] = in_calls - sum(out.values())
    busy = covered[-1] * 1e-6
    out["outside"] = window_s - busy - in_calls
    return out


def report(rec: dict, out=sys.stderr):
    """The span report of a run's record (see the module doc); nothing
    when the window's calls carry no tables."""
    def say(msg):
        print(msg, file=out, flush=True)

    got = spans.tables(rec)
    if got is None:
        say("spans: the window's calls carry no span tables")
        return
    calls = rec["calls"]
    pairs = sum(c["pairs"] for c in calls)
    rows, counters = {}, {}
    for table in got:
        for path, row in table["spans"].items():
            n, host, dev = rows.get(path, (0, 0.0, None))
            if row["device_s"] is not None:
                dev = (dev or 0.0) + row["device_s"]
            rows[path] = (n + row["count"], host + row["host_s"], dev)
        for k in ("index_builds", "device_allocs"):
            if k in table:
                counters[k] = counters.get(k, 0) + table[k]
    say(f"spans over {len(calls)} calls, {pairs} pairs (a pair: count, "
        f"host ms, device ms)")
    for path, (n, host, dev) in rows.items():
        say(f"  {path:<32} {n / pairs:9.3f} {1e3 * host / pairs:10.3f} "
            + ("-" if dev is None else f"{1e3 * dev / pairs:10.3f}"))
    for k, v in counters.items():
        say(f"  {k} a pair {v / pairs:.3f}")
    gaps = sorted(c["wall_s"] - t["spans"]["call"]["host_s"]
                  for c, t in zip(calls, got))
    near = sum(c["wall_s"] - t["spans"]["call"]["host_s"]
               <= 0.01 * c["wall_s"] + 0.005 for c, t in zip(calls, got))
    say(f"wall less root: median {1e3 * gaps[len(gaps) // 2]:.3f} ms, "
        f"largest {1e3 * gaps[-1]:.3f} ms; {near} of {len(calls)} calls "
        f"within 1% + 5 ms")
    # outside the search: the stages but the search, and the escalations'
    # warm-up, which the anytime clock leaves out; less the searches of
    # the stragglers redeemed
    outside = sum(c["wall_s"] - c["search_s"] for c in calls)

    def host(*paths):
        return sum(rows[p][1] for p in paths if p in rows)

    staged = (host("setup", "refine", "finish", "redeem")
              - host("redeem/call/search"))
    escalate = host("search/escalate")
    if outside > 0:
        say(f"outside the search, ms a pair: wall less search "
            f"{1e3 * outside / pairs:.3f}; setup + refine + finish + "
            f"redeem less its searches {1e3 * staged / pairs:.3f} "
            f"({100 * (staged / outside - 1):+.2f}%); with search/escalate "
            f"{1e3 * (staged + escalate) / pairs:.3f} "
            f"({100 * ((staged + escalate) / outside - 1):+.2f}%)")
    t = rec["trace"]
    if t and t.get("idle_by_stage") and t["window_s"] > 0:
        split = {k: round(100 * v / t["window_s"], 3)
                 for k, v in t["idle_by_stage"].items()}
        say(f"idle by stage, % of the stretch: {split}, sum "
            f"{sum(split.values()):.3f}, device idle "
            f"{100 * (1 - t['busy_s'] / t['window_s']):.3f}")


def main(argv=None, **kwargs) -> int:
    """Run the cell of ``argv`` traced (``--trace 1`` is added) and
    print its span report; ``kwargs`` go to ``run.main``."""
    argv = list(sys.argv[1:] if argv is None else argv) + ["--trace", "1"]
    seen = {}
    real_record, real_reduce = harness.record, tracing.reduce_events

    def record(*args, **kw):
        seen["rec"] = real_record(*args, **kw)
        return seen["rec"]

    def reduce_events(events, window_s, *args, **kw):
        out = real_reduce(events, window_s, *args, **kw)
        out["idle_by_stage"] = idle_by_stage(events, window_s)
        return out

    harness.record, tracing.reduce_events = record, reduce_events
    try:
        code = run.main(argv, **kwargs)
    finally:
        harness.record, tracing.reduce_events = real_record, real_reduce
    if "rec" in seen:
        report(seen["rec"])
    return code


if __name__ == "__main__":
    sys.exit(main())
