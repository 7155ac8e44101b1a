"""One run of one cell: set-up, the measured window, the check against
the plain reference, and the result line.

A cell (``BENCHMARK.json`` ``workloads``) names a configuration and a
traffic mix; both are data files the harness finds by name:

- the configuration's ``file`` (``configs/<config>.json``): the port's
  ``Options`` fields (``options``, ``overlap``), the data recipe
  (``data``, read by ``generate.py``), the limits of the check
  (``checks``), and ``source``, ``assumed`` and ``reduced``;
- ``traffic/<traffic>.json``: the entry point (``entry``), the pairs a
  call (``pairs_per_call``), the distinct calls (``calls``, sent in an
  order drawn from the seed, over and over), made from the seed or, with
  ``pool_seed``, from that seed: a pool of the same calls for every
  seed.

The metrics are readers found by name too: ``end_to_end/<name>.py`` and
``metrics/<name>.py``, each ``read(rec)`` over the run's record (see
:func:`record`), returning a number or None (left out). So are an
``entry`` that :data:`ENTRIES` lacks (``entries/<entry>.py``) and a data
recipe that ``generate.RECIPES`` lacks (``recipes/<kind>.py``): see
``byname.py``.

The loop is closed with one client: the next call starts when the last
returned. The window opens after one warm call of the cell's own
shapes, and closes at the end of the call in flight when ``seconds``
have passed.
"""

from __future__ import annotations

import gc
import json
import os
import sys
import time
import traceback
from typing import Optional

import numpy as np

import generate
import roofline
from byname import load as load_reader
from reference import lcp as ref

HERE = os.path.dirname(os.path.abspath(__file__))
#: top-level module names that no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "super4pcs_tpu")
#: the profiled stretch of a traced run: the calls until this many
#: seconds of the window have passed
TRACE_SECONDS = 4.0
#: the kernels whose roofline a traced run reads (``roofline/<k>.py``)
ROOFLINE_KERNELS = ("k1", "k2")


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _applies(metric: dict, cell: str, reported: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") in reported if "moves" in metric else True


class Cell:
    """A cell of ``BENCHMARK.json`` at ``root`` and everything it names."""

    def __init__(self, root: str, name: str, here: str = HERE):
        bench = load_json(os.path.join(root, "BENCHMARK.json"))
        found = [w for w in bench["workloads"] if w["name"] == name]
        if not found:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        self.name, self.workload = name, found[0]
        entry = [c for c in bench["configs"]
                 if c["name"] == self.workload["config"]][0]
        self.config = load_json(os.path.join(root, entry["file"]))
        self.traffic = load_json(os.path.join(
            here, "traffic", f"{self.workload['traffic']}.json"))
        self.chips = int(self.workload["chips"])
        self.end_to_end = [m for m in bench["end_to_end"]
                           if _applies(m, name, set())]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if _applies(m, name, reported)]
        self.here = here

    def reader(self, kind: str, name: str):
        return load_reader(self.here, kind, name)


def options(port, config: dict, random_seed: int):
    o = port.Options(**config["options"], random_seed=random_seed)
    if "overlap" in config:
        o = o.configure_overlap(*config["overlap"])
    return o


def _clouds(port, pair):
    return (port.PointCloud(pair["target"], normal=pair.get("target_normal"),
                            rgb=pair.get("target_rgb")),
            port.PointCloud(pair["source"], normal=pair.get("source_normal"),
                            rgb=pair.get("source_rgb")))


def _register(port, pairs, opts, device):
    (p, q), = [_clouds(port, pair) for pair in pairs]
    return [port.register(p.pos, q.pos, target_normal=p.normal,
                          source_normal=q.normal, target_rgb=p.rgb,
                          source_rgb=q.rgb, options=opts, device=device)]


def _register_batch(port, pairs, opts, device):
    from super4pcs_tpu_torch.parallel import register_batch
    return register_batch([_clouds(port, pair) for pair in pairs], opts,
                          device=device)


#: the traffic files' built-in entry points
ENTRIES = {"api.register": _register,
           "parallel.register_batch": _register_batch}


def entry_point(here: str, name: str):
    """The traffic's entry point ``name``: a built-in of :data:`ENTRIES`,
    else the ``call`` of ``<here>/entries/<name>.py``."""
    return ENTRIES[name] if name in ENTRIES else load_reader(
        here, "entries", name).call


def _call_numbers(results) -> dict:
    """Per call: its search seconds (a batch's once, plus the straggler
    redemptions), trials over its pairs, and each pair's answer."""
    search = max([r.stats.get("search_seconds", 0.0) for r in results
                  if "straggler_escalated_to" not in r.stats] or [0.0])
    search += sum(r.stats.get("search_seconds", 0.0) for r in results
                  if "straggler_escalated_to" in r.stats)
    return dict(search_s=search, trials=sum(r.n_trials for r in results),
                answers=[dict(score=float(r.score),
                              transform=np.asarray(r.transform, np.float64),
                              redeemed="straggler_escalated_to" in r.stats)
                         for r in results])


def check_pairs(cell: Cell, calls: list, done: list, device,
                control: bool = False, shard: Optional[tuple] = None
                ) -> list:
    """The reference's reading of every answer of the window: (lcp gap,
    rot_diff, tr_err, reported score). ``control`` puts the reference's
    own score in TF32 in place of the reported one. ``shard`` (lo, hi):
    only each call's pairs ``lo:hi`` (one process's of a run over
    several cards)."""
    delta = float(cell.config["options"]["delta"])
    n = int(cell.config["options"]["sample_size"])
    out = []
    for rec in done:
        if not rec.get("answers"):
            continue
        call = calls[rec["call"]]
        batch = ref.samples(call["pairs"], delta, n, call["random_seed"])
        lo, hi = shard or (0, len(call["pairs"]))
        for ans, pair, pq in list(zip(rec["answers"], call["pairs"],
                                      batch))[lo:hi]:
            # a redeemed straggler was registered alone, with the
            # call's seed
            p, q = (ref.samples([pair], delta, n, call["random_seed"])[0]
                    if ans["redeemed"] else pq)
            truth_lcp = ref.lcp(ans["transform"], q, p, delta, device)
            score = (ref.lcp(ans["transform"], q, p, delta, device,
                             precision="tf32") if control
                     else ans["score"])
            rot, tr = ref.pose_errors(ans["transform"], pair["truth"])
            out.append((abs(score - truth_lcp), rot, tr, score))
    return out


def verdict(cell: Cell, done: list, readings: list) -> tuple:
    """(correct, attempted, failed, checks): ``checks`` maps each number
    compared to its value and limit."""
    lim = cell.config["checks"]
    thr = cell.config.get("overlap", [0, 1.0])[1]
    attempted = sum(r["pairs"] for r in done)
    raised = sum(r["pairs"] for r in done if r.get("error"))
    answered = attempted - raised
    gap = max([g for g, _, _, _ in readings] or [0.0])
    failed = raised
    wrong = 0
    for _, rot, tr, score in readings:
        posed = rot <= lim["rot_diff"] and tr <= lim["tr_err"]
        if score < thr or not posed:
            failed += 1
        if score >= thr and not posed:
            wrong += 1
    checks = {
        "lcp_gap": [gap, lim["lcp_gap"]],
        "unchecked_answers": [answered - len(readings), 0],
        "calls_raised": [raised, 0],
        "wrong_poses_claimed": [wrong, 0],
        "failed_share": [failed / max(attempted, 1), lim["failed_share"]],
    }
    correct = all(v <= L for v, L in checks.values()) and attempted > 0
    return correct, attempted, failed, checks


def record(done: list, window_s: float, setup_s: float,
           trace: Optional[dict], pose: list) -> dict:
    """What the readers read: the window's calls that returned (wall,
    search seconds, trials, pairs, refine seconds of a traced run),
    outside the profiled stretch when any call is, its length, the
    set-up seconds, each registered pair's seconds (``pose_s``: its
    call's wall), the pairs begun (``pairs``) and the reduced trace of a
    traced run (None otherwise). The harness adds the pairs registered
    correctly (``good``)."""
    returned = [r for r in done if not r.get("error")]
    calls = [r for r in returned if not r["profiled"]] or returned
    return dict(calls=[{k: r[k] for k in ("wall_s", "search_s", "trials",
                                          "pairs", "refine_s", "exchange_s")
                        if k in r}
                       for r in calls],
                window_s=window_s, setup_s=setup_s, trace=trace,
                pose_s=pose, pairs=sum(r["pairs"] for r in done))


def _stderr(msg: str):
    print(msg, file=sys.stderr, flush=True)


def calls_of(cell: Cell, seed: int, pool_seed: Optional[int] = None
             ) -> tuple:
    """(the run's distinct calls, its warm call, the generator of the
    order the calls are sent in). A pool ("pool_seed"): the same calls
    for every seed, the seed drawing the order they are sent in, pass
    after pass; ``pool_seed`` draws it from another seed than the
    traffic file's."""
    traffic = cell.traffic
    if "pool_seed" in traffic:
        seed_calls = traffic["pool_seed"] if pool_seed is None else pool_seed
    else:
        seed_calls = seed % 2 ** 64
    calls = generate.make_calls(
        cell.config["data"], dict(traffic, calls=traffic["calls"] + 1),
        seed_calls, here=cell.here)
    warm = calls.pop()
    return calls, warm, np.random.default_rng(seed % 2 ** 64)


def caller(port, cell: Cell, dev):
    """``one(call)``: the call through the traffic's entry point, with the
    configuration's options and the call's registration seed."""
    import torch
    entry = entry_point(cell.here, cell.traffic["entry"])

    def one(call):
        opts = options(port, cell.config, call["random_seed"])
        with torch.profiler.record_function("register"):
            return entry(port, call["pairs"], opts, dev)
    return one


def timed_call(one, calls: list, k: int, watch, profiled: bool, dev
               ) -> tuple:
    """(the record of call ``k`` of the window, the clock after it): its
    wall, the refines' seconds of a traced run (``watch``, else None),
    over several cards the port's collectives' seconds (a ``watch`` with
    ``exchange``), the collection after it, and on the card the
    allocator's counters."""
    import torch
    t0 = time.perf_counter()
    refines = len(watch.refine_s) if watch else 0
    exchanges = len(watch.exchange_s) if watch else 0
    rec = dict(call=k, pairs=len(calls[k]["pairs"]), profiled=profiled)
    try:
        results = one(calls[k])
        rec.update(_call_numbers(results))
    except Exception:
        rec["error"] = traceback.format_exc()
        _stderr(rec["error"])
    t1 = time.perf_counter()
    rec["wall_s"] = t1 - t0
    rec["refine_s"] = sum(watch.refine_s[refines:]) if watch else 0.0
    if watch and watch.exchange:
        rec["exchange_s"] = sum(watch.exchange_s[exchanges:])
    # the call's garbage (its matcher, captured graph and memory pool)
    # is collected here, inside the window, so that no later call's
    # latency pays for it
    gc.collect()
    t1 = time.perf_counter()
    rec["gc_s"] = t1 - t0 - rec["wall_s"]
    if dev.type == "cuda":
        mem = torch.cuda.memory_stats(dev)
        rec["memory"] = [mem.get(k, -1) for k in (
            "reserved_bytes.all.current", "num_device_alloc",
            "num_device_free", "num_alloc_retries")]
    return rec, t1


def window(one, calls: list, warm: dict, rng, seconds: float,
           traced: bool, dev, t_start: float, *, exchange: bool = False,
           decide=bool, reduce=None) -> tuple:
    """The warm call and the measured window of a run on ``dev``: calls
    drawn from ``calls`` in the order of ``rng``, pass after pass, until
    ``seconds`` have passed. A traced run watches the calls (``exchange``:
    the port's collectives too) and profiles them for its first
    :data:`TRACE_SECONDS`. ``decide`` turns each of the window's
    decisions (the profiled stretch ends, the window closes) into the
    one every process of the run takes (process 0's over several cards;
    in one process, the decision itself); ``reduce`` reduces the
    profiled stretch (default :func:`_reduced`). Returns (the window's
    call records, its seconds, the set-up seconds since the epoch time
    ``t_start``, the reduced trace of a traced run on the card else
    None, the peak of the device's memory)."""
    import torch
    from contextlib import nullcontext
    from tracing import Stretch, Watch
    reduce = reduce or _reduced
    on_card = dev.type == "cuda"
    watch = (Watch(ROOFLINE_KERNELS if on_card else (), exchange=exchange)
             if traced else nullcontext())
    done, trace_out = [], None
    with watch:
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        one(warm)
        if on_card:
            torch.cuda.synchronize(dev)
        # what set-up made lives through the run: the collections after
        # each call need not walk it
        gc.collect()
        gc.freeze()
        stretch = Stretch(watch) if traced and on_card else None
        if stretch:
            stretch.start()
        t_window = t_stretch = time.perf_counter()
        tries = 0
        setup_s = time.time() - t_start
        order = []
        while True:
            if not order:
                order = rng.permutation(len(calls)).tolist()
            k = order.pop(0)
            rec, t1 = timed_call(one, calls, k, watch if traced else None,
                                 stretch is not None, dev)
            done.append(rec)
            if stretch and decide(t1 - t_stretch >= TRACE_SECONDS):
                t_reduce = time.perf_counter()
                trace_out = reduce(stretch)
                # the trace's reading is not the window's: the window
                # goes on for its seconds of calls after it
                t_window += time.perf_counter() - t_reduce
                # a trace now and then comes back without a device
                # record: profile the next calls again
                tries += 1
                stretch = None
                if trace_out["busy_s"] <= 0 and tries < 3:
                    stretch = Stretch(watch)
                    stretch.start()
                    t_stretch = time.perf_counter()
            if decide(t1 - t_window >= seconds):
                break
        window_s = time.perf_counter() - t_window
        if stretch:
            trace_out = reduce(stretch)
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return done, window_s, setup_s, trace_out, peak


def run(root: str, cell_name: str, seed: int, seconds: float, traced: bool,
        *, device: str = "cuda", t_start: Optional[float] = None,
        control: bool = False, cell: Optional[Cell] = None,
        pool_seed: Optional[int] = None) -> dict:
    """One run of ``cell_name`` in this process, on one device; returns
    the result line's object. ``t_start``: the epoch time the run's
    process started. ``pool_seed`` draws a pooled traffic's pool from
    another seed than its file's (the correctness readings over several
    pools; the benchmark's own runs keep the file's). A cell on several
    cards runs one process a card instead (``ranks.py``)."""
    t_start = time.time() if t_start is None else t_start
    cell = cell or Cell(root, cell_name)
    import torch
    import super4pcs_tpu_torch as port
    torch.set_num_threads(1)
    dev = torch.device(device)
    calls, warm, rng = calls_of(cell, seed, pool_seed)
    one = caller(port, cell, dev)
    done, window_s, setup_s, trace_out, peak = window(
        one, calls, warm, rng, seconds, traced, dev, t_start)
    readings = check_pairs(cell, calls, done, dev, control)
    return result_line(cell, done, verdict(cell, done, readings), window_s,
                       setup_s, trace_out, traced, dev, peak)


def result_line(cell: Cell, done: list, judged: tuple, window_s: float,
                setup_s: float, trace_out: Optional[dict], traced: bool,
                dev, peak: int, count: int = 1) -> dict:
    """The result line's object of a run: ``judged`` is
    :func:`verdict`'s (correct, attempted, failed, checks), ``count``
    the cards the run used, ``peak`` the peak on the fullest. Prints
    each call, the window and the checks, last, on standard error."""
    import torch
    correct, attempted, failed, checks = judged
    on_card = dev.type == "cuda"
    pose = [r["wall_s"] for r in done if not r.get("error")
            for _ in range(r["pairs"])]
    good = attempted - failed
    rec = record(done, window_s, setup_s, trace_out, pose)
    rec["good"] = good
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        kind = "metrics" if traced else "end_to_end"
        value = cell.reader(kind, m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    line = {"correct": bool(correct), "attempted": attempted,
            "failed": failed, "metrics": metrics,
            "device": {"platform": "gpu" if on_card else dev.type,
                       "kind": (torch.cuda.get_device_name(dev) if on_card
                                else "cpu"),
                       "count": count,
                       "memory_peak_bytes": int(peak)}}
    if traced and trace_out:
        line["device"]["busy_s"] = trace_out["busy_s"]
        line["device"]["window_s"] = trace_out["window_s"]
        watts = roofline.power_limit_w(dev.index or 0)
        if watts is not None:
            # the roofline shares are of the data sheet's 700 W peaks
            line["device"]["power_limit_w"] = watts
        ops = sorted(trace_out["kernels"].items(), key=lambda kv: -kv[1][0])
        line["breakdown"] = {
            "device_ops": [[k[:160], v[0]] for k, v in ops[:10]],
            "idle_gaps": trace_out["idle_gaps"][:10]}
    line["checks"] = {k: {"value": v, "limit": L}
                      for k, (v, L) in checks.items()}
    for r in done:
        _stderr(f"call {r['call']}: {r['pairs']} pairs, wall "
                f"{r['wall_s']:.3f} s, gc {r['gc_s']:.3f} s, search "
                f"{r.get('search_s', 0):.3f} s, "
                f"trials {r.get('trials', 0)}, reserved, cudaMalloc, "
                f"cudaFree, retries {r.get('memory')}, scores "
                f"{[round(a['score'], 4) for a in r.get('answers', [])]}")
    _stderr(f"{cell.name}: {len(done)} calls, {attempted} pairs, "
            f"{failed} failed, window {window_s:.3f} s, set-up "
            f"{setup_s:.3f} s, pose seconds "
            f"{sorted(round(s, 3) for s in pose)}")
    for k, (v, L) in checks.items():
        _stderr(f"check {k} {v} limit {L}")
    return line


def _reduced(stretch) -> dict:
    stretch.stop()
    t0 = time.perf_counter()
    out = stretch.reduce()
    _stderr(f"trace: stopped in {stretch.stop_s:.3f} s, reduced in "
            f"{time.perf_counter() - t0:.3f} s, busy {out['busy_s']:.3f} "
            f"of {out['window_s']:.3f} s")
    return out
