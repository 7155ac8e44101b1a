"""Scaling of super4pcs_tpu_torch over the cards of one host (run it on a
machine with four cards; it uses as many as it sees, up to four):

- the headline step (bench.py's 100k-point pair, chip_smoke.py's
  headline options: delta 0.01, sample_size 8192, B = 16 bases a step)
  over 1, 2 and 4 cards in ONE process, ``MatchSuper4PCS(opts,
  mesh=make_mesh(cards))``: trials per second = B x steps / their wall,
  over ``--steps`` steps after the run's off-clock warm-up;
- the same step in ONE PROCESS PER CARD (1, 2 and 4 processes of
  ``distributed.initialize``, each the unsharded headline matcher on
  its own card, timed together between two barriers): trials per
  second summed over the processes;
- ``register_batch`` of 8 pairs (chip_smoke.py phase 5j's four pairs,
  twice) with 5j's options, in one process on one card and over 4
  processes (``distributed.global_mesh()``, one card each): search
  seconds, the wall of 3 steps of the same batch, and whether every
  process holds the one-card run's results bit for bit.

Usage, from the repo root:

    python3 tools/multichip_scaling.py [--steps N] [--out FILE]

Prints the cards (nvidia-smi name and power limit of each), one line
per measurement and one JSON line (``--out`` writes it to a file too).
Exits 2 without a CUDA device. Every child process has a time limit and
is killed when it passes it.
"""
import _path  # noqa: F401
import argparse
import json
import os
import socket
import subprocess
import sys
import time

import chip_smoke as cs

_TIMEOUT = 600


def _free_addr():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


def _spawn(role, n, extra=()):
    """Run ``n`` processes of this script in ``role`` (a job of
    ``distributed.initialize``); returns their JSON lines by rank."""
    addr = _free_addr()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), role, addr, str(n),
         str(pid), *extra], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for pid in range(n)]
    outs = []
    try:
        for p in procs:
            try:
                out, err = p.communicate(timeout=_TIMEOUT)
            except subprocess.TimeoutExpired:
                raise SystemExit(f"{role}: a process ran past {_TIMEOUT} s")
            if p.returncode != 0:
                raise SystemExit(f"{role}: a process exited {p.returncode}:"
                                 f"\n{err[-3000:]}")
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def _headline():
    import bench
    import super4pcs_tpu_torch as s4
    P, Q = bench.fine_delta_pair()
    return s4, s4.PointCloud(P), s4.PointCloud(Q), cs._headline_options(s4)


def _time_steps(m, steps, first=100):
    import torch
    t0 = time.perf_counter()
    for i in range(first, first + steps):
        m._run_step(i)
    for d in (m._mesh.devices if m._mesh else (m.device,)):
        torch.cuda.synchronize(d)
    return time.perf_counter() - t0


def _step_worker(addr, n, pid, steps):
    """One process of the one-process-per-card headline: the unsharded
    matcher on this process's card, its steps timed between barriers."""
    import torch.distributed as dist
    from super4pcs_tpu_torch.parallel import distributed
    dev = distributed.initialize(addr, n, pid)
    s4, P, Q, opts = _headline()
    m = s4.MatchSuper4PCS(opts, device=dev)
    m._init(P, Q)
    dist.barrier()
    wall = _time_steps(m, steps)
    dist.barrier()
    walls = [None] * n
    dist.all_gather_object(walls, wall)
    out = dict(pid=pid, device=str(dev), bases=m._b_eff, walls=walls)
    dist.destroy_process_group()
    return out


def _batch_pairs8():
    import bench
    import super4pcs_tpu_torch as s4
    P, Q = bench.fine_delta_pair()
    pairs, truth, opts = cs._batch_pairs(P, Q, s4)
    return s4, pairs * 2, truth * 2, opts


def _batch_run(pairs, opts, mesh=None, device="cuda"):
    """register_batch and the wall of 3 steps of the same batch."""
    import numpy as np
    import torch
    from super4pcs_tpu_torch.parallel import register_batch
    from super4pcs_tpu_torch.parallel.batch import BatchRun
    res = register_batch(pairs, opts, mesh=mesh, device=device)
    run = BatchRun(pairs, opts, mesh=mesh, device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(3):
        run.run_step(1000 + i)
    step_ms = 1e3 * (time.perf_counter() - t0) / 3
    return dict(scores=[r.score for r in res],
                trials=[r.n_trials for r in res],
                transforms=[np.asarray(r.transform).tolist() for r in res],
                search_s=res[0].stats["search_seconds"],
                compile_s=res[0].stats["compile_seconds"], step_ms=step_ms)


def _batch_worker(addr, n, pid):
    import torch.distributed as dist
    from super4pcs_tpu_torch.parallel import distributed
    dev = distributed.initialize(addr, n, pid)
    _, pairs, _, opts = _batch_pairs8()
    out = dict(pid=pid, device=str(dev),
               **_batch_run(pairs, opts, mesh=distributed.global_mesh()))
    dist.destroy_process_group()
    return out


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("multichip_scaling: no CUDA device", file=sys.stderr)
        return 2
    role = sys.argv[1] if len(sys.argv) > 1 else ""
    if role == "--step-worker":
        print(json.dumps(_step_worker(sys.argv[2], int(sys.argv[3]),
                                      int(sys.argv[4]), int(sys.argv[5]))),
              flush=True)
        return 0
    if role == "--batch-worker":
        print(json.dumps(_batch_worker(sys.argv[2], int(sys.argv[3]),
                                       int(sys.argv[4]))), flush=True)
        return 0
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--out")
    args = ap.parse_args()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    for line in smi:
        print(line, flush=True)
    n_cards = torch.cuda.device_count()
    counts = [c for c in (1, 2, 4) if c <= n_cards]
    from super4pcs_tpu_torch.kernels import lcp as k1
    from super4pcs_tpu_torch.kernels import rowcap as k2
    from super4pcs_tpu_torch.parallel import make_mesh
    k1._lib()
    k2._lib()
    result = dict(cards=smi, one_process={}, process_per_card={},
                  batch8={})

    # the headline step over 1, 2, 4 cards in one process
    s4, P, Q, opts = _headline()
    for c in counts:
        mesh = make_mesh([f"cuda:{i}" for i in range(c)])
        m = s4.MatchSuper4PCS(opts, mesh=mesh)
        m._init(P, Q)
        launches = (k1.lcp_min_d2_within.launches,
                    k2.rowcap_capture.launches)
        m._run_step(99)
        per_step = (k1.lcp_min_d2_within.launches - launches[0],
                    k2.rowcap_capture.launches - launches[1])
        wall = _time_steps(m, args.steps)
        rate = m._b_eff * args.steps / wall
        print(f"one process, {c} card(s): B={m._b_eff}, "
              f"{1e3 * wall / args.steps:.2f} ms a step, {rate:.1f} "
              f"trials/s; a step's launches K1 {per_step[0]}, K2 "
              f"{per_step[1]} (each shard: 3 and 2)", flush=True)
        if per_step != (3 * c, 2 * c):
            raise SystemExit("a shard launched other than 3 verifies and "
                             "2 captures")
        result["one_process"][c] = dict(step_ms=1e3 * wall / args.steps,
                                        trials_per_s=rate,
                                        launches_k1_k2=per_step)
        del m
    torch.cuda.empty_cache()

    # the same step, one process per card
    for c in counts:
        outs = _spawn("--step-worker", c, (str(args.steps),))
        walls = outs[0]["walls"]
        rate = sum(outs[0]["bases"] * args.steps / w for w in walls)
        print(f"one process per card, {c} card(s) "
              f"({[o['device'] for o in outs]}): "
              f"{', '.join(f'{1e3 * w / args.steps:.2f}' for w in walls)} "
              f"ms a step, {rate:.1f} trials/s together", flush=True)
        result["process_per_card"][c] = dict(
            step_ms=[1e3 * w / args.steps for w in walls],
            trials_per_s=rate)

    # register_batch of 8 pairs: one card, then 4 processes
    s4, pairs, truth, bopts = _batch_pairs8()
    one = _batch_run(pairs, bopts, device="cuda:0")
    torch.cuda.empty_cache()
    print(f"register_batch G=8, one process, one card: search "
          f"{one['search_s']:.3f} s, a step {one['step_ms']:.1f} ms, "
          f"trials {one['trials'][0]}, scores "
          f"{[round(x, 4) for x in one['scores']]}", flush=True)
    result["batch8"]["one_card"] = {k: v for k, v in one.items()
                                    if k != "transforms"}
    if n_cards >= 4:
        outs = _spawn("--batch-worker", 4)
        same = all(o[k] == outs[0][k] for o in outs
                   for k in ("scores", "trials", "transforms"))
        equal_one = all(outs[0][k] == one[k]
                        for k in ("scores", "trials", "transforms"))
        print(f"register_batch G=8 over 4 processes "
              f"({[o['device'] for o in outs]}): search "
              f"{[round(o['search_s'], 3) for o in outs]} s, a step "
              f"{[round(o['step_ms'], 1) for o in outs]} ms, every process "
              f"the same={same}, equal to the one-card run={equal_one}",
              flush=True)
        if not same:
            raise SystemExit("the processes' results differ")
        result["batch8"]["four_processes"] = dict(
            search_s=[o["search_s"] for o in outs],
            step_ms=[o["step_ms"] for o in outs],
            trials=outs[0]["trials"], scores=outs[0]["scores"],
            same_in_every_process=same, equal_to_one_card=equal_one)
    for g, (score, mat, gt) in enumerate(zip(one["scores"],
                                             one["transforms"], truth)):
        rot_diff, tr_diff = s4.reference_pose_diff(np.asarray(mat), gt)
        if not (score >= 0.6 and rot_diff <= 0.2 and tr_diff <= 0.1):
            raise SystemExit(f"batch pair {g} missed its gates")
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
