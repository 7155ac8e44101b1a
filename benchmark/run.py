"""The benchmark of super4pcs_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

run from the root of a checkout. It makes the cell's clouds from the
seed, warms the cell's shapes with one registration, registers pairs in
a closed loop for ``--seconds`` (the call in flight at the end
finishes), checks every answer against the plain reference, and prints
the result as the last line of its standard output: one JSON object
with ``correct``, ``attempted``, ``failed``, ``metrics``, ``device``
(and, traced, ``breakdown``), then ``checks``: each number compared
beside its limit, which are also the last lines of its standard error.
``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from a run with the benchmark's probes and
``torch.profiler`` on.

A cell on several cards (``chips`` > 1) runs one process a card: this
process launches them (``launch.py``), each joins one
``torch.distributed`` job and runs its part (``ranks.py``), and process
0's result line is printed here. ``setup_s`` counts from this process's
start.

It exits with another code than 0, and prints no result, when CUDA is
not available or the machine has fewer cards than the cell asks for,
when a module of jax, jaxlib, flax or the JAX package is loaded, and
when a process of a run over several cards fails or passes its time
limit.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# one process with few threads: the host's BLAS and OpenMP pools would
# otherwise spin on every core of a host the card shares
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for path in (HERE, ROOT):
    if path not in sys.path:
        sys.path.insert(0, path)


def _args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # for the control, the faults and the tests (``control.py``):
    # ``--device`` other than "cuda" skips the look for cards,
    # ``--control`` and ``--fault`` (a name of ``faults.FAULTS``) break
    # the check or the timed path, ``--pool-seed`` draws a pooled
    # traffic's pool from another seed; and what the launcher gives
    # each process of a run over several cards
    hidden = dict(help=argparse.SUPPRESS)
    ap.add_argument("--device", default="cuda", **hidden)
    ap.add_argument("--control", action="store_true", **hidden)
    ap.add_argument("--fault", **hidden)
    ap.add_argument("--pool-seed", type=int, **hidden)
    ap.add_argument("--rank", type=int, **hidden)
    ap.add_argument("--coordinator", **hidden)
    ap.add_argument("--parent", type=int, **hidden)
    ap.add_argument("--t-start", type=float, **hidden)
    return ap.parse_args(argv)


def _refuse(msg: str) -> int:
    print(msg, file=sys.stderr, flush=True)
    return 2


def _no_forbidden(harness) -> bool:
    bad = harness.forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {', '.join(bad)}",
              file=sys.stderr, flush=True)
    return not bad


def main(argv=None) -> int:
    """Run the cell of ``argv`` (default ``sys.argv[1:]``)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    args = _args(argv)
    import harness
    cell = harness.Cell(ROOT, args.workload)
    if args.rank is not None:
        return _rank(args, cell)
    if args.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            return _refuse("CUDA is not available")
        if torch.cuda.device_count() < cell.chips:
            return _refuse(f"{args.workload} needs {cell.chips} cards, "
                           f"{torch.cuda.device_count()} visible")
    if cell.chips > 1:
        import launch
        code, out = launch.launch(os.path.abspath(__file__), argv + [
            "--t-start", repr(T_START)], cell.chips)
        if code != 0:
            return code
        if not _no_forbidden(harness):
            return 3
        print(out.rstrip("\n"), flush=True)
        return 0
    from contextlib import nullcontext
    import faults
    with faults.FAULTS[args.fault]() if args.fault else nullcontext():
        line = harness.run(ROOT, args.workload, args.seed, args.seconds,
                           bool(args.trace), device=args.device,
                           t_start=T_START, control=args.control, cell=cell,
                           pool_seed=args.pool_seed)
    if not _no_forbidden(harness):
        return 3
    print(json.dumps(line), flush=True)
    return 0


def _rank(args, cell) -> int:
    """Process ``args.rank`` of a run over several cards: it joins the
    job, runs its part, checks its own modules, and process 0 prints the
    result line."""
    import launch
    launch.die_with(args.parent)
    from contextlib import nullcontext
    import torch.distributed as dist
    from super4pcs_tpu_torch.parallel import distributed
    import faults
    import harness
    import ranks
    dev = distributed.initialize(
        args.coordinator, cell.chips, args.rank,
        device=None if args.device == "cuda" else args.device)
    try:
        with faults.FAULTS[args.fault]() if args.fault else nullcontext():
            line = ranks.run(ROOT, args.workload, args.seed, args.seconds,
                             bool(args.trace), rank=args.rank,
                             device=str(dev), t_start=args.t_start,
                             control=args.control, cell=cell,
                             pool_seed=args.pool_seed)
    finally:
        dist.destroy_process_group()
    # every process looks at what it loaded: one that names a forbidden
    # module exits 3, and the launcher then ends the run with no result
    if not _no_forbidden(harness):
        return 3
    if line is not None:
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
