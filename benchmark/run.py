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

It exits with another code than 0, and prints no result, when CUDA is
not available or the machine has fewer cards than the cell asks for,
and when a module of jax, jaxlib, flax or the JAX package is loaded.
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


def main(argv=None, *, device: str = "cuda", control: bool = False,
         fault: str | None = None, pool_seed: int | None = None) -> int:
    """Run the cell of ``argv``. The keywords serve the control and the
    tests only: ``device`` other than "cuda" skips the look for cards,
    ``control`` and ``fault`` (a name of ``faults.FAULTS``) break the
    check or the timed path, ``pool_seed`` draws a pooled traffic's pool
    from another seed."""
    args = _args(argv)
    import harness
    cell = harness.Cell(ROOT, args.workload)
    if device == "cuda":
        import torch
        if not torch.cuda.is_available():
            return _refuse("CUDA is not available")
        if torch.cuda.device_count() < cell.chips:
            return _refuse(f"{args.workload} needs {cell.chips} cards, "
                           f"{torch.cuda.device_count()} visible")
    from contextlib import nullcontext
    import faults
    with faults.FAULTS[fault]() if fault else nullcontext():
        line = harness.run(ROOT, args.workload, args.seed, args.seconds,
                           bool(args.trace), device=device,
                           t_start=T_START, control=control, cell=cell,
                           pool_seed=pool_seed)
    if not _no_forbidden(harness):
        return 3
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
