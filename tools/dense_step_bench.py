"""Times the dense engine's four paths of one checkout of
super4pcs_tpu_torch on one CUDA card, on chip_smoke.py's inputs:

- the recipe (phase 6: ``register`` on the verify skill's 500-point
  pair), 5e's ``-x`` CLI run on the 30,000-vertex OBJ meshes (the
  options the CLI forms, the clouds read back from the files, through
  ``Match4PCS``), 5g's ``register_sequence`` of bench.py's four
  synthetic views, and 5h's coarse similarity phase (``MatchSuper4PCS``
  at scale_max_q samples);
- for each: the search seconds, trials and score of its registration,
  then a step's profile as phase 5p takes it (kernels per step, wall,
  device busy time, idle share, peak device memory, and the step's run
  over its B bases against one base), without 5p's per-trial check;
- the OBJ and a 100,000-point binary PLY read through ``read_object``.

Usage, from the repo root:

    python3 tools/dense_step_bench.py [--root DIR] [--out FILE]

``--root`` names the directory whose ``super4pcs_tpu_torch`` is timed
(default: this repo), e.g. an unpacked ``git archive`` of an earlier
commit, so that two versions are timed by one script on one card: run
it for the old, the new, the new and the old checkout in one command.
Prints the card (nvidia-smi name and power limit), one line per path and
one JSON line; ``--out`` writes the JSON to a file too. Exits 2 without
a CUDA device.
"""
import _path  # noqa: F401
import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import bench
import chip_smoke as cs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--out")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    # chip_smoke above comes from this repo; the package timed comes
    # from --root
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("dense_step_bench: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    import super4pcs_tpu_torch as s4
    from super4pcs_tpu_torch import io as sio
    if not os.path.abspath(s4.__file__).startswith(root + os.sep):
        raise SystemExit(f"imported {s4.__file__}, not from {root}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    rows = {}
    with tempfile.TemporaryDirectory() as tmp:
        cases = cs._dense_cases(s4, tmp)
        reads = {}
        P, _ = bench.fine_delta_pair()
        sio.write_ply(os.path.join(tmp, "P.ply"), s4.PointCloud(P))
        for name in ("d1.obj", "P.ply"):
            t0 = time.perf_counter()
            sio.read_object(os.path.join(tmp, name))
            reads[name] = 1e3 * (time.perf_counter() - t0)
    for label, cls, opts, Pc, Qc in cases:
        if label == "sequence":
            scans, gts = cs._sequence_views(cs._synth_model())
            t0 = time.perf_counter()
            steps = s4.register_sequence(
                [s4.PointCloud(s) for s in scans], opts,
                gt_transforms=gts, device="cuda")
            reg = dict(wall_s=time.perf_counter() - t0,
                       search_s=[st.result.stats["search_seconds"]
                                 for st in steps],
                       trials=[st.result.n_trials for st in steps],
                       score=[st.result.score for st in steps])
        else:
            res = cls(opts, device="cuda").compute_transformation(Pc, Qc)
            reg = dict(search_s=res.stats["search_seconds"],
                       trials=res.n_trials, score=res.score)
        prof = cs._dense_step_profile(label, cls, opts, Pc, Qc,
                                      check_trials=False)
        rows[label] = dict(reg, **prof)
        print(label, json.dumps(rows[label]), flush=True)
    out = dict(card=smi, root=root, reads_ms=reads, paths=rows)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
