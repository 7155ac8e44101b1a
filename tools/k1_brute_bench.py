"""Times the brute-force K1 wrappers (``lcp_min_d2``, ``min_sq_dists``)
of one checkout of super4pcs_tpu_torch on one CUDA card, at the six
shapes of chip_smoke.py's phases 3 and 3b and on the same inputs (the
headline's samples and the 1M config's, candidates drawn in the same
order from the same generator):

- the verify's exact stage 64 x 8192 x 74738, mid 2048 x 512 x 7474 and
  coarse 4096 / 16384 x 64 x 2020 (lcp_min_d2);
- the 1M config's exact stage 64 x 16384 x 530,895 (lcp_min_d2, the
  shape of the TPU's streamed-P K3);
- K4a, 16384 x 530,895 (min_sq_dists).

Kernel times are profiler device times of the brute force's kernel
(and of its fill of the output, where the tiled kernel splits the group
list); a tiled K1's index is built before and not timed. chip_smoke.py
phases 3 and 3b check the current kernel at these shapes and count its
tests; this script only times two versions on one card.

Usage, from the repo root:

    python3 tools/k1_brute_bench.py [--root DIR] [--out FILE]

``--root`` names the directory whose ``super4pcs_tpu_torch`` is timed
(default: this repo), e.g. an unpacked ``git archive`` of an earlier
commit, so that two versions are timed by one script on one card: run
it for the old, the new, the new and the old checkout in one command.
Prints the card (nvidia-smi name and power limit), one line per shape
(kernel ms) and one JSON line; ``--out`` writes the JSON to a file too.
Exits 2 without a CUDA device.
"""
import _path  # noqa: F401
import argparse
import json
import os
import subprocess
import sys

import bench
import chip_smoke as cs


#: the brute-force kernel of a checkout without the tiled index (one
#: thread a slot over all of P)
UNTILED_NAME = "lcp_min_d2_kernel"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--out")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    # chip_smoke and bench above come from this repo; the package timed
    # comes from --root
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("k1_brute_bench: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    import super4pcs_tpu_torch as s4
    from super4pcs_tpu_torch.kernels import lcp as k1
    if not os.path.abspath(s4.__file__).startswith(root + os.sep):
        raise SystemExit(f"imported {s4.__file__}, not from {root}")
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    P, Q = bench.fine_delta_pair()
    opts = cs._headline_options(s4)
    p_pos, q_pos = cs._samples(s4, P, Q, opts.delta, opts.sample_size,
                               opts.random_seed, dev)
    near_pose = cs._pose_sampler(dev)
    shapes = [("exact", near_pose(64), q_pos, p_pos),
              ("mid", near_pose(2048), q_pos[::16], p_pos[::10]),
              ("coarse-4096", near_pose(4096), q_pos[::128], p_pos[::37]),
              ("coarse-16384", near_pose(16384), q_pos[::128],
               p_pos[::37])]
    up, uqp = cs._ultra_samples(s4, *cs._ultra_pair(), dev)
    shapes += [("1M exact", near_pose(64), uqp, up), ("K4a", None, uqp, up)]

    tiled = hasattr(k1, "tile_index")
    rows = []
    for label, tr, qs, ps in shapes:
        qs, ps = qs.contiguous(), ps.contiguous()
        extra = (k1.tile_index(ps),) if tiled else ()
        if tr is None:
            def fn():
                return k1.min_sq_dists(qs, ps, *extra)
        else:
            def fn():
                return k1.lcp_min_d2(tr, qs, ps, *extra)
        c = 1 if tr is None else tr.shape[0]
        names = UNTILED_NAME
        if tiled:
            parts = k1.lcp_min_d2_counts(tr, qs, ps, *extra)[3]
            names = ((cs.K1B_NAME, cs.K1B_FILL) if parts > 1
                     else cs.K1B_NAME)
        reps = 3 if c * qs.shape[0] * ps.shape[0] > 1e11 else 10
        row = dict(shape=label, c=c, nq=qs.shape[0], np=ps.shape[0],
                   ms=cs._kernel_ms(fn, names, reps))
        print(" ".join(f"{k}={v}" for k, v in row.items()), flush=True)
        rows.append(row)
    out = dict(card=smi, root=root, tiled=tiled, rows=rows)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
