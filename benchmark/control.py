"""The control, the planted faults and sound runs on other pools, read
on the card.

    python3 benchmark/control.py --what control --workload <cell> \\
        --seed <n> --seconds <s> [--pool-seed <m>]
    python3 benchmark/control.py --what <fault> --workload <cell> ...
    python3 benchmark/control.py --what sound --workload <cell> ...

``--what control`` runs the cell with the plain reference's own LCP,
computed in TF32 (the precision just below the port's float32 with TF32
off), in place of each reported score: the check's ``lcp_gap`` then
reads how far that precision lands from the float64 reference, and
``correct`` has to come out false. ``--what <fault>`` runs the cell
with a fault of ``faults.py`` planted under the timed path.
``--what sound`` runs it as it stands. ``--pool-seed`` draws a pooled
traffic's pool (``pool_seed`` in its file) from another seed, so that
the readings cover more pairs than the timed runs' pool. The
benchmark's own runs run none of this.
"""

from __future__ import annotations

import sys

import run


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    i = argv.index("--what")
    what = argv[i + 1]
    del argv[i:i + 2]
    if what == "control":
        argv.append("--control")
    elif what != "sound":
        argv += ["--fault", what]
    return run.main(argv)


if __name__ == "__main__":
    sys.exit(main())
