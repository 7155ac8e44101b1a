"""``super4pcs-torch`` console entry point.

The port's copy of ``super4pcs_tpu.cli``. Mirrors the reference demo
CLI (ref:demos/Super4PCS/super4pcs_test.cc:44-189 +
demos/demo-utils.h:57-179): identical flags, defaults, printed parameter
list, progress line, and exit codes (-1 read failure, -2 usage or any
exception, -3 bad options; 0 after the usage text for an unknown flag
or a bad flag value). The registration runs on the CUDA device; where
there is none it fails, and the failure exits -2 with its message.

Flags:
  -i input1 input2    the two clouds (PLY/OBJ/PTX); the returned
                      transform maps input2 onto input1
  -o overlap (0.20)   estimated overlap fraction
  -d delta (5.00)     LCP registration accuracy
  -n n_points (200)   sub-sampling target
  -a norm_diff (-1)   max normal difference in degrees
  -c max_color (-1)   max RGB distance
  -t seconds (10)     anytime budget (CLI default, ref:demo-utils.h:100)
  -r file             output: transformed input2 geometry
  -m file             output: 4x4 transform, Polyworks format
  -x                  use the quadratic 4PCS instead of Super4PCS
  --sampled1/2 file   export the sampled working clouds

Extension of the JAX package, kept by name so that its command lines
carry over (not in the reference CLI; reference flags and semantics are
untouched):
  --tpu-opts k=v[,k=v...]   set tuning fields of Options, e.g.
                      --tpu-opts bases_per_step=32,pair_row_cap=96,
                      use_full_time_budget=true,direction_bins=healpix
                      Keys are TPU_OPT_KEYS; values are parsed by
                      field type ("none" clears an optional).
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np

from . import io as io_
from .matcher import Match4PCS, MatchSuper4PCS
from .options import Options
from .ops.geometry import clean_invalid_normals
from .utils import Logger, LogLevel
from .visitor import PrintingTransformVisitor

DEFAULT_OBJ_OUTPUT = "output.obj"   # ref:demo-utils.h:65

#: Options fields settable via ``--tpu-opts`` — the tuning surface
#: only; reference-CLI parameters keep their dedicated flags. The JAX
#: package's set, so a command line means the same in both packages,
#: plus ``pair_engine`` (the JAX package's CLI takes no engine: there a
#: ``pair_engine=...`` item is an invalid flag value).
TPU_OPT_KEYS = frozenset({
    "pair_engine",
    "bases_per_step", "max_pairs", "max_quads", "max_candidates",
    "pair_row_cap", "pair_recall_target", "cone_cos_tolerance",
    "n_triangle_trials", "search_delta_factor",
    "search_escalation_factor",
    "cell_candidates", "join_q_budget", "join_probe_budget",
    "direction_bins",
    "healpix_nside", "refine_iterations", "verify_top_k", "coarse_q",
    "coarse_p", "p_sample_budget", "use_full_time_budget",
    "phase_timing", "random_seed", "estimate_scale",
})

_OPT_TYPES = {f.name: f.type for f in dataclasses.fields(Options)}


def parse_tpu_opts(spec: str) -> dict:
    """Parse ``k=v,k=v`` into typed Options overrides.

    Types come from the Options dataclass fields: bools accept
    true/false/1/0, ``Optional[int]`` accepts an int or ``none``.
    Raises ValueError on unknown keys or unparsable values.
    """
    out = {}
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        key, sep, val = item.partition("=")
        key = key.strip()
        val = val.strip()
        if not sep or key not in TPU_OPT_KEYS:
            raise ValueError(f"unknown --tpu-opts key: {key!r}")
        ftype = str(_OPT_TYPES[key])
        if val.lower() == "none":
            if "Optional" not in ftype:
                raise ValueError(f"{key} is not optional")
            out[key] = None
        elif "bool" in ftype:
            if val.lower() not in ("true", "false", "1", "0"):
                raise ValueError(f"bad bool for {key}: {val!r}")
            out[key] = val.lower() in ("true", "1")
        elif "int" in ftype:
            out[key] = int(val)
        elif "float" in ftype:
            out[key] = float(val)
        else:                                   # str (direction_bins)
            out[key] = val
    return out


class Args:
    """Parsed flag state with the reference defaults
    (ref:demo-utils.h:57-102)."""

    def __init__(self):
        self.input1 = "input1.obj"
        self.input2 = "input2.obj"
        self.output = ""
        self.output_mat = ""
        self.sampled1 = ""
        self.sampled2 = ""
        self.delta = 5.0
        self.overlap = 0.2
        self.max_color = -1.0
        self.n_points = 200
        self.norm_diff = -1.0
        self.max_time_seconds = 10
        self.use_super4pcs = True
        self.tpu_opts = {}


def print_parameter_list(a: Args, file=sys.stderr):
    print("Parameter list:", file=file)
    print(f"\t[ -o overlap ({a.overlap:2.2f}) ]", file=file)
    print(f"\t[ -d delta ({a.delta:2.2f}) ]", file=file)
    print(f"\t[ -n n_points ({a.n_points}) ]", file=file)
    print(f"\t[ -a norm_diff ({a.norm_diff:f}) ]", file=file)
    print(f"\t[ -c max_color_diff ({a.max_color:f}) ]", file=file)
    print(f"\t[ -t max_time_seconds ({a.max_time_seconds}) ]", file=file)


def print_usage(argv, a: Args):
    print(f"\nUsage: {argv[0]} -i input1 input2", file=sys.stderr)
    print_parameter_list(a)


def get_args(argv, a: Args) -> int:
    """Flag scan with the reference's semantics (ref:demo-utils.h:
    119-162): returns 0 ok, 1 help requested, -1 unknown flag."""
    i = 1
    try:
        while i < len(argv):
            arg = argv[i]
            if arg == "-i":
                a.input1 = argv[i + 1]
                a.input2 = argv[i + 2]
                i += 2
            elif arg == "-o":
                a.overlap = float(argv[i + 1]); i += 1
            elif arg == "-d":
                a.delta = float(argv[i + 1]); i += 1
            elif arg == "-c":
                a.max_color = float(argv[i + 1]); i += 1
            elif arg == "-t":
                a.max_time_seconds = int(argv[i + 1]); i += 1
            elif arg == "-a":
                a.norm_diff = float(argv[i + 1]); i += 1
            elif arg == "-n":
                a.n_points = int(argv[i + 1]); i += 1
            elif arg == "-r":
                a.output = argv[i + 1]; i += 1
            elif arg == "-m":
                a.output_mat = argv[i + 1]; i += 1
            elif arg == "-x":
                a.use_super4pcs = False
            elif arg == "--sampled1":
                a.sampled1 = argv[i + 1]; i += 1
            elif arg == "--sampled2":
                a.sampled2 = argv[i + 1]; i += 1
            elif arg == "--tpu-opts":
                a.tpu_opts = parse_tpu_opts(argv[i + 1]); i += 1
            elif arg == "-h":
                return 1
            elif arg.startswith("-"):
                print("Unknown flag", file=sys.stderr)
                return -1
            i += 1
    except IndexError:
        print("Missing flag value", file=sys.stderr)
        return -1
    except ValueError:
        print("Invalid flag value", file=sys.stderr)
        return -1

    # if no output file (geometry/matrix) is set, force 3d mesh
    # (ref:demo-utils.h:158-159)
    if not a.output and not a.output_mat:
        a.output = DEFAULT_OBJ_OUTPUT
    return 0


def options_from_args(a: Args, logger: Logger) -> Options:
    """ref:demo-utils.h:164-179 — overlap validation then field copy."""
    try:
        opts = Options().configure_overlap(a.overlap)
    except ValueError:
        logger.error("Invalid overlap configuration. ABORT")
        raise
    return opts.replace(
        sample_size=a.n_points,
        max_normal_difference=a.norm_diff,
        max_color_distance=a.max_color,
        max_time_seconds=a.max_time_seconds,
        delta=a.delta,
        **a.tpu_opts,
    )


def main(argv=None, device="cuda") -> int:
    """Run the CLI on ``argv`` (``sys.argv`` by default). ``device`` is
    where the registration runs: the CUDA device unless the caller asks
    for "cpu" (the kernels' plain versions); it is not a flag."""
    argv = list(sys.argv) if argv is None else list(argv)
    a = Args()
    logger = Logger(LogLevel.Verbose)

    if len(argv) < 4:
        print_usage(argv, a)
        return -2
    c = get_args(argv, a)
    if c != 0:
        print_usage(argv, a)
        return max(c, 0)

    try:
        opts = options_from_args(a, logger)
    except ValueError:
        return -3

    # load data
    try:
        set1, mesh1 = io_.read_object(a.input1)
    except (OSError, ValueError) as e:
        logger.error("Can't read input set1: ", e)
        return -1
    try:
        set2, mesh2 = io_.read_object(a.input2)
    except (OSError, ValueError) as e:
        logger.error("Can't read input set2: ", e)
        return -1

    # clean only when we have a point set, to avoid wrong face-to-point
    # indexation (ref:super4pcs_test.cc:101-106)
    for cloud, mesh in ((set1, mesh1), (set2, mesh2)):
        if (mesh is None or len(mesh.tris) == 0) and cloud.normal is not None:
            cloud.normal, _ = clean_invalid_normals(cloud.normal)

    visitor = PrintingTransformVisitor()

    try:
        if a.use_super4pcs:
            matcher = MatchSuper4PCS(opts, logger, device=device)
            logger.verbose("Use Super4PCS")
        else:
            matcher = Match4PCS(opts, logger, device=device)
            logger.verbose("Use old 4PCS")
        result = matcher.compute_transformation(set1, set2, visitor=visitor)

        if a.sampled1:
            logger.verbose("Exporting Sampled cloud 1 to ", a.sampled1,
                           " ...")
            io_.write_object(a.sampled1, matcher.get_first_sampled())
            logger.verbose("Export DONE")
        if a.sampled2:
            logger.verbose("Exporting Sampled cloud 2 to ", a.sampled2,
                           " ...")
            io_.write_object(a.sampled2, matcher.get_second_sampled())
            logger.verbose("Export DONE")
    except Exception as e:  # noqa: BLE001  (ref catches all: cc:147-155)
        logger.error("[Error]: ", e)
        logger.error("Aborting with code -2 ...")
        return -2

    logger.verbose("Score: ", result.score)
    logger.verbose("(Homogeneous) Transformation from ", a.input2,
                   " to ", a.input1, ": \n",
                   np.array2string(result.transform, precision=6,
                                   suppress_small=False))

    if a.output_mat:
        logger.verbose("Exporting Matrix to ", a.output_mat, "...")
        io_.write_matrix(a.output_mat, result.transform.astype(np.float64))
        logger.verbose("Export DONE")

    if a.output:
        logger.verbose("Exporting Registered geometry to ", a.output, "...")
        io_.write_object(a.output, result.transformed_q or set2, mesh2)
        logger.verbose("Export DONE")

    return 0


if __name__ == "__main__":
    sys.exit(main())
