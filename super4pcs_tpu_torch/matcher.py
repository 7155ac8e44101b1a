"""Batched-RANSAC registration drivers (4PCS and Super4PCS modes).

PyTorch counterpart of ``super4pcs_tpu.matcher``, the re-architecture of
``Match4PCSBase::ComputeTransformation``
(ref:src/super4pcs/algorithms/match4pcsBase.hpp:61-274):

- each *device step* runs ``bases_per_step`` complete trials — base
  selection, pair extraction, congruent-set join, rigid fit — as an
  explicit batch over a flat trial axis (the JAX package's ``vmap``
  over bases, and over pairs for parallel/batch.py, becomes a batch
  dimension: the rowcap engine captures every trial's edge in one
  kernel launch (K2; on the XLA route, ``rowcap_kernel="xla"`` or
  similarity mode, both edges in one K2x launch), the banded engine
  extracts it in one call over the run's band index, the dense engine
  masks them in one call, the allpairs engine shares one implicit
  table, and the join takes every trial's table at once), then scores
  every surviving candidate with the batched LCP kernel and takes an
  argmax per pair;
- the anytime contract (ref:hpp:236-255) is a host loop around the
  step: wall-clock budget, trial budget and terminate threshold are
  checked between steps, with the same ``stats`` keys and visitor
  stream as the JAX package;
- RANSAC state is an explicit dict (:meth:`export_state`), and a run
  resumes from the JAX package's exported state too
  (:func:`state_from_jax`);
- similarity mode (``estimate_scale``, the reference's MULTISCALE
  build) runs the dense engine up to nq = 2048 and the "allpairs"
  implicit-table engine above (or, asked for, the rowcap engine on the
  XLA route), and above ``scale_max_q`` samples the two-phase
  hierarchical solve (:meth:`_compute_scale_hierarchical`).

- ``mesh`` (parallel/sharded.py) shards each step's bases over a
  device mesh: the step's draws are drawn once on the mesh's first
  device, each device runs its slice of the bases against its own
  replica of the clouds and the run's indexes, and the best candidate
  is reduced on the host;
- ``Options.phase_timing`` times the phases of one warm step
  (:meth:`_measure_phases`, ``stats["phase_seconds"]``) and attributes
  them against the step's cost model (``step.cost_model``,
  utils/roofline.py, ``stats["phase_roofline"]``).

The dispatch layer: on the card every unsharded run captures its step
into a CUDA graph once, off the anytime clock (utils/graphs.py), and
replays it, with the step's draws drawn eagerly and copied in, so a
graphed run draws the trials an eager run draws. One anytime loop
(:meth:`Match4PCSBase._perform_steps`) runs every step on every device,
size and engine, with two steps in flight. The CPU, a mesh,
``register_batch`` and the phase timing run the step eagerly.

What the port leaves out, because it exists only for XLA compile time:
the background escalation compile (escalation here is a synchronous
rebuild of the step at the wider factor, captured again off the clock)
and the telescoped phase probes. On the card one step and one refine
run before the anytime clock starts (and again, off the clock, after an
escalation), so the clock does not count the CUDA libraries' first
calls, the verify's cell indexes or the capture. The banded engine's
band index (ops/band_extract.py) is built once per run, before the
clock, like the kernels.

Randomness comes from a ``torch.Generator`` reseeded per step from
``(random_seed, step index)``, so a resumed run draws the trials an
uninterrupted run would have; the draws differ from the JAX package's
threefry streams, so runs of the two packages agree statistically, not
trial for trial. Similarity mode draws two more numbers per base (the
dense capture's row rotation and the strided probe walk's rotation),
and the banded engine and the XLA capture one (the band window's
rotation, the capture's column rotation), after the base draws, so the
other engines' draws do not depend on them.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
import time
from typing import Optional

import numpy as np
import torch

from .cloud import PointCloud
from .kernels import join as join_kernel
from .kernels import lcp as lcp_kernel
from .kernels.lcp import PAIR_TEST_OPS
from .kernels import rowcap as rowcap_kernel
from .kernels import rowcap_layout as rowcap_layout_kernel
from .options import (Options, DISTANCE_FACTOR, K_LARGE_NUMBER,
                      K_NUMBER_OF_DIAMETER_TRIALS)
from .ops import congruent, geometry, lcp, refine, sampling, select
from .ops.band_extract import build_band_index, extract_pairs_banded
from .ops.masking import masked_indices
from .ops.pairs import (PairFilterConfig, extract_pairs,
                        extract_pairs_dense_rowcap,
                        extract_pairs_rowcap_layout_both)
from .utils import Logger, LogLevel, profiling
from .utils import graphs
from .utils.graphs import HostCopies, StepGraph
from .visitor import DummyTransformVisitor, visitor_needs_global

_K_SMALL_ERROR = 0.00001      # ref:match4pcsBase.hpp:101
_K_MIN_TRIALS = 4             # ref:hpp:102
_K_DIAMETER_FRACTION = 0.3    # ref:hpp:103


@dataclasses.dataclass
class RegistrationResult:
    """Outcome of one registration run."""
    score: float                     # best LCP in [0, 1]
    transform: np.ndarray            # 4x4 mapping Q onto P, original coords
    transformed_q: Optional[PointCloud]  # original Q moved by `transform`
    n_trials: int
    improved: bool
    stats: dict


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def resolve_bases_per_step(opts: Options, nq: int,
                           mesh_size: int = 1) -> int:
    """Effective RANSAC width per step (see Options.bases_per_step):
    ``None`` gives 16 at nq > 1024, else 64, and 4 in similarity mode
    above nq = 2048, where each base's allpairs table holds nq^2 rows,
    rounded up to a multiple of ``mesh_size`` so that bases-axis
    sharding divides evenly (the JAX package's rule)."""
    b = opts.bases_per_step
    if b is None:
        b = 16 if nq > 1024 else 64
        if opts.estimate_scale and nq > 2048:
            b = 4
        if mesh_size > 1:
            b = _round_up(b, mesh_size)
    return b


def resolve_pair_engine(opts: Options, nq: int) -> str:
    """Effective pair-extraction engine (see Options.pair_engine), the
    JAX package's rule: dense masking up to nq = 2048, the rowcap engine
    above, the banded sorted-table engine above nq = 65536 on the
    capture kernel's route and above 32768 on the XLA capture's
    (``rowcap_kernel="xla"``: the JAX package's capture kernel covers
    every nq <= 65536 on its own backend). In similarity mode the
    distance filter is off and every ordered pair is a candidate, so
    "auto" gives dense up to 2048 and the allpairs implicit table above
    (no capture at all); an explicit "rowcap" there runs the XLA
    capture (:func:`uses_capture_kernel`)."""
    e = opts.pair_engine
    if e == "auto":
        if opts.estimate_scale:
            return "dense" if nq <= 2048 else "allpairs"
        rowcap_top = 32768 if opts.rowcap_kernel == "xla" else 65536
        e = ("dense" if nq <= 2048
             else ("rowcap" if nq <= rowcap_top else "banded"))
    return e


def uses_capture_kernel(opts: Options, engine: str) -> bool:
    """Whether a rowcap engine's step captures with K2, the band-capture
    kernel (kernels/rowcap.py: per-segment quotas, the join hash, tile
    rejection), or, when False, with K2x, the XLA route's row-capped
    capture (kernels/rowcap_layout.py: each row's first hits in a
    rotated column order). The XLA route runs under
    ``rowcap_kernel="xla"`` and in similarity mode, where the JAX
    package's kernel path is off (``use_pk``)."""
    return (engine == "rowcap" and opts.rowcap_kernel != "xla"
            and not opts.estimate_scale)


def capture_bounds(opts: Options, engine: str, q_pos):
    """The Q bounds of a capture's rejection, for the clouds ``q_pos``
    (G, n, 3) on the card: K2's tile spheres (``rowcap.reject_bounds``)
    or K2x's row order and spheres (``rowcap_layout.reject_bounds``,
    with the distance band only), per the engine; None on the CPU, with
    ``rowcap_tile_reject`` off, or on another engine."""
    if not opts.rowcap_tile_reject or q_pos.device.type != "cuda":
        return None
    if uses_capture_kernel(opts, engine):
        return rowcap_kernel.reject_bounds(q_pos)
    if engine == "rowcap" and not opts.estimate_scale:
        return rowcap_layout_kernel.reject_bounds(q_pos)
    return None


def warm_kind(opts: Options, engine: str, *, refine: bool,
              batch: bool = False) -> tuple:
    """The kind of a warm-up, as the process's record of warmed kinds
    keys it (``utils.graphs.CaptureContext.warmed``): a batch's step or
    a single pair's, the resolved engine, the capture route (K2, K2x or
    none), which pair filters are on, similarity mode and the refine.
    One warm of a kind loads what every later step of that kind
    launches."""
    route = ("K2" if uses_capture_kernel(opts, engine)
             else "K2x" if engine == "rowcap" else None)
    filters = (opts.max_normal_difference > 0, opts.max_color_distance > 0,
               opts.max_translation_distance > 0, opts.max_angle > 0)
    return ("batch" if batch else "pair", engine, route, filters,
            bool(opts.estimate_scale), bool(refine))


def _step_seed(random_seed: int, step_idx: int) -> int:
    """Seed of one step's draws: a fixed function of the run seed and
    the step index, so a resumed run continues the same stream."""
    return (int(random_seed) * 1_000_003 + int(step_idx)) % (1 << 63)


@contextlib.contextmanager
def step_span(device=None):
    """A span "step" (utils/profiling.py) around one step run, which
    also adds 1 to the counter ``join_kernel_steps`` when the step's
    join ran the join kernel (``kernels/join.py``): its launch count
    moved, as a replay moves it by its capture's launches."""
    before = join_kernel.grid_join.launches
    with profiling.span("step", device):
        yield
    profiling.count("join_kernel_steps",
                    int(join_kernel.grid_join.launches > before))


def _build_try_bases(opts: Options, nq: int, cone_tol: float,
                     band_index=None):
    """Build the batched trial function of one step.

    ``band_index``: the run's ``ops.band_extract.BandIndex`` of Q (one
    per cloud pair, batched, for G pairs) when the engine is "banded";
    its cell and occupancy counts size the engine's window.

    Returns (try_bases, (k_pairs, k_quads, n_cands)), where
    ``try_bases(draws, diam, p_pos, p_norm, p_rgb, q_pos, q_norm, q_rgb,
    q_bounds, rot_draws)`` runs one trial per base draw of G cloud
    pairs (the clouds (G, n, .), the draws (G, B, ...), see
    ops/select.py), over the flat trial axis T = G * B, trial ``t`` on
    pair ``t // B``; ``q_bounds`` are the Q bounds of the capture's
    rejection (:func:`capture_bounds`, over G sets), or None;
    ``rot_draws`` are each trial's rotations, (T,) tensors: in
    similarity mode the dense capture's row rotation (the XLA capture's
    column rotation) in [0, nq) and the probe walk's in [0, k_pairs), on
    the banded engine its window's and on the XLA capture its column
    rotation in [0, nq); else None.

    Every engine runs every trial at once: one capture launch per base
    edge (K2), one for both edges (K2x, the XLA route), one extraction
    call per edge (banded, dense) or none (allpairs, whose validity
    vector every trial shares), then one join over all T tables (the
    grid join's one sort per chunk of trials, or the dense join a chunk
    of trials at a time).
    """
    if opts.bases_per_step is None:
        opts = opts.replace(bases_per_step=resolve_bases_per_step(opts, nq))
    engine = resolve_pair_engine(opts, nq)
    if engine == "banded" and band_index is None:
        raise ValueError("the banded engine needs the run's band index")
    capture_kernel = uses_capture_kernel(opts, engine)
    # Capacity defaults (the JAX package's block): pair counts scale ~
    # nq^2 * shell fraction; the rowcap engine captures 64 * nq, the
    # dense and banded ones 16 * nq (the banded engine's candidates are
    # band-filtered before capture; widened under coarse search); quads
    # ~8 * nq up to 8192. Similarity mode has no distance band: every
    # ordered pair is a hit, so the dense engine holds all nq (nq - 1)
    # of them and the allpairs table is the full nq^2 enumeration.
    if engine == "allpairs":
        if not opts.estimate_scale:
            raise ValueError("pair_engine='allpairs' requires "
                             "estimate_scale=True")
        if (opts.max_normal_difference > 0 or opts.max_color_distance > 0
                or opts.max_translation_distance > 0):
            # the implicit table marks every pair valid: there is no
            # extraction stage to filter in
            raise ValueError(
                "pair_engine='allpairs' cannot apply pair-level filters "
                "(max_normal_difference/max_color_distance/"
                "max_translation_distance); reduce sample_size to "
                "<= 2048 (dense engine) or disable the filters")
        k_pairs = nq * nq
    elif opts.max_pairs:
        k_pairs = opts.max_pairs
    elif opts.estimate_scale and nq <= 2048:
        k_pairs = _round_up(nq * (nq - 1), 128)
    else:
        per_nq = 64 if (nq > 2048 and engine != "banded") else 16
        k_pairs = _round_up(
            min(nq * nq,
                max(int(per_nq * nq
                        * max(opts.search_delta_factor, 1.0)), 512)), 128)
    k_quads = _round_up(
        opts.max_quads or min(max(8 * nq, 512), 8192), 128)
    # candidate compaction budget of the step (see the JAX package)
    default_cands = (4096 if nq <= 1024
                     else max(4096, 8 * max(opts.verify_top_k, 0)))
    n_cands = min(opts.max_candidates or default_cands,
                  opts.bases_per_step * k_quads)

    cfg = PairFilterConfig(
        max_normal_difference=opts.max_normal_difference,
        max_color_distance=opts.max_color_distance,
        max_translation_distance=opts.max_translation_distance,
        max_angle=opts.max_angle,
        use_distance_filter=not opts.estimate_scale,
    )
    # Search-stage tolerances widen by search_delta_factor; verification
    # and refinement stay exact at delta (see Options).
    sf = opts.search_delta_factor
    eps_pairs = DISTANCE_FACTOR * opts.delta * sf  # ref:hpp:328-331
    # join radius: squared-vs-squared contract (see ops/congruent.py)
    dist_thr = DISTANCE_FACTOR * opts.delta * sf   # ref:hpp:340-347
    max_angle_rad = (opts.max_angle * math.pi / 180.0
                     if opts.max_angle >= 0 else -1.0)
    rms_gate = DISTANCE_FACTOR * opts.delta * sf   # ref:hpp:439
    # join cell size stays at the exact-delta scale
    cell_size = 2.0 * DISTANCE_FACTOR * opts.delta
    n_tri = opts.n_triangle_trials
    # dense K1 x K2 join when its mask fits the element budget
    dense_join = (not opts.force_grid_join
                  and engine == "dense"
                  and k_pairs * k_pairs * opts.bases_per_step <= (1 << 30))

    est_scale = opts.estimate_scale
    if engine == "dense":
        join_row_cap = None
        # per-row capture when the per-row quota is small; the global
        # row-major prefix otherwise, and always in similarity mode,
        # whose capture is rotated by a per-base row offset (with every
        # pair a hit, an unrotated prefix would keep the same low rows
        # every trial)
        dense_fn = (extract_pairs_dense_rowcap
                    if not est_scale and max(k_pairs // nq, 1) <= 64
                    else extract_pairs)

        def extract_both(pos, normal, rgb, bpos, bnorm, brgb, inv1,
                         bounds, off):
            return (dense_fn(pos, normal, rgb, bpos, bnorm, brgb, 0, 1,
                             eps_pairs, cfg, capacity=k_pairs,
                             row_offset=off),
                    dense_fn(pos, normal, rgb, bpos, bnorm, brgb, 2, 3,
                             eps_pairs, cfg, capacity=k_pairs,
                             row_offset=off))
    elif engine == "allpairs":
        join_row_cap = nq
        # nothing to extract: the join reads pair (t // nq, t % nq) from
        # the slot index. The diagonal slots (t % (nq + 1) == 0) are
        # invalid, so the valid count is the nq (nq - 1) hits. The
        # validity vector depends on nq alone: it is built once (per
        # device) and every trial's row is a view of it
        all_valid = None

        def extract_both(pos, normal, rgb, bpos, bnorm, brgb, inv1,
                         bounds, off):
            nonlocal all_valid
            if all_valid is None or all_valid.device != pos.device:
                all_valid = (torch.arange(nq * nq, device=pos.device)
                             % (nq + 1)) != 0
            nt = bpos.shape[0]
            valid = all_valid.expand(nt, -1)
            cnt = torch.full((nt,), nq * (nq - 1), dtype=torch.int64,
                             device=pos.device)
            z = torch.zeros_like(cnt)
            return (None, valid, cnt, z), (None, valid, cnt, z)
    elif engine == "banded":
        join_row_cap = None
        pc = band_index.pc
        # two-level capture sizing (the JAX package's): each window
        # entry's slot budget ~2x the mean occupancy product bounds the
        # padding, and the window spreads the expansion budget over as
        # much of the band as it can expand
        mean_occ = max(
            1.0, min(band_index.n / max(band_index.m, 1), float(pc)))
        es_target = max(4, int(2.0 * mean_occ * mean_occ))

        def band_sizing(cap):
            ec = opts.band_expand_cap or _round_up(4 * cap, 128)
            cp = opts.band_cell_pair_cap or _round_up(
                min(max(ec // es_target, 2048), 262144), 128)
            return cp, min(ec, cp * pc * pc)

        # asymmetric capacities: the join hashes the first edge's pairs
        # (its whole table feeds a trial's success) but probes only
        # join_q_budget second-edge pairs, so the second edge captures
        # ~4x that budget
        jqb = min(opts.join_q_budget or 8192, k_pairs)
        k2_cap = min(k_pairs, _round_up(4 * jqb, 128))
        cp1, ec1 = band_sizing(k_pairs)
        cp2, ec2 = band_sizing(k2_cap)

        def extract_both(pos, normal, rgb, bpos, bnorm, brgb, inv1,
                         bounds, off):
            # every trial of the step in one call per edge
            return (extract_pairs_banded(
                        band_index, pos, normal, rgb, bpos, bnorm, brgb,
                        0, 1, eps_pairs, cfg, cp1, rot_offset=off,
                        capacity=k_pairs, expand_cap=ec1),
                    extract_pairs_banded(
                        band_index, pos, normal, rgb, bpos, bnorm, brgb,
                        2, 3, eps_pairs, cfg, cp2, rot_offset=off,
                        capacity=k2_cap, expand_cap=ec2))
    else:
        join_row_cap = opts.pair_row_cap or min(nq, max(32, _round_up(
            5 * k_pairs // (2 * nq), 32)))
    if capture_kernel:
        if opts.pair_row_cap is None and nq > 32768:
            # 128-slot taper (quality-neutral vs 256 at nq = 65536)
            join_row_cap = min(join_row_cap, 128)
        join_row_cap = rowcap_kernel.slots_for(nq, join_row_cap)

        def extract_both(pos, normal, rgb, bpos, bnorm, brgb, inv1,
                         bounds, off):
            # every trial's capture in one launch per edge; edge 0 also
            # emits the join hash of every captured slot
            return rowcap_kernel.extract_pairs_rowcap_both(
                pos, bpos, eps_pairs, join_row_cap,
                invariant1=inv1, cell_size=cell_size,
                normal=normal, rgb=rgb, base_norm=bnorm, base_rgb=brgb,
                max_normal_difference=opts.max_normal_difference,
                max_color_distance=opts.max_color_distance,
                max_translation_distance=opts.max_translation_distance,
                max_angle=opts.max_angle,
                tile_reject=opts.rowcap_tile_reject, bounds=bounds)
    elif engine == "rowcap":
        def extract_both(pos, normal, rgb, bpos, bnorm, brgb, inv1,
                         bounds, off):
            # the XLA route (K2x): both edges of every trial in one
            # launch, each row's first join_row_cap hits in the column
            # order rotated by the trial's offset; cols-only tables, the
            # join hashes them
            return extract_pairs_rowcap_layout_both(
                pos, normal, rgb, bpos, bnorm, brgb, eps_pairs, cfg,
                row_cap=join_row_cap,
                recall_target=opts.pair_recall_target, col_offset=off,
                cols_only=True, tile_reject=opts.rowcap_tile_reject,
                bounds=bounds)

    qb_default = opts.join_q_budget or 8192
    # allpairs: the nq^2-row table fills nearly every cell, so nearly
    # every probe hits and a probe budget would only cut the probe
    # sample: no budget there
    probe_budget = opts.join_probe_budget or (
        None if engine == "allpairs" else
        (2 * min(qb_default, k_pairs if join_row_cap is None
                 else qb_default)
         * congruent.probe_window(dist_thr, cell_size) ** 3) // 8)

    # the join kernel's inputs (kernels/join.py::takes): the capture
    # kernel's table hash and candidate tests the kernel runs
    kernel_join = capture_kernel and join_kernel.tests_candidates(
        opts.direction_bins, cone_tol,
        geometry.SCALE_RATIO_DEV if est_scale else -1.0,
        opts.cell_candidates)

    def _phase_costs(np_: int, device=None) -> dict:
        """First-order operations + device-memory bytes of the trial
        phases of ONE step (x bases_per_step), from the static
        capacities that size the buffers: the JAX package's
        ``_phase_costs`` term by term (its Pallas capture kernel's terms
        for the rowcap engine), except the join's sort: the port sorts
        every table once with ``torch.sort`` over int64 keys, counted as
        the keys read once and the sorted keys and their int64
        permutation written once, where the JAX package counts the
        passes of a bitonic network. On a CUDA ``device`` the capture
        kernel's join is the join kernel's, which sorts nothing
        (``kernels/join.py::join_bytes``)."""
        b = opts.bases_per_step
        sel_fl = b * (n_tri * 40.0 + np_ * 24.0)
        sel_by = b * np_ * 12.0
        if engine == "dense":
            ex_fl = b * 2 * float(nq) * nq * 12.0
            ex_by = b * 2 * float(nq) * nq * 5.0
        elif engine == "allpairs":
            ex_fl = 0.0                  # the table is implicit
            ex_by = float(nq) * nq       # the validity vector
        elif engine == "banded":
            ex_fl = b * float(ec1 + ec2) * 24.0
            ex_by = b * (float(cp1 + cp2) * (2.0 * pc * 4.0 + 16.0)
                         + float(ec1 + ec2) * 36.0)
        elif capture_kernel:             # the capture kernel (K2)
            # the Theta(nq^2) band test in registers and the hash of
            # edge 0; device memory holds only the tables
            ex_fl = b * float(nq) * nq * (40.0 + 25.0)
            ex_by = b * (float(nq) * join_row_cap * 12.0
                         + 2.0 * float(nq) * 4.0)
        else:                            # the XLA route (K2x)
            # the JAX package's approx_max_k terms: its key plane and
            # iota (16 bytes per row, column and edge) and the tables
            ex_fl = b * 2 * float(nq) * nq * 16.0
            ex_by = b * 2 * (float(nq) * nq * 16.0
                             + float(nq) * join_row_cap * 8.0)
        k1 = float(nq) * join_row_cap if join_row_cap else float(k_pairs)
        k2_eff = float(k2_cap) if engine == "banded" else k1
        if dense_join:
            jn_fl = b * float(k_pairs) * k_pairs * 10.0
            jn_by = b * float(k_pairs) * k_pairs * 1.0
        elif kernel_join and torch.device(device or "cpu").type == "cuda":
            qb = min(opts.join_q_budget or 8192, int(k1))
            probes = float(qb) * congruent.probe_window(
                dist_thr, cell_size) ** 3
            kept = min(float(probe_budget), probes)
            # a hash lookup a slot twice, each probe's cell hash and
            # entry, each kept candidate's tests
            jn_fl = b * (k1 * 10.0 + probes * 20.0
                         + kept * opts.cell_candidates * 30.0)
            jn_by = b * join_kernel.join_bytes(
                k1, probes, kept, opts.cell_candidates, k_quads)
        else:
            qb = min(opts.join_q_budget or 8192, int(k2_eff))
            w = congruent.probe_window(dist_thr, cell_size)
            probes = float(qb) * w ** 3
            lg = max(math.log2(max(k1, 2.0)), 1.0)
            rounds = min(lg, max(12.0, (int(k1) >> 16)
                                 .bit_length() + 5.0))
            # the capture kernel delivers the table hash
            hash_fl = 0.0 if capture_kernel else k1 * 20.0
            hash_by = 0.0 if capture_kernel else k1 * 16.0
            jn_fl = b * (hash_fl + probes * opts.cell_candidates * 10.0)
            jn_by = b * (hash_by + k1 * 24.0
                         + probes * (2.0 * rounds * 4.0
                                     + opts.cell_candidates * 8.0))
        ft_fl = b * float(k_quads) * 600.0
        ft_by = b * float(k_quads) * 96.0
        return {
            "select_extract": dict(flops=sel_fl + ex_fl,
                                   hbm_bytes=sel_by + ex_by),
            "join": dict(flops=jn_fl, hbm_bytes=jn_by),
            "fit": dict(flops=ft_fl, hbm_bytes=ft_by),
        }

    def try_bases(draws, diam, p_pos, p_norm, p_rgb, q_pos, q_norm,
                  q_rgb, q_bounds=None, rot_draws=None, marks=None):
        mark = marks.mark if marks is not None else (lambda name: None)
        ids, inv1, inv2, bvalid = select.select_base(p_pos, diam, *draws)
        n_sets, nb = ids.shape[:2]
        nt = n_sets * nb
        dev = q_pos.device
        gi = torch.arange(n_sets, device=dev)[:, None, None]
        base_pos = p_pos[gi, ids].reshape(nt, 4, 3)
        base_norm = p_norm[gi, ids].reshape(nt, 4, 3)
        base_rgb = p_rgb[gi, ids].reshape(nt, 4, 3)
        ids, inv1, inv2, bvalid = (ids.reshape(nt, 4), inv1.reshape(nt),
                                   inv2.reshape(nt), bvalid.reshape(nt))
        # angle between the two base segments (ref:super4pcs.cc:109-111)
        s1 = base_pos[:, 1] - base_pos[:, 0]
        s2 = base_pos[:, 3] - base_pos[:, 2]
        n1 = torch.clamp(torch.linalg.vector_norm(s1, dim=-1), min=1e-30)
        n2 = torch.clamp(torch.linalg.vector_norm(s2, dim=-1), min=1e-30)
        cos_alpha = ((s1 / n1[:, None]) * (s2 / n2[:, None])).sum(-1)
        offs = q_rots = None
        if rot_draws is not None:
            offs = rot_draws[0]
        if est_scale:
            # the MULTISCALE ratio gate of the joins: d1 / d2 of the base
            seg_ratio = n1 / n2
            q_rots = rot_draws[1]
        gate = (dict(seg_ratio=seg_ratio,
                     scale_band=geometry.SCALE_RATIO_DEV)
                if est_scale else {})
        nq_ = q_pos.shape[1]
        set_of = torch.arange(nt, device=dev) // nb

        # every trial of the step at once: one extraction call (a capture
        # launch on the rowcap engine, none on allpairs) per base edge,
        # then one join over all T tables
        ext = extract_both(q_pos, q_norm, q_rgb, base_pos, base_norm,
                           base_rgb, inv1, q_bounds, offs)
        (pairs1, v1, c1, d1), (pairs2, v2, c2, d2) = ext[:2]
        # the capture kernel emits the join hash of its table
        thash = ext[2] if len(ext) > 2 else None
        mark("join")
        if dense_join:
            quads, qvalid, qcount = congruent.find_congruent_quads(
                q_pos, pairs1, v1, pairs2, v2, inv1, inv2, dist_thr,
                cos_alpha, cone_tol, k_quads,
                direction_bins=opts.direction_bins,
                healpix_nside=opts.healpix_nside, **gate)
            qdropped = q_sub = torch.zeros_like(qcount)
        else:
            quads, qvalid, qcount, qdropped, q_sub = \
                congruent.find_congruent_quads_grid(
                    q_pos, pairs1, v1, pairs2, v2, inv1, inv2,
                    dist_thr, cos_alpha, cone_tol, k_quads,
                    cell_candidates=opts.cell_candidates,
                    q_budget=opts.join_q_budget,
                    direction_bins=opts.direction_bins,
                    healpix_nside=opts.healpix_nside,
                    cell_size=cell_size, row_cap=join_row_cap,
                    probe_budget=probe_budget, table_hash=thash,
                    # the strided probe walk only over the raw allpairs
                    # enumeration, whose valid prefix holds the pairs of
                    # a handful of first endpoints
                    allpairs_cols=engine == "allpairs",
                    q_uniform=engine == "allpairs", q_rot=q_rots, **gate)
        counts = torch.stack([c1, c2, qcount, qdropped, d1 + d2, q_sub],
                             dim=1)
        mark("fit")
        qvalid = qvalid & bvalid[:, None]

        # each trial's quads index its own pair's Q
        cand = q_pos.reshape(-1, 3)[quads + (set_of * nq_)[:, None, None]]
        centroid1 = base_pos[:, :3].mean(dim=1)          # ref:hpp:385
        centroid2 = cand[:, :, :3].mean(dim=2)           # ref:hpp:415-417
        transform, rms, tvalid = geometry.batched_rigid_fit(
            base_pos, cand, centroid1, centroid2, max_angle_rad,
            estimate_scale=est_scale)
        cvalid = qvalid & tvalid & (rms >= 0) & (rms < rms_gate)
        # telemetry row per trial: exact pre-cap pair counts, exact
        # pre-cap quad count, per-cell join drops, pairs dropped from
        # the buffers, and the Q-side probe-subsample volume
        return dict(transform=transform, cvalid=cvalid,
                    centroid1=centroid1, centroid2=centroid2,
                    ids=ids, quads=quads, counts=counts)

    try_bases.phase_costs = _phase_costs
    return try_bases, (k_pairs, k_quads, n_cands)


def build_step(opts: Options, nq: int, cone_tol: float, band_index=None):
    """Build the RANSAC device step over G cloud pairs (``band_index``:
    the run's band index of the G pairs' Q when the engine is
    "banded", see :func:`_build_try_bases`).

    ``step(gen, diam, p_pos, p_norm, p_rgb, q_pos, q_norm, q_rgb,
    q_bounds=None, p_index=None, marks=None, stages=None)`` takes G
    pairs' clouds (``p_*`` (G, np, .), ``q_*`` (G, nq, .), ``diam`` (G,)
    or a number), draws ``bases_per_step`` bases per pair from the
    generator (``step.draw``), and runs them (``step.run``).

    ``step.draw(gen, n_sets, n_p)``: the step's draws for ``n_sets``
    pairs of ``n_p`` P samples, pair by pair (so G = 1 draws what a
    single-pair step draws), as one tuple of tensors with a leading (G,
    B): the base draws (first, seconds, thirds, see ops/select.py), then
    each base's rotations (similarity mode's two, the banded window's
    or the XLA capture's one). Sharding slices them along either axis.

    ``step.run(draws, diam, ...)`` runs the trials of ``draws`` (see
    :func:`_build_try_bases`; any B, the shard's), compacts each pair's
    valid candidates (the cap scales with the shard's bases, as in the
    JAX package), verifies them (``lcp_scores_two_stage``, one launch
    per stage for every pair, against ``p_index``, the run's
    ``lcp.VerifyIndex`` of ``p_pos``) and returns each pair's best one:
    the JAX package's step outputs with a leading G (its pairs-axis
    ``vmap``). ``marks``: a ``utils.profiling.PhaseMarks`` to mark the
    phases in (select_extract, join, fit, verify); ``stages``: a list to
    which the verify appends each K1 launch's inputs (for the cost
    model).

    ``step.index_keys(np_)``: the (stride, radius) of each verify index
    ``step.run`` reads (``lcp.VerifyIndex.get``) over P of ``np_``
    samples, each pair's bases in one shard: what a capture that no
    eager step precedes needs built.

    ``step.cost_model(np_, verify_stages, device=None)``: the step's
    first-order operations and bytes per phase (utils/roofline.py), the
    verify's from ``verify_stages`` (``ops.lcp.stage_tests`` of
    ``stages``), the join's on ``device`` (the join kernel's on a card).

    Returns (step, (k_pairs, k_quads, n_cands)).
    """
    if opts.bases_per_step is None:
        opts = opts.replace(bases_per_step=resolve_bases_per_step(opts, nq))
    try_bases, caps = _build_try_bases(opts, nq, cone_tol, band_index)
    k_pairs, k_quads, n_cands = caps
    engine = resolve_pair_engine(opts, nq)
    # a column offset per base: the banded window's rotation, the XLA
    # capture's, and similarity mode's row rotation
    rotated = (opts.estimate_scale or engine == "banded"
               or (engine == "rowcap" and not uses_capture_kernel(opts,
                                                                  engine)))
    b = opts.bases_per_step
    delta = opts.delta
    # coarse-search candidates rank at the search tolerance; the
    # selected one's exact-delta score is reported apart
    rank_delta = delta * opts.search_delta_factor

    def draw(gen, n_sets: int, n_p: int):
        per_pair = []
        for _ in range(n_sets):
            d = list(select.draw_base_indices(gen, n_p, b,
                                              opts.n_triangle_trials))
            # the rotations per base (similarity mode's two, the banded
            # window's and the XLA capture's one), drawn after the pair's
            # base draws so the other engines' draws are the same
            # without them
            if rotated:
                d.append(torch.randint(0, nq, (b,), generator=gen,
                                       device=gen.device))
            if opts.estimate_scale:
                d.append(torch.randint(0, k_pairs, (b,), generator=gen,
                                       device=gen.device))
            per_pair.append(d)
        return tuple(torch.stack(d) for d in zip(*per_pair))

    def run(draws, diam, p_pos, p_norm, p_rgb, q_pos, q_norm, q_rgb,
            q_bounds=None, p_index=None, marks=None, stages=None):
        n_sets, b_local = draws[0].shape[:2]
        rot_draws = tuple(r.reshape(-1) for r in draws[3:]) or None
        tb = try_bases(draws[:3], diam, p_pos, p_norm, p_rgb, q_pos,
                       q_norm, q_rgb, q_bounds, rot_draws, marks)
        if marks is not None:
            marks.mark("verify")
        flat_t = tb["transform"].reshape(n_sets, -1, 4, 4)
        flat_v = tb["cvalid"].reshape(n_sets, -1)
        # compact each pair's valid candidates before the (expensive)
        # scoring; the cap scales with the shard's bases
        n_cands_local = max(128, n_cands * b_local // b)
        if n_cands_local >= flat_v.shape[1]:
            idx = torch.arange(flat_v.shape[1], device=flat_v.device) \
                .expand(n_sets, -1)
            live = flat_v
            n_valid = flat_v.sum(dim=1)
            cand_t = flat_t
            cands_dropped = torch.zeros_like(n_valid)
        else:
            idx, live, n_valid = masked_indices(flat_v, n_cands_local)
            cand_t = lcp._rows(flat_t, idx)
            cands_dropped = torch.clamp(n_valid - n_cands_local, min=0)
        if opts.verify_top_k > 0:
            scores, sel = lcp.lcp_scores_two_stage(
                cand_t, q_pos, p_pos, rank_delta,
                coarse_q=opts.coarse_q, coarse_p=opts.coarse_p,
                top_k=opts.verify_top_k, live=live, index=p_index,
                stages=stages)
            live = lcp._rows(live, sel)
            cand_t = lcp._rows(cand_t, sel)
            idx = lcp._rows(idx, sel)
        else:
            scores = lcp.lcp_scores(
                cand_t, q_pos, p_pos, rank_delta,
                None if p_index is None else p_index.get(1, rank_delta),
                stages=stages)
        scores = torch.where(live, scores, -1.0)

        gi = torch.arange(n_sets, device=scores.device)
        best = torch.argmax(scores, dim=1)
        best_t = cand_t[gi, best]
        if rank_delta != delta:
            exact = lcp.lcp_scores(
                best_t[:, None], q_pos, p_pos, delta,
                None if p_index is None else p_index.get(1, delta),
                stages=stages)[:, 0]
            exact = torch.where(scores[gi, best] >= 0, exact, -1.0)
        else:
            exact = scores[gi, best]
        flat_i = idx[gi, best]
        bi = flat_i // k_quads
        qi = flat_i % k_quads
        out = dict(
            lcp=exact,
            rank_lcp=scores[gi, best],
            transform=best_t,
            qcentroid1=tb["centroid1"].reshape(n_sets, b_local, 3)[gi, bi],
            qcentroid2=tb["centroid2"].reshape(n_sets, b_local, k_quads,
                                               3)[gi, bi, qi],
            base_ids=tb["ids"].reshape(n_sets, b_local, 4)[gi, bi],
            congruent_ids=tb["quads"].reshape(n_sets, b_local, k_quads,
                                              4)[gi, bi, qi],
            n_congruent=n_valid,
            cands_dropped=cands_dropped,
            pair_counts=tb["counts"].reshape(n_sets, b_local, 6),
        )
        if marks is not None:
            marks.stop()
        return out

    def index_keys(np_: int) -> list:
        c = min(max(128, n_cands), b * k_quads)
        strides = (lcp.two_stage_strides(c, nq, np_, opts.coarse_q,
                                         opts.coarse_p, opts.verify_top_k)
                   if opts.verify_top_k > 0 else [1])
        keys = [(s, rank_delta) for s in strides]
        if rank_delta != delta:
            keys.append((1, delta))
        return keys

    def step(gen, diam, p_pos, p_norm, p_rgb, q_pos, q_norm, q_rgb,
             q_bounds=None, p_index=None, marks=None, stages=None):
        if marks is not None:
            marks.mark("select_extract")
        return run(draw(gen, p_pos.shape[0], p_pos.shape[1]), diam, p_pos,
                   p_norm, p_rgb, q_pos, q_norm, q_rgb, q_bounds, p_index,
                   marks, stages)

    def cost_model(np_: int, verify_stages, device=None) -> dict:
        """The trial phases' costs (see :func:`_build_try_bases`) and
        the verify's: the pair tests its pruned K1 launches made (9
        float32 operations each, csrc/lcp.cu) and each launch's inputs
        read once (the transforms, the queries, P as float4 points and
        int32 keys) and output written once, as chip_smoke.py's K1
        bound counts them. The JAX package counts its brute force
        there (8 operations per candidate, query and P point)."""
        costs = dict(try_bases.phase_costs(np_, device))
        fl = by = 0.0
        for g, c, nq_, np_s, tests in verify_stages:
            fl += PAIR_TEST_OPS * tests
            by += 4.0 * g * (16 * c + 3 * nq_ + 5 * np_s + c * nq_)
        costs["verify"] = dict(flops=fl, hbm_bytes=by)
        return costs

    step.draw = draw
    step.run = run
    step.index_keys = index_keys
    step.cost_model = cost_model
    return step, (k_pairs, k_quads, n_cands)


#: the stats counters of a step's telemetry (:func:`telemetry_row`)
_TELEMETRY = ("pairs_overflow", "quads_overflow", "cell_dropped",
              "q_sampled_out", "n_congruent", "cands_overflow", "n_pairs")


def telemetry_row(out, k_quads: int) -> tuple:
    """One pair's telemetry of a step, the counters of ``_TELEMETRY`` in
    order, from its outputs ``out`` on the host. The overflow counters
    are DROPPED-ITEM counts; ``n_pairs`` is the exact pre-cap pair count
    of both base edges."""
    counts = out["pair_counts"]
    return (counts[:, 4].sum(),
            (counts[:, 2] - k_quads).clip(min=0).sum(),
            counts[:, 3].sum(), counts[:, 5].sum(),
            out["n_congruent"], out["cands_dropped"],
            counts[:, :2].sum())


_STATE_KEYS = ("trial", "best_lcp", "transform", "qcentroid1",
               "qcentroid2", "base_ids", "congruent_ids")


def state_from_jax(state: dict) -> dict:
    """Check and convert a RANSAC state written by ``export_state`` of
    either package (plain numbers and nested lists, JSON-safe) into the
    port's form: numpy float32 transform/centroids, int64 ids."""
    missing = [k for k in _STATE_KEYS if k not in state]
    if missing:
        raise ValueError(f"resume state lacks {missing}")
    out = {
        "trial": int(state["trial"]),
        "best_lcp": float(state["best_lcp"]),
        "best_rank": float(state.get("best_rank", -np.inf)),
        "transform": np.asarray(state["transform"], np.float32),
        "qcentroid1": np.asarray(state["qcentroid1"], np.float32),
        "qcentroid2": np.asarray(state["qcentroid2"], np.float32),
        "base_ids": np.asarray(state["base_ids"], np.int64),
        "congruent_ids": np.asarray(state["congruent_ids"], np.int64),
    }
    for k in ("search_sf", "budget_mult", "initial_lcp"):
        if k in state:
            out[k] = state[k]
    shapes = dict(transform=(4, 4), qcentroid1=(3,), qcentroid2=(3,),
                  base_ids=(4,), congruent_ids=(4,))
    for k, shape in shapes.items():
        if out[k].shape != shape:
            raise ValueError(f"resume state {k!r} must have shape {shape}, "
                             f"got {out[k].shape}")
    return out


class Match4PCSBase:
    """Shared driver. Subclasses fix the congruent-join mode."""

    #: cosine cone tolerance; subclass sets (<0 disables = 4PCS mode)
    _cone_mode = -1.0

    def __init__(self, options: Options, logger: Optional[Logger] = None,
                 device="cuda", mesh=None):
        """``device``: where the device arrays live and the kernels run
        ("cuda" by default; "cpu" runs the kernels' plain versions).

        ``mesh``: a mesh of this process's devices
        (``parallel.make_mesh``); each device step then shards its bases
        over it (see parallel/sharded.py; bases_per_step must divide
        evenly), and the mesh's first device takes ``device``'s place:
        it draws the steps and runs the initial verify and the refine. A
        mesh across processes (``parallel.distributed.global_mesh``)
        carries ``register_batch``'s pairs axis, not a matcher's
        bases."""
        if mesh is not None:
            if mesh.group is not None:
                raise ValueError(
                    "a matcher shards its bases over the devices of one "
                    "process; a mesh across processes carries "
                    "register_batch's pairs axis")
            if (options.bases_per_step is not None
                    and options.bases_per_step % mesh.size != 0):
                raise ValueError(
                    f"bases_per_step ({options.bases_per_step}) must be "
                    f"divisible by the mesh size ({mesh.size})")
            device = mesh.devices[0]
        self.options = options
        self.logger = logger or Logger(LogLevel.NoLog)
        self.device = torch.device(device)
        self._mesh = mesh
        self._b_eff = options.bases_per_step
        #: the run's captured step (card, unsharded) and the lease of its
        #: memory pool (utils/graphs.py)
        self._graph = self._lease = None

    # ------------------------------------------------------------------
    # public API (mirrors ComputeTransformation, ref:hpp:61-86)
    # ------------------------------------------------------------------

    def compute_transformation(
        self, P: PointCloud, Q: PointCloud,
        visitor=None, resume_state: Optional[dict] = None,
    ) -> RegistrationResult:
        """Run (or resume) the registration.

        ``resume_state``: a dict returned by :meth:`export_state` of this
        package or of the JAX package (converted by
        :func:`state_from_jax`) — the search continues from its trial
        counter and best-so-far (ref:match4pcsBase.hpp:236-258,
        h:131-161). A resumed run never takes the hierarchical scale
        branch; a similarity state (linear part ``s R``) resumes as is.

        ``stats["spans"]``: the registration's span table
        (``utils/profiling.py``): the host seconds of its stages
        ("setup" with "sample", "build", "warm" and "verify"; "search"
        with "step", "refine" and "escalate"; the final "refine";
        "finish"), the device seconds of its steps and refines on the
        card, and the verify indexes it built (``index_builds``).
        """
        visitor = visitor or DummyTransformVisitor()
        with profiling.call(self.device) as spans:
            try:
                res = self._register(P, Q, visitor, resume_state)
            finally:
                self._release_graphs()
        res.stats["spans"] = spans
        return res

    def _register(self, P: PointCloud, Q: PointCloud, visitor,
                  resume_state: Optional[dict]) -> RegistrationResult:
        if len(P) == 0 or len(Q) == 0:
            # degenerate inputs return kLargeNumber (ref:hpp:69-70)
            return RegistrationResult(
                score=K_LARGE_NUMBER, transform=np.eye(4, dtype=np.float32),
                transformed_q=None, n_trials=0, improved=False, stats={})
        opts = self.options
        if (opts.estimate_scale and opts.scale_hierarchical
                and resume_state is None
                and opts.sample_size > opts.scale_max_q):
            return self._compute_scale_hierarchical(P, Q, visitor)

        with torch.no_grad():
            with profiling.span("setup"):
                self._init(P, Q)
                if resume_state is not None:
                    self._import_state(state_from_jax(resume_state))
            if self._best_lcp != 1.0:
                with profiling.span("search"):
                    self._perform_steps(visitor)
            if self._refine_active() and self._best_lcp < 1.0:
                self._maybe_refine()

        with profiling.span("finish"):
            profiling.count("index_builds", self._index_builds())
            improved = self._best_lcp > self._initial_lcp
            if improved:
                global_mat = self._global_transform()
                transformed_q = self._q_original.transformed(global_mat)
                out_mat = global_mat
            else:
                transformed_q = self._q_original
                out_mat = np.eye(4, dtype=np.float32)

            return RegistrationResult(
                score=float(self._best_lcp),
                transform=np.asarray(out_mat, dtype=np.float32),
                transformed_q=transformed_q,
                n_trials=self._trial,
                improved=improved,
                stats=dict(self._stats),
            )

    def _compute_scale_hierarchical(self, P: PointCloud, Q: PointCloud,
                                    visitor) -> RegistrationResult:
        """Two-phase similarity registration above ``scale_max_q``
        samples (see Options.scale_hierarchical):

        1. coarse: a similarity solve at ``scale_max_q`` samples with
           40% of the time budget gives the scale ``s``, the cube root
           of |det| of its linear part;
        2. fine: a rigid solve at full resolution on ``s * Q`` (the
           distance-banded engines, the capture kernel above nq = 2048)
           with the remaining budget.

        Returns ``M = T_fine @ diag(s, s, s, 1)``; the coarse result
        when either phase finds nothing better than the identity
        (``stats["scale_hierarchical"]`` says which). The visitor sees
        the coarse phase's progress in [0, 0.5] and the fine phase's in
        [0.5, 1], in the original Q's frame when it asks for the global
        transform.
        """
        opts = self.options
        needs_global = visitor_needs_global(visitor)
        coarse_opts = opts.replace(
            sample_size=opts.scale_max_q,
            max_time_seconds=max(opts.max_time_seconds * 0.4, 1.0))

        def coarse_visitor(fraction, lcp, transform):
            visitor(fraction if fraction < 0 else 0.5 * min(fraction, 1.0),
                    lcp, transform)

        coarse_visitor.needs_global_transformation = lambda: needs_global
        with profiling.span("coarse") as coarse_span:
            coarse = type(self)(coarse_opts, self.logger,
                                device=self.device, mesh=self._mesh) \
                .compute_transformation(P, Q, visitor=coarse_visitor)
        coarse_s = coarse_span.seconds
        if not coarse.improved:
            coarse.stats["scale_hierarchical"] = "coarse_failed"
            return coarse
        # columns of s R all have norm s; the determinant's cube root
        # does not depend on the rotation
        s = float(abs(np.linalg.det(
            np.asarray(coarse.transform)[:3, :3]))) ** (1.0 / 3.0)

        q2 = PointCloud(pos=np.asarray(Q.pos, np.float32) * np.float32(s),
                        normal=Q.normal, rgb=Q.rgb)
        fine_opts = opts.replace(
            estimate_scale=False,
            max_time_seconds=max(opts.max_time_seconds - coarse_s, 1.0))
        scale_mat = np.diag([s, s, s, 1.0]).astype(np.float32)

        def fine_visitor(fraction, lcp, transform):
            t = (np.asarray(transform) @ scale_mat if needs_global
                 else transform)
            visitor(fraction if fraction < 0
                    else 0.5 + 0.5 * min(fraction, 1.0), lcp, t)

        fine_visitor.needs_global_transformation = lambda: needs_global
        with profiling.span("fine"):
            fine = type(self)(fine_opts, self.logger, device=self.device,
                              mesh=self._mesh) \
                .compute_transformation(P, q2, visitor=fine_visitor)

        stats = dict(fine.stats)
        stats["hierarchical_scale"] = s
        stats["coarse_search_seconds"] = coarse.stats.get(
            "search_seconds", coarse_s)
        stats["coarse_lcp"] = coarse.score
        stats["coarse_trials"] = coarse.n_trials
        if not fine.improved:
            coarse.stats.update(stats)
            coarse.stats["scale_hierarchical"] = "fine_failed"
            return coarse
        mat = np.asarray(fine.transform, np.float32) @ scale_mat
        return RegistrationResult(
            score=fine.score, transform=mat,
            transformed_q=Q.transformed(mat),
            n_trials=coarse.n_trials + fine.n_trials,
            improved=True, stats=stats)

    # accessors mirroring getFirstSampled/getSecondSampled
    # (ref:match4pcsBase.h:88-94) — in original (uncentered) coordinates.
    def get_first_sampled(self) -> PointCloud:
        return self._sampled_p_world

    def get_second_sampled(self) -> PointCloud:
        return self._sampled_q_world

    # ------------------------------------------------------------------
    # init (mirrors ref:hpp:90-203)
    # ------------------------------------------------------------------

    def _init(self, P: PointCloud, Q: PointCloud):
        opts = self.options
        # sampling, the kd order, centering, the diameter, the trial
        # estimate and the upload
        with profiling.span("sample"):
            rng = np.random.default_rng(opts.random_seed)
            self._q_original = Q
            self._b_eff = opts.bases_per_step

            if len(P) <= opts.sample_size:
                self.logger.error("(P) More samples requested than "
                                  "available: use whole cloud")
            sampled_p = sampling.sample_for_matching(
                P, opts.delta, opts.sample_size, truncate=False, rng=rng)
            if opts.p_sample_budget:
                # pin the P shape (see Options.p_sample_budget)
                n_p = len(sampled_p)
                if n_p > opts.p_sample_budget:
                    keep = rng.permutation(n_p)[:opts.p_sample_budget]
                else:
                    keep = np.resize(np.arange(n_p), opts.p_sample_budget)
                sampled_p = sampled_p.take(keep)
            if len(Q) <= opts.sample_size:
                self.logger.error("(Q) More samples requested than "
                                  "available: use whole cloud")
            q_target = opts.sample_size
            scale_q_capped = 0
            if opts.estimate_scale and q_target > opts.scale_max_q:
                # similarity mode's pair space is nq^2: Q is cut to the
                # ceiling (see Options.scale_max_q)
                scale_q_capped = q_target - opts.scale_max_q
                q_target = opts.scale_max_q
                self.logger.error(
                    "estimate_scale: Q sample capped to ", q_target,
                    " (scale_max_q; see Options)")
            sampled_q = sampling.sample_for_matching(
                Q, opts.delta, q_target, truncate=True, rng=rng)
            # spatially order the Q samples (kd median-split blocks): a
            # fixed permutation is semantically transparent, and it makes
            # the capture kernel's 256- and 512-point tiles compact, which
            # its tile-pair rejection needs. Not in similarity mode, whose
            # engines have no tile rejection: there the order would only
            # reshuffle the trials (the JAX package's rule)
            if not opts.estimate_scale:
                sampled_q = sampled_q.take(
                    sampling.kd_argsort(sampled_q.pos))
            self._sampled_p_world = sampled_p
            self._sampled_q_world = sampled_q

            # center on centroids (ref:hpp:141-149)
            self._centroid_p = sampled_p.pos.mean(axis=0)
            self._centroid_q = sampled_q.pos.mean(axis=0)
            p_pos = sampled_p.pos - self._centroid_p
            q_pos = sampled_q.pos - self._centroid_q

            # randomized diameter — drawn from the *Q* samples, as the
            # reference does (ref:hpp:156-163)
            self._p_diameter = geometry.estimate_diameter(
                q_pos, K_NUMBER_OF_DIAMETER_TRIALS, rng)
            self._max_base_diameter = self._p_diameter  # ref:hpp:172

            # trial-count estimate (ref:hpp:175-185)
            overlap = opts.overlap_estimation
            denom = math.log(max(1.0 - overlap ** _K_MIN_TRIALS, 1e-300))
            first_estimation = (math.log(_K_SMALL_ERROR) / denom
                                if denom != 0.0 else 0.0)
            if self._max_base_diameter > 0:
                n_trials = int(first_estimation
                               * (self._p_diameter / _K_DIAMETER_FRACTION)
                               / self._max_base_diameter)
            else:
                n_trials = 0
            self.number_of_trials = max(n_trials, _K_MIN_TRIALS)
            #: trial-budget multiplier — +1 per escalation
            self._budget_mult = 1
            #: escalation rungs climbed (Options.search_escalation_stages)
            self._esc_stage = 0
            #: live search factor (escalation raises it mid-run)
            self._search_sf = opts.search_delta_factor

            self.logger.verbose("norm_max_dist: ", opts.delta)

            dev = self.device

            def put(a):
                return torch.as_tensor(np.asarray(a, np.float32),
                                       device=dev)

            self._d_p_pos = put(p_pos)
            self._d_p_norm = put(sampled_p.normals_or_zero())
            self._d_p_rgb = put(sampled_p.rgb_or_invalid())
            self._d_q_pos = put(q_pos)
            self._d_q_norm = put(sampled_q.normals_or_zero())
            self._d_q_rgb = put(sampled_q.rgb_or_invalid())

        self._trial = 0
        # *_overflow / *_dropped are exact dropped-ITEM counts across
        # the run (pairs, quads, candidates lost to static buffer caps)
        self._stats = {
            "pairs_overflow": 0, "quads_overflow": 0,
            "cands_overflow": 0, "n_congruent": 0, "cell_dropped": 0,
            "q_sampled_out": 0, "n_pairs": 0,
            # steps enqueued and dropped unread at a stop or escalation
            "steps_abandoned": 0,
        }
        if scale_q_capped:
            self._stats["scale_q_capped"] = scale_q_capped

        # best-so-far state (ref:match4pcsBase.h:131-161)
        self._best_rank = -np.inf       # coarse-search rank metric
        self._transform = np.eye(4, dtype=np.float32)
        self._qcentroid1 = np.zeros(3, dtype=np.float32)
        self._qcentroid2 = np.zeros(3, dtype=np.float32)
        self._base_ids = np.zeros(4, dtype=np.int64)
        self._congruent_ids = np.zeros(4, dtype=np.int64)

        # the band index, the step, the run's state on every mesh device,
        # the CUDA kernels of this engine, and one step and one refine
        # whose outputs are thrown away, before any timed phase: the
        # analog of the JAX package's off-clock compile (the CUDA
        # libraries' first calls and the verify's cell indexes)
        with profiling.span("build") as build:
            # P's cell indexes of the verify, built once per run and
            # radius
            self._p_index = lcp.VerifyIndex(self._d_p_pos)
            engine = resolve_pair_engine(self._opts_eff(), len(sampled_q))
            rowcap = uses_capture_kernel(self._opts_eff(), engine)
            layout = engine == "rowcap" and not rowcap
            # the banded engine's once-per-run sorted cell-pair table over
            # the centered Q samples (ops/band_extract.py)
            self._band_index = idx = None
            if engine == "banded":
                self._band_index = idx = build_band_index(
                    q_pos, opts.delta, cell_budget=opts.band_cell_budget,
                    device=dev)
                self._stats.update(band_cells=idx.m,
                                   band_cell_size=float(idx.g),
                                   band_member_dropped=idx.member_dropped)
            # the Q bounds of the capture's rejection: Q is fixed for the
            # run, so they are computed once
            self._q_bounds = capture_bounds(self._opts_eff(), engine,
                                            self._d_q_pos[None])
            self._replicas = {}
            self._build_step()
            self._gen = torch.Generator(device=dev)
        with profiling.span("warm") as warm:
            if dev.type == "cuda":
                lcp_kernel._lib()
                if rowcap:
                    rowcap_kernel._lib()
                if layout:
                    rowcap_layout_kernel._lib()
                self._warm()
        self._stats["compile_seconds"] = build.seconds + warm.seconds

        # initial verification of the identity transform (ref:hpp:201)
        with profiling.span("verify") as verify:
            self._best_lcp = float(lcp.lcp_score_single(
                torch.eye(4, dtype=torch.float32, device=dev),
                self._d_q_pos, self._d_p_pos, opts.delta,
                self._p_index.get(1, opts.delta)))
        self._stats["initial_verify_seconds"] = verify.seconds
        self._initial_lcp = self._best_lcp
        self.logger.verbose("Initial LCP: ", self._best_lcp)

    def _warm(self):
        """On the card: ready the run's step off the clock, touching no
        best-so-far, counter, trial count or visitor call (each step
        reseeds the generator, so the run's draws do not move).

        Warm once per process, not once per call (utils/graphs.py). The
        first warm of its kind (:func:`warm_kind`) on the device in this
        process, and every warm over a mesh: one step (on every mesh
        device) and (with refine on) one refine of the current
        transform, their outputs thrown away, and, unsharded, the
        capture of the step after an eager run on the capture stream,
        and one replay (:meth:`_capture`); a counter ``warm_full`` in the
        span table. A later warm of that kind builds the verify indexes
        that the step and the refine read and captures alone; a counter
        ``warm_reused``. The graph's pool is the device's, lent until the
        registration ends (:meth:`_release_graphs`)."""
        if self.device.type != "cuda":
            return
        ctx = None
        if self._mesh is None:
            ctx = graphs.context(self.device)
            opts = self._opts_eff()
            kind = warm_kind(
                opts, resolve_pair_engine(opts, int(self._d_q_pos.shape[0])),
                refine=self._refine_active())
            if kind in ctx.warmed:
                profiling.count("warm_reused", 1)
                np_ = int(self._d_p_pos.shape[0])
                for key in self._step_fn.index_keys(np_):
                    self._p_index.get(*key)
                if self._refine_active():
                    self._p_index.get(1, opts.delta)
                    self._refine_index()
                self._capture(prerun=False)
                torch.cuda.synchronize(self.device)
                return
        profiling.count("warm_full", 1)
        self._run_step(-1)
        if ctx is not None:
            self._capture()
            self._run_step(-1)
        if self._refine_active():
            self._refine(self._transform)
        for dev in (self._mesh.devices if self._mesh else (self.device,)):
            torch.cuda.synchronize(dev)
        if ctx is not None:
            ctx.warmed.add(kind)

    def _capture(self, prerun: bool = True):
        """Capture this run's step, as ``step.run`` runs it on the
        step's draws, into a CUDA graph (utils/graphs.py), in the pool
        the run leases from the device's capture context; and the pinned
        host copies that two steps in flight read through. ``prerun``:
        run it eagerly on the capture stream first (``StepGraph``)."""
        dev = self.device
        diam = self._max_base_diameter
        args = self._step_args()
        run = self._step_fn.run
        if self._lease is None:
            self._lease = graphs.context(dev).lease()
        pool = self._lease
        with profiling.span("capture"):
            self._graph = StepGraph(lambda *draws: run(draws, diam, *args),
                                    self._draws(-1), device=dev, pool=pool,
                                    prerun=prerun)
        self._step_host = HostCopies(
            {k: v[0] for k, v in self._graph.outputs.items()}, dev)

    def _release_graphs(self):
        """Drop the run's graph and its lease of its pool, which goes
        back to the device's free list once no graph captured into it is
        left: at an escalation's rebuild, and at the end of the
        registration (the final refine and ``finish`` replay nothing)."""
        if self._graph is not None:
            # a replay of the old graph may still run: let it end before
            # its memory goes back to the pool
            torch.cuda.synchronize(self.device)
        self._graph = self._lease = None

    # ------------------------------------------------------------------
    # device step: B complete RANSAC trials + batched verify
    # ------------------------------------------------------------------

    @property
    def _trial_budget(self) -> int:
        return self.number_of_trials * self._budget_mult

    def _opts_eff(self) -> Options:
        """Options with the LIVE search factor (see _escalate) and the
        resolved bases_per_step."""
        if (self._search_sf == self.options.search_delta_factor
                and self._b_eff == self.options.bases_per_step):
            return self.options
        return self.options.replace(search_delta_factor=self._search_sf,
                                    bases_per_step=self._b_eff)

    def _build_step(self):
        nq = int(self._d_q_pos.shape[0])
        mesh = self._mesh
        if self._b_eff is None:
            self._b_eff = resolve_bases_per_step(
                self.options, nq, mesh.size if mesh is not None else 1)
        opts = self._opts_eff()
        self._release_graphs()
        self._step_fn, caps = build_step(opts, nq, self._cone_mode,
                                         self._band_index)
        self._k_pairs, self._k_quads, self._n_cands = caps
        if mesh is None:
            return
        from .parallel.sharded import sharded_step
        # one step per mesh device, over that device's replica (its
        # band index)
        steps = {}
        for dev in dict.fromkeys(mesh.devices):
            args, band = self._replica(dev)
            steps[dev] = (self._step_fn if dev == self.device else
                          build_step(opts, nq, self._cone_mode, band)[0],
                          args)

        def shard(draws, dev):
            step, args = steps[dev]
            out = step.run(tuple(d[None] for d in draws),
                           self._max_base_diameter, *args)
            return {k: v[0] for k, v in out.items()}

        self._sharded = sharded_step(
            shard, mesh, gather_telemetry=opts.sharded_gather_telemetry)

    def _replica(self, dev):
        """This run's clouds and indexes on mesh device ``dev``, made at
        its first use and kept for the run: (the step's arguments after
        ``diam``, the band index)."""
        rep = self._replicas.get(dev)
        if rep is None:
            if dev == self.device:
                rep = (self._step_args(), self._band_index)
            else:
                arrs = [a.to(dev)[None] for a in (
                    self._d_p_pos, self._d_p_norm, self._d_p_rgb,
                    self._d_q_pos, self._d_q_norm, self._d_q_rgb)]
                bounds = capture_bounds(
                    self._opts_eff(),
                    resolve_pair_engine(self._opts_eff(), arrs[3].shape[1]),
                    arrs[3])
                rep = ((*arrs, bounds, lcp.VerifyIndex(arrs[0])),
                       None if self._band_index is None
                       else self._band_index.to(dev))
            self._replicas[dev] = rep
        return rep

    def _step_args(self):
        """The step's cloud arguments: this run's one pair (G = 1)."""
        return (self._d_p_pos[None], self._d_p_norm[None],
                self._d_p_rgb[None], self._d_q_pos[None],
                self._d_q_norm[None], self._d_q_rgb[None], self._q_bounds,
                self._p_index)

    def _draws(self, step_idx: int):
        """Step ``step_idx``'s draws, on the generator reseeded for it."""
        self._gen.manual_seed(_step_seed(self.options.random_seed,
                                         step_idx))
        return self._step_fn.draw(self._gen, 1, int(self._d_p_pos.shape[0]))

    def _launch_step(self, step_idx: int, eager: bool = False):
        """Enqueue device step ``step_idx``; :meth:`_fetch_step` turns
        the returned handle into the step's outputs on the host. On the
        card (unsharded) the step is a replay of the run's captured
        graph, its outputs copied into one of two pinned host buffers
        behind an event, so the host can enqueue the next step before it
        reads this one. On the CPU, over a mesh (its draws drawn once,
        on the mesh's first device, each device running its slice of the
        bases) and with ``eager`` the handle runs the step when it is
        fetched: no device runs ahead of the host there, and a step
        abandoned unfetched costs nothing.

        Each step that runs is a span "step" (utils/profiling.py), a
        device span but over a mesh."""
        if self._mesh is not None:
            sharded, draws = self._sharded, self._draws(step_idx)

            def run_sharded():
                with profiling.span("step"):
                    return sharded(tuple(d[0] for d in draws))
            return run_sharded
        if self._graph is None or eager:
            step, args = self._step_fn, self._step_args()
            draws = self._draws(step_idx)

            def run():
                with step_span(self.device):
                    out = step.run(draws, self._max_base_diameter, *args)
                    return {k: v[0].cpu().numpy() for k, v in out.items()}
            return run
        with step_span(self.device):
            out = self._graph(*self._draws(step_idx))
            return self._step_host.put({k: v[0] for k, v in out.items()})

    @staticmethod
    def _fetch_step(handle) -> dict:
        return handle() if callable(handle) else HostCopies.get(handle)

    def _run_step(self, step_idx: int, eager: bool = False) -> dict:
        """One device step, its outputs fetched to the host (see
        :meth:`_launch_step`)."""
        return self._fetch_step(self._launch_step(step_idx, eager))

    # ------------------------------------------------------------------
    # host anytime loop (mirrors Perform_N_steps, ref:hpp:208-274)
    # ------------------------------------------------------------------

    def _perform_steps(self, visitor, inflight: int = 2):
        """The anytime search. ``inflight``: the steps the per-step loop
        keeps enqueued, the one the host reads and the next (1 runs the
        loop unpipelined)."""
        opts = self.options
        needs_global = visitor_needs_global(visitor)
        b = self._b_eff

        visitor(0.0, self._best_lcp,
                self._visitor_transform(needs_global))
        self._esc_enabled = (self._esc_next_factor() > self._search_sf
                             and self._refine_active())
        if opts.phase_timing:
            with profiling.span("phases"):
                self._measure_phases()

        t0 = time.perf_counter()
        step_idx = self._trial // b   # continue the stream on resume
        # Predictive deadline guard: an EMA of step latency; no step is
        # enqueued once the remaining budget cannot fit it.
        step_ema = 0.0
        t_last = time.perf_counter()

        def budget_left(extra):
            return (time.perf_counter() - t0 + extra * step_ema
                    <= 0.99 * opts.max_time_seconds)

        def counted(ahead):
            # whether a step enqueued ``ahead`` steps past the one read
            # next can still count: the trial estimate stops (or
            # escalates) the search before it otherwise. The step read
            # next always counts (a fresh escalation runs one at least)
            t = self._trial + ahead * b
            return ahead == 0 or opts.use_full_time_budget or not (
                t / self._trial_budget >= 0.99 or t > self._trial_budget)

        # Two steps in flight: the next step is enqueued before this
        # one's outputs are read, so the card runs it while the host
        # reads, adopts, refines and calls the visitor. A stop on the
        # threshold or the clock abandons the step in flight: it is
        # neither counted nor adopted.
        queue = collections.deque()
        while True:
            # each enqueued step must fit, after the ones before it
            while (len(queue) < inflight and counted(len(queue))
                   and budget_left(len(queue) + 1.0)):
                queue.append(self._launch_step(step_idx + len(queue)))
            if not queue:
                break        # the deadline guard: no step fits
            out = self._fetch_step(queue.popleft())
            now = time.perf_counter()
            step_ema = (now - t_last if step_ema == 0.0
                        else 0.5 * step_ema + 0.5 * (now - t_last))
            t_last = now
            step_lcp = float(out["lcp"])
            step_idx += 1
            if torch.is_tensor(out["pair_counts"]):
                # a sharded step's lazily gathered table (see
                # Options.sharded_gather_telemetry)
                out["pair_counts"] = out["pair_counts"].cpu().numpy()
            self._count(telemetry_row(out, self._k_quads))

            step_rank = float(out["rank_lcp"])
            if step_lcp > self._best_lcp:
                self._best_lcp = step_lcp
                self._transform = out["transform"]
                self._qcentroid1 = out["qcentroid1"]
                self._qcentroid2 = out["qcentroid2"]
                self._base_ids = out["base_ids"]
                self._congruent_ids = out["congruent_ids"]
                # improvement callback (ref:hpp:458-465, fraction = -1)
                visitor(-1.0, self._best_lcp,
                        self._visitor_transform(needs_global))
                # in-loop guarded refinement of each new best
                if self._refine_active() and self._best_lcp < 1.0:
                    before = self._best_lcp
                    self._maybe_refine()
                    if self._best_lcp > before:
                        visitor(-1.0, self._best_lcp,
                                self._visitor_transform(needs_global))
            elif (step_rank > self._best_rank and step_rank >= 0
                  and self._search_sf != 1.0
                  and self._refine_active() and self._best_lcp < 1.0):
                # coarse-search mode: a rank improvement whose exact
                # score did not win gets the guarded refine
                before = self._best_lcp
                self._refine_candidate(out)
                if self._best_lcp > before:
                    visitor(-1.0, self._best_lcp,
                            self._visitor_transform(needs_global))
            self._best_rank = max(self._best_rank, step_rank)

            decision = self._progress(visitor, needs_global, t0)
            if decision == "stop":
                break
            if decision == "escalate":
                # a step in flight (use_full_time_budget enqueues past
                # the estimate) ran at the old factor: its draws run
                # again at the new one
                self._stats["steps_abandoned"] += len(queue)
                queue.clear()
                warm = self._escalate()
                t0 += warm
                t_last += warm
                # escalated steps are slower; the EMA re-learns
                step_ema *= 3.0
        self._stats["steps_abandoned"] += len(queue)

        # search time (the reference's totalTime analog,
        # ref:match4pcsBase.hpp:77-83)
        self._stats["search_seconds"] = time.perf_counter() - t0

    def _count(self, row):
        """Count one step of this run and its telemetry ``row``
        (:func:`telemetry_row`)."""
        self._trial += self._b_eff
        for key, v in zip(_TELEMETRY, row):
            self._stats[key] += int(v)

    def _progress(self, visitor, needs_global, t0):
        """After a step: the progress callback, then the stop rules
        (ref:hpp:255). Returns "stop", "escalate" (the trial estimate ran
        out below the threshold and the search escalates: configured,
        and more than 5% of the wall budget left) or None (go on; when
        the estimate ran out, only under use_full_time_budget)."""
        opts = self.options
        fraction_try = self._trial / self._trial_budget
        fraction_time = (time.perf_counter() - t0) / opts.max_time_seconds
        fraction = (fraction_time if opts.use_full_time_budget
                    else max(fraction_time, fraction_try))
        visitor(min(fraction, 1.0), self._best_lcp,
                self._visitor_transform(needs_global))
        if (self._best_lcp > opts.terminate_threshold
                or fraction_time >= 0.99 or self._best_lcp == 1.0):
            return "stop"
        if fraction_try >= 0.99 or self._trial > self._trial_budget:
            remaining = opts.max_time_seconds * (1.0 - fraction_time)
            if (self._esc_enabled
                    and remaining > 0.05 * opts.max_time_seconds):
                return "escalate"
            if not opts.use_full_time_budget:
                return "stop"
        return None

    def _esc_next_factor(self) -> float:
        """The next escalation rung's search factor
        (``search_escalation_factor ** (stage + 1)``), 0 when none."""
        opts = self.options
        if self._esc_stage >= opts.search_escalation_stages:
            return 0.0
        if self._esc_stage >= 1 and int(self._d_q_pos.shape[0]) > 16384:
            # rung >= 2 above nq = 16384 turns the 128-slot capture
            # almost pure drop — not a usable recourse at that scale
            return 0.0
        return float(opts.search_escalation_factor
                     ** (self._esc_stage + 1))

    def _escalate(self) -> float:
        """Rebuild the step at the next rung's search factor and extend
        the trial budget by another estimate. On the card the new step
        is warmed as in ``_init`` (its rank radius has its own verify
        index); returns the seconds of that warm-up, which the anytime
        clock leaves out."""
        esc = self._esc_next_factor()
        self.logger.verbose("Trial estimate exhausted at LCP ",
                            self._best_lcp,
                            "; escalating search_delta_factor to ", esc)
        with profiling.span("escalate") as span:
            self._search_sf = esc
            self._esc_stage += 1
            self._esc_enabled = (self._esc_next_factor() > self._search_sf
                                 and self._refine_active())
            self._build_step()
            tw = time.perf_counter()
            self._warm()
            warm = time.perf_counter() - tw
            self._budget_mult += 1
        self._stats["escalation_compile_seconds"] = span.seconds
        self._stats["escalated_to"] = esc
        return warm

    def _measure_phases(self, repeats: int = 5):
        """The phases of a warm step (``stats["phase_seconds"]``: the
        JAX package's keys select_extract, join, fit, verify and
        step_total), logged as the reference-style timing table, and
        their roofline against the step's cost model
        (``stats["phase_roofline"]``, utils/roofline.py).

        The phases are marked in one step (utils/profiling.PhaseMarks:
        CUDA events on the card, the wall clock on the CPU) on the
        matcher's device, over all of the step's bases; ``step_total``
        is the wall time of one unmarked step, launched op by op as the
        marked ones are (the search replays the step's captured graph
        on the card; sharded with a mesh), from the draws to the fetched
        outputs.
        ``repeats`` marked and unmarked steps run in turns, each pair
        on its own draws (step indexes 2^20 + i, off the search's
        stream); the phases are the marked step of median span, the
        total the median wall, so that one slow step (a pause of the
        host) moves neither. All of it runs before the anytime
        clock."""
        from .utils import roofline
        from .utils.profiling import PhaseMarks
        from .utils.timer import PhaseTimers

        def marked(i, stages=None):
            self._gen.manual_seed(_step_seed(self.options.random_seed,
                                             (1 << 20) + i))
            marks = PhaseMarks(self.device)
            self._step_fn(self._gen, self._max_base_diameter,
                          *self._step_args(), marks=marks, stages=stages)
            return marks.seconds()

        stages = []
        marked(0, stages)          # warm, and the verify's launches
        runs, walls = [], []
        for i in range(1, repeats + 1):
            runs.append(marked(i))
            t0 = time.perf_counter()
            self._run_step((1 << 20) + i, eager=True)
            walls.append(time.perf_counter() - t0)
        phases = sorted(runs, key=lambda p: sum(p.values()))[repeats // 2]
        total = float(np.median(walls))
        timers = PhaseTimers()
        for name in ("select_extract", "join", "fit", "verify"):
            timers.add(name, phases.get(name, 0.0))
        timers.add("step_total", total)
        self._stats["phase_seconds"] = dict(timers.phases)
        self.logger.verbose(timers.table())
        costs = self._step_fn.cost_model(int(self._d_p_pos.shape[0]),
                                         lcp.stage_tests(stages),
                                         self.device)
        roof = roofline.attribute(costs, dict(timers.phases))
        self._stats["phase_roofline"] = roof
        self.logger.verbose(roofline.table(roof))

    # ------------------------------------------------------------------

    def _refine(self, cur: np.ndarray):
        """Trimmed-ICP refine of ``cur`` at the live search factor, and
        the exact LCP of both, in a device span "refine". Returns
        (refined (4, 4), scores (2,))."""
        dev = self.device
        with profiling.span("refine", dev):
            cur_t = torch.as_tensor(np.asarray(cur, np.float32), device=dev)
            refined = refine.refine_transform(
                cur_t, self._d_q_pos, self._d_p_pos, self.options.delta,
                iters=self.options.refine_iterations,
                start_factor=self._search_sf,
                estimate_scale=self.options.estimate_scale,
                index=(self._refine_index() if refine.walks(dev)
                       else None))
            scores = lcp.lcp_scores(
                torch.stack([cur_t, refined]), self._d_q_pos,
                self._d_p_pos, self.options.delta,
                self._p_index.get(1, self.options.delta))
            return refined.cpu().numpy(), scores.cpu().numpy()

    def _refine_active(self) -> bool:
        return self.options.refine_iterations > 0

    def _refine_index(self):
        """P's cell index at the refine's trim radius for the live search
        factor (``refine.trim_radius``), built once per run and radius;
        read by the refine's walk on the card alone (``refine.walks``)."""
        return self._p_index.get(1, refine.trim_radius(
            self.options.delta, self.options.refine_iterations,
            self._search_sf)).part(0)

    def _refine_candidate(self, out):
        """Guarded refine of a step's selected candidate that did NOT
        beat the exact best (coarse-search rank path): adopted, with
        this step's base/congruent bookkeeping, only if its exact-delta
        LCP wins."""
        refined, scores = self._refine(out["transform"])
        self._stats["refined_lcp"] = float(scores[1])
        if scores[1] > self._best_lcp:
            self._best_lcp = float(scores[1])
            self._transform = refined
            self._qcentroid1 = refined[:3, 3].copy()
            self._qcentroid2 = np.zeros(3, np.float32)
            self._base_ids = out["base_ids"]
            self._congruent_ids = out["congruent_ids"]

    def _maybe_refine(self):
        """Trimmed-ICP polish of the best transform (ops/refine.py),
        kept only when the exact LCP improves. The transform maps
        centered Q to centered P, so refinement runs in those frames;
        the refined translation is carried in qcentroid1."""
        refined, scores = self._refine(self._transform)
        self._stats["refined_lcp"] = float(scores[1])
        if scores[1] > self._best_lcp:
            self._best_lcp = float(scores[1])
            self._transform = refined
            self._qcentroid1 = refined[:3, 3].copy()
            self._qcentroid2 = np.zeros(3, np.float32)

    def _index_builds(self) -> int:
        """The verify indexes this run built, on every mesh device."""
        indexes = {self._p_index}
        indexes.update(args[-1] for args, _ in self._replicas.values())
        return sum(ix.builds for ix in indexes)

    def _global_transform(self) -> np.ndarray:
        """Recompose the centered-frame best transform into original
        coordinates (ref:hpp:224-229)."""
        out = np.array(self._transform, dtype=np.float32)
        rot = out[:3, :3]
        out[:3, 3] = (self._qcentroid1 + self._centroid_p
                      - rot @ (self._qcentroid2 + self._centroid_q))
        return out

    def _visitor_transform(self, needs_global: bool) -> np.ndarray:
        return (self._global_transform() if needs_global
                else np.array(self._transform))

    def export_state(self) -> dict:
        """Serializable RANSAC state (checkpoint/resume; the analog of
        ref:match4pcsBase.h:131-161), in the JAX package's format."""
        return {
            "trial": self._trial,
            "best_lcp": self._best_lcp,
            "best_rank": self._best_rank,
            "search_sf": self._search_sf,
            "budget_mult": self._budget_mult,
            "initial_lcp": self._initial_lcp,
            "transform": np.asarray(self._transform).tolist(),
            "qcentroid1": np.asarray(self._qcentroid1).tolist(),
            "qcentroid2": np.asarray(self._qcentroid2).tolist(),
            "base_ids": np.asarray(self._base_ids).tolist(),
            "congruent_ids": np.asarray(self._congruent_ids).tolist(),
        }

    def _import_state(self, state: dict):
        """Restore a state converted by :func:`state_from_jax`. The
        trial counter also resumes the per-step draw stream."""
        self._trial = state["trial"]
        self._best_lcp = state["best_lcp"]
        self._best_rank = state["best_rank"]
        self._budget_mult = int(state.get("budget_mult",
                                          self._budget_mult))
        # one budget extension per rung climbed
        self._esc_stage = self._budget_mult - 1
        sf = float(state.get("search_sf", self._search_sf))
        if sf != self._search_sf:
            # taken post-escalation: rebuild at its factor (and warm it,
            # off the clock)
            self._search_sf = sf
            self._build_step()
            with profiling.span("warm") as warm:
                self._warm()
            self._stats["compile_seconds"] += warm.seconds
        self._initial_lcp = float(state.get("initial_lcp",
                                            self._initial_lcp))
        self._transform = state["transform"]
        self._qcentroid1 = state["qcentroid1"]
        self._qcentroid2 = state["qcentroid2"]
        self._base_ids = state["base_ids"]
        self._congruent_ids = state["congruent_ids"]


class Match4PCS(Match4PCSBase):
    """Quadratic-mode matcher (ref:src/super4pcs/algorithms/4pcs.h:52):
    congruent join on invariant-point distance only."""
    _cone_mode = -1.0


class MatchSuper4PCS(Match4PCSBase):
    """Smart-indexing-mode matcher (ref:src/super4pcs/algorithms/
    super4pcs.h:56): adds the pair-direction cone filter to the join."""

    def __init__(self, options: Options, logger: Optional[Logger] = None,
                 device="cuda", mesh=None):
        super().__init__(options, logger, device=device, mesh=mesh)
        self._cone_mode = options.cone_cos_tolerance
