"""Registration options of the PyTorch port.

The port's own copy of ``super4pcs_tpu.options`` (it never imports the
JAX package): the same fields, defaults and validation, so an
``Options`` built for one package means the same search in the other;
the field docs say what each field does in the port. It is the
equivalent of the reference ``Match4PCSOptions``
(ref:src/super4pcs/shared4pcs.h:148-190). Library defaults match the
reference library layer (delta=5.0, overlap=0.2, n=200, t=60 s).

On top of the reference fields sit the static capacities (pair/quad
buffer caps, bases per device step). The port keeps the JAX package's
fixed-capacity buffers, so these mean the same here. Every field acts
as in the JAX package; ``pair_recall_target`` is met at any value (the
port's row-capped capture is exact, as the JAX package's is on the
CPU).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

# std::mt19937::default_seed — ref:src/super4pcs/shared4pcs.h:171
MT19937_DEFAULT_SEED = 5489


@dataclasses.dataclass(frozen=True)
class Options:
    # --- reference-visible parameters (ref:shared4pcs.h:148-190) ---
    #: LCP distance threshold; also the voxel size of the uniform sampler.
    delta: float = 5.0
    #: Maximum normal difference in degrees between paired points (<0: off).
    max_normal_difference: float = -1.0
    #: Maximum translation distance (<0: off).
    max_translation_distance: float = -1.0
    #: Maximum rotation angle in degrees (<0: off).
    max_angle: float = -1.0
    #: Maximum RGB color distance between corresponding vertices (<0: off).
    max_color_distance: float = -1.0
    #: Number of points sampled from Q (P keeps its full voxel-sampled set,
    #: mirroring ref:match4pcsBase.hpp:112-138).
    sample_size: int = 200
    #: Anytime budget in seconds (ref:shared4pcs.h:166-169).
    max_time_seconds: int = 60
    #: RNG seed (ref:shared4pcs.h:171).
    random_seed: int = MT19937_DEFAULT_SEED
    #: Estimate a similarity (scaled-rigid) transform instead of rigid —
    #: the reference's compile-time MULTISCALE mode (off by default
    #: there too): the pair distance filter is disabled and the fit
    #: estimates a per-candidate scale from the two segment ratios,
    #: rejecting candidates whose ratios deviate > 10%
    #: (ref:match4pcsBase.cc:390-414, 4pcs.cc:141-143); the refine fits
    #: a similarity (Umeyama). See scale_max_q, scale_hierarchical and
    #: pair_engine for the engines it runs.
    estimate_scale: bool = False

    # validated pair, set via configure_overlap (ref:shared4pcs.h:173-190)
    overlap_estimation: float = 0.2
    terminate_threshold: float = 1.0

    # --- execution shape parameters (no reference counterpart) ---
    #: Bases attempted per device step (the batched RANSAC width).
    #: ``None`` derives it from the sampled-Q size at matcher init: 16 at
    #: nq > 1024, else 64.
    bases_per_step: Optional[int] = None
    #: Static capacity of each per-base extracted-pair buffer. ``None``
    #: derives a capacity from the sampled-Q size at matcher init.
    max_pairs: Optional[int] = None
    #: Static capacity of the per-base congruent-quad buffer. ``None``
    #: derives it from the Q size. Candidates beyond capacity are
    #: dropped and counted in stats — the reference scores every
    #: congruent quad, so capacities must be generous, not minimal.
    max_quads: Optional[int] = None
    #: Cap on candidates LCP-scored per device step (a compaction
    #: budget; drops are counted in stats["cands_overflow"]). ``None``
    #: derives it from the Q size and ``verify_top_k``.
    max_candidates: Optional[int] = None
    #: Per-row slot target of the rowcap engine's capture (nq > 2048):
    #: on the capture kernel's route rounded up to whole per-segment
    #: quotas (kernels/rowcap.slots_for), on the XLA route the row's
    #: first hits in a rotated column order. ``None`` derives ~2.5 *
    #: max_pairs / nq. Hits beyond a row's slots are counted in
    #: stats["pairs_overflow"].
    pair_row_cap: Optional[int] = None
    #: Recall target of the XLA route's per-row capture (the JAX
    #: package's approx_max_k knob), in (0, 1]. The port's capture
    #: (K2x, kernels/rowcap_layout.py) is exact: recall 1 meets any
    #: target, as the JAX package's capture does on the CPU.
    pair_recall_target: float = 0.9
    #: Rowcap capture route: "auto" runs the band-capture kernel K2
    #: (kernels/rowcap.py: per-segment quotas, the fused join hash,
    #: tile rejection) and carries the auto rowcap range to nq = 65536;
    #: "xla" runs the JAX package's XLA route, each row's first hits in
    #: a rotated column order (K2x, kernels/rowcap_layout.py), with the
    #: auto rowcap range ending at nq = 32768. Similarity mode's rowcap
    #: engine always takes the XLA route.
    rowcap_kernel: str = "auto"
    #: Band rejection inside the capture kernels: K2's bounding-sphere
    #: test per 256-row x 512-column tile pair, K2x's test of each
    #: column against a warp's 32 rows (kernels/rowcap_layout.py),
    #: both against the distance band. The captured tables are
    #: identical either way; it only skips work, on the card (the CPU
    #: path never skips).
    rowcap_tile_reject: bool = True
    #: Cosine tolerance of the Super4PCS pair-direction cone filter. The
    #: reference realizes this filter as a 7^3-bin direction-grid cone
    #: rasterization (ref:accelerators/normalset.hpp:162-210); the bin
    #: resolution makes its effective tolerance ~2/7 in component space.
    cone_cos_tolerance: float = 0.30
    #: Number of random triangle draws when picking a wide base triangle
    #: (ref:match4pcsBase.h:79 kNumberOfDiameterTrials).
    n_triangle_trials: int = 1000
    #: Per-cell candidate cap of the grid-hash congruent join (overflow
    #: beyond the cap is counted in stats["cell_dropped"]).
    cell_candidates: int = 16
    #: Second-side pair budget of the grid join: at most this many
    #: (valid) Q-side pairs are probed per base (``None`` -> all, up to
    #: 8192). Q samples are pre-shuffled, so the budgeted subset is a
    #: uniform random subsample; skipped pairs are counted in
    #: stats["q_sampled_out"] (x w^3 probe units, w = the join's probe
    #: window) — intentional subsampling, reported apart from the
    #: capacity-pressure counter stats["cell_dropped"].
    join_q_budget: Optional[int] = None
    #: Probe budget of the grid join: probes that hit a non-empty cell
    #: are compacted to at most this many before the candidate gather
    #: (``None`` derives 2 * join_q_budget, scaled by the probe-window
    #: volume over 8). Probes beyond the budget drop their cell, counted
    #: in stats["cell_dropped"].
    join_probe_budget: Optional[int] = None
    #: Similarity-mode (estimate_scale) Q-sample ceiling. With the
    #: distance filter off every ordered pair is a candidate, so the
    #: allpairs engine's table holds nq^2 rows per base: this bounds
    #: that cost. With ``scale_hierarchical`` off, Q samples beyond it
    #: are cut (logged; counted in stats["scale_q_capped"]).
    scale_max_q: int = 2048
    #: Two-phase similarity mode: when estimate_scale is on and
    #: sample_size exceeds scale_max_q, a coarse similarity solve at
    #: scale_max_q samples gives the scale s, then a rigid solve on
    #: s * Q at full width (the rigid engines, the capture kernel above
    #: nq = 2048) gives the pose; the result is T_fine @ diag(s, s, s,
    #: 1). False cuts Q to the ceiling instead.
    scale_hierarchical: bool = True
    #: Pair-extraction engine: "auto" picks dense masking (nq <= 2048),
    #: the rowcap engine (nq <= 65536; 32768 with rowcap_kernel="xla")
    #: or the banded sorted
    #: cell-pair table above (ops/band_extract.py); in similarity mode
    #: dense (nq <= 2048) or "allpairs", the implicit table of every
    #: ordered pair (no capture; needs estimate_scale). "dense",
    #: "rowcap", "banded" and "allpairs" pin one. "rowcap" in similarity
    #: mode runs the XLA route's capture (see rowcap_kernel).
    pair_engine: str = "auto"
    #: Occupied-cell budget of the banded engine's index: the cell size
    #: doubles from 2 * delta until the occupied cells fit.
    band_cell_budget: int = 8192
    #: Band-window size (table entries per base edge) of the banded
    #: engine; None sizes it from the expansion budget.
    band_cell_pair_cap: Optional[int] = None
    #: Candidate slots per base edge of the banded engine; None gives
    #: 4x the edge's pair capacity.
    band_expand_cap: Optional[int] = None
    #: Force the grid-hash congruent join even where the dense K x K
    #: oracle would be chosen (small nq, in-budget mask). The dense
    #: oracle is exact, but it bypasses the per-cell candidate cap — this
    #: knob lets tests exercise the grid path at any problem size.
    force_grid_join: bool = False
    #: Direction filter of the Super4PCS congruent join: "cone" (exact
    #: dot-product mask, the default) or "healpix" (rasterized
    #: ring-scheme bins, the reference's deprecated
    #: ``IndexedNormalHealSet``; ops/healpix.py).
    direction_bins: str = "cone"
    #: HEALPix nside resolution of the "healpix" direction filter
    #: (12 * nside^2 pixels).
    healpix_nside: int = 4
    #: Search-stage tolerance multiplier. The pair distance band, the
    #: congruent-join radius and the rms gate (all DISTANCE_FACTOR *
    #: delta in the reference, ref:match4pcsBase.hpp:328-347,439) widen
    #: by this factor, while LCP verification and the trimmed-ICP
    #: refinement stay exact at delta, so a coarsely located true base
    #: is found in far fewer trials and the refinement pulls it to full
    #: accuracy (the terminate_threshold stop rule only sees exact-delta
    #: scores). 1.0 reproduces the reference contract. Designed to pair
    #: with ``refine_iterations`` > 0: step winners are selected on the
    #: coarse rank metric and only become the best through the guarded
    #: exact-delta refine.
    search_delta_factor: float = 1.0
    #: Anytime escalation of the search factor: when the trial estimate
    #: exhausts below ``terminate_threshold`` and more than 5% of the
    #: wall-clock budget remains, the step is rebuilt at this factor
    #: (with a fresh trial estimate) instead of stopping. Requires active
    #: refinement. Values <= the active search_delta_factor disable it.
    #: In the port the rebuild is synchronous and cheap (no compile);
    #: its time is stats["escalation_compile_seconds"].
    search_escalation_factor: float = 2.0
    #: Escalation LADDER depth: how many rungs a run may climb, rung
    #: ``s`` searching at ``search_escalation_factor ** s`` with a fresh
    #: trial-estimate extension each time. The wall-clock budget still
    #: binds.
    search_escalation_stages: int = 2
    #: Trimmed-ICP refinement iterations applied to every new best
    #: transform inside the anytime loop and once more after the search
    #: (a quality stage beyond the reference; guarded: the refined pose
    #: is kept only if the exact LCP improves). 0 disables.
    refine_iterations: int = 8
    #: Two-stage LCP verification (the batched analog of the reference
    #: Verify's early exit, ref:match4pcsBase.cc:520-558): rank all
    #: candidates on subsampled clouds, exact-score only the top
    #: ``verify_top_k``. 0 disables the coarse stage.
    verify_top_k: int = 2048
    #: Q / P subsample targets of the coarse ranking stage.
    coarse_q: int = 64
    coarse_p: int = 2048
    #: Pin the sampled-P point count to exactly this value (truncating
    #: by random choice / repeat-padding as needed). Repeat-padding is
    #: exact (duplicate P points never change a min-distance);
    #: truncation subsamples P and is only safe when the budget
    #: comfortably covers the overlap region. ``None`` keeps the
    #: reference semantics (all voxel-sampled P points,
    #: ref:match4pcsBase.hpp:112-127).
    p_sample_budget: Optional[int] = None
    #: Stop rule. The reference stops when EITHER budget (trial estimate
    #: or wall clock) is exhausted (fraction = max(time, trials) >= 0.99,
    #: ref:match4pcsBase.hpp:239-255). True keeps searching until the
    #: wall-clock budget or the terminate threshold is reached (fraction
    #: = time only).
    use_full_time_budget: bool = False
    #: Bases-axis sharding (a matcher with ``mesh``): True fetches each
    #: shard's per-base ``pair_counts`` table with its results; False
    #: leaves the tables on the devices, concatenated on the mesh's first
    #: device, for the host to read when it needs them. The numbers are
    #: the same (parallel/sharded.py::sharded_step).
    sharded_gather_telemetry: bool = True
    #: Before the search, time the phases of a warm step (select_extract,
    #: join, fit, verify, and step_total) into ``stats["phase_seconds"]``
    #: and attribute them against the step's cost model in
    #: ``stats["phase_roofline"]`` (CUDA events on the card, the wall
    #: clock on the CPU; matcher._measure_phases). Off the anytime clock.
    phase_timing: bool = False

    def configure_overlap(self, overlap: float,
                          terminate_threshold: float = 1.0) -> "Options":
        """Validated overlap setter (ref:shared4pcs.h:173-179).

        Returns a new Options; raises ValueError when
        terminate_threshold < overlap, mirroring the reference's
        ``configureOverlap`` returning false.
        """
        if terminate_threshold < overlap:
            raise ValueError(
                f"terminate_threshold ({terminate_threshold}) must be >= "
                f"overlap ({overlap})")
        return dataclasses.replace(
            self, overlap_estimation=float(overlap),
            terminate_threshold=float(terminate_threshold))

    def replace(self, **kw) -> "Options":
        return dataclasses.replace(self, **kw)

    def __post_init__(self):
        if self.delta <= 0:
            raise ValueError(f"delta must be > 0, got {self.delta}")
        if self.sample_size < 4:
            raise ValueError("sample_size must be >= 4")
        if self.terminate_threshold < self.overlap_estimation:
            raise ValueError(
                "terminate_threshold must be >= overlap_estimation; use "
                "configure_overlap to set both")
        if self.search_delta_factor < 1.0:
            # < 1 would rank candidates tighter than the verification
            # and anneal the refine trim radius upward — outside the
            # design (see the field docstring)
            raise ValueError(
                f"search_delta_factor must be >= 1, got "
                f"{self.search_delta_factor}")
        if self.search_escalation_factor < 0:
            raise ValueError(
                f"search_escalation_factor must be >= 0, got "
                f"{self.search_escalation_factor}")
        if self.search_escalation_stages < 0:
            raise ValueError(
                f"search_escalation_stages must be >= 0, got "
                f"{self.search_escalation_stages}")
        if self.direction_bins not in ("cone", "healpix"):
            raise ValueError(
                f"direction_bins must be 'cone' or 'healpix', got "
                f"{self.direction_bins!r}")
        if self.pair_engine not in ("auto", "dense", "rowcap", "banded",
                                    "allpairs"):
            raise ValueError(
                f"pair_engine must be one of auto/dense/rowcap/banded/"
                f"allpairs, got {self.pair_engine!r}")
        if self.pair_engine == "allpairs" and not self.estimate_scale:
            raise ValueError(
                "pair_engine='allpairs' is the scale-mode engine and "
                "requires estimate_scale=True")
        if self.rowcap_kernel not in ("auto", "xla"):
            raise ValueError(
                f"rowcap_kernel must be 'auto' or 'xla', got "
                f"{self.rowcap_kernel!r}")
        if not 0.0 < self.pair_recall_target <= 1.0:
            raise ValueError(
                f"pair_recall_target must be in (0, 1], got "
                f"{self.pair_recall_target!r}")


# Constants shared with the reference algorithm core.
# ref:src/super4pcs/algorithms/match4pcsBase.h:79-81
K_NUMBER_OF_DIAMETER_TRIALS = 1000
K_LARGE_NUMBER = 1e9
DISTANCE_FACTOR = 2.0
