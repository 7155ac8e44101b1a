"""Batched multi-pair scan-graph registration (pairs axis).

PyTorch counterpart of ``super4pcs_tpu.parallel.batch`` (BASELINE.json
config 5): G independent scan pairs are registered by one step with a
pairs axis (``matcher.build_step`` over G pairs, the JAX package's
``vmap``): per step, every pair's base edges are captured by one kernel
launch per edge over all G * B trials, every trial's join table goes
through one sort, and each verify stage is one kernel launch for every
pair's candidates. With a mesh the pairs axis is sharded: each device
runs that step on its G / m pairs, in one process or one process per
device (``distributed``), and every pair's results reach every process
after each step.

Fixed shapes across pairs come from padding every sampled cloud to the
batch maximum. P clouds are *repeat*-padded (duplicate P points never
change a min-distance, so LCP and congruent scoring are exact). Q clouds
are *sentinel*-padded: pad rows sit at the far ``2 * ops.lcp.Q_PAD``
coordinate, where the pair-distance band never selects them and the LCP
denominator masks them out, so a padded pair's LCP is exactly its
unpadded LCP. As in the single-pair matcher, Q's samples are kd-ordered
before padding (outside similarity mode), which keeps the capture
kernel's tiles compact for its tile-pair rejection.

Each result carries the same stats dict as the single-pair matcher
(overflow telemetry, n_congruent, search/compile seconds, ``q_padded``),
and the run supports the visitor stream and checkpoint/resume contracts
(``batch_state`` out / ``resume_state`` in).

Coarse search: an explicit ``Options.search_delta_factor`` applies to
every pair; per-pair rank-best transforms are tracked and redeemed
through the guarded refine (``refine_iterations`` > 0). The batch step
never escalates; after the batch loop, pairs still below the terminate
threshold are re-registered one by one through the port's single-pair
matcher at the escalated search factor, worst first, within the wall
budget left (straggler redemption; off when
``search_escalation_factor`` <= ``search_delta_factor``). Over a mesh
that spans processes every process holds the same list: straggler
``j`` is redeemed by process ``j mod m`` on its own device, and one
gather then gives every process every redeemed answer (score,
transform, trials and stats; each process moves the pair's Q itself),
so all return the same results.

Where the port differs: randomness comes from a ``torch.Generator``
reseeded per step from ``(random_seed, step index)`` and drawn pair by
pair (the JAX package splits threefry keys), so runs of the two
packages agree statistically, not trial for trial. Every process draws
the whole step's draws on its first device and each shard takes its
pairs' slice, so a sharded run draws what an unsharded one draws (the
generators of two cards of one type give the same numbers for a
seed). On the card the warm-up runs before the clock starts and counts
in ``compile_seconds``, where the JAX package compiles inside its first
timed step. It runs once per process, not once per call, as the
single-pair matcher's does (``utils/graphs.py``): the first batch of its
kind on a device (``matcher.warm_kind``), and every batch over a mesh
of several devices, still pays one step and one refine whose outputs
are thrown away (the CUDA libraries' first calls, the kernels' first
loads, the verify's cell indexes); a later batch of that kind in the
process builds the cell indexes alone. The batched step runs eagerly
and captures no graph, so it leases no pool; each straggler's matcher
leases the device's pool for its registration and gives it back at its
end.

When the engine resolved for the batch's largest Q is "banded", each
pair's band index (ops/band_extract.py) is built once per run, padded
to one shape and stacked (``build_batched_band_index``, sentinel rows
left out), and trial ``t`` of the flat trial axis reads its pair's
index; a shard reads its pairs' part of it.
"""

from __future__ import annotations

import math
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..cloud import PointCloud
from ..kernels import lcp as lcp_kernel
from ..kernels import rowcap as rowcap_kernel
from ..kernels import rowcap_layout as rowcap_layout_kernel
from ..matcher import (Match4PCS, MatchSuper4PCS, RegistrationResult,
                       _K_DIAMETER_FRACTION, _K_MIN_TRIALS, _K_SMALL_ERROR,
                       _step_seed, build_step, capture_bounds,
                       resolve_bases_per_step, resolve_pair_engine,
                       step_span, uses_capture_kernel, warm_kind)
from ..options import K_NUMBER_OF_DIAMETER_TRIALS, Options
from ..ops import geometry, lcp, refine, sampling
from ..ops.band_extract import build_batched_band_index
from ..utils import graphs, profiling
from ..visitor import DummyTransformVisitor, visitor_needs_global
from .sharded import Mesh, gather_objects, run_shards

# Q-side sentinel coordinate — beyond ops.lcp.Q_PAD so the masked LCP
# denominator excludes these rows (see ops/lcp.py::q_valid_mask).
_Q_SENTINEL = 2.0 * lcp.Q_PAD


def _repeat_pad(a: np.ndarray, n: int) -> np.ndarray:
    if a.shape[0] == n:
        return a
    reps = -(-n // a.shape[0])
    return np.tile(a, (reps,) + (1,) * (a.ndim - 1))[:n]


def _sentinel_pad(pos: np.ndarray, n: int) -> np.ndarray:
    if pos.shape[0] == n:
        return pos
    pad = np.full((n - pos.shape[0], 3), _Q_SENTINEL, pos.dtype)
    return np.concatenate([pos, pad])


def _zero_pad(a: np.ndarray, n: int, value: float) -> np.ndarray:
    if a.shape[0] == n:
        return a
    pad = np.full((n - a.shape[0],) + a.shape[1:], value, a.dtype)
    return np.concatenate([a, pad])


def _prep(cloud: PointCloud, opts: Options, truncate: bool,
          rng: np.random.Generator):
    # scale mode caps the Q sample exactly like the single-pair matcher
    # (Options.scale_max_q): without the cap an estimate_scale batch
    # with sample_size > 2048 would run the allpairs engine over
    # G * B * nq^2 implicit table rows. P keeps its full sample
    # (truncate=False).
    target = opts.sample_size
    if truncate and opts.estimate_scale and target > opts.scale_max_q:
        target = opts.scale_max_q
    sampled = sampling.sample_for_matching(
        cloud, opts.delta, target, truncate=truncate, rng=rng)
    if truncate and not opts.estimate_scale:
        sampled = sampled.take(sampling.kd_argsort(sampled.pos))
    centroid = sampled.pos.mean(axis=0)
    return sampled, centroid


class _Shard:
    """One device's part of a batch: pairs ``lo:hi`` on ``dev``, their
    step (over their band index), clouds, diameters, Q tile bounds and
    verify indexes."""

    def __init__(self, i, lo, hi, dev, step, arrays, diam, q_bounds,
                 p_index):
        self.i, self.lo, self.hi, self.dev, self.step = i, lo, hi, dev, step
        self.arrays, self.diam = arrays, diam
        self.q_bounds, self.p_index = q_bounds, p_index


class BatchRun:
    """The set-up :func:`register_batch` runs before its clock starts:
    ``pairs`` sampled, padded and put on their devices, their batched
    step built (and on the card warmed). ``run_step(step_idx)`` runs one
    step of every pair and returns its outputs (the JAX step's dict
    with a leading G) as numpy arrays.

    ``mesh`` (axis "pairs"): each of this process's mesh devices holds
    its G / m pairs and runs the batched step over them; every step
    ends with every pair's results in every process."""

    def __init__(self, pairs: Sequence[Tuple[PointCloud, PointCloud]],
                 options: Optional[Options] = None,
                 algorithm: str = "super4pcs", device="cuda", mesh=None):
        opts = self.opts = options or Options()
        g = self.g = len(pairs)
        if mesh is not None:
            if g % mesh.size != 0:
                raise ValueError(f"number of pairs ({g}) must be divisible "
                                 f"by the mesh size ({mesh.size})")
            # this process's first device draws the steps and runs the
            # pairs' straggler redemption
            device = mesh.devices[mesh.local_shards()[0]]
        dev = self.dev = torch.device(device)
        self.mesh = mesh or Mesh(devices=(dev,), axis="pairs")
        cone_tol = (opts.cone_cos_tolerance if algorithm == "super4pcs"
                    else -1.0)
        # sampling, the kd order, centering, padding, the diameters and
        # the trial estimate
        with profiling.span("sample"):
            rng = np.random.default_rng(opts.random_seed)
            preps = [(_prep(p, opts, False, rng), _prep(q, opts, True, rng))
                     for p, q in pairs]
            np_max = self.np_max = max(len(pp) for (pp, _), _ in preps)
            self.nq_max = max(len(qq) for _, (qq, _) in preps)
            self.nq_real = np.asarray([len(qq) for _, (qq, _) in preps])
            if opts.bases_per_step is None:
                opts = self.opts = opts.replace(
                    bases_per_step=resolve_bases_per_step(opts,
                                                          self.nq_max))
            self.engine = resolve_pair_engine(opts, self.nq_max)
            p_pos = np.stack([_repeat_pad(pp.pos - cp, np_max)
                              for (pp, cp), _ in preps])
            p_norm = np.stack([_repeat_pad(pp.normals_or_zero(), np_max)
                               for (pp, _), _ in preps])
            p_rgb = np.stack([_repeat_pad(pp.rgb_or_invalid(), np_max)
                              for (pp, _), _ in preps])
            q_pos = np.stack([_sentinel_pad(qq.pos - cq, self.nq_max)
                              for _, (qq, cq) in preps])
            q_norm = np.stack([_zero_pad(qq.normals_or_zero(), self.nq_max,
                                         0.0) for _, (qq, _) in preps])
            q_rgb = np.stack([_zero_pad(qq.rgb_or_invalid(), self.nq_max,
                                        -1.0) for _, (qq, _) in preps])
            self.cent_p = np.stack([cp for (_, cp), _ in preps])
            self.cent_q = np.stack([cq for _, (_, cq) in preps])
            # diameter from the *unpadded* samples (sentinel rows would
            # blow the estimate up by ~Q_PAD/extent)
            diams = np.asarray([
                geometry.estimate_diameter(
                    preps[i][1][0].pos - self.cent_q[i],
                    K_NUMBER_OF_DIAMETER_TRIALS, rng)
                for i in range(g)], np.float32)

            # trial estimate from the worst pair (ref:hpp:175-185
            # semantics)
            overlap = opts.overlap_estimation
            denom = math.log(max(1.0 - overlap ** _K_MIN_TRIALS, 1e-300))
            first_estimation = (math.log(_K_SMALL_ERROR) / denom
                                if denom else 0.0)
            self.n_trials = max(
                int(first_estimation / _K_DIAMETER_FRACTION), _K_MIN_TRIALS)

        with profiling.span("build") as build:
            # the banded engine's per-pair indexes, one stacked index of
            # every pair (a shard reads its pairs' part); the step is
            # sized by the whole index, so every shard's step is sized
            # alike
            self.band_index = (build_batched_band_index(
                list(q_pos), opts.delta, cell_budget=opts.band_cell_budget,
                device=dev) if self.engine == "banded" else None)
            self.step, (_, self.k_quads, _) = build_step(
                opts, self.nq_max, cone_tol, self.band_index)
            # the capture kernel K2 (its tile bounds), or on the XLA route
            # K2x
            rowcap = uses_capture_kernel(opts, self.engine)
            layout = self.engine == "rowcap" and not rowcap
            self.shards = []
            for i in self.mesh.local_shards():
                d = self.mesh.devices[i]
                lo, hi = self.mesh.bounds(g, i)
                arrays = tuple(_put(a[lo:hi], d) for a in (
                    p_pos, p_norm, p_rgb, q_pos, q_norm, q_rgb))
                step = self.step
                if (self.band_index is not None
                        and (lo, hi, d) != (0, g, dev)):
                    step = build_step(
                        opts, self.nq_max, cone_tol,
                        self.band_index.to(d, slice(lo, hi)))[0]
                self.shards.append(_Shard(
                    i, lo, hi, d, step, arrays, _put(diams[lo:hi], d),
                    # the Q bounds of the capture's rejection
                    capture_bounds(opts, self.engine, arrays[3]),
                    # the pairs' cell indexes of the verify, built once
                    # for the run
                    lcp.VerifyIndex(arrays[0])))
            self.gen = torch.Generator(device=dev)
            #: the device of the step's and refines' device spans (none
            #: over a mesh of several devices)
            self.span_device = dev if self.mesh.size == 1 else None
            #: the radius of the cell index the refine's walk reads (on
            #: the card: refine.walks)
            self.refine_radius = refine.trim_radius(
                opts.delta, opts.refine_iterations, opts.search_delta_factor)
        with profiling.span("warm") as warm:
            if dev.type == "cuda":
                # the kernels' builds, and before the clock either one
                # step and one refine whose outputs are thrown away, on
                # every device, or the verify indexes they read (see the
                # module docstring)
                lcp_kernel._lib()
                if rowcap:
                    rowcap_kernel._lib()
                if layout:
                    rowcap_layout_kernel._lib()
                self._warm()

        # initial LCP of the identity per pair (ref:hpp:201); the masked
        # denominator makes sentinel padding exact here and below
        def init(sh):
            eye = torch.eye(4, dtype=torch.float32, device=sh.dev)
            return dict(s=lcp.lcp_scores(
                eye.expand(sh.hi - sh.lo, 1, 4, 4), sh.arrays[3],
                sh.arrays[0], opts.delta,
                sh.p_index.get(1, opts.delta))[:, 0])

        with profiling.span("verify") as verify:
            self.init_scores = self._on_shards(init)["s"]
        self.compile_seconds = build.seconds + warm.seconds + verify.seconds

    def _warm(self):
        """On the card, once per process and kind (``warm_kind``, the
        record of ``utils.graphs.context``): the first batch of its kind
        on one device runs one step and (refine on) one refine, their
        outputs thrown away (a counter ``warm_full``), as does every
        batch over a mesh of several devices; a later one builds the
        verify indexes that the step and the refine read
        (``warm_reused``)."""
        opts, refine_on = self.opts, self.opts.refine_iterations > 0
        ctx = graphs.context(self.dev) if self.mesh.size == 1 else None
        kind = warm_kind(opts, self.engine, refine=refine_on, batch=True)
        if ctx is not None and kind in ctx.warmed:
            profiling.count("warm_reused", 1)
            for sh in self.shards:
                for key in sh.step.index_keys(self.np_max):
                    sh.p_index.get(*key)
                if refine_on:
                    sh.p_index.get(1, opts.delta)
                    sh.p_index.get(1, self.refine_radius)
        else:
            profiling.count("warm_full", 1)
            self.run_step(-1)
            if refine_on:
                self.refine_pairs(np.tile(np.eye(4, dtype=np.float32),
                                          (self.g, 1, 1)))
        for sh in self.shards:
            torch.cuda.synchronize(sh.dev)
        if ctx is not None:
            ctx.warmed.add(kind)

    @property
    def index_builds(self) -> int:
        """Verify indexes built so far, on every shard."""
        return sum(sh.p_index.builds for sh in self.shards)

    def _on_shards(self, fn) -> dict:
        """``fn(shard)`` (a dict of tensors with a leading pairs axis)
        on every shard of this process, all launched before any is
        fetched; every pair's results, in pair order, in every
        process."""
        shard = {sh.i: sh for sh in self.shards}
        got = run_shards(self.mesh, lambda i, d: fn(shard[i]))
        return {k: np.concatenate([r[k] for r in got]) for k in got[0]}

    def run_step(self, step_idx: int) -> dict:
        """Step ``step_idx`` of every pair, its outputs fetched to the
        host, in a span "step". Its draws are seeded from the run seed
        and the index and drawn for all G pairs, pair by pair, on this
        process's first device; each shard runs its pairs' slice."""
        def one(sh):
            return sh.step.run(
                tuple(t[sh.lo:sh.hi].to(sh.dev) for t in draws), sh.diam,
                *sh.arrays, sh.q_bounds, sh.p_index)

        with torch.no_grad(), step_span(self.span_device):
            self.gen.manual_seed(_step_seed(self.opts.random_seed,
                                            step_idx))
            draws = self.step.draw(self.gen, self.g, self.np_max)
            return self._on_shards(one)

    def refine_pairs(self, src: np.ndarray):
        """The guarded refine of every pair's ``src`` (G, 4, 4): (the
        refined (G, 4, 4), the exact LCP of both (G, 2)), on each shard
        the refines one pair at a time and the scores in one verify
        launch; a span "refine"."""
        opts = self.opts

        def one(sh):
            d_p, d_q = sh.arrays[0], sh.arrays[3]
            cur = _put(src[sh.lo:sh.hi], sh.dev)
            index = (sh.p_index.get(1, self.refine_radius)
                     if refine.walks(sh.dev) else None)
            refined = torch.stack([refine.refine_transform(
                cur[i], d_q[i], d_p[i], opts.delta,
                iters=opts.refine_iterations,
                start_factor=opts.search_delta_factor,
                estimate_scale=opts.estimate_scale,
                index=None if index is None else index.part(i))
                for i in range(sh.hi - sh.lo)])
            scores = lcp.lcp_scores(torch.stack([cur, refined], dim=1),
                                    d_q, d_p, opts.delta,
                                    sh.p_index.get(1, opts.delta))
            return dict(refined=refined, scores=scores)

        with torch.no_grad(), profiling.span("refine", self.span_device):
            out = self._on_shards(one)
        return out["refined"], out["scores"]


def _put(a, dev):
    return torch.as_tensor(np.asarray(a, np.float32), device=dev)


def straggler_order(lcp, threshold: float) -> list:
    """The stragglers: the pairs whose ``lcp`` is below ``threshold``,
    worst first (ties in pair order)."""
    return sorted((i for i in range(len(lcp)) if lcp[i] < threshold),
                  key=lambda i: lcp[i])


def straggler_share(order: list, rank: int, world: int) -> list:
    """The stragglers of ``order`` that process ``rank`` of ``world``
    redeems: straggler ``j`` goes to process ``j mod world``, which
    spreads the worst pairs over the cards."""
    return order[rank::world]


def merge_redeemed(order: list, answers: dict, lcp, factor: float) -> dict:
    """The redeemed answers kept ({pair: result}), in the order of the
    list ``order``: those that improved and beat the pair's batch LCP
    ``lcp``, each marked ``straggler_escalated_to`` ``factor``."""
    kept = {}
    for i in order:
        r = answers.get(i)
        if r is not None and r.score > lcp[i] and r.improved:
            r.stats["straggler_escalated_to"] = factor
            kept[i] = r
    return kept


def _exchange_redeemed(answers: dict, pairs, mesh) -> dict:
    """Every process's redeemed answers ({pair: result}) in every
    process, from one gather over ``mesh``'s processes. An answer
    travels as its score, transform, trials, improved flag and stats
    (not its span table); each process moves the pair's Q by the
    transform itself."""
    sent = {i: (r.score, r.transform, r.n_trials, r.improved,
                {k: v for k, v in r.stats.items() if k != "spans"})
            for i, r in answers.items()}
    out = {}
    for got in gather_objects(mesh, sent):
        for i, (score, mat, trials, improved, stats) in got.items():
            out.setdefault(i, RegistrationResult(
                score=score, transform=mat,
                transformed_q=pairs[i][1].transformed(mat),
                n_trials=trials, improved=improved, stats=stats))
    return out


def register_batch(
    pairs: Sequence[Tuple[PointCloud, PointCloud]],
    options: Optional[Options] = None,
    mesh=None,
    algorithm: str = "super4pcs",
    visitor=None,
    resume_state: Optional[dict] = None,
    on_checkpoint=None,
    device="cuda",
) -> List[RegistrationResult]:
    """Register ``pairs[g] = (P_g, Q_g)`` for all g with one batched step.

    ``device``: where the clouds live and the kernels run ("cuda" by
    default; "cpu" runs the kernels' plain versions).

    ``mesh`` (1-D, axis "pairs"; ``make_mesh`` over this process's
    devices, or ``distributed.global_mesh()`` over one device per
    process): G must be divisible by the mesh size, and each device
    runs the batched step on its G / m pairs (its first device takes
    ``device``'s place). After every step every process holds every
    pair's results, so the loop state and ``on_checkpoint``'s state are
    identical replicas, and process 0's clock decides the stop rule in
    every process. The guarded refine runs on each shard's pairs.
    Straggler redemption splits its list over the processes: each
    redeems its share on its own device, and one gather gives every
    process every redeemed answer.

    ``visitor``: optional callable ``visitor(fraction, scores, mats)``
    with per-pair arrays ``scores (G,)`` / ``mats (G, 4, 4)`` — called
    once before the loop (fraction 0), after every improving step
    (fraction -1, matching the single-pair improvement convention,
    ref:hpp:458-465) and every step (progress fraction). When the
    visitor answers ``needs_global_transformation() == True`` the mats
    are recomposed into original coordinates.

    ``resume_state``: dict returned in ``results[g].stats["batch_state"]``
    of a previous (possibly interrupted) run over the *same pairs and
    options* — the search resumes from its trial counter and per-pair
    best-so-far, continuing the same draw stream.

    ``on_checkpoint``: optional callable receiving the serializable
    state dict after every device step (persist it: every process holds
    an identical replica, so any may write it; a fresh run passing it as
    ``resume_state`` continues where the dead one stopped, sharded or
    not).

    Every result's ``stats["spans"]`` is the call's one span table
    (``utils/profiling.py``): "setup" (``BatchRun``), "search" (its
    steps), "refine", "redeem" (each straggler's registration a "call"
    under it; over several processes the gather of the answers,
    "exchange") and "finish"; with redemption on, the counters
    ``stragglers`` (the list's length), ``redeemed_here`` (this
    process's registrations) and ``redeem_kept`` (the answers kept).
    """
    if len(pairs) == 0:
        return []
    with profiling.call(device if mesh is None
                        else mesh.devices[mesh.local_shards()[0]],
                        len(pairs)) as spans:
        results = _register_batch(pairs, options, mesh, algorithm, visitor,
                                  resume_state, on_checkpoint, device)
    for r in results:
        r.stats["spans"] = spans
    return results


def _register_batch(pairs, options, mesh, algorithm, visitor, resume_state,
                    on_checkpoint, device) -> List[RegistrationResult]:
    visitor = visitor or DummyTransformVisitor()
    needs_global = visitor_needs_global(visitor)
    g = len(pairs)
    with profiling.span("setup"):
        run = BatchRun(pairs, options, algorithm, device, mesh)
    dev = run.dev
    n_procs = run.mesh.world_size
    opts = run.opts
    k_quads, n_trials = run.k_quads, run.n_trials
    cent_p, cent_q = run.cent_p, run.cent_q
    nq_max, nq_real = run.nq_max, run.nq_real
    compile_seconds = run.compile_seconds
    init_scores = run.init_scores

    best = {
        "lcp": init_scores.copy(),
        "transform": np.tile(np.eye(4, dtype=np.float32), (g, 1, 1)),
        "qcentroid1": np.zeros((g, 3), np.float32),
        "qcentroid2": np.zeros((g, 3), np.float32),
    }
    # Coarse-search support (explicit Options.search_delta_factor > 1):
    # step winners are selected on the rank metric (sf * delta) and
    # their exact-delta scores are depressed, so track each pair's
    # rank-best transform too and give it to the guarded refine below,
    # as the single-pair matcher's _refine_candidate does.
    rank_best = None
    if opts.search_delta_factor != 1.0 and opts.refine_iterations > 0:
        rank_best = {
            "rank": np.full(g, -np.inf, np.float32),
            "transform": np.tile(np.eye(4, dtype=np.float32), (g, 1, 1)),
        }
    improved = np.zeros(g, bool)
    counters = {name: np.zeros(g, np.int64) for name in
                ("pairs_overflow", "quads_overflow", "cands_overflow",
                 "n_congruent", "cell_dropped", "q_sampled_out")}
    trial = 0
    step_idx = 0
    if resume_state is not None:
        trial = int(resume_state["trial"])
        step_idx = int(resume_state["step_idx"])
        improved = np.asarray(resume_state["improved"], bool).copy()
        for name in best:
            best[name] = np.asarray(resume_state[name],
                                    np.float32).copy()
        for name in counters:
            if name in resume_state["counters"]:
                counters[name] = np.asarray(
                    resume_state["counters"][name], np.int64).copy()

    def global_mats():
        mats = np.tile(np.eye(4, dtype=np.float32), (g, 1, 1))
        for i in range(g):
            if improved[i]:
                mats[i] = best["transform"][i]
                rot = mats[i, :3, :3]
                mats[i, :3, 3] = (best["qcentroid1"][i] + cent_p[i]
                                  - rot @ (best["qcentroid2"][i]
                                           + cent_q[i]))
        return mats

    def visit(fraction):
        mats = global_mats() if needs_global else best["transform"].copy()
        visitor(fraction, best["lcp"].copy(), mats)

    def snapshot_state():
        return {
            "trial": trial, "step_idx": step_idx,
            "improved": improved.tolist(),
            "counters": {k: v.tolist() for k, v in counters.items()},
            **{k: v.tolist() for k, v in best.items()},
        }

    with torch.no_grad():
        with profiling.span("search"):
            visit(0.0)
            t0 = time.perf_counter()
            while True:
                out = run.run_step(step_idx)
                lcps = out["lcp"]
                upd = lcps > best["lcp"]
                improved |= upd
                for name in ("lcp", "transform", "qcentroid1",
                             "qcentroid2"):
                    best[name][upd] = out[name][upd]

                # same dropped-ITEM accounting as the single-pair
                # matcher, kept per pair. pair_counts: (G, B, 6) = (c1,
                # c2, qcount, cell_dropped, pairs_dropped, q_sampled_out)
                counts = out["pair_counts"]
                counters["n_congruent"] += out["n_congruent"]
                counters["pairs_overflow"] += counts[:, :, 4].sum(axis=1)
                counters["quads_overflow"] += np.maximum(
                    counts[:, :, 2] - k_quads, 0).sum(axis=1)
                counters["cell_dropped"] += counts[:, :, 3].sum(axis=1)
                counters["q_sampled_out"] += counts[:, :, 5].sum(axis=1)
                counters["cands_overflow"] += out["cands_dropped"]

                if rank_best is not None:
                    ranks = out["rank_lcp"]
                    rupd = (ranks > rank_best["rank"]) & (ranks >= 0)
                    rank_best["rank"][rupd] = ranks[rupd]
                    rank_best["transform"][rupd] = out["transform"][rupd]

                trial += opts.bases_per_step
                step_idx += 1
                if on_checkpoint is not None:
                    on_checkpoint(snapshot_state())
                if upd.any():
                    visit(-1.0)
                elapsed = time.perf_counter() - t0
                if n_procs > 1:
                    # the anytime stop rule must be the same in every
                    # process (one that stops while another launches
                    # the next step's collective hangs the job): process
                    # 0's clock decides
                    import torch.distributed as dist
                    clock = torch.tensor([elapsed], dtype=torch.float64)
                    dist.broadcast(clock, 0, group=run.mesh.group)
                    elapsed = float(clock[0])
                fraction_time = elapsed / opts.max_time_seconds
                fraction = (fraction_time if opts.use_full_time_budget
                            else max(trial / n_trials, fraction_time))
                visit(min(fraction, 1.0))
                if (fraction >= 0.99
                        or (trial > n_trials
                            and not opts.use_full_time_budget)
                        or (best["lcp"]
                            >= opts.terminate_threshold).all()):
                    break
            search_seconds = time.perf_counter() - t0

        # guarded trimmed-ICP polish of every pair (same contract as the
        # single-pair matcher: kept only if LCP improves). In
        # coarse-search mode the per-pair rank-best transforms are
        # refined too — that is how a coarse-ranked winner becomes the
        # best.
        if opts.refine_iterations > 0:
            sources = [best["transform"]]
            if rank_best is not None:
                sources.append(rank_best["transform"])
            for src in sources:
                refined, scores = run.refine_pairs(src)
                for i in range(g):
                    if scores[i, 1] > best["lcp"][i]:
                        best["lcp"][i] = scores[i, 1]
                        best["transform"][i] = refined[i]
                        best["qcentroid1"][i] = refined[i, :3, 3]
                        best["qcentroid2"][i] = 0.0
                        improved[i] = True

    # Straggler redemption (single-pair escalation analog, see module
    # docstring): re-register the pairs still below the terminate
    # threshold individually at the escalated search factor, worst
    # first, while wall budget remains; over several processes each
    # redeems its share of the list on its own card, and one exchange
    # gives every process every redeemed answer.
    redeemed = {}
    if (opts.search_escalation_factor > opts.search_delta_factor
            and opts.refine_iterations > 0):
        cls = MatchSuper4PCS if algorithm == "super4pcs" else Match4PCS
        order = straggler_order(best["lcp"], opts.terminate_threshold)
        profiling.count("stragglers", len(order))
        if order or n_procs > 1:
            with profiling.span("redeem"):
                answers = {}
                for i in straggler_share(order, run.mesh.rank, n_procs):
                    remaining = (opts.max_time_seconds
                                 - (time.perf_counter() - t0))
                    if remaining < max(0.1 * opts.max_time_seconds, 15.0):
                        break
                    # full-time-budget: the pair already failed one
                    # trial estimate in the batch — the redemption pass
                    # should use the wall budget, not fail the same
                    # estimate again
                    sub = opts.replace(
                        search_delta_factor=opts.search_escalation_factor,
                        max_time_seconds=int(remaining),
                        use_full_time_budget=True,
                        bases_per_step=None)
                    answers[i] = cls(sub, device=dev).compute_transformation(
                        pairs[i][0], pairs[i][1])
                profiling.count("redeemed_here", len(answers))
                if n_procs > 1:
                    # every process gathers once, whatever its share
                    # held, so that none is left inside the collective
                    with profiling.span("exchange"):
                        answers = _exchange_redeemed(answers, pairs,
                                                     run.mesh)
                # kept OUTSIDE the resumable batch_state: the redeemed
                # transform lives in original coordinates (the batch
                # state tracks centered-frame poses); a resumed run
                # simply redeems again
                redeemed = merge_redeemed(order, answers, best["lcp"],
                                          opts.search_escalation_factor)
            profiling.count("redeem_kept", len(redeemed))

    with profiling.span("finish"):
        profiling.count("index_builds", run.index_builds)
        batch_state = snapshot_state()
        results = []
        for i in range(g):
            if i in redeemed:
                r = redeemed[i]
                stats = {name: int(counters[name][i])
                         for name in counters}
                stats.update(r.stats, compile_seconds=compile_seconds,
                             q_padded=int(nq_max - nq_real[i]),
                             batch_state=batch_state)
                results.append(RegistrationResult(
                    score=r.score, transform=r.transform,
                    transformed_q=r.transformed_q,
                    n_trials=trial + r.n_trials,
                    improved=True, stats=stats))
                continue
            if improved[i]:
                mat = np.array(best["transform"][i])
                rot = mat[:3, :3]
                mat[:3, 3] = (best["qcentroid1"][i] + cent_p[i]
                              - rot @ (best["qcentroid2"][i] + cent_q[i]))
                moved = pairs[i][1].transformed(mat)
            else:
                mat = np.eye(4, dtype=np.float32)
                moved = pairs[i][1]
            stats = {name: int(counters[name][i]) for name in counters}
            stats.update(
                compile_seconds=compile_seconds,
                search_seconds=search_seconds,
                q_padded=int(nq_max - nq_real[i]),
                batch_state=batch_state,
            )
            if run.band_index is not None:
                stats.update(
                    band_cells=run.band_index.m,
                    band_member_dropped=run.band_index.member_dropped)
            results.append(RegistrationResult(
                score=float(best["lcp"][i]), transform=mat,
                transformed_q=moved, n_trials=trial,
                improved=bool(improved[i]), stats=stats))
        return results
