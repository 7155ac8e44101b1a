#!/usr/bin/env python3
"""Smoke test of the PyTorch port (super4pcs_tpu_torch) on one CUDA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase's failure is caught):

1. the card's name and power limit (nvidia-smi);
2. build of the CUDA kernels from csrc/ (one nvcc per source) and of
   the native IO parsers (csrc/io_native.cpp, g++), started together,
   with the build time; the script fails when the IO library does not
   load;
3. K1 (LCP min-distance) at the main path's verify shapes: the exact
   stage (64 candidates x 8192 queries x the headline's sampled P), the
   mid stage (2048 x 512 x P[::10]) and the coarse stages (4096 and
   16384 x 64 x P[::37]). The grid-pruned lcp_min_d2_within (the main
   path's kernel) equals its plain walk and the brute-force contract
   where(lcp_min_d2_plain <= eps^2, ., inf) bit for bit, with the hit
   count of the brute-force kernel; its largest error where both are
   finite and its non-finite mismatches, its time, the index build's
   device time, the pair tests it made and two bounds (the pruned work,
   the brute force). The brute force lcp_min_d2 (a branch-and-bound
   over P's tiled index) equals its plain version (torch.equal), with
   its time, its index build's, the pair and box tests per query of its
   counting build, and two bounds (the work done, the brute force);
   torch.cdist + amin at the coarse shape as the library yardstick;
3b. K1 at the 1M config's shapes (bench.py:109-123 sampled as the
   matcher does: Np = 530,895, nq = 16384), which the TPU verified with
   its streamed-P kernel K3: the brute force at the exact stage (64 x
   16384 x 530,895) equal to its plain version and printed as in 3,
   lcp_min_d2_within there against the contract; then min_sq_dists
   (the same kernel on the rows as they are, for K4a/K4b) the same way;
   torch.cdist + amin over the whole 16384 x 530,895 matrix as the
   library yardstick of K4a and of K3 at C = 1;
3c. KR (the refine's neighbour walk, kernels/lcp.py::nearest_within) on
   the headline's samples, 8192 queries under a pose near the true one
   against P at the trim radius of 2, 4 and 8 delta: bit for bit its
   plain walk, the same neighbour as the refine's brute force
   (ops/refine.py::_nearest) on >= 99.9% of the queries within the
   radius; its time, pair tests a query, bound and plain time, the
   brute force's time, and a whole refine with the walk and with the
   brute force, their transforms within 1e-5;
3d. KJ (the join kernel, kernels/join.py::grid_join) on the joins of a
   step over the headline's samples, T 16 (one pair) and T 64 (four
   pairs, a step of 5j) at the search factor 1 and 2 (w 2 and 3): its
   outputs bit for bit the plain join's (the sort route), its device
   time and the plain join's, each kernel's share, its bound (the
   table hash and the second table's mask read once, the quads
   written once, at the memory rate), and the wall of both;
4. K2 (band capture) against its plain version at n = 8192,
   row_cap = 160, edge 0 with the join hash: cols/rc/h bit-identical,
   then the same with tile-pair rejection on (the one-thread-per-row
   kernel's times beside);
4a. K2 with all four pair filters on both edges of the headline's Q
   samples (n = 8192 and 32768), rejection on and off, bit-identical to
   each other and to the plain version, with the share of tile pairs
   rejected;
4b. K2 over the trial axis, T = 16 captures of the headline's Q (a
   step's edge) and T = 64 over four rotated copies (a step of 5j), one
   launch each, edge 0 with the hash and rejection on; K1 over the
   pairs axis, the exact stage for G = 1 and 4 pairs in one launch with
   indexes built beforehand: each bit-identical to its plain version,
   with its time, index build, plain time and bound;
4c. K2x (the XLA route's capture, both edges of T trials in one launch)
   at nq 8192 T 16 with and without the four filters, nq 32768 T 16
   and similarity nq 4096 T 4, rejection on and off: bit for bit each
   other and the plain version outside the rows holding a candidate
   within 1e-6 rad of the angle gate (rows at a band edge are compared
   too); its time with the rejection on and off, the share of pair
   tests the rejection skips, the bound of every pair test and of the
   tests left;
5. the headline registration — the 100k-point noisy bumpy-sphere pair
   of bench.py, Options(delta=0.01, sample_size=8192) through
   MatchSuper4PCS on the GPU (rowcap engine, rejection on).
   lcp_min_d2_within and rowcap_capture must have launched, and KR 8
   times a refine (the "refine" spans of its span table, at least one,
   and its ``refine_walks`` counter); LCP >= 0.7 and the known pose
   within rotDiff <= 0.2 / trDiff <= 0.1;
5b. the filtered registration at the same width: radial normals and
   abs(pos) * 200 colors (tools/parity_configs.py:105-121), normal and
   color filters of BASELINE Config 3; same gates, filtered K2 launches,
   KR 8 times a refine;
5c. the CLI from files (``cli.main``, as ``super4pcs-torch`` runs it):
   the headline pair written as PLY with the port's writer (the read
   time of a 100k-point file printed, with the parser tier that read it
   and the numpy parser's time), ``-o 0.7 -d 0.01 -n 8192 -t 10
   -m mat -r out``: exit 0, K1 and K2 launched, the Polyworks matrix
   within rotDiff <= 0.2 / trDiff <= 0.1 of the known pose, and the
   written geometry's LCP against P >= 0.7;
5d. the same with the filtered clouds' normals and colors in the PLY
   files and ``-a 20 -c 60``: the same gates, filtered K2 launches;
5e. 4PCS (``-x``) on a generated 30,000-vertex bumpy-sphere OBJ mesh
   (``f a//n`` faces; its read time, tier and numpy time printed) and
   a rotated copy, at the
   reference demo's sample size: ``-n 200 -o 0.9 -d 0.05``. The dense
   engine (K1, no K2), the pose gates, and ``-r out.obj`` keeps the
   faces;
5f. 5c with ``--tpu-opts direction_bins=healpix``: the same gates, its
   quads_overflow printed;
5g. ``register_sequence``: bench.py's synthetic 4-view sequence with
   its options (K1 only), then the 100k-point bumpy sphere cut into the
   same 4 views at delta 0.01, sample_size 8192 (K1 and K2); every step
   within rotDiff <= 0.2 / trDiff <= 0.1, its search seconds printed;
5h. similarity mode, hierarchical, through ``register``: the 50,000-
   point scale fixture of tools/scale_hier_16k.py (Q = the headline
   pose / 1.4, noise 0.008), ``delta=0.05, sample_size=16384,
   estimate_scale=True``: the coarse similarity phase at scale_max_q
   (2048, dense engine, K1) and the fine rigid phase on s * Q (rowcap,
   K1 and K2 when its nq > 2048); LCP >= 0.95, scale error < 0.5% and
   the pose with the scale divided out within rotDiff <= 0.2 / trDiff
   <= 0.1; each phase's nq, engine, trials and seconds and the peak
   device memory printed;
5i. similarity mode through the allpairs engine (``MatchSuper4PCS``,
   sample_size = scale_max_q = 4096, hierarchical off): the same
   clouds and gates, K1 and no K2; then a step's wall and device time
   (4 bases, each sorting a table of nq^2 rows) and the overflow
   counters;
5j. ``register_batch`` (super4pcs_tpu_torch.parallel) on G = 4 pairs at
   the headline's width: the headline pair and the three consecutive
   pairs of 5g's sequence-full views, 5g sequence-full's options
   (delta 0.01, sample_size 8192, 30 s, seed 5, overlap 0.5,
   threshold 0.6); every pair at LCP >= 0.6 and within rotDiff <= 0.2 /
   trDiff <= 0.1 of its known relative pose, K1 and K2 launched; then,
   outside the path, one step's launches (2 capture launches covering
   2 x 64 captures, 3 verify launches, no index build) and the wall,
   device time and idle share of a step;
5j-banded. 5j with ``pair_engine="banded"``: the four pairs' band
   indexes padded and stacked once per run, T = 64 trials a step, K1
   and no K2; the same gates, launches and step profile (extraction,
   join and verify device time);
5k. the headline registration forced onto the banded engine
   (``pair_engine="banded"``): the same gates, K1 and no K2; its band
   index (cells, cell size, members dropped, host bucketing and table
   sort times), overflow counters and a step's profile;
5l. the 1M pair of bench.py:109-123 at ``delta=0.005,
   sample_size=131072`` (seed 5, overlap and threshold 0.7, 120 s, the
   whole budget open to the search): "auto" resolves to banded at
   nq = 131,072 against Np = 530,895;
   LCP >= 0.7 within the budget and the pose gates; printed as 5k;
   then, measured and not gated, the rowcap engine on the same samples
   (K2 capturing at n = 131,072): two steps' profile and peak memory
   beside 5l's banded step;
5m. the headline through ``MatchSuper4PCS(opts, mesh=make_mesh())``
   over every visible card (a one-card mesh must equal phase 5 bit for
   bit), then over ``make_mesh(["cuda:0"] * 2)`` (two shards of 8
   bases on one card; its trials and LCP printed beside phase 5's):
   the headline's gates, K1 and K2 launched, one step's launches (2
   captures and 3 verifies on every shard) and the step's wall, device
   time and idle share per card;
5n. ``register_batch`` on 5j's four pairs with 5j's options over two
   processes of ``distributed.initialize`` (gloo), which the script
   spawns (``chip_smoke.py --batch-worker ADDR 2 PID``; both on cuda:0
   with one card, cuda:rank with more): each exits 0 within 300 s (else
   every child is killed and the script fails), both hold bit-identical
   results, every pair meets 5j's gates, each process launched K1 and
   K2; the step time of each;
5o. the headline with ``phase_timing=True``: ``stats["phase_seconds"]``
   and the roofline table against the H100's peaks; the phases' sum
   within 10% of step_total, and the search phase 5's;
5p. a step of each dense path (the recipe, 5e, 5g's first sequence
   step, 5h's coarse phase), each pair formed as its phase forms it:
   its kernels, wall, device busy time, idle share and peak memory;
   the step's run over its B bases launching at most 2x the kernels of
   the same run over one base; every trial of the step's trial function
   equal to its one-base call bit for bit (transform, cvalid, quads,
   counts);
5q. the dispatch layer: on the engines of 5 (rowcap), 5b (filtered),
   5k (banded), 5i (allpairs), 5r (the XLA route), 5s (similarity
   rowcap), 6 (the recipe, dense) and 5h's coarse phase (similarity
   dense), a matcher's captured step (a CUDA graph, utils/graphs.py)
   replayed against the same step launched op by op, every output bit
   for bit and the same launch counts, and the step's trial function
   captured alone against its eager call (transform, cvalid, quads,
   counts);
6. the 500-point known-pose recipe on the GPU (dense engine,
   lcp_min_d2_within only);
7. a headline step's launches (2 capture launches, 3 verify
   launches, no verify index built: it is built once per run; a
   replay of the captured step counts the launches its capture
   recorded) and a profile of headline steps as the search runs them
   (replays): device busy and idle share per step, kernels per step,
   time by kernel;
8. one line of the entry points' numbers (5c-5o), one JSON line of
   per-kernel results, then the last line {"ok": true, "device": {...}}.

Kernel times are device times from torch.profiler (K2's includes its
prep kernel, which writes the padded column planes once per call); the
plain versions and the library call are timed with CUDA events.

With ``--seeds 1,3,5,7,11`` it then also runs the headline and the
filtered registration once per seed with tile-pair rejection on and
once with it off (alternating which goes first), and prints each run's
search seconds, trials and LCP and the medians.

Each registration (5, 5b, 5c-5o, 6) is a path of its own: the launch
counts (K2's launches and the captures they covered) are set to 0 just
before it and read just after (5n's in each of its processes, summed).

With ``--scale-only`` it runs phases 1-2 and 5h-5i alone, so that 5h is
the first registration in its process; with ``--dispatch-only``, phases
1-2 and 5q; with ``--refine-only``, phases 1-2, 3c and 5; with
``--join-only``, phases 1-2, 3d and 5, then the headline's step split
(``Options.phase_timing``) and its graph's join kernels; with
``--xla-only``, phases 1-2, 4c, 5r and 5s (and, with
``--seeds``, 5r once per seed: search seconds, steps, trials, LCP).

Exits with code 2 and prints no result when no CUDA device is present.
"""

import collections
import concurrent.futures
import contextlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time

#: H100 SXM peaks from NVIDIA's data sheet (at 700 W): float32 outside
#: the tensor cores, and HBM bandwidth
FP32_OPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
#: fp32 operations per pair test (see the .cu notes): K1 3 sub, 3 mul,
#: 2 add, 1 min; K2's band test a 3-term dot, d2 and two compares; an
#: in-band pair adds 19 for the normal band, 2 for the scores and 5 for
#: the angle; a captured pair with the hash 15 (3 x sub, mul, add, div,
#: floor)
K1_OPS = 9
#: fp32 operations per box test of the tiled brute force: per axis two
#: sub and two max, then 3 mul, 2 add and the compare
K1_BOX_OPS = 18
K2_BAND_OPS = 10
K2_FILTER_OPS = {"normals": 19, "rowcol": 2, "angle": 5}
K2_HASH_OPS = 15

#: the tiled brute force's kernel, and its fill of the output (launched
#: before it when the group list is split)
K1B_NAME = "lcp_min_d2_tiles_kernel"
K1B_FILL = "lcp_min_d2_tiles_fill_kernel"
K1W_NAME = "lcp_min_d2_within_kernel"
#: the refine's neighbour walk (KR), and the multiples of the trim radius
#: at the search factor 1 it is checked at (one and two escalations)
KR_NAME = "refine_nearest_within_kernel"
KR_FACTORS = (1.0, 2.0, 4.0)
K2_NAME = "rowcap_capture_kernel"
K2_NAMES = (K2_NAME, "rowcap_prep_kernel")
#: the join kernel's kernels share this prefix; its last one, once a
#: launch
KJ_PREFIX = "join_"
KJ_NAME = "join_emit_kernel"
#: the search factors of 3d: the cells' (w 2) and one escalation's (w 3)
KJ_FACTORS = (1.0, 2.0)
#: the previous, one-thread-per-row capture kernel, ms per launch on an
#: NVIDIA H100 80GB HBM3 at 700 W (PERF.md, kernel table), printed
#: beside the current kernel's times: the headline base (rejection on,
#: off) and the filtered edges (n, edge) with rejection on
K2_ROW_THREAD_MS = {"headline": (0.089, 0.104), (8192, 0): 0.132,
                    (8192, 1): 0.132, (32768, 0): 0.434,
                    (32768, 1): 0.754}

#: K2x, the XLA route's row-capped capture (csrc/rowcap_layout.cu)
K2X_NAME = "rowcap_layout_kernel"
#: fp32 operations of K2x per pair test: the squared band (a 3-term
#: dot, d2, two compares), the band with the angle filter (difference,
#: norm, square root, |dist - d|, compare), no band (the diagonal test);
#: and per pair inside the band: the normal band (two 3-term norms with
#: their square roots, two differences, two abs, min, compare), the
#: scores (add, compare) and the angle (3 div, 3 mul, 2 add, clamp,
#: acos ~10, compare)
K2X_OPS = {"band": 10, "dirs": 12, "no-band": 2, "normals": 24,
           "scores": 2, "angle": 20}
#: 5i's step as the parent ran it, its trials in a Python loop, on an
#: NVIDIA H100 80GB HBM3 at 700 W: PR 10's final smoke log (wall, busy,
#: idle, kernels recorded by the profiler) and PR 11's graph of it
#: (call 16, kernel nodes), printed beside the batched step's numbers
ALLPAIRS_LOOP_PARENT = dict(step_wall_ms=37.7, step_busy_ms=21.9,
                            idle_share=0.42, step_kernels=1766,
                            graph_kernel_nodes=1685)

TH = 0.8                    # the headline pair's rotation about z
SHIFT = (0.1, -0.05, 0.2)   # and its translation (bench.py:48-51)
SCALE = 1.4                 # the scale fixture's Q is P's pose / SCALE


def _log(*parts):
    print(*parts, flush=True)


def _cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds per call of ``fn`` on the current stream,
    timed with CUDA events after ``warmup`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device_events(fn, attempts: int = 3, scope=()):
    """(name, microseconds, scope) of every kernel the card ran during
    ``fn``, from torch.profiler; ``scope`` names the host range
    (``record_function``, one of the names in ``scope``: a string or a
    tuple of them) the kernel was launched in, found through the ops the
    profiler nests in that range, or is None. Now and then a trace comes
    back without any device record: ``fn`` is then profiled again, and
    it fails when ``attempts`` traces in a row recorded none."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    scopes = (scope,) if isinstance(scope, str) else tuple(scope)
    for attempt in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = prof.events()
        # a record_function range also leaves a device-side annotation
        # spanning its kernels (and the gaps between them): not a kernel
        evs = [(e.name, e.time_range.elapsed_us()) for e in events
               if e.device_type == cuda
               and not getattr(e, "is_user_annotation", False)
               and e.name not in scopes]
        if evs:
            scoped = collections.defaultdict(collections.Counter)

            def collect(e, label):
                for k in e.kernels:
                    scoped[(k.name, k.duration)][label] += 1
                for child in e.cpu_children:
                    collect(child, label)

            for e in events:
                if e.name in scopes and e.device_type == cpu:
                    collect(e, e.name)
            out = []
            for name, t in evs:
                left = +scoped[(name, t)]
                label = next(iter(left), None)
                if label is not None:
                    scoped[(name, t)][label] -= 1
                out.append((name, t, label))
            return out
        _log(f"  torch.profiler recorded no device time (trace "
             f"{attempt + 1} of {attempts})")
    raise SystemExit("torch.profiler recorded no device time")


def _kernel_ms(fn, kernels, reps: int) -> float:
    """Mean device milliseconds per call of ``fn`` of the kernel named
    ``kernels`` (or the sum over a tuple of names, each launched once
    per call), from the profiler: the kernels alone, without the host
    time of their wrapper.

    The profiler's CUDA trace now and then loses kernel records, so each
    mean is over the launches it recorded; when it recorded none of a
    kernel, the calls are timed with CUDA events instead (wrapper
    included). It fails when it recorded more than ``reps``."""
    names = (kernels,) if isinstance(kernels, str) else kernels
    fn()
    evs = _device_events(lambda: [fn() for _ in range(reps)])
    total = 0.0
    for kernel in names:
        times = [t for name, t, _ in evs if kernel in name]
        if len(times) > reps:
            raise SystemExit(f"expected {reps} launches of {kernel}, the "
                             f"profiler saw {len(times)}")
        if len(times) < reps:
            _log(f"  the profiler recorded {len(times)} of {reps} launches"
                 f" of {kernel}" + ("; timed with CUDA events"
                                    if not times else ""))
        if not times:
            return _cuda_ms(fn, reps, warmup=0)
        total += sum(times) / len(times) / 1e3
    return total


def _device_ms(fn, reps: int) -> float:
    """Device milliseconds per call of ``fn``, all its kernels summed,
    from the profiler."""
    fn()
    evs = _device_events(lambda: [fn() for _ in range(reps)])
    return sum(t for _, t, _ in evs) / reps / 1e3


def _finite_err(got, want):
    """(largest |got - want| over the entries where both are finite, the
    number of entries that differ where either is not finite)."""
    import torch
    both = torch.isfinite(got) & torch.isfinite(want)
    err = float((got - want)[both].abs().max()) if bool(both.any()) else 0.0
    return err, int(((got != want) & ~both).sum())


def _bound(ops: float, nbytes: float):
    """(bound_ms, bound_by): the larger of the operations at the fp32
    peak and the bytes at the memory rate."""
    t_ops = ops / FP32_OPS_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return ((t_ops, "operations") if t_ops >= t_bytes
            else (t_bytes, "bytes"))


def _random_transforms(rng, c: int, max_angle: float, max_shift: float):
    """(c, 4, 4) float32 rigid transforms near the identity."""
    import numpy as np
    out = np.zeros((c, 4, 4), np.float32)
    for i in range(c):
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        ang = rng.uniform(0.0, max_angle)
        k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                      [-axis[1], axis[0], 0]])
        out[i, :3, :3] = (np.eye(3) + np.sin(ang) * k
                          + (1 - np.cos(ang)) * k @ k)
        out[i, :3, 3] = rng.uniform(-max_shift, max_shift, 3)
        out[i, 3, 3] = 1.0
    return out


def _rot():
    import numpy as np
    return np.array([[np.cos(TH), -np.sin(TH), 0],
                     [np.sin(TH), np.cos(TH), 0], [0, 0, 1]], np.float32)


def _ground_truth():
    """The Q -> P pose of the bench.py pairs (q = R p + t)."""
    import numpy as np
    rot = _rot().astype(np.float64)
    gt = np.eye(4)
    gt[:3, :3] = rot.T
    gt[:3, 3] = -rot.T @ np.array(SHIFT)
    return gt


def _ultra_pair():
    """The 1M-point pair of bench.py:109-123 (numpy seed 0)."""
    import numpy as np
    rng = np.random.default_rng(0)
    n = 1_000_000
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    bump = (1 + 0.3 * np.sin(5 * v[:, 0]) * np.cos(3 * v[:, 1])
            + 0.2 * np.sin(4 * v[:, 2]))
    upos = (v * bump[:, None]).astype(np.float32)
    uq = (upos @ _rot().T + np.float32(SHIFT)).astype(np.float32)
    uq += rng.normal(scale=0.001, size=uq.shape).astype(np.float32)
    return upos, uq


def _headline_options(s4):
    """The headline registration's options (delta 0.01, n = 8192)."""
    return (s4.Options(delta=0.01, sample_size=8192, max_time_seconds=120,
                       random_seed=1)
            .configure_overlap(0.7, terminate_threshold=0.7))


def _samples(s4, P, Q, delta, n, seed, dev):
    """(P's samples, Q's samples in kd order), each centered, on ``dev``:
    the clouds the matcher verifies against, as it forms them."""
    import numpy as np
    import torch
    from super4pcs_tpu_torch.ops import sampling
    rng = np.random.default_rng(seed)
    sp = sampling.sample_for_matching(s4.PointCloud(P), delta, n, False, rng)
    sq = sampling.sample_for_matching(s4.PointCloud(Q), delta, n, True, rng)
    sq = sq.take(sampling.kd_argsort(sq.pos))
    return (torch.as_tensor(sp.pos - sp.pos.mean(0), device=dev),
            torch.as_tensor(sq.pos - sq.pos.mean(0), device=dev))


def _ultra_samples(s4, upos, uq, dev):
    """The 1M config's samples (delta 0.005, n = 16384, seed 5):
    Np = 530,895 and nq = 16384, or a SystemExit."""
    up, uqp = _samples(s4, upos, uq, 0.005, 16384, 5, dev)
    if up.shape[0] != 530_895 or uqp.shape[0] != 16384:
        raise SystemExit("the 1M config's samples changed size")
    return up, uqp


def _pose_sampler(dev, seed: int = 0):
    """``near_pose(c)``: (c, 4, 4) candidates near the bench pairs' pose
    (rotation part, in the centered frames), as the verify sees them once
    a step finds the overlap, drawn in turn from one numpy generator: the
    pruned kernels' work depends on where the queries land."""
    import numpy as np
    import torch
    trng = np.random.default_rng(seed)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = _rot().T

    def near_pose(c):
        return torch.as_tensor(pose @ _random_transforms(trng, c, 0.05,
                                                         0.02), device=dev)
    return near_pose


def _filtered_clouds(P, Q, s4):
    """The headline pair with radial normals (Q's rotated with the pair)
    and colors abs(pos) * 200 carried by index, as
    tools/parity_configs.py:105-121 builds them."""
    import numpy as np
    normal = (P / np.linalg.norm(P, axis=1, keepdims=True)).astype(
        np.float32)
    rgb = (np.abs(P) * 200).astype(np.float32)
    return (s4.PointCloud(P, normal=normal, rgb=rgb),
            s4.PointCloud(Q, normal=(normal @ _rot().T).astype(np.float32),
                          rgb=rgb))


def _counters() -> dict:
    """Every kernel wrapper's launch counters by name: (object,
    attribute)."""
    from super4pcs_tpu_torch.kernels import join as kj
    from super4pcs_tpu_torch.kernels import lcp as k1
    from super4pcs_tpu_torch.kernels import rowcap as k2
    from super4pcs_tpu_torch.kernels import rowcap_layout as k2x
    return {"lcp_min_d2_within": (k1.lcp_min_d2_within, "launches"),
            "lcp_min_d2": (k1.lcp_min_d2, "launches"),
            "rowcap_capture": (k2.rowcap_capture, "launches"),
            "rowcap_capture_captures": (k2.rowcap_capture, "captures"),
            "rowcap_capture_filtered": (k2.rowcap_capture,
                                        "filtered_launches"),
            "rowcap_layout": (k2x.rowcap_layout, "launches"),
            "rowcap_layout_captures": (k2x.rowcap_layout, "captures"),
            "nearest_within": (k1.nearest_within, "launches"),
            "grid_join": (kj.grid_join, "launches")}


def _run_path(label, fn, counters):
    """Run one path with every launch count set to 0 just before it;
    returns (its result, the counts just after, wall seconds, peak MiB)."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for obj, attr in counters.values():
        setattr(obj, attr, 0)
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: getattr(obj, attr) for k, (obj, attr) in counters.items()}
    peak = torch.cuda.max_memory_allocated() / 2**20
    _log(f"{label} launches: {counts}; max_memory_allocated "
         f"{peak:.1f} MiB")
    return res, counts, wall, peak


def _refine_launches(label, res, counts, iters: int) -> int:
    """The refines of one registration (the "refine" spans of its span
    table), each an ICP loop of ``iters`` iterations that launches KR
    once an iteration: its launch count and the table's
    ``refine_walks`` must both be ``iters`` x the refines, and at least
    one refine must have run. Returns the refines."""
    table = res.stats["spans"]
    refines = sum(row["count"] for path, row in table["spans"].items()
                  if path.rsplit("/", 1)[-1] == "refine")
    walks, launched = table["refine_walks"], counts["nearest_within"]
    _log(f"{label} refines: {refines}, refine_walks {walks}, KR launches "
         f"{launched} ({iters} a refine)")
    if not (refines >= 1 and walks == launched == iters * refines):
        raise SystemExit(f"{label}: the refines did not launch KR "
                         f"{iters} times each")
    return refines


def _refine_walk_rows(p_pos, q_pos, delta, dev) -> dict:
    """Phase 3c: KR (``kernels/lcp.py::nearest_within``) on the
    headline's samples under a pose near the true one, at the trim
    radius of the search factors in ``KR_FACTORS``: bit for bit its
    plain walk, the same neighbour as the brute force (``ops/refine.py::
    _nearest``, the refine's step before the walk) on at least 99.9% of
    the queries within the radius; its time (P's index built beforehand),
    pair tests a query, bound and plain time, the brute force's time,
    and a whole refine (8 iterations) with the walk and with the brute
    force, their transforms within 1e-5. Returns the rows by factor."""
    import numpy as np
    import torch
    from super4pcs_tpu_torch.kernels import lcp as k1
    from super4pcs_tpu_torch.ops import refine
    pose = _pose_sampler(dev)(1)[0].contiguous()
    q, p = q_pos, p_pos
    nq, np_ = q.shape[0], p.shape[0]
    tq = q @ pose[:3, :3].T + pose[:3, 3]
    idx, d2 = refine._nearest(tq, p)
    rows = {}
    for sf in KR_FACTORS:
        r = refine.trim_radius(delta, 8, sf)
        index = k1.grid_index(p, r)
        got = k1.nearest_within(pose, q, p, r, index)
        plain = k1.nearest_within_plain(pose, q, p, r, index)
        torch.cuda.synchronize()
        same = torch.equal(got, plain)
        within = d2 <= float(np.float32(r) * np.float32(r))
        agree = ((got[:, :3] == p[idx]).all(1) & within).sum()
        agree_share = int(agree) / max(int(within.sum()), 1)
        found = int(torch.isfinite(got[:, 3]).sum())
        del plain
        ms = _kernel_ms(lambda: k1.nearest_within(pose, q, p, r, index),
                        KR_NAME, reps=20)
        plain_ms = _cuda_ms(
            lambda: k1.nearest_within_plain(pose, q, p, r, index), reps=3)
        brute_ms = _cuda_ms(lambda: refine._nearest(tq, p), reps=5)
        tests = k1.pair_tests(pose[None], q, p, r)
        # the pair tests at K1's operations each; the transform, Q, P's
        # index (float4 points, int32 keys) and its grid read once, the
        # (x, y, z, d^2) rows written once
        bound_ms, bound_by = _bound(
            K1_OPS * tests, 4 * (16 + 3 * nq + 5 * np_ + 4 * nq + 7))

        def walk():
            return refine.refine_transform(pose, q, p, delta,
                                           start_factor=sf, index=index)

        def brute():
            return refine._icp(pose, q, refine._radii(delta, 8, sf),
                               refine._brute(q, p))
        err = float((walk() - brute()).abs().max())
        refine_ms = _cuda_ms(walk, reps=5)
        refine_brute_ms = _cuda_ms(brute, reps=3)
        _log(f"KR refine walk {sf:g}x: nq={nq} np={np_} radius={r:.6g} "
             f"equal to plain walk={same} found={found} same neighbour as "
             f"the brute force on {100 * agree_share:.3f}% of the queries "
             f"within the radius; pair tests {tests / nq:.1f} per query "
             f"(brute force {np_}); kernel {ms:.4f} ms plain "
             f"{plain_ms:.3f} ms bound {bound_ms:.5f} ms ({bound_by}), "
             f"brute force {brute_ms:.3f} ms; a refine (8 iterations) "
             f"{refine_ms:.2f} ms with the walk, {refine_brute_ms:.2f} ms "
             f"with the brute force, max|dT| {err:.3e}")
        if not (same and agree_share >= 0.999 and err <= 1e-5):
            raise SystemExit(f"KR at {sf:g}x the trim radius disagrees "
                             f"with its plain walk or the brute force")
        rows[f"{sf:g}x"] = dict(
            shape=f"nq={nq} np={np_} radius={r:.6g}", ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=None, pair_tests_per_query=tests / nq,
            brute_force_ms=brute_ms, same_neighbour_share=agree_share,
            refine_ms=refine_ms, refine_brute_force_ms=refine_brute_ms,
            refine_max_abs_err=err)
    return rows


def _step_joins(s4, p_pos, q_pos, opts, sets: int, factor: float, dev):
    """The (args, kwargs) of the grid join a rowcap step makes over
    ``sets`` copies of the headline's samples (T = 16 x sets) at the
    search factor ``factor``, recorded from one step of the step
    function the matcher builds (``matcher.build_step``)."""
    import torch
    from super4pcs_tpu_torch import matcher
    from super4pcs_tpu_torch.kernels import rowcap as k2
    from super4pcs_tpu_torch.ops import congruent
    from super4pcs_tpu_torch.ops import lcp as ops_lcp
    o = opts.replace(search_delta_factor=factor)
    step, _ = matcher.build_step(o, q_pos.shape[0], o.cone_cos_tolerance)
    pp = p_pos[None].expand(sets, -1, -1).contiguous()
    qq = q_pos[None].expand(sets, -1, -1).contiguous()
    z = torch.zeros_like(pp)
    zq = torch.zeros_like(qq)
    diam = torch.full((sets,), float(2.0 * torch.linalg.vector_norm(
        q_pos, dim=1).max()), device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    seen = []
    real = congruent.find_congruent_quads_grid

    def recording(*args, **kwargs):
        seen.append((args, kwargs))
        return real(*args, **kwargs)

    congruent.find_congruent_quads_grid = recording
    try:
        step(gen, diam, pp, z, z - 1, qq, zq, zq - 1, k2.reject_bounds(qq),
             ops_lcp.VerifyIndex(pp))
    finally:
        congruent.find_congruent_quads_grid = real
    return seen[0]


def _join_rows(s4, p_pos, q_pos, opts, dev) -> dict:
    """Phase 3d: KJ (``kernels/join.py::grid_join``) on the joins of a
    rowcap step over the headline's samples, T 16 and T 64, at each
    search factor of ``KJ_FACTORS``: bit for bit the plain join (the
    sort route), the device time of both (every kernel of a call,
    profiler), KJ's kernels' shares, the wall of both (CUDA events),
    and the bound: the table hash and the second table's mask read
    once and the quads written once, at the memory rate. Returns the
    rows by shape."""
    import torch
    from super4pcs_tpu_torch.kernels import join as kj
    from super4pcs_tpu_torch.ops import congruent
    rows = {}
    for sets in (1, 4):
        for sf in KJ_FACTORS:
            args, kwargs = _step_joins(s4, p_pos, q_pos, opts, sets, sf, dev)

            def kernel():
                return congruent.find_congruent_quads_grid(*args, **kwargs)

            def plain():
                takes = kj.takes
                kj.takes = lambda *a: False
                try:
                    return congruent.find_congruent_quads_grid(*args,
                                                               **kwargs)
                finally:
                    kj.takes = takes
            before = kj.grid_join.launches
            got = kernel()
            launched = kj.grid_join.launches - before
            want = plain()
            torch.cuda.synchronize()
            same = all(_same_bits(a, b) for a, b in zip(got, want))
            nt, k1 = kwargs["table_hash"].shape
            k2_ = args[4].shape[1]
            cap = args[10]
            w = congruent.probe_window(args[7], kwargs["cell_size"])
            evs = _device_events(lambda: [kernel() for _ in range(10)])
            by_kernel = collections.Counter()
            for name, t, _ in evs:
                key = re.search(KJ_PREFIX + r"\w+|Memset", name)
                by_kernel[key.group(0) if key else name[:48]] += t / 10e3
            ms = sum(by_kernel.values())
            plain_ms = _device_ms(plain, reps=3)
            wall_ms = _cuda_ms(kernel, reps=10)
            plain_wall_ms = _cuda_ms(plain, reps=3)
            # the hash (4 bytes a slot) and the mask (1) read once, the
            # quads (32 bytes), their mask and the counters written once
            bound_ms, bound_by = _bound(
                0.0, nt * (5.0 * k1 + 1.0 * k2_ + 33.0 * cap + 24.0))
            label = f"T={nt} w={w}"
            _log(f"KJ join {label}: k1={k1} probes/trial="
                 f"{min(kwargs['q_budget'] or 8192, k2_) * w ** 3} "
                 f"budget={kwargs['probe_budget']} launches={launched} "
                 f"equal to plain={same} quads={int(want[2].sum())} "
                 f"dropped={int(want[3].sum())}; kernel {ms:.4f} ms "
                 f"(wall {wall_ms:.4f}) plain {plain_ms:.4f} ms (wall "
                 f"{plain_wall_ms:.4f}) bound {bound_ms:.5f} ms "
                 f"({bound_by}); by kernel: " + ", ".join(
                     f"{k} {v:.4f}" for k, v in by_kernel.most_common()))
            if not (same and launched == 1):
                raise SystemExit(f"KJ at {label} disagrees with the plain "
                                 f"join or did not launch once")
            rows[label] = dict(
                shape=f"T={nt} nq={q_pos.shape[0]} k1={k1} w={w}", ms=ms,
                plain_ms=plain_ms, wall_ms=wall_ms,
                plain_wall_ms=plain_wall_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None,
                by_kernel=dict(by_kernel))
            del got, want
    return rows


def _step_split(P, Q, opts, s4) -> dict:
    """The headline registration with ``Options.phase_timing``: its
    step's phases (``stats["phase_seconds"]``, ms) and the kernel nodes
    of its captured step, the join kernel's among them."""
    m = s4.MatchSuper4PCS(opts.replace(phase_timing=True), device="cuda")
    res = m.compute_transformation(s4.PointCloud(P), s4.PointCloud(Q))
    split = {k: 1e3 * v for k, v in res.stats["phase_seconds"].items()}
    m._capture()
    with tempfile.TemporaryDirectory() as tmp:
        nodes = m._graph.kernel_nodes(os.path.join(tmp, "graph.dot"))
    join_nodes = sum(KJ_PREFIX in n for n in nodes)
    _log(f"headline step split (ms): " + ", ".join(
        f"{k} {v:.3f}" for k, v in split.items())
         + f"; graph kernel nodes {len(nodes)}, of the join kernel "
         f"{join_nodes} ({sum(KJ_NAME in n for n in nodes)} launch)")
    return dict(phase_ms=split, graph_kernel_nodes=len(nodes),
                join_kernel_nodes=join_nodes)


def _headline_path(P, Q, opts, s4, counters, by_path, report):
    """Phase 5: the headline registration through the public entry
    point, K1, K2 and (per refine) KR launched; returns (its result, its
    pairs per step)."""
    res, counts, wall, peak = _run_path(
        "headline", lambda: s4.MatchSuper4PCS(
            opts, device="cuda").compute_transformation(
                s4.PointCloud(P), s4.PointCloud(Q)), counters)
    by_path["headline"] = counts
    if min(counts["lcp_min_d2_within"], counts["rowcap_capture"]) <= 0:
        raise SystemExit("a kernel of the main path never launched")
    _refine_launches("headline", res, counts, opts.refine_iterations)
    return res, report("headline", res, wall, peak)


def _seed_runs(seeds, opts, fopts, clouds, s4):
    """The headline and filtered registrations per seed, rejection on
    and off in alternating order; prints each run and the medians."""
    import numpy as np
    gt = _ground_truth()
    for label, base, (cp, cq) in (("headline", opts, clouds[0]),
                                  ("filtered", fopts, clouds[1])):
        search = {True: [], False: []}
        for i, seed in enumerate(seeds):
            order = (True, False) if i % 2 == 0 else (False, True)
            for reject in order:
                o = base.replace(random_seed=seed, rowcap_tile_reject=reject)
                res = s4.MatchSuper4PCS(o, device="cuda") \
                    .compute_transformation(cp, cq)
                rot_diff, tr_diff = s4.reference_pose_diff(res.transform,
                                                           gt)
                st = res.stats["search_seconds"]
                search[reject].append(st)
                _log(f"seeds {label} seed={seed} reject={reject}: "
                     f"score={res.score:.4f} trials={res.n_trials} "
                     f"search_s={st:.3f} rotDiff={rot_diff:.4f} "
                     f"trDiff={tr_diff:.4f} escalated_to="
                     f"{res.stats.get('escalated_to', '-')}")
        _log(f"seeds {label}: median search_s rejection on "
             f"{np.median(search[True]):.3f}, off "
             f"{np.median(search[False]):.3f}")


def _xla_seed_runs(seeds, P, Q, s4):
    """Phase 5r once per seed (the headline on the XLA route): each
    run's search seconds, steps, trials, LCP and pose; then the medians
    of search seconds and steps."""
    import numpy as np
    gt = _ground_truth()
    base = _headline_options(s4).replace(rowcap_kernel="xla")
    search, steps = [], []
    for seed in seeds:
        m = s4.MatchSuper4PCS(base.replace(random_seed=seed), device="cuda")
        res = m.compute_transformation(s4.PointCloud(P), s4.PointCloud(Q))
        rot_diff, tr_diff = s4.reference_pose_diff(res.transform, gt)
        st = res.stats["search_seconds"]
        k = max(res.n_trials // m._b_eff, 1)
        search.append(st)
        steps.append(k)
        _log(f"seeds xla-rowcap seed={seed}: score={res.score:.4f} "
             f"trials={res.n_trials} steps={k} search_s={st:.3f} "
             f"rotDiff={rot_diff:.4f} trDiff={tr_diff:.4f} "
             f"escalated_to={res.stats.get('escalated_to', '-')}")
        del m
    _log(f"seeds xla-rowcap: median search_s {np.median(search):.3f}, "
         f"median steps {np.median(steps):.0f}")


def _read_polyworks(path):
    """The 4x4 matrix of a Polyworks matrix file (the CLI's ``-m``)."""
    import numpy as np
    with open(path) as f:
        lines = f.read().splitlines()
    if lines[:2] != ["VERSION\t=\t1", "MATRIX\t="] or len(lines) != 6:
        raise SystemExit(f"{path} is not a Polyworks matrix file")
    return np.array([[float(x) for x in ln.split()] for ln in lines[2:]])


@contextlib.contextmanager
def _recording(module, runs):
    """Within the block, the matchers that ``module`` (``cli`` or
    ``api``) builds append ``(matcher, result)`` to ``runs`` as each run
    ends: the CLI prints the score, not the stats (search seconds,
    trials, overflow counters), and a hierarchical scale run's coarse
    and fine phases are matchers of the same class, recorded before
    their composed result."""
    saved = module.MatchSuper4PCS, module.Match4PCS

    def recorded(cls):
        class Recorded(cls):
            def compute_transformation(self, *args, **kw):
                res = super().compute_transformation(*args, **kw)
                runs.append((self, res))
                return res
        return Recorded

    module.MatchSuper4PCS, module.Match4PCS = (recorded(c) for c in saved)
    try:
        yield
    finally:
        module.MatchSuper4PCS, module.Match4PCS = saved


def _bumpy_mesh(n_lat=150, n_lon=200):
    """A bumpy-sphere grid mesh (the bench.py surface on a latitude x
    longitude grid, poles left out): (n_lat * n_lon, 3) positions,
    unit vertex normals (area-weighted face normals) and the triangles,
    int32."""
    import numpy as np
    th = np.linspace(0.0, np.pi, n_lat + 2)[1:-1]
    ph = np.linspace(0.0, 2.0 * np.pi, n_lon, endpoint=False)
    t, f = np.meshgrid(th, ph, indexing="ij")
    v = np.stack([np.sin(t) * np.cos(f), np.sin(t) * np.sin(f), np.cos(t)],
                 -1).reshape(-1, 3)
    bump = (1 + 0.3 * np.sin(5 * v[:, 0]) * np.cos(3 * v[:, 1])
            + 0.2 * np.sin(4 * v[:, 2]))
    pos = v * bump[:, None]
    i, j = np.meshgrid(np.arange(n_lat - 1), np.arange(n_lon), indexing="ij")
    a, b = i * n_lon + j, i * n_lon + (j + 1) % n_lon
    c, d = a + n_lon, b + n_lon
    tris = np.concatenate([np.stack([a, b, d], -1).reshape(-1, 3),
                           np.stack([a, d, c], -1).reshape(-1, 3)])
    fn = np.cross(pos[tris[:, 1]] - pos[tris[:, 0]],
                  pos[tris[:, 2]] - pos[tris[:, 0]])
    nrm = np.zeros_like(pos)
    for k in range(3):
        np.add.at(nrm, tris[:, k], fn)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return (pos.astype(np.float32), nrm.astype(np.float32),
            tris.astype(np.int32))


def _axis_rot(axis, ang):
    """Rotation of ``ang`` radians about ``axis`` (Rodrigues)."""
    import numpy as np
    k = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(ang) * kx + (1 - np.cos(ang)) * kx @ kx


def _recipe_pair():
    """The verify skill's 500-point known-pose recipe: (target, source),
    source = target moved by a rotation of 1.1 rad about z."""
    import numpy as np
    r2 = np.random.default_rng(11)
    v = r2.normal(size=(500, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    bump = (1 + 0.3 * np.sin(5 * v[:, 0]) * np.cos(3 * v[:, 1])
            + 0.2 * np.sin(4 * v[:, 2]))
    target = (v * bump[:, None]).astype(np.float32)
    ang = 1.1
    R = np.array([[np.cos(ang), -np.sin(ang), 0],
                  [np.sin(ang), np.cos(ang), 0], [0, 0, 1]], np.float32)
    return target, (target - np.array([.4, -.2, .7], np.float32)) @ R


def _mesh_pair():
    """Phase 5e's meshes: the 30,000-vertex bumpy-sphere grid and its
    copy rotated by 0.6 rad about (1, 1, 0) and shifted. Returns
    (positions, normals, triangles, moved positions, moved normals, the
    ground truth of the copy onto the first)."""
    import numpy as np
    mpos, mnrm, tris = _bumpy_mesh()
    rot = _axis_rot([1, 1, 0], 0.6)
    shift = np.array([0.05, 0.1, -0.1])
    mgt = np.eye(4)
    mgt[:3, :3] = rot.T
    mgt[:3, 3] = -rot.T @ shift
    return (mpos, mnrm, tris, (mpos @ rot.T + shift).astype(np.float32),
            (mnrm @ rot.T).astype(np.float32), mgt)


def _synth_model():
    """bench.py's 4000-point synthetic sequence model (numpy seed 7)."""
    import numpy as np
    rng = np.random.default_rng(7)
    v = rng.normal(size=(4000, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    bump = (1 + 0.3 * np.sin(5 * v[:, 0]) * np.cos(3 * v[:, 1])
            + 0.2 * np.sin(4 * v[:, 2]))
    return (v * bump[:, None]).astype(np.float32)


def _sequence_options(s4):
    """Phase 5g's options for bench.py's synthetic sequence (before its
    overlap is configured)."""
    return s4.Options(delta=0.03, sample_size=300, max_time_seconds=90,
                      bases_per_step=16, max_quads=2048, max_candidates=4096,
                      p_sample_budget=1024, random_seed=5)


def _scale_options(s4):
    """Phase 5h's options (hierarchical similarity at 16384 samples)."""
    return s4.Options(delta=0.05, sample_size=16384, estimate_scale=True,
                      random_seed=21, max_time_seconds=60
                      ).configure_overlap(0.6, 0.9)


def _dense_cases(s4, obj_dir):
    """The dense engine's four paths, each as its phase forms the pair it
    registers first: (label, matcher class, options, P, Q). The recipe
    (phase 6, ``register``'s options); 5e's ``-x`` CLI run (the CLI's
    options, the clouds read from the OBJ files it reads, written to
    ``obj_dir``; returns their read time and tier beside); 5g's first
    sequence step (view 0 onto view 1); 5h's coarse phase (its options
    at scale_max_q samples, as the hierarchical solve forms them)."""
    import numpy as np
    from super4pcs_tpu_torch import cli
    from super4pcs_tpu_torch import io as sio
    from super4pcs_tpu_torch.utils import Logger, LogLevel
    cases = []
    target, source = _recipe_pair()
    cases.append(("recipe", s4.MatchSuper4PCS, s4.Options().configure_overlap(
        0.9).replace(delta=0.05, sample_size=500, max_time_seconds=30),
        s4.PointCloud(target), s4.PointCloud(source)))
    mpos, mnrm, tris, mpos2, mnrm2, _ = _mesh_pair()
    mesh = sio.Mesh(tris=tris, tri_norm=tris)
    paths = [os.path.join(obj_dir, f"d{i}.obj") for i in (1, 2)]
    for path, pos, nrm in zip(paths, (mpos, mpos2), (mnrm, mnrm2)):
        sio.write_obj(path, s4.PointCloud(pos, normal=nrm), mesh)
    a = cli.Args()
    cli.get_args(["super4pcs-torch", "-i", *paths, "-x", "-n", "200", "-o",
                  "0.9", "-d", "0.05", "-t", "10", "--tpu-opts",
                  "random_seed=1"], a)
    clouds = [sio.read_object(path)[0] for path in paths]
    cases.append(("cli-4pcs-mesh", s4.Match4PCS,
                  cli.options_from_args(a, Logger(LogLevel.NoLog)),
                  *clouds))
    scans, _ = _sequence_views(_synth_model())
    cases.append(("sequence", s4.MatchSuper4PCS,
                  _sequence_options(s4).configure_overlap(0.5, 0.6),
                  s4.PointCloud(scans[0]), s4.PointCloud(scans[1])))
    opts = _scale_options(s4)
    P, Q = _scale_pair()
    cases.append(("scale-coarse", s4.MatchSuper4PCS, opts.replace(
        sample_size=opts.scale_max_q,
        max_time_seconds=max(opts.max_time_seconds * 0.4, 1.0)),
        s4.PointCloud(P), s4.PointCloud(Q)))
    return cases


def _dense_step_profile(label, cls, opts, P, Q, check_trials=True):
    """Phase 5p for one dense path: a matcher formed as the path forms it
    (its samples, its step), then, outside every path, its step's
    launches (kernels in a profiled step), wall (4 unprofiled steps),
    device busy time, idle share and peak device memory; the launches of
    the same step's ``run`` over its B bases and over one of them (the
    trial axis must not add launches: at most 2x); and, with
    ``check_trials``, every trial of the batched trial function equal to
    its one-base call bit for bit (transform, cvalid, quads, counts).
    Returns the numbers."""
    import torch
    from super4pcs_tpu_torch import matcher as mt
    m = cls(opts, device="cuda")
    m._init(P, Q)
    nq = int(m._d_q_pos.shape[0])
    opts_eff = m._opts_eff()
    engine = mt.resolve_pair_engine(opts_eff, nq)
    if engine != "dense":
        raise SystemExit(f"5p {label}: the {engine!r} engine at nq={nq}")
    b = m._b_eff
    for i in range(2):
        m._run_step(i)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    m._run_step(2)
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    t0 = time.perf_counter()
    for i in range(3, 7):
        m._run_step(i)
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0) / 4
    evs = _device_events(lambda: [m._run_step(i) for i in (7, 8)])
    busy = sum(t for _, t, _ in evs) / 2 / 1e3
    kernels = len(evs) / 2

    step = m._step_fn
    diam = m._max_base_diameter
    args = m._step_args()
    m._gen.manual_seed(mt._step_seed(opts.random_seed, 9))
    draws = step.draw(m._gen, 1, int(m._d_p_pos.shape[0]))
    one = tuple(d[:, :1] for d in draws)

    def fetch(ds):
        return {k: v.cpu() for k, v in step.run(ds, diam, *args).items()}

    fetch(draws), fetch(one)
    run_b = len(_device_events(lambda: [fetch(draws) for _ in range(2)])) / 2
    run_1 = len(_device_events(lambda: [fetch(one) for _ in range(2)])) / 2
    out = dict(nq=nq, np=int(m._d_p_pos.shape[0]), B=b,
               k_pairs=m._k_pairs, step_kernels=kernels, step_wall_ms=wall, step_busy_ms=busy,
               idle_share=1.0 - busy / wall, peak_mib=peak,
               run_kernels_B=run_b, run_kernels_1=run_1)
    same = None
    if check_trials:
        tb, _ = mt._build_try_bases(opts_eff, nq, m._cone_mode)

        def trials(lo, hi):
            rot = tuple(r[:, lo:hi].reshape(-1) for r in draws[3:]) or None
            return tb(tuple(d[:, lo:hi] for d in draws[:3]), diam,
                      *args[:7], rot)

        full = trials(0, b)
        same = True
        for t in range(b):
            single = trials(t, t + 1)
            for k in ("transform", "cvalid", "quads", "counts"):
                x, y = full[k][t], single[k][0]
                same &= bool(((x == y) | (x != x) & (y != y)).all())
        out["trials_equal"] = same
    _log(f"5p {label}: nq={nq} np={out['np']} B={b} k_pairs="
         f"{m._k_pairs}; a step: {kernels:.0f} kernels, wall "
         f"{wall:.1f} ms, device busy {busy:.1f} ms (idle share "
         f"{100 * out['idle_share']:.0f}%), peak {peak:.1f} MiB; the run "
         f"over B={b} bases {run_b:.0f} kernels, over 1 base {run_1:.0f}"
         + ("" if same is None else
            f"; every trial equal to its one-base call={same}"))
    if check_trials:
        if run_b > 2 * run_1:
            raise SystemExit(f"5p {label}: the step over {b} bases launched "
                             f"{run_b:.0f} kernels, over one {run_1:.0f}")
        if not same:
            raise SystemExit(f"5p {label}: a trial of the batched step "
                             f"differs from its one-base call")
    return out


def _same_bits(a, b) -> bool:
    """Whether two arrays (numpy or torch) hold the same dtype, shape
    and bytes: equal bit for bit, NaNs included."""
    import numpy as np
    a, b = (x.detach().cpu().numpy() if hasattr(x, "detach") else
            np.asarray(x) for x in (a, b))
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.tobytes() == b.tobytes())


def _launch_counts():
    from super4pcs_tpu_torch.utils.graphs import COUNTERS
    return [getattr(o, a) for o, a in COUNTERS]


def _graph_kernels(graph):
    """The kernel nodes of a captured graph (utils/graphs.StepGraph),
    from CUDA's own dump of it: (their number, {counter: the nodes of
    that counter's kernel}) for the kernels the port's launch counters
    count. Exact, where the profiler can drop records of a replay's
    kernels."""
    from super4pcs_tpu_torch.kernels import join as kj
    from super4pcs_tpu_torch.kernels import lcp as k1
    from super4pcs_tpu_torch.kernels import rowcap as k2
    from super4pcs_tpu_torch.kernels import rowcap_layout as k2x
    with tempfile.TemporaryDirectory() as tmp:
        nodes = graph.kernel_nodes(os.path.join(tmp, "graph.dot"))
    if not nodes:
        raise SystemExit("the dump of a captured step lists no kernel")
    named = {(k1.lcp_min_d2_within, "launches"): K1W_NAME,
             (k1.lcp_min_d2, "launches"): K1B_NAME,
             (k2.rowcap_capture, "launches"): K2_NAME,
             (k2x.rowcap_layout, "launches"): K2X_NAME,
             (k1.nearest_within, "launches"): KR_NAME,
             (kj.grid_join, "launches"): KJ_NAME}
    return len(nodes), {c: sum(name in n for n in nodes)
                        for c, name in named.items()}


def _recorded_matches_nodes(graph) -> bool:
    """Whether the launches a capture recorded (``graph.launches``) are
    the kernel nodes of its graph, counter by counter."""
    _, by_counter = _graph_kernels(graph)
    rec = dict(zip(graph.launches.counters, graph.launches.increments))
    return all(rec[c] == n for c, n in by_counter.items())


def _graph_check(label, cls, opts, P, Q):
    """Phase 5q, one engine: a matcher formed as its path forms it
    (which captures its step), then two steps replayed from the capture
    and the same steps launched op by op: every output equal bit for bit
    (lcp, rank_lcp, transform, centroids, base and congruent ids,
    n_congruent, cands_dropped, the per-trial counts), the replay's
    launch counts the eager step's, and the launches the capture
    recorded the kernel nodes of its graph (CUDA's dump, counter by
    counter: K1, the brute force, K2, K2x); and the step's trial function
    captured alone (utils/graphs.StepGraph) against its eager call on
    the same draws: transform, cvalid, quads and counts bit for bit."""
    import torch
    from super4pcs_tpu_torch import matcher as mt
    from super4pcs_tpu_torch.utils.graphs import StepGraph
    m = cls(opts, device="cuda")
    m._init(P, Q)
    nq = int(m._d_q_pos.shape[0])
    engine = mt.resolve_pair_engine(m._opts_eff(), nq)
    if m._graph is None:
        raise SystemExit(f"5q {label}: the run captured no step")
    same, launches = True, []
    for i in (0, 1):
        c0 = _launch_counts()
        g = m._run_step(i)
        c1 = _launch_counts()
        e = m._run_step(i, eager=True)
        c2 = _launch_counts()
        same &= set(g) == set(e) and all(_same_bits(g[k], e[k]) for k in e)
        launches.append(([b - a for a, b in zip(c0, c1)],
                         [b - a for a, b in zip(c1, c2)]))
    n_nodes, by_counter = _graph_kernels(m._graph)
    rec = dict(zip(m._graph.launches.counters,
                   m._graph.launches.increments))
    nodes_match = all(rec[c] == n for c, n in by_counter.items())
    tb, _ = mt._build_try_bases(m._opts_eff(), nq, m._cone_mode,
                                m._band_index)
    diam, args = m._max_base_diameter, m._step_args()

    def trials(*d):
        rot = tuple(r.reshape(-1) for r in d[3:]) or None
        return tb(d[:3], diam, *args[:7], rot)

    draws = m._draws(2)
    graph = StepGraph(trials, draws, device="cuda")
    got = {k: v.clone() for k, v in graph(*draws).items()}
    want = trials(*draws)
    torch.cuda.synchronize()
    trials_same = all(_same_bits(got[k], want[k])
                      for k in ("transform", "cvalid", "quads", "counts"))
    counted = all(a == b for a, b in launches)
    _log(f"5q {label}: engine={engine} nq={nq} B={m._b_eff}; graphed "
         f"steps equal to eager bit for bit={same}; the trial function "
         f"captured alone equal to eager={trials_same}; launches a "
         f"replayed step {launches[0][0]}, an eager one {launches[0][1]}; "
         f"the graph: {n_nodes} kernel nodes, of them K1 / brute force / "
         f"K2 / K2x {list(by_counter.values())}, recorded launches equal to "
         f"them={nodes_match}")
    if not (same and trials_same and counted and nodes_match):
        raise SystemExit(f"5q {label}: a graphed step differs from the "
                         f"eager one, or its launch counts do, or the "
                         f"capture's record differs from its graph")
    del m, graph
    torch.cuda.empty_cache()
    return dict(engine=engine, nq=nq, equal=same, trials_equal=trials_same,
                step_launches=launches[0][0], graph_kernel_nodes=n_nodes,
                graph_nodes_by_counter=list(by_counter.values()))


def _dispatch_paths(s4, obj_dir, P, Q, fP, fQ):
    """Phase 5q: the graphed step against the eager one on each engine
    (:func:`_graph_check`). Returns the numbers."""
    opts = _headline_options(s4)
    fopts = (s4.Options(delta=0.01, sample_size=8192,
                        max_normal_difference=20.0, max_color_distance=60.0,
                        max_time_seconds=120, random_seed=1)
             .configure_overlap(0.7, terminate_threshold=0.7))
    aopts = _scale_aopts(s4)
    SP, SQ = _scale_pair()
    dense = {c[0]: c for c in _dense_cases(s4, obj_dir)}
    hP, hQ = s4.PointCloud(P), s4.PointCloud(Q)
    numbers = {}
    for label, cls, o, Pc, Qc in (
            ("headline", s4.MatchSuper4PCS, opts, hP, hQ),
            ("filtered", s4.MatchSuper4PCS, fopts, fP, fQ),
            ("banded", s4.MatchSuper4PCS,
             opts.replace(pair_engine="banded"), hP, hQ),
            ("scale-allpairs", s4.MatchSuper4PCS, aopts,
             s4.PointCloud(SP), s4.PointCloud(SQ)),
            ("xla-rowcap", s4.MatchSuper4PCS,
             opts.replace(rowcap_kernel="xla"), hP, hQ),
            ("similarity-rowcap", s4.MatchSuper4PCS,
             aopts.replace(pair_engine="rowcap"), s4.PointCloud(SP),
             s4.PointCloud(SQ)),
            dense["recipe"], dense["scale-coarse"]):
        numbers[label] = _graph_check(label, cls, o, Pc, Qc)
    return numbers


def _dense_paths(s4, obj_dir):
    """Phase 5p: :func:`_dense_step_profile` on each dense path."""
    return {label: _dense_step_profile(label, cls, opts, P, Q)
            for label, cls, opts, P, Q in _dense_cases(s4, obj_dir)}


def _timed_read(path):
    """Read ``path`` as the CLI does (``io.read_object``): (the cloud,
    its read ms, the parser tier that read it, the read ms of the numpy
    parser forced by SUPER4PCS_TPU_NO_NATIVE). The tier is "native"
    when the C++ parser takes the file, else "numpy"."""
    from super4pcs_tpu_torch import io as sio
    from super4pcs_tpu_torch.io import native
    parse = (native.native_parse_obj if path.endswith(".obj")
             else native.native_parse_ply)
    tier = "native" if parse(path) is not None else "numpy"
    t0 = time.perf_counter()
    cloud, _ = sio.read_object(path)
    read_ms = 1e3 * (time.perf_counter() - t0)
    os.environ["SUPER4PCS_TPU_NO_NATIVE"] = "1"
    try:
        t0 = time.perf_counter()
        sio.read_object(path)
        numpy_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        del os.environ["SUPER4PCS_TPU_NO_NATIVE"]
    return cloud, read_ms, tier, numpy_ms


def _cli_paths(P, Q, fP, fQ, s4, counters, by_path):
    """Phases 5c-5f: the CLI from files, each run a path of its own.
    Returns a dict of the numbers each run printed."""
    import io

    import numpy as np
    import torch
    from super4pcs_tpu_torch import cli
    from super4pcs_tpu_torch import io as sio
    from super4pcs_tpu_torch.ops import lcp

    dev = torch.device("cuda")
    gt = _ground_truth()
    p_full = torch.as_tensor(P, device=dev)

    def run(label, argv, mat, pose, need_k2):
        """cli.main(argv) as one path (its progress lines kept out of
        the log), then the gates: exit 0, K1 launched and K2 launched
        or not as ``need_k2`` says, the matrix file ``mat`` within
        rotDiff <= 0.2 / trDiff <= 0.1 of ``pose``."""
        runs, text = [], io.StringIO()

        def call():
            with _recording(cli, runs), contextlib.redirect_stdout(text):
                return cli.main(argv)

        rc, counts, wall, peak = _run_path(label, call, counters)
        by_path[label] = counts
        score = [ln for ln in text.getvalue().splitlines()
                 if ln.startswith("Score: ")]
        if rc != 0 or not runs:
            _log(text.getvalue()[-2000:])
            raise SystemExit(f"{label}: the CLI exited {rc}")
        res = runs[0][1]
        rot_diff, tr_diff = s4.reference_pose_diff(_read_polyworks(mat),
                                                   pose)
        st = res.stats
        _log(f"{label}: exit {rc}, {score[-1] if score else 'no score'} "
             f"trials={res.n_trials} search_s={st['search_seconds']:.3f} "
             f"wall_s={wall:.3f} rotDiff={rot_diff:.4f} trDiff="
             f"{tr_diff:.4f} quads_overflow={st['quads_overflow']} "
             f"pairs_overflow={st['pairs_overflow']} escalated_to="
             f"{st.get('escalated_to', '-')} peak_MiB={peak:.1f}")
        if counts["lcp_min_d2_within"] <= 0 or (
                (counts["rowcap_capture"] > 0) != need_k2):
            raise SystemExit(f"{label}: K1 launched "
                             f"{counts['lcp_min_d2_within']} times, K2 "
                             f"{counts['rowcap_capture']} (wanted "
                             f"{'some' if need_k2 else 'none'})")
        if not (rot_diff <= 0.2 and tr_diff <= 0.1):
            raise SystemExit(f"{label} missed the pose gates")
        return res, counts

    def out_lcp(path):
        """LCP of the registered geometry the CLI wrote against P (all
        points, at the run's delta)."""
        moved, _ = sio.read_object(path)
        q = torch.as_tensor(moved.pos, device=dev)
        return float(lcp.lcp_score_single(
            torch.eye(4, device=dev), q, p_full, 0.01))

    numbers = {}
    with tempfile.TemporaryDirectory() as tmp:
        def f(name):
            return os.path.join(tmp, name)

        # 5c. the headline from PLY files
        sio.write_ply(f("P.ply"), s4.PointCloud(P))
        sio.write_ply(f("Q.ply"), s4.PointCloud(Q))
        back, read_ms, tier, numpy_ms = _timed_read(f("P.ply"))
        if not np.array_equal(back.pos, P):
            raise SystemExit("the PLY round trip changed P")
        _log(f"PLY read of {len(P)} points (binary, positions only): "
             f"{read_ms:.1f} ms ({tier} parser; the numpy parser "
             f"{numpy_ms:.1f} ms)")
        base = ["super4pcs-torch", "-i", f("P.ply"), f("Q.ply"), "-o", "0.7",
                "-d", "0.01", "-n", "8192", "-t", "10", "-m", f("m.txt"),
                "-r", f("out.ply")]
        res, _ = run("cli", base + ["--tpu-opts", "random_seed=1"],
                     f("m.txt"), gt, True)
        lcp_c = out_lcp(f("out.ply"))
        _log(f"cli: LCP of the written geometry against P: {lcp_c:.4f}")
        if lcp_c < 0.7:
            raise SystemExit("cli: the written geometry misses LCP 0.7")
        numbers["cli"] = dict(search_s=res.stats["search_seconds"],
                              trials=res.n_trials, lcp=lcp_c,
                              ply_read_ms=read_ms, ply_tier=tier,
                              ply_numpy_read_ms=numpy_ms)

        # 5d. filtered: normals and colors through PLY, -a 20 -c 60
        sio.write_ply(f("fP.ply"), fP)
        sio.write_ply(f("fQ.ply"), fQ)
        argv = list(base)
        argv[2:4] = [f("fP.ply"), f("fQ.ply")]
        res, counts = run("cli-filtered", argv + [
            "-a", "20", "-c", "60", "--tpu-opts", "random_seed=1"],
            f("m.txt"), gt, True)
        if counts["rowcap_capture_filtered"] <= 0:
            raise SystemExit("cli-filtered: no filtered K2 launch")
        lcp_d = out_lcp(f("out.ply"))
        _log(f"cli-filtered: LCP of the written geometry against P: "
             f"{lcp_d:.4f}")
        if lcp_d < 0.7:
            raise SystemExit("cli-filtered: the written geometry misses "
                             "LCP 0.7")
        numbers["cli-filtered"] = dict(search_s=res.stats["search_seconds"],
                                       trials=res.n_trials, lcp=lcp_d)

        # 5e. 4PCS on a mesh at the reference demo's sample size (the
        # hippo demo's -n 200; the hippo assets are not in the repo)
        mpos, mnrm, tris, mpos2, mnrm2, mgt = _mesh_pair()
        mesh = sio.Mesh(tris=tris, tri_norm=tris)
        sio.write_obj(f("m1.obj"), s4.PointCloud(mpos, normal=mnrm), mesh)
        sio.write_obj(f("m2.obj"), s4.PointCloud(mpos2, normal=mnrm2), mesh)
        _, obj_ms, obj_tier, obj_numpy_ms = _timed_read(f("m1.obj"))
        _log(f"OBJ read of {len(mpos)} vertices, {len(tris)} a//n faces: "
             f"{obj_ms:.1f} ms ({obj_tier} parser; the numpy parser "
             f"{obj_numpy_ms:.1f} ms)")
        res, _ = run("cli-4pcs-mesh", [
            "super4pcs-torch", "-i", f("m1.obj"), f("m2.obj"), "-x", "-n",
            "200", "-o", "0.9", "-d", "0.05", "-t", "10", "-m", f("m.txt"),
            "-r", f("out.obj"), "--tpu-opts", "random_seed=1"],
            f("m.txt"), mgt, False)
        back, back_mesh = sio.read_object(f("out.obj"))
        err = float(np.median(np.linalg.norm(back.pos - mpos, axis=1)))
        _log(f"cli-4pcs-mesh: {len(mpos)} vertices, {len(tris)} faces; "
             f"written {len(back)} vertices, "
             f"{0 if back_mesh is None else len(back_mesh.tris)} faces, "
             f"median vertex error {err:.2e}")
        if back_mesh is None or not np.array_equal(back_mesh.tris, tris):
            raise SystemExit("cli-4pcs-mesh: the written OBJ lost the faces")
        if err > 0.05:
            raise SystemExit("cli-4pcs-mesh: the written mesh is off P")
        numbers["cli-4pcs-mesh"] = dict(search_s=res.stats["search_seconds"],
                                        trials=res.n_trials, score=res.score,
                                        obj_read_ms=obj_ms, obj_tier=obj_tier,
                                        obj_numpy_read_ms=obj_numpy_ms)

        # 5f. HEALPix direction bins at the headline's width
        res, _ = run("cli-healpix", base + [
            "--tpu-opts", "direction_bins=healpix,random_seed=1"],
            f("m.txt"), gt, True)
        lcp_f = out_lcp(f("out.ply"))
        _log(f"cli-healpix: LCP of the written geometry against P: "
             f"{lcp_f:.4f}; score {res.score:.4f} quads_overflow "
             f"{res.stats['quads_overflow']} n_congruent "
             f"{res.stats['n_congruent']}")
        if lcp_f < 0.7:
            raise SystemExit("cli-healpix: the written geometry misses "
                             "LCP 0.7")
        numbers["cli-healpix"] = dict(
            search_s=res.stats["search_seconds"], trials=res.n_trials,
            lcp=lcp_f, score=res.score,
            quads_overflow=res.stats["quads_overflow"])
    return numbers


def _sequence_views(model):
    """bench.py's synthetic sequence (bench.py:169-193): four views of
    ``model``, 65% of its x extent wide, starting at 0, 0.15, 0.3 and
    0.35, each moved into its own frame by its ground truth."""
    import numpy as np
    from super4pcs_tpu_torch.sequence import _quat_to_rot

    def aa_quat(axis, angle):
        axis = np.asarray(axis, np.float64)
        axis = axis / np.linalg.norm(axis)
        return (np.cos(angle / 2), *(axis * np.sin(angle / 2)))

    quats = [aa_quat([0, 0, 1], 0.0), aa_quat([0, 1, 0], 0.9),
             aa_quat([1, 0, 1], -0.7), aa_quat([1, 1, 0], 1.3)]
    trs = [[0, 0, 0], [0.10, -0.05, 0.08], [-0.07, 0.12, 0.02],
           [0.04, 0.06, -0.11]]
    gts = []
    for q, t in zip(quats, trs):
        m = np.eye(4)
        m[:3, :3] = _quat_to_rot(*q)
        m[:3, 3] = -m[:3, :3] @ np.asarray(t, np.float64)
        gts.append(m.astype(np.float32))
    x = model[:, 0]
    lo, hi = x.min(), x.max()
    scans = []
    for s, m in zip([0.0, 0.15, 0.3, 0.35], gts):
        a = lo + s * (hi - lo)
        v = model[(x >= a) & (x <= a + 0.65 * (hi - lo))]
        scans.append((v @ m[:3, :3].T + m[:3, 3]).astype(np.float32))
    return scans, gts


def _sequence_paths(P, s4, counters, by_path):
    """Phase 5g: register_sequence on bench.py's synthetic sequence with
    its options, then at the headline's width. Returns the search
    seconds of each step."""
    configs = (
        ("sequence", _synth_model(), _sequence_options(s4), False),
        ("sequence-full", P, s4.Options(
            delta=0.01, sample_size=8192, max_time_seconds=30,
            random_seed=5), True))
    numbers = {}
    for label, model, opts, need_k2 in configs:
        scans, gts = _sequence_views(model)
        steps, counts, wall, _ = _run_path(
            label, lambda: s4.register_sequence(
                [s4.PointCloud(s) for s in scans],
                opts.configure_overlap(0.5, 0.6), gt_transforms=gts,
                device="cuda"), counters)
        by_path[label] = counts
        numbers[label] = []
        for st in steps:
            r = st.result
            numbers[label].append(r.stats["search_seconds"])
            _log(f"{label} step {st.index}: scan of "
                 f"{len(scans[st.index])} points, score="
                 f"{r.score:.4f} trials={r.n_trials} search_s="
                 f"{r.stats['search_seconds']:.3f} rotDiff="
                 f"{st.rot_diff:.4f} trDiff={st.tr_diff:.4f}")
        _log(f"{label}: wall_s={wall:.3f}")
        if counts["lcp_min_d2_within"] <= 0 or (
                need_k2 and counts["rowcap_capture"] <= 0):
            raise SystemExit(f"{label}: a kernel of the path never "
                             f"launched")
        if not all(st.rot_diff <= 0.2 and st.tr_diff <= 0.1
                   for st in steps):
            raise SystemExit(f"{label}: a step missed the pose gates")
    return numbers


def _scale_pair(n=50_000):
    """The scale fixture of tools/scale_hier_16k.py (BASELINE r3's, at
    50,000 points): a bumpy sphere from numpy seed 21, moved by the
    headline's rotation and shift, divided by SCALE, plus noise sigma
    0.008. Returns (P, Q); Q -> P is SCALE times the headline's pose."""
    import numpy as np
    rng = np.random.default_rng(21)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    bump = (1 + 0.3 * np.sin(5 * v[:, 0]) * np.cos(3 * v[:, 1])
            + 0.2 * np.sin(4 * v[:, 2]))
    pos = (v * bump[:, None]).astype(np.float32)
    q = (((pos @ _rot().T) + np.float32(SHIFT)) / SCALE).astype(np.float32)
    q += rng.normal(scale=0.008, size=q.shape).astype(np.float32)
    return pos, q


def _scale_error(res):
    """(scale estimate, its relative error against SCALE, rotDiff,
    trDiff) of a similarity result, the pose with its scale divided
    out."""
    import numpy as np
    from super4pcs_tpu_torch import reference_pose_diff
    m = np.asarray(res.transform, np.float64)
    s_est = float(np.linalg.norm(m[:3, :3], axis=0).mean())
    pose = m.copy()
    pose[:3, :3] /= s_est
    rot_diff, tr_diff = reference_pose_diff(pose, _ground_truth())
    return s_est, abs(s_est - SCALE) / SCALE, rot_diff, tr_diff


def _scale_gates(label, res, s4):
    """The scale tool's gates (LCP >= 0.95, scale error < 0.5%) and the
    pose of the transform with its scale divided out (rotDiff <= 0.2 /
    trDiff <= 0.1). Returns (scale estimate, relative error)."""
    import numpy as np
    s_est, err, rot_diff, tr_diff = _scale_error(res)
    m = np.asarray(res.transform, np.float64)
    t_err = float(np.linalg.norm(m[:3, 3] - _ground_truth()[:3, 3]))
    _log(f"{label}: score={res.score:.4f} scale={s_est:.5f} (error "
         f"{100 * err:.3f}%) rotDiff={rot_diff:.4f} trDiff={tr_diff:.4f} "
         f"|t - t_gt|={t_err:.4f} trials={res.n_trials}")
    if not (res.score >= 0.95 and err < 0.005 and rot_diff <= 0.2
            and tr_diff <= 0.1):
        raise SystemExit(f"{label} missed its gates")
    return s_est, err


def _scale_paths(s4, counters, by_path):
    """Phases 5h (hierarchical scale through ``register``) and 5i (the
    allpairs engine through ``MatchSuper4PCS``), each a path of its own.
    Returns the numbers each printed."""
    import torch
    from super4pcs_tpu_torch import api
    P, Q = _scale_pair()
    numbers = {}

    # 5h. hierarchical: coarse similarity at scale_max_q, fine rigid on
    # s * Q at full width
    opts = _scale_options(s4)
    runs = []

    def hier():
        with _recording(api, runs):
            return s4.register(P, Q, options=opts, device="cuda")

    res, counts, wall, peak = _run_path("scale-hierarchical", hier, counters)
    by_path["scale-hierarchical"] = counts
    st = res.stats
    if len(runs) != 3 or "hierarchical_scale" not in st:
        raise SystemExit(f"scale-hierarchical: expected the coarse and "
                         f"fine phases, got {len(runs)} runs, "
                         f"{st.get('scale_hierarchical', 'composed')}")
    phases = {}
    for name, (m, r) in zip(("coarse", "fine"), runs[:2]):
        nq = len(m.get_second_sampled())
        phases[name] = dict(
            nq=nq, np=len(m.get_first_sampled()),
            engine=s4.matcher.resolve_pair_engine(m.options, nq),
            bases_per_step=m._b_eff, trials=r.n_trials, lcp=r.score,
            search_s=r.stats["search_seconds"])
        _log(f"scale-hierarchical {name}: nq={nq} np={phases[name]['np']} "
             f"engine={phases[name]['engine']} B={m._b_eff} "
             f"trials={r.n_trials} score={r.score:.4f} "
             f"search_s={r.stats['search_seconds']:.3f}")
    _log(f"scale-hierarchical: hierarchical_scale="
         f"{st['hierarchical_scale']:.5f} coarse_lcp={st['coarse_lcp']:.4f}"
         f" coarse_trials={st['coarse_trials']} coarse_search_s="
         f"{st['coarse_search_seconds']:.3f} fine_search_s="
         f"{st['search_seconds']:.3f} wall_s={wall:.3f} "
         f"peak_MiB={peak:.1f}")
    s_est, err = _scale_gates("scale-hierarchical", res, s4)
    need_k2 = phases["fine"]["nq"] > 2048
    if counts["lcp_min_d2_within"] <= 0 or (
            need_k2 and counts["rowcap_capture"] <= 0):
        raise SystemExit(f"scale-hierarchical: K1 launched "
                         f"{counts['lcp_min_d2_within']} times, K2 "
                         f"{counts['rowcap_capture']} (fine nq "
                         f"{phases['fine']['nq']})")
    numbers["scale-hierarchical"] = dict(
        phases=phases, hierarchical_scale=st["hierarchical_scale"],
        coarse_search_s=st["coarse_search_seconds"],
        fine_search_s=st["search_seconds"], wall_s=wall, peak_mib=peak,
        score=res.score, scale=s_est, scale_err=err)

    # 5i. the allpairs engine at nq = 4096 (BASELINE r3's larger size)
    aopts = _scale_aopts(s4)
    matchers = []

    def allpairs():
        m = s4.MatchSuper4PCS(aopts, device="cuda")
        matchers.append(m)
        return m.compute_transformation(s4.PointCloud(P), s4.PointCloud(Q))

    res, counts, wall, peak = _run_path("scale-allpairs", allpairs, counters)
    by_path["scale-allpairs"] = counts
    m = matchers[0]
    nq = len(m.get_second_sampled())
    engine = s4.matcher.resolve_pair_engine(aopts, nq)
    st = res.stats
    steps = max(res.n_trials // m._b_eff, 1)
    _log(f"scale-allpairs: nq={nq} np={len(m.get_first_sampled())} "
         f"engine={engine} B={m._b_eff} table rows per base={nq * nq} "
         f"steps={steps} search_s={st['search_seconds']:.3f} "
         f"mean_step_s={st['search_seconds'] / steps:.3f} "
         f"quads_overflow={st['quads_overflow']} cell_dropped="
         f"{st['cell_dropped']} q_sampled_out={st['q_sampled_out']} "
         f"n_congruent={st['n_congruent']} wall_s={wall:.3f} "
         f"peak_MiB={peak:.1f}")
    s_est, err = _scale_gates("scale-allpairs", res, s4)
    if engine != "allpairs":
        raise SystemExit(f"scale-allpairs resolved the {engine!r} engine")
    if counts["lcp_min_d2_within"] <= 0 or counts["rowcap_capture"] != 0:
        raise SystemExit(f"scale-allpairs: K1 launched "
                         f"{counts['lcp_min_d2_within']} times, K2 "
                         f"{counts['rowcap_capture']} (wanted none)")
    # a step's wall, device time and peak memory, outside the path
    step = _step_numbers(m, 100)
    nodes = _graph_kernels(m._graph)[0]
    same = _allpairs_trials_equal(m)
    par = ALLPAIRS_LOOP_PARENT
    _log(f"scale-allpairs step (B={m._b_eff} trials batched: one join, "
         f"tables of {nq * nq} rows each): wall {step['step_wall_ms']:.1f} "
         f"ms, device busy {step['step_busy_ms']:.1f} ms (idle share "
         f"{100 * step['idle_share']:.0f}%), sorts "
         f"{step['step_sort_ms']:.1f} ms, {step['step_kernels']:.0f} kernels"
         f" recorded by the profiler, {nodes} kernel nodes in the graph, "
         f"step peak {step['step_peak_mib']:.1f} MiB;"
         f" the parent's trial loop: wall {par['step_wall_ms']} ms, busy "
         f"{par['step_busy_ms']} ms (idle share "
         f"{100 * par['idle_share']:.0f}%), {par['step_kernels']} kernels,"
         f" {par['graph_kernel_nodes']} graph kernel nodes; every trial "
         f"equal to its one-trial call={same}")
    if not same:
        raise SystemExit("scale-allpairs: a trial of the batched step "
                         "differs from its one-trial call")
    numbers["scale-allpairs"] = dict(
        nq=nq, engine=engine, trials=res.n_trials, steps=steps,
        search_s=st["search_seconds"], **step, graph_kernel_nodes=nodes,
        trials_equal=same,
        quads_overflow=st["quads_overflow"],
        cell_dropped=st["cell_dropped"],
        q_sampled_out=st["q_sampled_out"], wall_s=wall, peak_mib=peak,
        score=res.score, scale=s_est, scale_err=err)
    return numbers


def _allpairs_trials_equal(m) -> bool:
    """Whether every trial of allpairs matcher ``m``'s batched trial
    function, on one step's draws, equals its one-trial call bit for bit
    (transform, cvalid, quads, counts)."""
    from super4pcs_tpu_torch import matcher as mt
    nq = int(m._d_q_pos.shape[0])
    tb, _ = mt._build_try_bases(m._opts_eff(), nq, m._cone_mode)
    draws = m._draws(300)
    diam, args = m._max_base_diameter, m._step_args()

    def trials(lo, hi):
        rot = tuple(r[:, lo:hi].reshape(-1) for r in draws[3:]) or None
        return tb(tuple(d[:, lo:hi] for d in draws[:3]), diam, *args[:7],
                  rot)

    full = trials(0, m._b_eff)
    same = True
    for t in range(m._b_eff):
        one = trials(t, t + 1)
        for k in ("transform", "cvalid", "quads", "counts"):
            x, y = full[k][t], one[k][0]
            same &= bool(((x == y) | (x != x) & (y != y)).all())
    return same


def _batch_pairs(P, Q, s4, engine="auto"):
    """Phase 5j's four pairs (the headline pair and the three
    consecutive pairs of the sequence-full views), their known relative
    poses, and 5g sequence-full's options on ``engine``."""
    import numpy as np
    scans, gts = _sequence_views(P)
    pairs = [(s4.PointCloud(P), s4.PointCloud(Q))] + [
        (s4.PointCloud(scans[i]), s4.PointCloud(scans[i + 1]))
        for i in range(3)]
    # scan i = the model moved by gts[i], so scan i + 1 -> scan i is
    # gts[i] gts[i + 1]^-1
    truth = [_ground_truth()] + [
        gts[i].astype(np.float64) @ np.linalg.inv(
            gts[i + 1].astype(np.float64)) for i in range(3)]
    opts = s4.Options(delta=0.01, sample_size=8192, max_time_seconds=30,
                      random_seed=5, pair_engine=engine
                      ).configure_overlap(0.5, 0.6)
    return pairs, truth, opts


def _batch_path(P, Q, s4, counters, by_path, engine="auto"):
    """Phase 5j (``engine`` "auto": rowcap) and 5j-banded (``engine``
    "banded"): ``register_batch`` on G = 4 pairs at the headline's width
    (the headline pair and the three consecutive pairs of the
    sequence-full views) with 5g sequence-full's options; each pair
    gated on LCP >= 0.6 and its known relative pose; then, outside the
    path, one step's launches and two steps' wall and device time of
    the same batch. Returns the numbers it printed."""
    from super4pcs_tpu_torch.parallel import batch
    label = "batch" if engine == "auto" else f"batch-{engine}"
    banded = engine == "banded"
    pairs, truth, opts = _batch_pairs(P, Q, s4, engine)
    res, counts, wall, peak = _run_path(
        label, lambda: batch.register_batch(pairs, opts, device="cuda"),
        counters)
    by_path[label] = counts
    b_eff = s4.matcher.resolve_bases_per_step(opts, 8192)
    numbers = dict(wall_s=wall, peak_mib=peak, pairs=[])
    ok = True
    for g, (r, gt) in enumerate(zip(res, truth)):
        rot_diff, tr_diff = s4.reference_pose_diff(r.transform, gt)
        st = r.stats
        _log(f"{label} pair {g}: score={r.score:.4f} trials={r.n_trials} "
             f"search_s={st.get('search_seconds', float('nan')):.3f} "
             f"q_padded={st['q_padded']} rotDiff={rot_diff:.4f} "
             f"trDiff={tr_diff:.4f} straggler_escalated_to="
             f"{st.get('straggler_escalated_to', '-')} compile_s="
             f"{st['compile_seconds']:.3f} quads_overflow="
             f"{st['quads_overflow']} pairs_overflow="
             f"{st['pairs_overflow']}")
        ok &= r.score >= 0.6 and rot_diff <= 0.2 and tr_diff <= 0.1
        numbers["pairs"].append(dict(
            score=r.score, trials=r.n_trials,
            search_s=st.get("search_seconds"), q_padded=st["q_padded"],
            rot_diff=rot_diff, tr_diff=tr_diff,
            redeemed="straggler_escalated_to" in st))
    numbers["compile_s"] = res[0].stats["compile_seconds"]
    if banded:
        numbers["band_cells"] = res[0].stats["band_cells"]
        numbers["band_member_dropped"] = res[0].stats["band_member_dropped"]
    _log(f"{label}: G=4 B={b_eff} T={4 * b_eff} wall_s={wall:.3f} "
         f"peak_MiB={peak:.1f} band_cells="
         f"{res[0].stats.get('band_cells', '-')}")
    if not ok:
        raise SystemExit(f"{label}: a pair missed its gates")
    if counts["lcp_min_d2_within"] <= 0 or (
            (counts["rowcap_capture"] > 0) == banded):
        raise SystemExit(f"{label}: K1 launched "
                         f"{counts['lcp_min_d2_within']} times, K2 "
                         f"{counts['rowcap_capture']} (wanted "
                         f"{'none' if banded else 'some'})")

    # one step's launches, then the wall of 2 steps and the device time
    # of 2 more under the profiler (outside the path)
    run = batch.BatchRun(pairs, opts, device="cuda")
    for obj, attr in counters.values():
        setattr(obj, attr, 0)
    builds = run.index_builds
    run.run_step(0)
    per_step = {k: getattr(obj, attr) for k, (obj, attr) in counters.items()}
    prof = _step_profile(run.run_step, 1)
    _log(f"{label} step (G=4, T={4 * b_eff}): launches per step "
         f"{per_step}; index builds during steps "
         f"{run.index_builds - builds}; " + _profile_text(prof))
    want_k2 = 0 if banded else 2
    if (per_step["rowcap_capture"] != want_k2
            or per_step["rowcap_capture_captures"] != want_k2 * 4 * b_eff
            or per_step["lcp_min_d2_within"] != 3
            or run.index_builds != builds):
        raise SystemExit(f"{label}: a step launched other than "
                         f"{want_k2} captures of every trial and 3 "
                         f"verifies, or built an index")
    numbers.update(step_launches=per_step, **prof)
    del run
    return numbers


def _mesh_paths(P, Q, opts, ref, s4, counters, by_path, report):
    """Phase 5m: the headline through ``MatchSuper4PCS(opts,
    mesh=make_mesh())`` over every visible card, then over
    ``make_mesh(["cuda:0"] * 2)`` (two shards of eight bases on one
    card). Each run: the headline's gates, K1 and K2 launched, its
    trials and LCP against phase 5's ``ref`` (a one-device mesh runs
    phase 5's computation: it must equal it bit for bit; with more
    shards each shard's verify keeps its own best candidates, so the
    runs agree only where no shard drops one and the cuts pick alike);
    then, outside the path, one step's launches (2 captures and 3
    verifies on each shard) and the wall, device time and idle share of
    a step. Returns the numbers it printed."""
    import gc

    import numpy as np
    import torch
    from super4pcs_tpu_torch.parallel import make_mesh
    # the earlier phases' cached blocks (5l's 40 GB) and garbage out of
    # the way of the step times
    gc.collect()
    torch.cuda.empty_cache()
    numbers = {}
    for label, devices in (("mesh", None), ("mesh-cuda0x2", ["cuda:0"] * 2)):
        mesh = make_mesh(devices)
        res, counts, wall, peak = _run_path(
            label, lambda: s4.MatchSuper4PCS(
                opts, mesh=mesh).compute_transformation(
                    s4.PointCloud(P), s4.PointCloud(Q)), counters)
        by_path[label] = counts
        report(label, res, wall, peak)
        same = (res.n_trials == ref.n_trials and res.score == ref.score
                and np.array_equal(res.transform, ref.transform))
        dropped = (int(res.stats["cands_overflow"]),
                   int(ref.stats["cands_overflow"]))
        _log(f"{label}: {mesh.size} shard(s) on "
             f"{[str(d) for d in mesh.devices]}: trials {res.n_trials} LCP "
             f"{res.score:.4f}, phase 5: {ref.n_trials} / {ref.score:.4f}; "
             f"equal to phase 5 bit for bit={same}; candidates dropped "
             f"{dropped[0]} (phase 5: {dropped[1]})")
        if mesh.size == 1 and not same:
            raise SystemExit(f"{label}: a one-device mesh differs from "
                             f"phase 5")
        if min(counts["lcp_min_d2_within"], counts["rowcap_capture"]) <= 0:
            raise SystemExit(f"{label}: a kernel of the path never "
                             f"launched")
        # one step's launches, then the wall and device time of steps
        m = s4.MatchSuper4PCS(opts, mesh=mesh)
        m._init(s4.PointCloud(P), s4.PointCloud(Q))
        for obj, attr in counters.values():
            setattr(obj, attr, 0)
        m._run_step(0)
        per_step = {k: getattr(obj, attr)
                    for k, (obj, attr) in counters.items()}
        if (per_step["rowcap_capture"] != 2 * mesh.size
                or per_step["rowcap_capture_captures"] != 2 * m._b_eff
                or per_step["lcp_min_d2_within"] != 3 * mesh.size):
            raise SystemExit(f"{label}: a step launched {per_step}, not 2 "
                             f"captures and 3 verifies on each of "
                             f"{mesh.size} shard(s)")
        prof = _step_profile(m._run_step, 1, n=4)
        cards = len(set(mesh.devices))
        idle = 1.0 - prof["step_busy_ms"] / (prof["step_wall_ms"] * cards)
        _log(f"{label} step (B={m._b_eff} over {mesh.size} shard(s), "
             f"{cards} card(s)): launches per step {per_step}; "
             + _profile_text(prof) + f"; idle share per card "
             f"{100 * idle:.0f}%; {m._b_eff / prof['step_wall_ms'] * 1e3:.1f}"
             f" trials/s")
        numbers[label] = dict(
            shards=mesh.size, cards=cards, trials=res.n_trials,
            score=res.score, equal_to_phase5=same, cands_dropped=dropped[0],
            search_s=res.stats["search_seconds"], wall_s=wall,
            step_launches=per_step, card_idle_share=idle, **prof)
        del m
    return numbers


def _batch_worker(argv) -> int:
    """One process of phase 5n (``chip_smoke.py --batch-worker ADDR N
    PID``): joins the job, runs ``register_batch`` on 5j's pairs over
    ``distributed.global_mesh()`` with every launch count set to 0 just
    before, then times 3 steps of the same batch, and prints one JSON
    line: its results, counts and times."""
    import numpy as np
    import torch
    import torch.distributed as dist

    import bench
    import super4pcs_tpu_torch as s4
    from super4pcs_tpu_torch.parallel import distributed, register_batch
    from super4pcs_tpu_torch.parallel.batch import BatchRun
    addr, n, pid = argv[0], int(argv[1]), int(argv[2])
    dev = distributed.initialize(addr, n, pid)
    mesh = distributed.global_mesh()
    P, Q = bench.fine_delta_pair()
    pairs, _, opts = _batch_pairs(P, Q, s4)
    counters = _counters()
    for obj, attr in counters.values():
        setattr(obj, attr, 0)
    t0 = time.perf_counter()
    res = register_batch(pairs, opts, mesh=mesh)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    counts = {k: getattr(obj, attr) for k, (obj, attr) in counters.items()}
    run = BatchRun(pairs, opts, mesh=mesh)
    t0 = time.perf_counter()
    for i in range(3):
        run.run_step(1000 + i)
    step_ms = 1e3 * (time.perf_counter() - t0) / 3
    out = dict(pid=pid, device=str(dev), mesh=[str(d) for d in mesh.devices],
               scores=[r.score for r in res],
               trials=[r.n_trials for r in res],
               transforms=[np.asarray(r.transform).tolist() for r in res],
               batch_state=res[0].stats["batch_state"],
               search_s=res[0].stats["search_seconds"],
               compile_s=res[0].stats["compile_seconds"], wall_s=wall,
               counts=counts, step_ms=step_ms)
    dist.destroy_process_group()
    print(json.dumps(out), flush=True)
    return 0


def _dist_batch_path(P, Q, s4, by_path, timeout=300):
    """Phase 5n: ``register_batch`` on 5j's four pairs with 5j's options
    over two processes of ``distributed.initialize`` (gloo), spawned
    here (:func:`_batch_worker`): both on ``cuda:0`` with one card,
    ``cuda:rank`` with more. Both must exit 0 within ``timeout``
    seconds (else every child is killed and the phase fails), hold
    bit-identical results, and every pair must meet 5j's gates; each
    process must have launched K1 and K2. Returns the numbers it
    printed."""
    import socket

    import numpy as np
    import torch
    torch.cuda.empty_cache()
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        addr = f"127.0.0.1:{sock.getsockname()[1]}"
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--batch-worker", addr,
         "2", str(pid)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for pid in range(2)]
    outs = []
    try:
        for p in procs:
            try:
                out, err = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                raise SystemExit(f"batch-2proc: a process ran past "
                                 f"{timeout} s")
            if p.returncode != 0:
                raise SystemExit(f"batch-2proc: a process exited "
                                 f"{p.returncode}:\n{err[-3000:]}")
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    wall = time.perf_counter() - t0
    a, b = outs
    same = all(a[k] == b[k] for k in ("scores", "trials", "transforms",
                                      "batch_state"))
    _, truth, _ = _batch_pairs(P, Q, s4)
    ok = True
    for g, (score, mat, gt) in enumerate(zip(a["scores"], a["transforms"],
                                             truth)):
        rot_diff, tr_diff = s4.reference_pose_diff(np.asarray(mat), gt)
        _log(f"batch-2proc pair {g}: score={score:.4f} trials="
             f"{a['trials'][g]} rotDiff={rot_diff:.4f} trDiff={tr_diff:.4f}")
        ok &= score >= 0.6 and rot_diff <= 0.2 and tr_diff <= 0.1
    counts = {k: a["counts"][k] + b["counts"][k] for k in a["counts"]}
    by_path["batch-2proc"] = counts
    _log(f"batch-2proc: processes on {a['mesh']}; results bit-identical in "
         f"both={same}; launches per process {a['counts']} / "
         f"{b['counts']}; search_s {a['search_s']:.3f} / "
         f"{b['search_s']:.3f}, compile_s {a['compile_s']:.3f} / "
         f"{b['compile_s']:.3f}; step {a['step_ms']:.1f} / "
         f"{b['step_ms']:.1f} ms (G=4 over 2 processes); job wall "
         f"{wall:.1f} s")
    if not same:
        raise SystemExit("batch-2proc: the processes' results differ")
    if not ok:
        raise SystemExit("batch-2proc: a pair missed its gates")
    if any(min(o["counts"]["lcp_min_d2_within"],
               o["counts"]["rowcap_capture"]) <= 0 for o in outs):
        raise SystemExit("batch-2proc: a process launched no K1 or no K2")
    return dict(devices=a["mesh"], scores=a["scores"], trials=a["trials"],
                search_s=[a["search_s"], b["search_s"]],
                step_ms=[a["step_ms"], b["step_ms"]], job_wall_s=wall,
                launches=[a["counts"], b["counts"]])


def _phase_timing_path(P, Q, opts, ref, s4, counters, by_path, report):
    """Phase 5o: the headline with ``phase_timing=True``: its phases'
    seconds and roofline table printed; the phases' sum within 10% of
    the step's; the search itself phase 5's (same trials and LCP: the
    measured steps draw off the search's stream). Returns them."""
    import gc

    import torch
    from super4pcs_tpu_torch.utils import roofline
    gc.collect()
    torch.cuda.empty_cache()
    res, counts, wall, peak = _run_path(
        "phase-timing", lambda: s4.MatchSuper4PCS(
            opts.replace(phase_timing=True),
            device="cuda").compute_transformation(
                s4.PointCloud(P), s4.PointCloud(Q)), counters)
    by_path["phase-timing"] = counts
    report("phase-timing", res, wall, peak)
    ph = res.stats["phase_seconds"]
    roof = res.stats["phase_roofline"]
    parts = sum(ph[k] for k in ("select_extract", "join", "fit", "verify"))
    _log("phase-timing phase_seconds (ms): " + ", ".join(
        f"{k} {1e3 * v:.3f}" for k, v in ph.items())
        + f"; sum of the phases {1e3 * parts:.3f} ms"
        + f" ({100 * parts / ph['step_total']:.1f}% of step_total)")
    _log("phase-timing roofline against " + roofline.H100["name"]
         + f", dispatch floor {1e3 * roofline.DISPATCH_FLOOR_S:.3f} ms:\n"
         + roofline.table(roof))
    if abs(parts - ph["step_total"]) > 0.1 * ph["step_total"]:
        raise SystemExit("phase-timing: the phases do not add up to the "
                         "step within 10%")
    if (res.n_trials, res.score) != (ref.n_trials, ref.score):
        raise SystemExit("phase-timing: the search differs from phase 5's")
    if min(counts["lcp_min_d2_within"], counts["rowcap_capture"]) <= 0:
        raise SystemExit("phase-timing: a kernel never launched")
    return dict(phase_seconds=ph, phase_roofline=roof, phases_sum_s=parts)


@contextlib.contextmanager
def _phase_scopes():
    """Within the block, a step's pair extraction (banded or the capture
    kernel), congruent join and verify each run inside a
    ``record_function`` range ("extract", "join", "verify"), so that
    the profiler attributes their kernels."""
    import torch
    from super4pcs_tpu_torch import matcher
    from super4pcs_tpu_torch.kernels import rowcap
    from super4pcs_tpu_torch.ops import congruent, lcp
    targets = ((matcher, "extract_pairs_banded", "extract"),
               (rowcap, "extract_pairs_rowcap_both", "extract"),
               (congruent, "find_congruent_quads_grid", "join"),
               (lcp, "lcp_scores_two_stage", "verify"))
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in targets]

    def scoped(fn, label):
        def inner(*args, **kw):
            with torch.profiler.record_function(label):
                return fn(*args, **kw)
        return inner

    for mod, attr, label in targets:
        setattr(mod, attr, scoped(getattr(mod, attr), label))
    try:
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def _step_profile(run_step, first: int, n: int = 2) -> dict:
    """Steps ``first`` on: the wall of ``n`` unprofiled steps, then the
    device time of ``n`` more under the profiler, by phase (extraction,
    join, verify: see :func:`_phase_scopes`) and by kernel (K1, K2, the
    sorts). Milliseconds per step."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(first, first + n):
        run_step(i)
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0) / n
    with _phase_scopes():
        evs = _device_events(
            lambda: [run_step(i) for i in range(first + n, first + 2 * n)],
            scope=("extract", "join", "verify"))
    busy = sum(t for _, t, _ in evs) / n / 1e3

    def ms(pred):
        return sum(t for name, t, sc in evs if pred(name, sc)) / n / 1e3

    def k2(name):
        return any(k in name for k in K2_NAMES)

    # K1 and K2 are launched through ctypes, outside any torch op, so
    # the profiler links them to no range: a step launches them only in
    # its verify and its capture
    return dict(
        step_wall_ms=wall, step_busy_ms=busy,
        idle_share=1.0 - busy / wall, step_kernels=len(evs) / n,
        extract_ms=ms(lambda name, sc: sc == "extract" or k2(name)),
        join_ms=ms(lambda _, sc: sc == "join"),
        verify_ms=ms(lambda name, sc: sc == "verify" or K1W_NAME in name),
        k1_ms=ms(lambda name, _: K1W_NAME in name),
        k2_ms=ms(lambda name, _: k2(name)),
        sort_ms=ms(lambda name, _: "sort" in name.lower()))


def _profile_text(p: dict) -> str:
    return (f"wall {p['step_wall_ms']:.1f} ms, device busy "
            f"{p['step_busy_ms']:.1f} ms (idle share "
            f"{100 * p['idle_share']:.0f}%), {p['step_kernels']:.0f} "
            f"kernels per step; extraction {p['extract_ms']:.3f} ms, join "
            f"{p['join_ms']:.3f} ms, verify {p['verify_ms']:.3f} ms; K2 "
            f"{p['k2_ms']:.3f} ms, K1 {p['k1_ms']:.3f} ms, sorts "
            f"{p['sort_ms']:.3f} ms")


def _banded_paths(P, Q, upos, uq, opts, s4, counters, by_path):
    """Phases 5k (the headline forced onto the banded engine) and 5l
    (auto -> banded at nq = 131,072 on the 1M pair), each a path of its
    own, then, outside every path, two steps of the rowcap engine on
    5l's samples (K2 at n = 131,072), measured and not gated. Returns
    the numbers each printed."""
    import torch
    gt = _ground_truth()
    numbers = {}

    def banded_run(label, o, cp, cq, want_nq=None, want_np=None):
        matchers = []
        refines = []
        refine_fn = s4.matcher.refine.refine_transform

        def timed_refine(*args, **kw):
            # the guarded ICP's calls (the warm-up's too), timed
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = refine_fn(*args, **kw)
            torch.cuda.synchronize()
            refines.append(time.perf_counter() - t0)
            return out

        def run():
            m = s4.MatchSuper4PCS(o, device="cuda")
            matchers.append(m)
            s4.matcher.refine.refine_transform = timed_refine
            try:
                return m.compute_transformation(s4.PointCloud(cp),
                                                s4.PointCloud(cq))
            finally:
                s4.matcher.refine.refine_transform = refine_fn

        res, counts, wall, peak = _run_path(label, run, counters)
        by_path[label] = counts
        m = matchers[0]
        nq, np_ = len(m.get_second_sampled()), len(m.get_first_sampled())
        engine = s4.matcher.resolve_pair_engine(o, nq)
        st, idx = res.stats, m._band_index
        rot_diff, tr_diff = s4.reference_pose_diff(res.transform, gt)
        steps = max(res.n_trials // m._b_eff, 1)
        row = dict(
            nq=nq, np=np_, engine=engine, trials=res.n_trials, steps=steps,
            score=res.score, search_s=st["search_seconds"],
            compile_s=st["compile_seconds"], wall_s=wall, peak_mib=peak,
            rot_diff=rot_diff, tr_diff=tr_diff,
            band_cells=st.get("band_cells"),
            band_cell_size=st.get("band_cell_size"),
            band_member_dropped=st.get("band_member_dropped"),
            band_m_real=None if idx is None else idx.m_real,
            band_pc=None if idx is None else idx.pc,
            index_host_ms=None if idx is None else 1e3 * idx.host_seconds,
            index_sort_ms=None if idx is None else 1e3 * idx.sort_seconds,
            pairs_overflow=st["pairs_overflow"],
            quads_overflow=st["quads_overflow"],
            cell_dropped=st["cell_dropped"],
            escalated_to=st.get("escalated_to"),
            k1_launches=counts["lcp_min_d2_within"],
            refine_calls=len(refines), refine_s=sum(refines))
        _log(f"{label}: nq={nq} np={np_} engine={engine} B={m._b_eff} "
             f"score={res.score:.4f} trials={res.n_trials} steps={steps} "
             f"search_s={st['search_seconds']:.3f} mean_step_s="
             f"{st['search_seconds'] / steps:.4f} compile_s="
             f"{st['compile_seconds']:.3f} wall_s={wall:.3f} rotDiff="
             f"{rot_diff:.4f} trDiff={tr_diff:.4f} band_cells="
             f"{row['band_cells']} (occupied {row['band_m_real']}, pc "
             f"{row['band_pc']}) band_cell_size={row['band_cell_size']} "
             f"band_member_dropped={row['band_member_dropped']} index: "
             f"host {row['index_host_ms']:.1f} ms, table sort "
             f"{row['index_sort_ms']:.2f} ms; pairs_overflow="
             f"{st['pairs_overflow']} quads_overflow={st['quads_overflow']} "
             f"cell_dropped={st['cell_dropped']} escalated_to="
             f"{st.get('escalated_to', '-')} K1 launches="
             f"{counts['lcp_min_d2_within']} peak_MiB={peak:.1f} refines="
             f"{len(refines)} ({sum(refines):.3f} s, warm-ups included)")
        if engine != "banded" or idx is None or not st["band_cells"] > 0:
            raise SystemExit(f"{label} resolved the {engine!r} engine")
        if (want_nq, want_np) != (None, None) and (nq, np_) != (want_nq,
                                                                want_np):
            raise SystemExit(f"{label}: nq={nq} np={np_}, wanted "
                             f"{want_nq} and {want_np}")
        if counts["lcp_min_d2_within"] <= 0 or counts["rowcap_capture"]:
            raise SystemExit(f"{label}: K1 launched "
                             f"{counts['lcp_min_d2_within']} times, K2 "
                             f"{counts['rowcap_capture']} (wanted none)")
        if not (res.score >= 0.7 and rot_diff <= 0.2 and tr_diff <= 0.1
                and st["search_seconds"] <= o.max_time_seconds):
            raise SystemExit(f"{label} registration missed its gates")
        # a step's time, outside the path, launched op by op for its
        # breakdown by phase (5q times the captured step)
        prof = _step_profile(lambda i: m._run_step(i, eager=True), 10_000)
        _log(f"{label} step (T={m._b_eff}): " + _profile_text(prof))
        row.update(prof)
        numbers[label] = row
        del m, matchers
        torch.cuda.empty_cache()

    # 5k. the headline's registration forced onto the banded engine
    banded_run("banded", opts.replace(pair_engine="banded"), P, Q)

    # 5l. the 1M pair at nq = 131,072: "auto" resolves to banded. The
    # search runs to the threshold or the 120 s budget: the reference's
    # trial estimate for overlap 0.7 (139 trials a rung, two rungs at
    # this nq) runs out before this seed's first good base at this
    # sample count
    lopts = s4.Options(delta=0.005, sample_size=131072, max_time_seconds=120,
                       random_seed=5, use_full_time_budget=True
                       ).configure_overlap(0.7, 0.7)
    banded_run("banded-1M", lopts, upos, uq, 131072, 530_895)

    # the rowcap engine on 5l's samples: K2 at n = 131,072 (no gate)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    m = s4.MatchSuper4PCS(lopts.replace(pair_engine="rowcap"), device="cuda")
    t0 = time.perf_counter()
    m._init(s4.PointCloud(upos), s4.PointCloud(uq))
    init_s = time.perf_counter() - t0
    prof = _step_profile(m._run_step, 0)
    peak = torch.cuda.max_memory_allocated() / 2**20
    row = dict(nq=int(m._d_q_pos.shape[0]), init_s=init_s, peak_mib=peak, k2_ms_per_edge=prof["k2_ms"] / 2, **prof)
    _log(f"rowcap-1M (no gate): nq={row['nq']} B={m._b_eff} k_pairs="
         f"{m._k_pairs} init (with its warm-up step) {init_s:.3f} s; "
         f"K2 {row['k2_ms_per_edge']:.3f} ms per edge (T={m._b_eff}); "
         + _profile_text(prof) + f"; peak_MiB={peak:.1f}; banded step "
         f"{numbers['banded-1M']['step_wall_ms']:.1f} ms, peak_MiB "
         f"{numbers['banded-1M']['peak_mib']:.1f}")
    numbers["rowcap-1M"] = row
    del m
    torch.cuda.empty_cache()
    return numbers


def _scale_aopts(s4):
    """Phase 5i's options: the allpairs engine at nq = 4096."""
    return s4.Options(delta=0.05, sample_size=4096, scale_max_q=4096,
                      scale_hierarchical=False, estimate_scale=True,
                      random_seed=21, max_time_seconds=60
                      ).configure_overlap(0.6, 0.9)


def _key_plane(pos, nrm, rgb, bpos, bnrm, brgb, off, eps, cfg):
    """One capture's (n, n) float32 key plane: ``-((col - off) mod n)``
    where the ordered-pair mask of base edge (0, 1) holds, ``-inf``
    elsewhere: what the JAX package's XLA capture hands
    ``approx_max_k`` (the library yardstick's input)."""
    import math
    import torch
    from super4pcs_tpu_torch.ops import pairs as tp
    n = pos.shape[0]
    dev = pos.device
    keys = torch.empty((n, n), dtype=torch.float32, device=dev)
    rank = -torch.remainder(torch.arange(n, device=dev) - off, n).float()
    pd = tp._norm(bpos[0] - bpos[1])
    pna = tp._norm(bnrm[0] - bnrm[1])
    for r0 in range(0, n, 2048):
        r1 = min(r0 + 2048, n)
        m = tp.ordered_pair_mask(
            pos[r0:r1], nrm[r0:r1], rgb[r0:r1], pos, nrm, rgb, bpos[0],
            bpos[1], bnrm[0], bnrm[1], brgb[0], brgb[1], pd, pna, eps, cfg,
            u_offset=r0)
        keys[r0:r1] = torch.where(m, rank, -math.inf)
    return keys


def _layout_cases(s4, P, Q, fP, fQ, p_pos, q_pos, opts, dev):
    """Phase 4c's shapes: (label, Q samples (n, 3) with normals and
    colors, P samples with normals and colors (the bases' cloud), the
    filter configuration, T, row_cap). The headline's nq 8192 at T 16
    and row_cap 160 (the XLA route's join_row_cap there) unfiltered and
    with the four filters of phase 4a; nq 32768 (the top of the XLA
    route's auto range) at T 16; similarity mode (no distance band) on
    5i's scaled scan at nq 4096, T 4."""
    import numpy as np
    import torch
    from super4pcs_tpu_torch.ops import sampling
    from super4pcs_tpu_torch.ops.pairs import PairFilterConfig

    def put(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    def bare(pos):
        return (pos, torch.zeros_like(pos), torch.full_like(pos, -1.0))

    def sample_q(cloud, delta, n, seed, kd=True):
        s = sampling.sample_for_matching(cloud, delta, n, True,
                                         np.random.default_rng(seed))
        if kd:
            s = s.take(sampling.kd_argsort(s.pos))
        c = s.pos.mean(0)
        return put(s.pos - c), put(s.normals_or_zero()), put(
            s.rgb_or_invalid())

    filters = PairFilterConfig(max_normal_difference=20.0,
                               max_color_distance=60.0,
                               max_translation_distance=1.3, max_angle=80.0)
    fsp = sampling.sample_for_matching(fP, opts.delta, 8192, False,
                                       np.random.default_rng(0))
    fp = (put(fsp.pos - fsp.pos.mean(0)), put(fsp.normals_or_zero()),
          put(fsp.rgb_or_invalid()))
    f8 = sample_q(fQ, opts.delta, 8192, 8192)
    f32 = sample_q(fQ, opts.delta, 32768, 32768)
    SP, SQ = _scale_pair()
    sp = sampling.sample_for_matching(s4.PointCloud(SP), 0.05, 4096, False,
                                      np.random.default_rng(21))
    sq = sample_q(s4.PointCloud(SQ), 0.05, 4096, 21, kd=False)
    return [
        ("nq=8192 T=16", bare(q_pos), bare(p_pos), PairFilterConfig(), 16,
         160, 2.0 * opts.delta),
        ("nq=8192 T=16 filtered", f8, fp, filters, 16, 160,
         2.0 * opts.delta),
        ("nq=32768 T=16", bare(f32[0]), bare(p_pos), PairFilterConfig(), 16,
         160, 2.0 * opts.delta),
        ("similarity nq=4096 T=4", bare(sq[0]),
         bare(put(sp.pos - sp.pos.mean(0))),
         PairFilterConfig(use_distance_filter=False), 4, 160, 0.1),
    ]


def _reject_share(k2x, args, rb, eps, cfg):
    """(the share of K2x's pair tests that its rejection skips, the pair
    tests left) for one call's ``args`` (one point set) and bounds
    ``rb``: per trial and edge, the (row group, column) pairs of
    ``rowcap_layout.column_reject_plain``, each weighted by its group's
    rows."""
    import torch
    n, nt = args[0].shape[1], args[3].shape[0]
    total = 2.0 * nt * n * n
    if rb is None:
        return 0.0, total
    geo = k2x.layout_args(*args, eps, cfg)["geo"]
    lo, hi = k2x.q_band(geo, cfg.max_angle > 0)
    m = rb.spheres.shape[1]
    rows = (n - 32 * torch.arange(m, device=args[0].device)).clamp(max=32)
    kept = 0.0
    for t in range(nt):
        rej = k2x.column_reject_plain(args[0], rb, lo[:, t:t + 1],
                                      hi[:, t:t + 1], 1)
        kept += float(((~rej).sum(-1) * rows).sum())
        del rej
    return 1.0 - kept / total, kept


def _layout_phase(s4, P, Q, fP, fQ, p_pos, q_pos, opts, dev):
    """Phase 4c: K2x (the XLA route's row-capped capture,
    kernels/rowcap_layout.py) against its plain version on the card at
    each of :func:`_layout_cases`' shapes, both edges of T trials in one
    launch, the bases drawn as the matcher draws them and a column
    offset per trial, with the rejection on (its bounds computed once,
    as the matcher does) and off: cols, hit and rc bit for bit outside
    the rows holding a candidate within 1e-6 rad of the angle gate
    (counted; the rows holding a pair within 4 ulp of a band edge are
    counted and compared), and the two runs bit for bit each other;
    then the kernel's time with the rejection on and off (profiler
    device time), the plain version's, the share of pair tests the
    rejection skips, the bound of every pair test and the bound of the
    tests left, and the library yardstick: torch.topk(keys, row_cap) on
    a precomputed key plane of one capture, times the captures of the
    call. Returns (rows by shape, largest |difference| on the compared
    rows)."""
    import torch
    from super4pcs_tpu_torch.kernels import rowcap_layout as k2x
    from super4pcs_tpu_torch.ops import select
    rows, err = {}, 0
    gen = torch.Generator(device=dev)
    for label, q, p, cfg, nt, row_cap, eps in _layout_cases(
            s4, P, Q, fP, fQ, p_pos, q_pos, opts, dev):
        n = q[0].shape[0]
        gen.manual_seed(nt + n)
        ids, _, _, _ = select.select_base(
            p[0], float(torch.linalg.vector_norm(q[0], dim=1).max() * 2),
            *select.draw_base_indices(gen, p[0].shape[0], nt, 1000))
        bases = tuple(c[ids] for c in p)
        offs = torch.randint(0, n, (nt,), generator=gen, device=dev)
        args = (*(c[None] for c in q), *bases)
        rb = (k2x.reject_bounds(args[0]) if cfg.use_distance_filter
              else None)
        before = k2x.rowcap_layout.launches
        got = k2x.rowcap_layout(*args, eps, cfg, row_cap, col_offset=offs,
                                bounds=rb)
        made = k2x.rowcap_layout.launches - before
        off_run = k2x.rowcap_layout(*args, eps, cfg, row_cap,
                                    col_offset=offs, tile_reject=False)
        ref = k2x.rowcap_layout_plain(*args, eps, cfg, row_cap,
                                      col_offset=offs)
        band, angle = k2x.gate_edge_rows(args[0], bases[0], eps, cfg)
        torch.cuda.synchronize()
        on_off = all(torch.equal(x, y) for a, b in zip(got, off_run)
                     for x, y in zip(a, b))
        del off_run
        mism = kept_mism = band_mism = hits = captured = 0
        for e, ((c, h, rc), (c0, h0, rc0)) in enumerate(zip(got, ref)):
            same = (c == c0).all(-1) & (h == h0).all(-1) & (rc == rc0)
            mism += int((~same).sum())
            kept_mism += int((~same & ~angle[e]).sum())
            band_mism += int((~same & band[e]).sum())
            keep = ~angle[e]
            if bool(keep.any()):
                err = max(err, int((c[keep].long() - c0[keep].long())
                                   .abs().max()),
                          int((rc[keep] - rc0[keep]).abs().max()))
            hits += int(rc.sum())
            captured += int(h.sum())
        n_band, n_angle = int(band.sum()), int(angle.sum())
        del ref

        def call(reject=True):
            return k2x.rowcap_layout(*args, eps, cfg, row_cap,
                                     col_offset=offs, tile_reject=reject,
                                     bounds=rb if reject else None)

        ms = _kernel_ms(call, K2X_NAME, reps=10)
        ms_off = (_kernel_ms(lambda: call(False), K2X_NAME, reps=10)
                  if rb is not None else ms)
        plain_ms = _cuda_ms(lambda: k2x.rowcap_layout_plain(
            *args, eps, cfg, row_cap, col_offset=offs), reps=1, warmup=0)
        # the bounds: every (trial, edge, row, column) pair test, and the
        # tests the rejection leaves, with the filters on the pairs
        # inside the band, each input read once and the tables written
        # once
        n_pad = k2x._round_up(n, 2048)
        tests = 2.0 * nt * n * n
        share, left = _reject_share(k2x, args, rb, eps, cfg)
        dirs = cfg.max_angle > 0
        per_test = (K2X_OPS["dirs"] if dirs else K2X_OPS["band"]) \
            if cfg.use_distance_filter else K2X_OPS["no-band"]
        bare_cfg = k2x.PairFilterConfig(
            max_angle=cfg.max_angle,
            use_distance_filter=cfg.use_distance_filter)
        in_band = sum(int(rc.sum()) for _, _, rc in k2x.rowcap_layout(
            *args, eps, bare_cfg, row_cap, col_offset=offs))
        filt = (K2X_OPS["normals"] * (cfg.max_normal_difference > 0)
                + K2X_OPS["scores"] * (cfg.max_color_distance > 0
                                       or cfg.max_translation_distance > 0)
                + K2X_OPS["angle"] * dirs)
        scores = (cfg.max_color_distance > 0
                  or cfg.max_translation_distance > 0)
        nbytes = (16 * n * (1 + (cfg.max_normal_difference > 0))
                  + 2 * nt * (32 + 8 * n * scores) + 4 * nt
                  + 2 * nt * n_pad * (row_cap + 1) * 4)
        bound_ms, bound_by = _bound(per_test * tests + filt * in_band,
                                    nbytes)
        need_ms, need_by = _bound(per_test * left + filt * in_band, nbytes)
        keys = _key_plane(q[0], q[1], q[2], bases[0][0], bases[1][0],
                          bases[2][0], int(offs[0]), eps, cfg)
        plane_ms = _cuda_ms(lambda: torch.topk(keys, row_cap, dim=-1),
                            reps=3)
        del keys
        torch.cuda.empty_cache()
        library_ms = plane_ms * 2 * nt
        _log(f"K2x {label}: {nt} trials x 2 edges in {made} launch, "
             f"row_cap={row_cap}, hits={hits} captured={captured}; rows "
             f"differing from the plain version: {mism} of "
             f"{2 * nt * n_pad}, {kept_mism} outside the angle-gate rows "
             f"({n_angle} rows hold a candidate within 1e-6 rad of the "
             f"angle gate; {n_band} rows hold a pair within 4 ulp of a "
             f"band edge, {band_mism} of them differ); rejection on equals "
             f"off bit for bit={on_off}, it skips {100 * share:.2f}% of "
             f"the pair tests; kernel {ms:.4f} ms (rejection off "
             f"{ms_off:.4f}) plain {plain_ms:.3f} ms bound {bound_ms:.4f} "
             f"ms ({bound_by}; {in_band} pairs in band), after rejection "
             f"{need_ms:.4f} ms ({need_by}; {left:.0f} pair tests); "
             f"library torch.topk(keys, {row_cap}) {plane_ms:.3f} ms a "
             f"plane x {2 * nt} planes = {library_ms:.3f} ms")
        if made != 1 or kept_mism or not on_off or hits == 0:
            raise SystemExit(f"K2x {label} disagrees with its plain "
                             f"version or with itself without rejection, "
                             f"or launched {made} times")
        rows[label] = dict(ms=ms, ms_no_reject=ms_off, plain_ms=plain_ms,
                           bound_ms=bound_ms, bound_by=bound_by,
                           bound_after_reject_ms=need_ms,
                           bound_after_reject_by=need_by,
                           rejected_share=share, pair_tests_left=left,
                           library_ms=library_ms,
                           library_plane_ms=plane_ms, trials=nt,
                           row_cap=row_cap, hits=hits, captured=captured,
                           rows_differing=mism, band_edge_rows=n_band,
                           angle_gate_rows=n_angle)
        del got, args, rb
        torch.cuda.empty_cache()
    return rows, err


def _step_numbers(m, first: int):
    """A replayed step of matcher ``m`` (initialized) as its search runs
    it, outside the search: its wall (4 steps), device busy time, sort
    time and kernels (2 more under the profiler), idle share; and the
    peak memory of the same step launched op by op (a replay allocates
    nothing: the graph's pool holds its memory). A matcher whose
    registration released its graphs captures its step again first."""
    import torch
    if m._graph is None:
        m._capture()
    m._run_step(first)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    m._run_step(first + 1, eager=True)
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    t0 = time.perf_counter()
    for i in range(first + 2, first + 6):
        m._run_step(i)
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0) / 4
    evs = _device_events(lambda: [m._run_step(i)
                                  for i in (first + 6, first + 7)])
    busy = sum(t for _, t, _ in evs) / 2 / 1e3
    sort_ms = sum(t for name, t, _ in evs if "sort" in name.lower()) / 2e3
    return dict(step_wall_ms=wall, step_busy_ms=busy,
                idle_share=1.0 - busy / wall, step_kernels=len(evs) / 2,
                step_sort_ms=sort_ms, step_peak_mib=peak)


def _xla_path(P, Q, s4, counters, by_path, report):
    """Phase 5r: the headline registration on the XLA route
    (``Options(delta=0.01, sample_size=8192, rowcap_kernel="xla")``,
    the headline's other options) through
    ``MatchSuper4PCS.compute_transformation``: the headline's gates, K1
    and K2x launched and K2 not; its search seconds, trials, a replayed
    step's wall, busy time, kernels and peak memory."""
    xopts = _headline_options(s4).replace(rowcap_kernel="xla")
    ms = []

    def run():
        m = s4.MatchSuper4PCS(xopts, device="cuda")
        ms.append(m)
        return m.compute_transformation(s4.PointCloud(P), s4.PointCloud(Q))

    res, counts, wall, peak = _run_path("xla-rowcap", run, counters)
    by_path["xla-rowcap"] = counts
    if (counts["rowcap_layout"] <= 0 or counts["rowcap_capture"] != 0
            or counts["lcp_min_d2_within"] <= 0):
        raise SystemExit(f"xla-rowcap launched K2x "
                         f"{counts['rowcap_layout']}, K2 "
                         f"{counts['rowcap_capture']}, K1 "
                         f"{counts['lcp_min_d2_within']} times")
    report("xla-rowcap", res, wall, peak)
    step = _step_numbers(ms[0], 100)
    _log(f"xla-rowcap: search_s={res.stats['search_seconds']:.3f} "
         f"trials={res.n_trials} pairs_overflow="
         f"{res.stats['pairs_overflow']} peak {peak:.1f} MiB; a replayed "
         f"step: wall {step['step_wall_ms']:.2f} ms, busy "
         f"{step['step_busy_ms']:.2f} ms (idle share "
         f"{100 * step['idle_share']:.0f}%), {step['step_kernels']:.0f} "
         f"kernels recorded by the profiler, peak "
         f"{step['step_peak_mib']:.1f} MiB")
    return dict(search_s=res.stats["search_seconds"], trials=res.n_trials,
                score=res.score, pairs_overflow=res.stats["pairs_overflow"],
                wall_s=wall, peak_mib=peak, **step)


def _plain_step(m, draws):
    """Step ``draws`` of matcher ``m`` launched op by op through the
    kernels (K2x, K1), then through their plain versions on the card:
    (kernel outputs, plain outputs) on the host."""
    from super4pcs_tpu_torch.kernels import lcp as k1
    from super4pcs_tpu_torch.kernels import rowcap_layout as k2x
    from super4pcs_tpu_torch.ops import lcp as olcp
    args = (draws, m._max_base_diameter) + m._step_args()

    def fetch():
        return {k: v.cpu() for k, v in m._step_fn.run(*args).items()}

    got = fetch()
    saved = k2x.rowcap_layout, olcp.lcp_min_d2_within
    k2x.rowcap_layout = (lambda *a, tile_reject=True, bounds=None, **k:
                         k2x.rowcap_layout_plain(*a, **k))
    olcp.lcp_min_d2_within = k1.lcp_min_d2_within_plain
    try:
        ref = fetch()
    finally:
        k2x.rowcap_layout, olcp.lcp_min_d2_within = saved
    return got, ref


def _similarity_rowcap_paths(s4, counters, by_path):
    """Phase 5s: similarity mode with ``pair_engine="rowcap"`` (the XLA
    route, K2x) on 5i's scaled 50k scan at nq 4096, 20 s each: with
    ``pair_row_cap=4096`` (every pair captured: no pair dropped) and at
    the default row cap. Both run through with K2x launched and K2 not;
    on one step on fixed draws each edge's ``dropped`` is its ``count -
    captured`` and the step's pair drops their sum, and the step equals
    the same step through the plain versions (K2x's and K1's) on the
    card bit for bit. Their LCP and scale error are printed, not gated:
    the JAX package records that a capped capture loses the true joint
    in this mode (super4pcs_tpu/matcher.py:131-139), and its join probes
    only the first join_q_budget valid slots on every engine but
    allpairs (:585-591); the port copies both."""
    import torch
    from super4pcs_tpu_torch import matcher as mt
    SP, SQ = _scale_pair()
    base = _scale_aopts(s4).replace(pair_engine="rowcap",
                                    max_time_seconds=20)
    numbers = {}
    for label, kw in (("similarity-rowcap-full", dict(pair_row_cap=4096)),
                      ("similarity-rowcap", {})):
        opts = base.replace(**kw)
        ms = []

        def run():
            m = s4.MatchSuper4PCS(opts, device="cuda")
            ms.append(m)
            return m.compute_transformation(s4.PointCloud(SP),
                                            s4.PointCloud(SQ))

        res, counts, wall, peak = _run_path(label, run, counters)
        by_path[label] = counts
        m = ms[0]
        nq = int(m._d_q_pos.shape[0])
        st = res.stats
        if (mt.resolve_pair_engine(m._opts_eff(), nq) != "rowcap"
                or counts["rowcap_layout"] <= 0
                or counts["rowcap_capture"] != 0):
            raise SystemExit(f"{label}: not the XLA route's capture "
                             f"(launches {counts})")
        if kw and st["pairs_overflow"] != 0:
            raise SystemExit(f"{label}: {st['pairs_overflow']} pairs "
                             f"dropped with every pair's slot")
        edges = []
        real = mt.extract_pairs_rowcap_layout_both

        def recording(*a, **k):
            out = real(*a, **k)
            edges.append([(int(c.sum()), int(v.sum()), int(d.sum()))
                          for _, v, c, d in out])
            return out

        mt.extract_pairs_rowcap_layout_both = recording
        try:
            got, ref = _plain_step(m, m._draws(700))
        finally:
            mt.extract_pairs_rowcap_layout_both = real
        same = set(got) == set(ref) and all(_same_bits(got[k], ref[k])
                                            for k in got)
        exact = all(d == c - v for call in edges for c, v, d in call)
        step_drops = int(got["pair_counts"][..., 4].sum())
        drops = sum(d for c, v, d in edges[0])
        s_est, err, rot_diff, tr_diff = _scale_error(res)
        _log(f"{label}: nq={nq} B={m._b_eff} row_cap="
             f"{opts.pair_row_cap or 'default'} score={res.score:.4f} "
             f"scale={s_est:.5f} (error {100 * err:.3f}%) rotDiff="
             f"{rot_diff:.4f} trDiff={tr_diff:.4f} trials={res.n_trials} "
             f"search_s={st['search_seconds']:.3f} pairs_overflow="
             f"{st['pairs_overflow']} wall_s={wall:.3f} peak {peak:.1f} "
             f"MiB (not gated: the reference's own capture and join; see "
             f"phase 5s); a step on fixed draws: dropped == count - "
             f"captured on both edges={exact}, the step's pair drops "
             f"{step_drops} = {drops}, equal to the plain versions' step "
             f"bit for bit={same}")
        if not (same and exact and step_drops == drops):
            raise SystemExit(f"{label}: the step's drop accounting or its "
                             f"plain versions' step differs")
        numbers[label] = dict(nq=nq, score=res.score, scale=s_est,
                              scale_err=err, trials=res.n_trials,
                              search_s=st["search_seconds"],
                              pairs_overflow=st["pairs_overflow"],
                              wall_s=wall, peak_mib=peak)
        del m, ms
        torch.cuda.empty_cache()
    return numbers


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if sys.argv[1:2] == ["--batch-worker"]:
        return _batch_worker(sys.argv[2:])
    import numpy as np

    import bench
    import super4pcs_tpu_torch as s4
    from super4pcs_tpu_torch.kernels import _build
    from super4pcs_tpu_torch.kernels import join as kj
    from super4pcs_tpu_torch.kernels import lcp as k1
    from super4pcs_tpu_torch.kernels import rowcap as k2
    from super4pcs_tpu_torch.kernels import rowcap_layout as k2x
    from super4pcs_tpu_torch.io import native as io_native
    from super4pcs_tpu_torch.ops import sampling, select

    dev = torch.device("cuda")
    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    _log(smi)
    _log("torch", torch.__version__, "cuda", torch.version.cuda,
         "device", torch.cuda.get_device_name(0))

    # 2. build: one nvcc per source and g++ for the IO parsers, started
    # together
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        futures = [pool.submit(k._lib) for k in (k1, k2, k2x, kj)]
        io_lib = pool.submit(io_native.get_lib)
        for f in futures:
            f.result()
        if io_lib.result() is None:
            raise SystemExit("the native IO parsers (csrc/io_native.cpp) "
                             "did not build or load")
    _log(f"build: {time.perf_counter() - t0:.3f} s (native IO library "
         f"{io_native.library_path().name})")
    for name, text in _build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                _log(f"  {name}: {line.strip()}")

    counters = _counters()
    if "--dispatch-only" in sys.argv:
        # phase 5q alone
        P, Q = bench.fine_delta_pair()
        fP, fQ = _filtered_clouds(P, Q, s4)
        with tempfile.TemporaryDirectory() as tmp:
            _log("entry points:", json.dumps(
                {"dispatch": _dispatch_paths(s4, tmp, P, Q, fP, fQ)}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if "--scale-only" in sys.argv:
        # phases 5h-5i alone: 5h is then the first registration in its
        # process (the off-clock warm-up's check)
        _log("entry points:", json.dumps(_scale_paths(s4, counters, {})))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    # the headline clouds and their samples, as the matcher forms them
    P, Q = bench.fine_delta_pair()
    opts = _headline_options(s4)
    p_pos, q_pos = _samples(s4, P, Q, opts.delta, opts.sample_size,
                            opts.random_seed, dev)
    _log(f"headline samples: np={p_pos.shape[0]} nq={q_pos.shape[0]}")
    gt = _ground_truth()
    b_eff = s4.matcher.resolve_bases_per_step(opts, q_pos.shape[0])
    by_path = {}

    def report(label, res, wall, peak):
        rot_diff, tr_diff = s4.reference_pose_diff(res.transform, gt)
        steps = max(res.n_trials // b_eff, 1)
        st = res.stats
        _log(f"{label}: score={res.score:.4f} trials={res.n_trials} "
             f"steps={steps} "
             f"search_s={st.get('search_seconds', float('nan')):.3f} "
             f"mean_step_s={st.get('search_seconds', 0.0) / steps:.3f} "
             f"wall_s={wall:.3f} rotDiff={rot_diff:.4f} "
             f"trDiff={tr_diff:.4f} pairs_per_step="
             f"{st.get('n_pairs', 0) / steps:.0f} peak_MiB={peak:.1f}")
        _log(f"{label} stats:", json.dumps(
            {k: v for k, v in st.items() if not isinstance(v, dict)}))
        if not (res.score >= 0.7 and rot_diff <= 0.2 and tr_diff <= 0.1):
            raise SystemExit(f"{label} registration missed its gates")
        return st.get("n_pairs", 0) / steps

    if "--xla-only" in sys.argv:
        # phases 4c, 5r and 5s alone: the XLA route
        fP, fQ = _filtered_clouds(P, Q, s4)
        _layout_phase(s4, P, Q, fP, fQ, p_pos, q_pos, opts, dev)
        numbers = {"xla-rowcap": _xla_path(P, Q, s4, counters, by_path,
                                           report)}
        numbers.update(_similarity_rowcap_paths(s4, counters, by_path))
        if "--seeds" in sys.argv:
            _xla_seed_runs([int(x) for x in sys.argv[
                sys.argv.index("--seeds") + 1].split(",")], P, Q, s4)
        _log("entry points:", json.dumps(numbers))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if "--refine-only" in sys.argv:
        # phases 3c and 5 alone: KR, and the main path that launches it
        kr_rows = _refine_walk_rows(p_pos, q_pos, opts.delta, dev)
        _headline_path(P, Q, opts, s4, counters, by_path, report)
        print(json.dumps({"kernels": [dict(name="nearest_within",
                                           shapes=kr_rows)]}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if "--join-only" in sys.argv:
        # phases 3d and 5 alone: KJ, the main path that launches it, and
        # the step's split
        kj_rows = _join_rows(s4, p_pos, q_pos, opts, dev)
        _headline_path(P, Q, opts, s4, counters, by_path, report)
        split = _step_split(P, Q, opts, s4)
        print(json.dumps({"kernels": [dict(name="grid_join",
                                           shapes=kj_rows)],
                          "step_split": split}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    k1_err = 0.0
    near_pose = _pose_sampler(dev)

    def check_within(label, tr, qs, ps, eps, ref, brute):
        """lcp_min_d2_within against its plain walk and the contract
        where(ref <= eps^2, ref, inf) of the plain brute force ``ref``,
        with the hit count of the brute-force kernel's ``brute``; its
        times, pair tests and bounds. Returns its JSON fields, and its
        largest error and non-finite mismatches (:func:`_finite_err`)
        against the contract and the walk."""
        eps2 = float(np.float32(eps) * np.float32(eps))
        got = k1.lcp_min_d2_within(tr, qs, ps, eps)
        walk = k1.lcp_min_d2_within_plain(tr, qs, ps, eps)
        contract = torch.where(ref <= eps2, ref, float("inf"))
        torch.cuda.synchronize()
        same = torch.equal(got, contract) and torch.equal(got, walk)
        errs = [_finite_err(got, want) for want in (contract, walk)]
        err, bad = max(e for e, _ in errs), sum(b for _, b in errs)
        hits_w = int(torch.isfinite(got).sum())
        hits_b = int((brute <= eps2).sum())
        del walk, contract
        ms = _kernel_ms(lambda: k1.lcp_min_d2_within(tr, qs, ps, eps),
                        K1W_NAME, reps=10)
        build_ms = _device_ms(lambda: k1.grid_index(ps, eps), reps=10)
        plain_ms = _cuda_ms(
            lambda: k1.lcp_min_d2_within_plain(tr, qs, ps, eps), reps=1)
        tested = k1.pair_tests(tr, qs, ps, eps)
        c, nq, np_ = tr.shape[0], qs.shape[0], ps.shape[0]
        # the pruned work: its pair tests, each input read once (P as
        # float4 points and int32 keys), the output written once
        bound_ms, bound_by = _bound(
            K1_OPS * tested, 4 * (16 * c + 3 * nq + 5 * np_ + c * nq))
        brute_ms, _ = _bound(K1_OPS * c * nq * np_,
                             4 * (16 * c + 3 * nq + 3 * np_ + c * nq))
        _log(f"K1 within {label}: C={c} nq={nq} np={np_} eps={eps} "
             f"equal to plain walk and contract={same} max|dd2|="
             f"{err:.3e} non-finite mismatches={bad} hits kernel="
             f"{hits_w} brute-force kernel={hits_b} pair tests={tested} "
             f"({tested / (c * nq):.1f} per query, brute force "
             f"{c * nq * np_}) kernel {ms:.4f} ms index build "
             f"{build_ms:.4f} ms plain {plain_ms:.3f} ms bound "
             f"{bound_ms:.5f} ms ({bound_by}), brute-force bound "
             f"{brute_ms:.3f} ms")
        if not (same and hits_w == hits_b):
            raise SystemExit(f"K1 within {label} disagrees with its "
                             f"contract")
        return dict(shape=f"C={c} nq={nq} np={np_} eps={eps}", ms=ms,
                    plain_ms=plain_ms, bound_ms=bound_ms,
                    bound_by=bound_by, library_ms=None,
                    index_build_ms=build_ms, pair_tests=tested,
                    brute_force_bound_ms=brute_ms), err, bad

    brute_rows = {}

    def check_tiles(label, tr, qs, ps, ref, plain_ms):
        """The tiled brute force (``tr`` None: min_sq_dists) against its
        plain version's ``ref``, bit for bit, with P's index built
        beforehand; its time, the index build, the tests the queries
        need (k1.needed_tests) and those its counting build made, and
        three bounds: the queries' need (``bound_ms``), the work it did
        and the brute force's. Returns (its output, its row)."""
        index = k1.tile_index(ps)
        if tr is None:
            def fn():
                return k1.min_sq_dists(qs, ps, index)
        else:
            def fn():
                return k1.lcp_min_d2(tr, qs, ps, index)
        got = fn()
        torch.cuda.synchronize()
        same = torch.equal(got, ref)
        err = float((got - ref).abs().max()) if got.numel() else 0.0
        c = 1 if tr is None else tr.shape[0]
        nq, np_ = qs.shape[0], ps.shape[0]
        m = c * nq
        _, pairs, boxes, parts = k1.lcp_min_d2_counts(tr, qs, ps, index)
        ms = _kernel_ms(fn, (K1B_NAME, K1B_FILL) if parts > 1 else K1B_NAME,
                        reps=10)
        build_ms = _device_ms(lambda: k1.tile_index(ps), reps=10)
        need = k1.needed_tests(tr, qs, index, ref)
        n_tiles, n_groups = (index.tile_box.shape[0],
                             index.group_box.shape[0])
        # each input read once (the index as float4 points and two float4
        # a box), the output written once
        nbytes = (4 * (16 * c + 3 * nq + m) + 16 * k1.TILE * n_tiles
                  + 32 * (n_tiles + n_groups))
        bound_ms, bound_by = _bound(
            K1_OPS * need["pairs"] + K1_BOX_OPS * need["boxes"], nbytes)
        work_ms, work_by = _bound(K1_OPS * pairs + K1_BOX_OPS * boxes,
                                  nbytes)
        brute_ms, brute_by = _bound(K1_OPS * m * np_,
                                    4 * (16 * c + 3 * nq + 3 * np_ + m))
        _log(f"K1 brute force {label}: C={c} nq={nq} np={np_} equal to "
             f"plain={same} max|dd2|={err:.3e}; {n_tiles} tiles, {n_groups} "
             f"groups, {parts} part(s) over blockIdx.y; per query: pair "
             f"tests {pairs / m:.1f} made, {need['pairs'] / m:.1f} needed "
             f"alone, {need['warp_pairs'] / m:.1f} by its warps "
             f"({need['other_order_pairs'] / m:.1f} in the other slot "
             f"order); box tests {boxes / m:.1f} made, "
             f"{need['boxes'] / m:.1f} needed (brute force {np_} pair "
             f"tests); kernel {ms:.4f} ms index build {build_ms:.4f} ms "
             f"plain {plain_ms:.3f} ms; bound of the need {bound_ms:.5f} ms "
             f"({bound_by}), of the work done {work_ms:.5f} ms ({work_by}),"
             f" of the brute force {brute_ms:.3f} ms ({brute_by})")
        if not same:
            raise SystemExit(f"K1 brute force {label} disagrees with its "
                             f"plain version")
        return got, dict(shape=f"C={c} nq={nq} np={np_}", ms=ms,
                         plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=None,
                         index_build_ms=build_ms, parts=parts,
                         pair_tests=pairs, box_tests=boxes,
                         pair_tests_per_query=pairs / m,
                         box_tests_per_query=boxes / m,
                         needed_pair_tests_per_query=need["pairs"] / m,
                         needed_box_tests_per_query=need["boxes"] / m,
                         warp_union_pair_tests_per_query=(
                             need["warp_pairs"] / m),
                         other_order_pair_tests_per_query=(
                             need["other_order_pairs"] / m),
                         work_bound_ms=work_ms, work_bound_by=work_by,
                         brute_force_bound_ms=brute_ms, max_abs_err=err)

    # 3. K1 at the verify's shapes: the pruned kernel against its
    # contract, the brute force against its plain version
    k1w_row = None
    k1w_err, k1w_bad = 0.0, 0
    for label, c, qs, ps in (
            ("exact", 64, q_pos, p_pos),
            ("mid", 2048, q_pos[::16], p_pos[::10]),
            ("coarse-4096", 4096, q_pos[::128], p_pos[::37]),
            ("coarse-16384", 16384, q_pos[::128], p_pos[::37])):
        qs = qs.contiguous()
        ps = ps.contiguous()
        tr = near_pose(c)
        ref = k1.lcp_min_d2_plain(tr, qs, ps)
        plain_ms = _cuda_ms(lambda: k1.lcp_min_d2_plain(tr, qs, ps),
                            reps=2)
        got, brute_rows[label] = check_tiles(label, tr, qs, ps, ref,
                                             plain_ms)
        k1_err = max(k1_err, brute_rows[label]["max_abs_err"])
        row, w_err, w_bad = check_within(label, tr, qs, ps, opts.delta,
                                         ref, got)
        k1w_err, k1w_bad = max(k1w_err, w_err), k1w_bad + w_bad
        if label == "exact":
            k1w_row = row
        if label == "coarse-4096":
            # the library yardstick: one PyTorch call for the same
            # function on the transformed queries (its (C, nq, Np)
            # distance matrix fits in memory at this shape only)
            tq = torch.stack(k1._transformed(tr, qs), dim=-1)
            pb = ps[None].expand(c, -1, -1)
            lib = torch.cdist(tq, pb).amin(-1)
            lib_err = float((lib * lib - ref).abs().max())
            library_ms = _cuda_ms(lambda: torch.cdist(tq, pb).amin(-1),
                                  reps=3)
            _log(f"K1 library: torch.cdist(tq, p).amin(-1) at C={c} "
                 f"nq={qs.shape[0]} np={ps.shape[0]}: {library_ms:.3f} ms"
                 f" (max|cdist^2 - plain| {lib_err:.3e})")
            brute_rows[label]["library_ms"] = library_ms
            del tq, pb, lib
        del got, ref

    # 3b. K1 at the 1M config's shapes (the TPU's streamed-P K3), and
    # min_sq_dists (K4a/K4b) against its plain version
    t0 = time.perf_counter()
    upos, uq = _ultra_pair()
    up, uqp = _ultra_samples(s4, upos, uq, dev)
    _log(f"1M config samples: np={up.shape[0]} nq={uqp.shape[0]} "
         f"({time.perf_counter() - t0:.1f} s to build and sample)")
    tr = near_pose(64)
    plain = {}
    plain_ms = _cuda_ms(lambda: plain.update(
        ref=k1.lcp_min_d2_plain(tr, uqp, up)), reps=1, warmup=0)
    ref = plain.pop("ref")
    got, brute_rows["1M exact"] = check_tiles("1M exact", tr, uqp, up, ref,
                                              plain_ms)
    k1_err = max(k1_err, brute_rows["1M exact"]["max_abs_err"])
    k1w_1m, w_err, w_bad = check_within("1M exact", tr, uqp, up, 0.005,
                                        ref, got)
    k1w_err, k1w_bad = max(k1w_err, w_err), k1w_bad + w_bad
    del ref, got
    ref = k1.min_sq_dists_plain(uqp, up)
    plain_ms = _cuda_ms(lambda: k1.min_sq_dists_plain(uqp, up), reps=2)
    got, brute_rows["K4a"] = check_tiles("K4a (min_sq_dists)", None, uqp,
                                         up, ref, plain_ms)
    k1_err = max(k1_err, brute_rows["K4a"]["max_abs_err"])
    # the library yardstick at the 1M shapes: one torch.cdist + amin
    # over the whole (M, Np) matrix (34.8 GB), for K4a (the queries as
    # they are) and for K3 at C = 1 (the queries moved by one candidate)
    library_1m = {}
    for name, qs in (("K4a", uqp), ("K3 C=1", torch.stack(
            k1._transformed(tr[:1], uqp), dim=-1)[0].contiguous())):
        want = (ref if name == "K4a"
                else k1.lcp_min_d2_plain(tr[:1], uqp, up)[0])
        lib = torch.cdist(qs, up).amin(-1)
        lib_err = float((lib * lib - want).abs().max())
        del lib
        lib_ms = _cuda_ms(lambda: torch.cdist(qs, up).amin(-1), reps=2)
        torch.cuda.empty_cache()
        library_1m[name] = dict(shape=f"M={qs.shape[0]} np={up.shape[0]}",
                                ms=lib_ms, max_abs_err=lib_err)
        if name == "K4a":
            brute_rows["K4a"]["library_ms"] = lib_ms
        gb = 4 * qs.shape[0] * up.shape[0] / 1e9
        _log(f"library {name}: torch.cdist(q, p).amin(-1) at M="
             f"{qs.shape[0]} np={up.shape[0]} ({gb:.1f} GB matrix): "
             f"{lib_ms:.3f} ms (max|cdist^2 - plain| {lib_err:.3e})")
    del up, uqp, got, ref

    # 3c. KR, the refine's neighbour walk, at the headline's shapes
    kr_rows = _refine_walk_rows(p_pos, q_pos, opts.delta, dev)

    # 3d. KJ, the join kernel, on a step's joins
    kj_rows = _join_rows(s4, p_pos, q_pos, opts, dev)

    # 4. K2 against its plain version (edge 0 with the join hash)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    ids, inv1, _, bvalid = select.select_base(
        p_pos, float(torch.linalg.vector_norm(q_pos, dim=1).max() * 2),
        *select.draw_base_indices(gen, p_pos.shape[0], 1, 1000))
    ids = ids[0]
    base = p_pos[ids]
    d = torch.linalg.vector_norm(base[0] - base[1])
    eps = 2.0 * opts.delta
    lo2 = torch.clamp(d - eps, min=0.0) ** 2
    hi2 = (d + eps) ** 2
    row_cap = k2.slots_for(q_pos.shape[0], 160)
    cell = 4.0 * opts.delta
    cap_args = (q_pos, lo2, hi2, row_cap, inv1[0], cell, True)
    got = k2.rowcap_capture(*cap_args)
    ref = k2.rowcap_capture_plain(*cap_args)
    same = all(torch.equal(a, b) for a, b in zip(got, ref))
    mism = sum(int((a != b).sum()) for a, b in zip(got, ref))
    k2_err = max(int((a.long() - b.long()).abs().max())
                 for a, b in zip(got, ref))
    hits = int(got[1].sum())
    ms = _kernel_ms(lambda: k2.rowcap_capture(*cap_args), K2_NAMES,
                    reps=20)
    plain_ms = _cuda_ms(lambda: k2.rowcap_capture_plain(*cap_args), reps=3)
    _log(f"K2: n={q_pos.shape[0]} row_cap={row_cap} hits={hits} "
         f"captured={int((got[0] >= 0).sum())} bit-identical={same} "
         f"mismatches={mism} kernel {ms:.3f} ms plain {plain_ms:.3f} ms")
    if not same or hits == 0:
        raise SystemExit("K2 disagrees with its plain version")
    # ... and with tile-pair rejection on (the main path's default)
    bounds = k2.reject_bounds(q_pos)
    rej = float(k2.tile_reject_mask(*bounds, lo2, hi2).float().mean())
    got = k2.rowcap_capture(*cap_args, bounds=bounds)
    same = all(torch.equal(a, b) for a, b in zip(got, ref))
    ms_rej = _kernel_ms(lambda: k2.rowcap_capture(*cap_args, bounds=bounds),
                        K2_NAMES, reps=20)
    prep_ms = _kernel_ms(lambda: k2.rowcap_capture(*cap_args, bounds=bounds),
                         K2_NAMES[1], reps=20)
    n_pad = k2._round_up(q_pos.shape[0], 2048)
    tested = (1.0 - rej) * n_pad * n_pad
    bound_ms, bound_by = _bound(
        K2_BAND_OPS * tested + K2_HASH_OPS * int((got[0] >= 0).sum()),
        12 * q_pos.shape[0] + 4 * n_pad * (2 * row_cap + 1))
    _log(f"K2 with rejection: {100 * rej:.1f}% of tile pairs rejected, "
         f"bit-identical={same} kernel {ms_rej:.4f} ms, of which prep "
         f"{prep_ms:.4f} ms (off {ms:.4f} ms; one-thread-per-row "
         f"kernel {K2_ROW_THREAD_MS['headline'][0]} / "
         f"{K2_ROW_THREAD_MS['headline'][1]} ms) "
         f"bound {bound_ms:.4f} ms ({bound_by})")
    if not same:
        raise SystemExit("K2 with rejection disagrees with its plain "
                         "version")
    k2_row = dict(shape=f"n={q_pos.shape[0]} row_cap={row_cap} edge 0 "
                  f"with hash, rejection on", ms=ms_rej, plain_ms=plain_ms,
                  bound_ms=bound_ms, bound_by=bound_by, library_ms=None)

    # 4a. K2 with all four filters, both edges, rejection on and off
    fP, fQ = _filtered_clouds(P, Q, s4)
    filters = dict(max_normal_difference=20.0, max_color_distance=60.0,
                   max_translation_distance=1.3, max_angle=80.0)
    # P's voxel sample keeps the order of the headline's (p_pos), so the
    # base ids index its normals and colors
    fsp = sampling.sample_for_matching(fP, opts.delta, 8192, False,
                                       np.random.default_rng(0))
    if not np.array_equal(fsp.pos - fsp.pos.mean(0), p_pos.cpu().numpy()):
        raise SystemExit("the filtered P sample differs from the headline's")
    for n_q, target in ((8192, 160), (32768, 160)):
        fsq = sampling.sample_for_matching(fQ, opts.delta, n_q, True,
                                           np.random.default_rng(n_q))
        fsq = fsq.take(sampling.kd_argsort(fsq.pos))
        fq = torch.as_tensor(fsq.pos - fsq.pos.mean(0), device=dev)
        fn_ = torch.as_tensor(fsq.normals_or_zero(), device=dev)
        fc = torch.as_tensor(fsq.rgb_or_invalid(), device=dev)
        bp = base
        bn = torch.as_tensor(fsp.normals_or_zero(), device=dev)[ids]
        bc = torch.as_tensor(fsp.rgb_or_invalid(), device=dev)[ids]
        rcap = k2.slots_for(fq.shape[0], target)
        fbounds = k2.reject_bounds(fq)
        # rejection share over 64 bases drawn as the matcher draws them
        gen.manual_seed(n_q)
        many, _, _, _ = select.select_base(
            p_pos, float(torch.linalg.vector_norm(q_pos, dim=1).max() * 2),
            *select.draw_base_indices(gen, p_pos.shape[0], 64, 1000))
        shares = torch.stack([
            k2.tile_reject_mask(*fbounds, kw["lo2"], kw["hi2"]).float()
            .mean() for b4 in p_pos[many]
            for kw in k2.edge_args(fq, b4, eps)])
        _log(f"K2 rejection at n={fq.shape[0]} over 64 bases x 2 edges: "
             f"mean {100 * float(shares.mean()):.1f}%, min "
             f"{100 * float(shares.min()):.1f}%, max "
             f"{100 * float(shares.max()):.1f}% of tile pairs")
        args = k2.edge_args(fq, bp, eps, fn_, fc, bn, bc, **filters)
        bare = k2.edge_args(fq, bp, eps)
        n_pad = k2._round_up(fq.shape[0], 2048)
        for e, (kw, kw0) in enumerate(zip(args, bare)):
            hash_kw = (dict(inv=inv1[0], cell=cell, emit_hash=True)
                       if e == 0 else {})
            ref = k2.rowcap_capture_plain(fq, row_cap=rcap, **hash_kw,
                                          **kw)
            on = k2.rowcap_capture(fq, row_cap=rcap, bounds=fbounds,
                                   **hash_kw, **kw)
            off = k2.rowcap_capture(fq, row_cap=rcap, **hash_kw, **kw)
            unf = k2.rowcap_capture(fq, row_cap=rcap, **hash_kw, **kw0)
            same = all(torch.equal(a, b) and torch.equal(a, c)
                       for a, b, c in zip(on, off, ref))
            k2_err = max([k2_err] + [int((a.long() - b.long()).abs().max())
                                     for a, b in zip(on, ref)])
            rej = float(k2.tile_reject_mask(fbounds[0], fbounds[1],
                                            kw["lo2"], kw["hi2"])
                        .float().mean())
            ms_on = _kernel_ms(lambda: k2.rowcap_capture(
                fq, row_cap=rcap, bounds=fbounds, **hash_kw, **kw),
                K2_NAMES, reps=10)
            ms_off = _kernel_ms(lambda: k2.rowcap_capture(
                fq, row_cap=rcap, **hash_kw, **kw), K2_NAMES, reps=10)
            ms_unf = _kernel_ms(lambda: k2.rowcap_capture(
                fq, row_cap=rcap, bounds=fbounds, **hash_kw, **kw0),
                K2_NAMES, reps=10)
            pl_ms = _cuda_ms(lambda: k2.rowcap_capture_plain(
                fq, row_cap=rcap, **hash_kw, **kw), reps=2)
            in_band = int(unf[1].sum())
            ops = (K2_BAND_OPS * (1.0 - rej) * n_pad * n_pad
                   + sum(K2_FILTER_OPS.values()) * in_band
                   + (K2_HASH_OPS * int((on[0] >= 0).sum()) if e == 0
                      else 0))
            nbytes = (4 * fq.shape[0] * 10
                      + 4 * n_pad * ((2 if e == 0 else 1) * rcap + 1))
            b_ms, b_by = _bound(ops, nbytes)
            _log(f"K2 filtered: n={fq.shape[0]} row_cap={rcap} edge {e} "
                 f"pairs in band={in_band} passing filters="
                 f"{int(on[1].sum())} bit-identical (on, off, plain)="
                 f"{same} rejected={100 * rej:.1f}% kernel {ms_on:.4f} ms "
                 f"(one-thread-per-row kernel "
                 f"{K2_ROW_THREAD_MS[(fq.shape[0], e)]} ms; "
                 f"rejection off {ms_off:.4f} ms, unfiltered "
                 f"{ms_unf:.4f} ms) plain {pl_ms:.3f} ms bound "
                 f"{b_ms:.4f} ms ({b_by})")
            if not same or int(on[1].sum()) == 0:
                raise SystemExit("filtered K2 disagrees with its plain "
                                 "version")
    del fq, fn_, fc, on, off, ref, unf

    # 4b. K2 and K1 over the trial and pairs axes at the headline's
    # shapes: T = 16 captures of one Q (a headline step's edge) and T =
    # 64 over four (a step of phase 5j), one launch each; the verify's
    # exact stage for G = 1 and G = 4 pairs in one launch, their indexes
    # built once beforehand
    gen.manual_seed(64)
    many, inv_many, _, _ = select.select_base(
        p_pos, float(torch.linalg.vector_norm(q_pos, dim=1).max() * 2),
        *select.draw_base_indices(gen, p_pos.shape[0], 64, 1000))
    q4 = torch.stack([q_pos] + [
        q_pos @ torch.as_tensor(_axis_rot(ax, 0.7), dtype=torch.float32,
                                device=dev).T
        for ax in ((1, 0, 0), (0, 1, 0), (1, 1, 1))]).contiguous()
    n_pad = k2._round_up(q_pos.shape[0], 2048)
    batched = {"K2": {}, "K1": {}}
    for label, nt, n_sets in (("T=16", 16, 1), ("T=64", 64, 4)):
        qs = q4[:n_sets]
        kw0 = k2.edge_args(qs, p_pos[many[:nt]], eps)[0]
        bnd = k2.reject_bounds(qs)
        cap = (qs, kw0["lo2"], kw0["hi2"], row_cap)
        ckw = dict(inv=inv_many[:nt], cell=cell, emit_hash=True)
        before = (k2.rowcap_capture.launches, k2.rowcap_capture.captures)
        got = k2.rowcap_capture(*cap, bounds=bnd, **ckw)
        made = (k2.rowcap_capture.launches - before[0],
                k2.rowcap_capture.captures - before[1])
        ref = k2.rowcap_capture_plain(*cap, **ckw)
        same = all(torch.equal(a, b) for a, b in zip(got, ref))
        k2_err = max([k2_err] + [int((a.long() - b.long()).abs().max())
                                 for a, b in zip(got, ref)])
        per_set = nt // n_sets
        rej = torch.stack([k2.tile_reject_mask(
            bnd[0][t // per_set], bnd[1][t // per_set], kw0["lo2"][t],
            kw0["hi2"][t]).float().mean() for t in range(nt)])
        captured = int((got[0] >= 0).sum())
        ms = _kernel_ms(lambda: k2.rowcap_capture(*cap, bounds=bnd, **ckw),
                        K2_NAMES, reps=10)
        plain_ms = _cuda_ms(lambda: k2.rowcap_capture_plain(*cap, **ckw),
                            reps=1)
        bound_ms, bound_by = _bound(
            K2_BAND_OPS * float((1.0 - rej).sum()) * n_pad * n_pad
            + K2_HASH_OPS * captured,
            12 * n_sets * q_pos.shape[0] + nt * 4 * n_pad * (2 * row_cap + 1))
        _log(f"K2 batched {label}: {n_sets} point set(s), {nt} trials in "
             f"{made[0]} launch(es) ({made[1]} captures), edge 0 with hash,"
             f" rejection on ({100 * float(rej.mean()):.1f}% of tile pairs)"
             f": bit-identical to the plain version={same}, hits="
             f"{int(got[1].sum())} captured={captured}; kernel {ms:.4f} ms "
             f"({ms / nt:.4f} ms per trial) plain {plain_ms:.3f} ms bound "
             f"{bound_ms:.4f} ms ({bound_by})")
        if not same or made != (1, nt):
            raise SystemExit(f"batched K2 {label} disagrees with its "
                             f"plain version or launched {made}")
        batched["K2"][label] = dict(
            trials=nt, sets=n_sets, ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by,
            rejected=float(rej.mean()))
        del got, ref
        # the verify's exact stage for G pairs (the headline pair each)
        trs = torch.stack([near_pose(64) for _ in range(n_sets)])
        qq = q_pos[None].expand(n_sets, -1, -1).contiguous()
        pp = p_pos[None].expand(n_sets, -1, -1)
        index = k1.build_index(pp, opts.delta)
        before = k1.lcp_min_d2_within.launches
        got = k1.lcp_min_d2_within(trs, qq, pp, opts.delta, index)
        made = k1.lcp_min_d2_within.launches - before
        walk = k1.lcp_min_d2_within_plain(trs, qq, pp, opts.delta, index)
        torch.cuda.synchronize()
        same = torch.equal(got, walk)
        err, bad = _finite_err(got, walk)
        k1w_err, k1w_bad = max(k1w_err, err), k1w_bad + bad
        ms = _kernel_ms(lambda: k1.lcp_min_d2_within(
            trs, qq, pp, opts.delta, index), K1W_NAME, reps=10)
        build_ms = _device_ms(lambda: k1.build_index(pp, opts.delta), reps=3)
        plain_ms = _cuda_ms(lambda: k1.lcp_min_d2_within_plain(
            trs, qq, pp, opts.delta, index), reps=1)
        tested = k1.pair_tests(trs, qq, pp, opts.delta, index)
        c, nq_, np_ = trs.shape[1], qq.shape[1], pp.shape[1]
        bound_ms, bound_by = _bound(
            K1_OPS * tested,
            4 * n_sets * (16 * c + 3 * nq_ + 5 * np_ + c * nq_))
        _log(f"K1 batched exact stage, G={n_sets} pairs x C={c} x nq={nq_}"
             f" x np={np_} in {made} launch: equal to the plain walk="
             f"{same}, hits={int(torch.isfinite(got).sum())} pair tests="
             f"{tested}; kernel {ms:.4f} ms, index build (once per run) "
             f"{build_ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
             f"{bound_ms:.5f} ms ({bound_by})")
        if not same or made != 1:
            raise SystemExit(f"batched K1 at G={n_sets} disagrees with its "
                             f"plain walk or launched {made} times")
        batched["K1"][f"G={n_sets}"] = dict(
            pairs=n_sets, candidates=n_sets * c, ms=ms, plain_ms=plain_ms,
            index_build_ms=build_ms, bound_ms=bound_ms, bound_by=bound_by,
            pair_tests=tested)
        del got, walk, index
    del q4

    # 4c. K2x (the XLA route's capture) against its plain version at the
    # headline's width, filtered, at nq 32768 and in similarity mode
    k2x_rows, k2x_err = _layout_phase(s4, P, Q, fP, fQ, p_pos, q_pos, opts,
                                      dev)

    # 5. the headline registration through the public entry point
    headline_res, pairs_headline = _headline_path(P, Q, opts, s4, counters,
                                                  by_path, report)

    # 5b. the filtered registration at the headline's width
    fopts = (s4.Options(delta=0.01, sample_size=8192,
                        max_normal_difference=20.0, max_color_distance=60.0,
                        max_time_seconds=120, random_seed=1)
             .configure_overlap(0.7, terminate_threshold=0.7))
    res, counts, wall, peak = _run_path(
        "filtered", lambda: s4.MatchSuper4PCS(
            fopts, device="cuda").compute_transformation(fP, fQ), counters)
    by_path["filtered"] = counts
    if (min(counts["lcp_min_d2_within"], counts["rowcap_capture"]) <= 0
            or counts["rowcap_capture_filtered"] <= 0):
        raise SystemExit("a kernel of the filtered path never launched")
    _refine_launches("filtered", res, counts, fopts.refine_iterations)
    pairs_filtered = report("filtered", res, wall, peak)
    _log(f"pairs per step: filtered {pairs_filtered:.0f} against "
         f"unfiltered headline {pairs_headline:.0f} "
         f"({pairs_filtered / max(pairs_headline, 1):.3f}x)")

    # 5c-5f. the CLI from files; 5g. register_sequence
    file_numbers = _cli_paths(P, Q, fP, fQ, s4, counters, by_path)
    file_numbers.update(_sequence_paths(P, s4, counters, by_path))
    # 5h-5i. similarity mode
    file_numbers.update(_scale_paths(s4, counters, by_path))
    # 5j. register_batch on four pairs at the headline's width, on the
    # rowcap engine and on the banded engine
    file_numbers["batch"] = _batch_path(P, Q, s4, counters, by_path)
    file_numbers["batch-banded"] = _batch_path(P, Q, s4, counters, by_path,
                                               engine="banded")
    # 5k-5l. the banded engine at the headline's width and at nq =
    # 131,072 on the 1M pair; the rowcap engine there, measured
    file_numbers.update(_banded_paths(P, Q, upos, uq, opts, s4, counters,
                                      by_path))
    del upos, uq
    # 5m. the headline over a mesh of every card, then two shards on one
    file_numbers.update(_mesh_paths(P, Q, opts, headline_res, s4, counters,
                                    by_path, report))
    # 5n. register_batch over two processes
    file_numbers["batch-2proc"] = _dist_batch_path(P, Q, s4, by_path)
    # 5o. the headline with phase timing
    file_numbers["phase-timing"] = _phase_timing_path(
        P, Q, opts, headline_res, s4, counters, by_path, report)
    # 5r. the headline on the XLA route; 5s. similarity mode's rowcap
    # engine (both K2x)
    file_numbers["xla-rowcap"] = _xla_path(P, Q, s4, counters, by_path,
                                           report)
    file_numbers.update(_similarity_rowcap_paths(s4, counters, by_path))

    # 5p. a step of each dense path: launches, wall, busy, idle, peak
    # memory, launches against one base, every trial against its
    # one-base call (outside every path)
    with tempfile.TemporaryDirectory() as tmp:
        file_numbers["dense-steps"] = _dense_paths(s4, tmp)
        # 5q. the dispatch layer: graphed steps against eager ones on
        # every engine
        file_numbers["dispatch"] = _dispatch_paths(s4, tmp, P, Q, fP, fQ)

    # 6. the 500-point known-pose recipe (dense engine, K1 only: its
    # pruned verify)
    target, source = _recipe_pair()
    r, counts, _, _ = _run_path(
        "recipe", lambda: s4.register(
            target, source, overlap=0.9, delta=0.05, sample_size=500,
            max_time_seconds=30, device="cuda"), counters)
    by_path["recipe"] = counts
    moved = source @ r.transform[:3, :3].T + r.transform[:3, 3]
    med = float(np.median(np.linalg.norm(moved - target, axis=1)))
    _log(f"recipe: score={r.score:.4f} median_err={med:.3e} "
         f"trials={r.n_trials} "
         f"search_s={r.stats.get('search_seconds', float('nan')):.3f}")
    if not (r.score > 0.95 and med < 0.05):
        raise SystemExit("500-point recipe missed its gates")
    if counts["lcp_min_d2_within"] <= 0:
        raise SystemExit("K1 never launched on the recipe path")

    # 7. where a headline step's time goes: one step's launches, then 4
    # steps under the profiler after 4 unprofiled ones for their wall
    # time (outside every path)
    m = s4.MatchSuper4PCS(opts, device="cuda")
    m._init(s4.PointCloud(P), s4.PointCloud(Q))
    # the launch and index gates read a step launched op by op: a replay
    # runs no host code (no wrapper counts, no index build, no profiler
    # range), and the replayed graph is the capture of that step; the
    # capture's record is held to the graph's kernel nodes
    for obj, attr in counters.values():
        setattr(obj, attr, 0)
    builds = m._p_index.builds
    m._run_step(0, eager=True)
    step_launches = {k: getattr(obj, attr)
                     for k, (obj, attr) in counters.items()}
    # the kernels of K1's index build (its "grid_index" range) would be
    # counted with K1: the index is built once per run, so none may run
    # in a step
    eager_evs = _device_events(lambda: m._run_step(9, eager=True),
                               scope="grid_index")
    recorded_ok = _recorded_matches_nodes(m._graph)
    t0 = time.perf_counter()
    for i in range(1, 5):
        m._run_step(i)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / 4
    evs = _device_events(lambda: [m._run_step(i) for i in range(5, 9)])
    busy = sum(t for _, t, _ in evs) / 4 / 1e3
    parts = {}
    for name, t, _ in evs:
        key = next((k for k in (K1W_NAME, K1B_NAME) + K2_NAMES
                    if k in name),
                   "sort" if "sort" in name.lower() else "other")
        ms_, n_ = parts.get(key, (0.0, 0))
        parts[key] = (ms_ + t / 4 / 1e3, n_ + 1)
    in_index = sum(lab is not None for _, _, lab in eager_evs)
    _log(f"headline step launches (step 0 of seed 1, op by op): "
         f"{step_launches}; verify index builds: {builds} in the run's "
         f"set-up, {m._p_index.builds - builds} in its steps; kernels in "
         f"a grid_index range of a step: {in_index}; the capture's "
         f"recorded launches equal to its graph's kernel nodes="
         f"{recorded_ok}")
    if (in_index or m._p_index.builds != builds or not recorded_ok
            or step_launches["rowcap_capture"] != 2
            or step_launches["lcp_min_d2_within"] != 3):
        raise SystemExit("a headline step launched other than 2 captures "
                         "and 3 verifies, or built a verify index, or "
                         "its graph holds other launches than recorded")
    k1_step = {K1W_NAME: parts.get(K1W_NAME, (0.0, 0))[0]}
    _log(f"headline step profile (steps 5-8 of seed 1): wall "
         f"{1e3 * step_s:.1f} ms per unprofiled step, device busy "
         f"{busy:.1f} ms per step (idle share "
         f"{100 * (1 - busy / (1e3 * step_s)):.0f}%), "
         f"{len(evs) / 4:.0f} kernels recorded by the profiler per "
         f"step; per step: " + ", ".join(
             f"{k} {v[0]:.2f} ms in {v[1] / 4:.0f} launches"
             for k, v in sorted(parts.items(), key=lambda kv: -kv[1][0])))
    _log(f"K1 verify per step: {k1_step[K1W_NAME]:.3f} ms (kernel; its "
         f"indexes are built once per run)")

    def launches(name):
        return {path: c[name] for path, c in by_path.items()}

    lk = "super4pcs_tpu/kernels/lcp_pallas.py"
    rk = "super4pcs_tpu/kernels/rowcap_pallas.py"
    kernels = [
        dict(name="lcp_min_d2_within", route="cuda",
             source="super4pcs_tpu_torch/csrc/lcp.cu",
             replaces=(f"{lk}:76 (K1 _lcp_min_kernel, as the verify "
                       f"lcp_scores_pallas :157 calls it)"),
             launches=sum(launches("lcp_min_d2_within").values()),
             launches_by_path=launches("lcp_min_d2_within"),
             max_abs_err=k1w_err, nonfinite_mismatches=k1w_bad,
             **k1w_row,
             step_ms=k1_step[K1W_NAME],
             step_launches=step_launches["lcp_min_d2_within"],
             batched=batched["K1"],
             one_million={k: k1w_1m[k] for k in (
                 "shape", "ms", "bound_ms", "bound_by", "index_build_ms",
                 "pair_tests", "brute_force_bound_ms")}),
        dict(name="lcp_min_d2", route="cuda",
             source="super4pcs_tpu_torch/csrc/lcp.cu",
             replaces=(f"{lk}:76 (K1 _lcp_min_kernel); {lk}:276 (K3 "
                       f"_lcp_min_stream_kernel); {lk}:183 (K4a "
                       f"_min_dist_kernel); {lk}:227 (K4b "
                       f"_min_dist_stream_kernel)"),
             launches=sum(launches("lcp_min_d2").values()),
             launches_by_path=launches("lcp_min_d2"),
             library_1m=library_1m, shapes=brute_rows,
             **dict(brute_rows["coarse-4096"], max_abs_err=k1_err)),
        dict(name="rowcap_capture", route="cuda",
             source="super4pcs_tpu_torch/csrc/rowcap.cu",
             replaces=(f"{rk}:115 (K2 _kernel + _kernel_body :202); "
                       f"{rk}:168 (K2c tile-pair rejection, _tile_bounds "
                       f":323); {rk}:233 (K2d pair filters)"),
             launches=sum(launches("rowcap_capture").values()),
             launches_by_path=launches("rowcap_capture"),
             captures=sum(launches("rowcap_capture_captures").values()),
             captures_by_path=launches("rowcap_capture_captures"),
             filtered_launches=launches("rowcap_capture_filtered"),
             step_launches=step_launches["rowcap_capture"],
             step_captures=step_launches["rowcap_capture_captures"],
             batched=batched["K2"],
             max_abs_err=float(k2_err), **k2_row),
        dict(name="rowcap_layout", route="cuda",
             source="super4pcs_tpu_torch/csrc/rowcap_layout.cu",
             replaces=("super4pcs_tpu/ops/pairs.py:503 (K2x, an XLA op: "
                       "_rowcap_scan_edges, jax.lax.approx_max_k :573)"),
             launches=sum(launches("rowcap_layout").values()),
             launches_by_path=launches("rowcap_layout"),
             captures=sum(launches("rowcap_layout_captures").values()),
             max_abs_err=float(k2x_err),
             shapes=k2x_rows,
             **{k: k2x_rows["nq=8192 T=16"][k] for k in (
                 "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                 "rejected_share", "bound_after_reject_ms",
                 "bound_after_reject_by")}),
        dict(name="nearest_within", route="cuda",
             source="super4pcs_tpu_torch/csrc/lcp.cu",
             replaces=("no TPU kernel: the JAX refine's neighbour step "
                       "super4pcs_tpu/ops/refine.py:20 (_nearest) is XLA"),
             launches=sum(launches("nearest_within").values()),
             launches_by_path=launches("nearest_within"),
             shapes=kr_rows, **kr_rows["1x"]),
        dict(name="grid_join", route="cuda",
             source="super4pcs_tpu_torch/csrc/join.cu",
             replaces=("no TPU kernel: the port's sort-based range search "
                       "of ops/congruent.py::find_congruent_quads_grid "
                       "over the capture kernel's tables"),
             launches=sum(launches("grid_join").values()),
             launches_by_path=launches("grid_join"),
             shapes=kj_rows, **{k: kj_rows["T=16 w=2"][k] for k in (
                 "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}),
    ]
    if "--seeds" in sys.argv:
        seeds = [int(x) for x in
                 sys.argv[sys.argv.index("--seeds") + 1].split(",")]
        _seed_runs(seeds, opts, fopts, ((s4.PointCloud(P), s4.PointCloud(Q)),
                                        (fP, fQ)), s4)
    _log("entry points:", json.dumps(file_numbers))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
