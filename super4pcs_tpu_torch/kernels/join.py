"""KJ: the congruent join's grid search over K2's table hash, with no
sort.

The CUDA kernel (``csrc/join.cu``) replaces, on the card, the range
search of ``ops/congruent.py::find_congruent_quads_grid`` over the
capture kernel's implicit tables: the sort of every trial's table by
cell group, the ``torch.searchsorted`` per probe and the (T, L, probes)
candidate planes. It replaces no TPU kernel (the JAX package's join is
XLA ops); its note says what bounds it and how it is laid out. Its
contract is the plain join's outputs, bit for bit and in their order,
for every trial whatever the batch.

:func:`takes` is the route rule, read from the join's inputs alone: K2's
table hash over the row-capped layout (1-D cols tables), the probe
budget, no strided probe walk or implicit all-pairs table, no scale
band, the cone test or none (4PCS), and at most :data:`MAX_CANDIDATES`
entries a cell. ``find_congruent_quads_grid`` launches the kernel for
such inputs on a CUDA device and keeps its body, the plain version, for
every other join and on the CPU. :func:`grid_join` sends a CPU tensor to
that plain version and launches the kernel for a CUDA tensor (or
raises).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from .rowcap import _per_trial
from ..utils.graphs import launch_counter

#: most entries a cell the kernel takes (a warp keeps a cell's smallest)
MAX_CANDIDATES = 32


def tests_candidates(direction_bins: str, cone_cos_tolerance: float,
                     scale_band: float, cell_candidates: int) -> bool:
    """Whether the kernel runs a join's candidate tests: no scale band,
    the cone test (or no direction test) and at most
    :data:`MAX_CANDIDATES` entries a cell. The half of :func:`takes`
    that the matcher's cost model reads from its options."""
    return (scale_band < 0
            and (cone_cos_tolerance < 0 or direction_bins == "cone")
            and 1 <= cell_candidates <= MAX_CANDIDATES)


def takes(pairs1, valid1, pairs2, valid2, table_hash, row_cap,
          direction_bins: str, cone_cos_tolerance: float,
          scale_band: float, allpairs_cols: bool, q_uniform: bool,
          probe_budget, cell_candidates: int) -> bool:
    """Whether the kernel computes a grid join with these inputs: K2's
    table hash over cols-only tables of the row-capped layout, a probe
    budget, the first valid second-side slots as probes, and candidate
    tests it runs (:func:`tests_candidates`)."""
    return (table_hash is not None and row_cap is not None
            and pairs1 is not None and pairs1.shape == valid1.shape
            and pairs2 is not None and pairs2.shape == valid2.shape
            and probe_budget is not None and not allpairs_cols
            and not q_uniform
            and tests_candidates(direction_bins, cone_cos_tolerance,
                                 scale_band, cell_candidates))


def grid_join(pos, cols1, valid1, cols2, valid2, table_hash, invariant1,
              invariant2, distance_threshold: float, base_cos_alpha,
              cone_cos_tolerance: float, capacity: int,
              cell_candidates: int, q_budget, row_cap: int,
              probe_budget: int, cell_size=None):
    """The grid join of ``find_congruent_quads_grid`` for the inputs
    :func:`takes` accepts: ``cols1``/``cols2`` the (T, K) int32 cols
    tables, ``valid1``/``valid2`` their (T, K) bool masks, ``table_hash``
    the (T, K1) int32 hash of the first, ``pos`` the G point sets (G, n,
    3), trial ``t`` on set ``t // (T // G)``; a single trial without
    the leading T. ``invariant1``, ``invariant2`` and ``base_cos_alpha``
    are numbers or (T,) tensors.

    Returns the plain join's (quads (T, capacity, 4) int64, valid (T,
    capacity), count, dropped, q_subsampled (T,) int64).
    ``grid_join.launches`` counts launches, ``trials`` the trials they
    joined."""
    single = valid1.ndim == 1
    if single:
        pos = pos[None]
        cols1, valid1, cols2, valid2, table_hash = (
            t[None] for t in (cols1, valid1, cols2, valid2, table_hash))
    dev = pos.device
    nt, k1 = valid1.shape
    k2 = valid2.shape[1]
    if pos.dtype != torch.float32 or pos.ndim != 3 or pos.shape[2] != 3:
        raise ValueError(f"grid_join: pos must be float32 (G, n, 3), got "
                         f"{pos.dtype} {tuple(pos.shape)}")
    for name, t, dtype, k in (("cols1", cols1, torch.int32, k1),
                              ("table_hash", table_hash, torch.int32, k1),
                              ("cols2", cols2, torch.int32, k2),
                              ("valid2", valid2, torch.bool, k2)):
        if t.dtype != dtype or tuple(t.shape) != (nt, k) or t.device != dev:
            raise ValueError(f"grid_join: {name} must be {dtype} "
                             f"{(nt, k)} on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if nt % pos.shape[0]:
        raise ValueError(f"grid_join: {nt} trials over {pos.shape[0]} "
                         f"point sets")
    if k1 == 0 or k1 % row_cap or k2 % row_cap:
        raise ValueError(f"grid_join: tables of {k1} and {k2} slots in "
                         f"rows of {row_cap}")
    if not 1 <= cell_candidates <= MAX_CANDIDATES:
        raise ValueError(f"grid_join: cell_candidates {cell_candidates} "
                         f"outside 1..{MAX_CANDIDATES}")
    if probe_budget < 1 or capacity < 1:
        raise ValueError(f"grid_join: probe_budget {probe_budget} and "
                         f"capacity {capacity} must be positive")
    if dev.type == "cpu":
        from ..ops.congruent import find_congruent_quads_grid
        out = find_congruent_quads_grid(
            pos, cols1, valid1, cols2, valid2, invariant1, invariant2,
            distance_threshold, base_cos_alpha, cone_cos_tolerance,
            capacity, cell_candidates, q_budget, row_cap=row_cap,
            probe_budget=probe_budget, cell_size=cell_size,
            table_hash=table_hash)
    elif dev.type != "cuda":
        raise ValueError(f"grid_join: unsupported device {dev}")
    else:
        out = _launch(pos, cols1, cols2, valid2, table_hash, invariant1,
                      invariant2, distance_threshold, base_cos_alpha,
                      cone_cos_tolerance, capacity, cell_candidates,
                      q_budget, row_cap, probe_budget, cell_size)
    return tuple(o[0] for o in out) if single else out


def _launch(pos, cols1, cols2, valid2, table_hash, invariant1, invariant2,
            r, base_cos_alpha, cone_tol, capacity, L, q_budget, row_cap,
            probe_budget, cell_size):
    from ..ops.congruent import probe_window
    dev = pos.device
    nt, k1 = cols1.shape
    k2 = cols2.shape[1]
    g, n = pos.shape[:2]
    cell = cell_size if cell_size is not None else 2.0 * r
    w = probe_window(r, cell)
    qb = min(q_budget or 8192, k2)
    use_cone = cone_tol >= 0
    geo = torch.stack([_per_trial(v, nt, dev) for v in (
        invariant1, invariant2, base_cos_alpha if use_cone else 0.0, 0.0)],
        dim=1).contiguous()
    lib = _lib()
    work = torch.empty(lib.grid_join_workspace(
        nt, k1, k2, qb, w, L, probe_budget, capacity),
        dtype=torch.uint8, device=dev)
    quads = torch.empty((nt, capacity, 4), dtype=torch.int64, device=dev)
    valid = torch.empty((nt, capacity), dtype=torch.bool, device=dev)
    counts = torch.empty((3, nt), dtype=torch.int64, device=dev)
    pos, cols1, cols2, valid2, table_hash = (
        t.contiguous() for t in (pos, cols1, cols2, valid2, table_hash))
    f32 = np.float32
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(lib.grid_join(
            pos.data_ptr(), n, nt // g, cols1.data_ptr(),
            table_hash.data_ptr(), k1, cols2.data_ptr(), valid2.data_ptr(),
            k2, geo.data_ptr(), float(f32(r)), float(f32(r * r)),
            float(f32(cell)), float(f32(cone_tol)), int(use_cone), row_cap,
            L, qb, w, probe_budget, capacity, nt, work.data_ptr(),
            quads.data_ptr(), valid.data_ptr(), counts[0].data_ptr(),
            counts[1].data_ptr(), counts[2].data_ptr(), stream),
            "grid_join")
    grid_join.launches += 1
    grid_join.trials += nt
    return quads, valid, counts[0], counts[1], counts[2]


#: kernel launches since the count was last reset (CUDA path only); a
#: launch joins every trial of its call
grid_join.launches = 0
#: the trials those launches joined
grid_join.trials = 0
launch_counter(grid_join, "launches", "trials")


def join_bytes(k1: float, probes: float, kept: float, L: int,
               capacity: int) -> float:
    """Device-memory bytes of one trial's join in the kernel: the table
    hash read twice and the second table's mask once (9 bytes a slot),
    every slot at most once into its bucket and out (8), each probe's
    hash-table entry and flag (5), each kept candidate's slot ids and
    points (L x 40 a kept probe) and the quads (40 a slot)."""
    return (k1 * 17.0 + probes * 5.0 + kept * L * 40.0
            + capacity * 40.0)


def _lib():
    lib = _build.load("join")
    if lib.grid_join.argtypes is None:
        p, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_float)
        lib.grid_join_workspace.argtypes = [i, ll, ll, i, i, i, i, i]
        lib.grid_join_workspace.restype = ll
        lib.grid_join.argtypes = [p, i, i, p, p, ll, p, p, ll, p, f, f, f,
                                  f, i, i, i, i, i, i, i, i, p, p, p, p, p,
                                  p, p]
        lib.grid_join.restype = ctypes.c_int
    return lib
