"""K1: candidate-transform LCP min squared distances.

``lcp_min_d2(transforms, q, p)[c, i] = min_j |R_c q_i + t_c - p_j|^2``:
the verify core of the matcher (the reference's ``Verify`` kd-tree walk,
ref:src/super4pcs/algorithms/match4pcsBase.cc:504-567). Two CUDA kernels
(``csrc/lcp.cu``) replace the TPU kernel
``super4pcs_tpu/kernels/lcp_pallas.py::_lcp_min_kernel``; their notes
say what bounds them and how they are laid out.

- :func:`lcp_min_d2_within` is the verify of the main path: the same
  min, kept only where it is ``<= eps^2`` (``+inf`` elsewhere), found by
  walking a cell index of P (:func:`grid_index`, :func:`build_index`)
  instead of all of P. One launch verifies the candidates of one cloud
  pair or of G pairs; the caller builds the index once per run.
- :func:`lcp_min_d2` is the brute force over all of P. It covers the
  TPU's streamed-P variant ``_lcp_min_stream_kernel`` (K3) and the
  untransformed ``_min_dist_kernel`` / ``_min_dist_stream_kernel`` (K4a
  / K4b) through :func:`min_sq_dists`.

The wrappers send a CPU tensor to the plain version and launch the
kernel for a CUDA tensor (or raise): there is no fallback between the
two. Both compute d^2 as the sum of squared coordinate differences in
the same order, so they agree bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from . import _build


def _elem_budget(device: torch.device) -> int:
    # live elements of one d^2 block of the plain version
    return 1 << 27 if device.type == "cuda" else 1 << 22


def _transformed(transforms: torch.Tensor, q: torch.Tensor):
    """(C, nq) x, y, z of the transformed queries, each row
    ``((m0 x + m1 y) + m2 z) + m3`` (the kernel's order)."""
    x, y, z = q[:, 0], q[:, 1], q[:, 2]
    out = []
    for k in range(3):
        m = transforms[:, k]
        out.append(((m[:, 0:1] * x + m[:, 1:2] * y) + m[:, 2:3] * z)
                   + m[:, 3:4])
    return out


def _min_d2_rows(tx, ty, tz, p: torch.Tensor) -> torch.Tensor:
    """(M,) min over P of ``(tx - px)^2 + (ty - py)^2 + (tz - pz)^2``
    for the (M, 1) coordinate columns, blocked over the rows and over
    P, in the kernel's order."""
    m, np_ = tx.shape[0], p.shape[0]
    out = torch.full((m,), float("inf"), dtype=torch.float32,
                     device=p.device)
    if m == 0 or np_ == 0:
        return out
    px, py, pz = p[:, 0], p[:, 1], p[:, 2]
    budget = _elem_budget(p.device)
    pb = min(np_, max(budget // 64, 1024))
    rb = max(budget // pb, 1)
    for r0 in range(0, m, rb):
        r1 = min(r0 + rb, m)
        best = out[r0:r1]
        for p0 in range(0, np_, pb):
            p1 = min(p0 + pb, np_)
            d = tx[r0:r1] - px[p0:p1]
            d.mul_(d)
            e = ty[r0:r1] - py[p0:p1]
            d.add_(e.mul_(e))
            e = tz[r0:r1] - pz[p0:p1]
            d.add_(e.mul_(e))
            torch.minimum(best, d.amin(dim=1), out=best)
    return out


def lcp_min_d2_plain(transforms: torch.Tensor, q: torch.Tensor,
                     p: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: blocked over the flattened
    (C * nq) rows and over P, the same arithmetic order."""
    c, nq = transforms.shape[0], q.shape[0]
    if c * nq == 0:
        return torch.empty((c, nq), dtype=torch.float32, device=q.device)
    tx, ty, tz = (t.reshape(-1, 1) for t in _transformed(transforms, q))
    return _min_d2_rows(tx, ty, tz, p).view(c, nq)


def _check(what: str, transforms, q, p) -> torch.device:
    """The inputs' common device; raises on a wrong type, shape or a
    device that is neither the CPU nor CUDA."""
    dev = q.device
    for name, t, shape in (("transforms", transforms, (4, 4)),
                           ("q", q, (3,)), ("p", p, (3,))):
        if t.dtype != torch.float32 or tuple(t.shape[1:]) != shape:
            raise ValueError(f"{what}: {name} must be float32 "
                             f"(N, {', '.join(map(str, shape))}), got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != dev:
            raise ValueError(f"{what}: inputs on different devices")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {dev}")
    return dev


def lcp_min_d2(transforms: torch.Tensor, q: torch.Tensor,
               p: torch.Tensor) -> torch.Tensor:
    """(C, nq) f32 min squared distances of every transformed query to
    P. ``transforms`` (C, 4, 4), ``q`` (nq, 3), ``p`` (np, 3), all
    float32 on one device. CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    dev = _check("lcp_min_d2", transforms, q, p)
    if dev.type == "cpu":
        return lcp_min_d2_plain(transforms, q, p)
    transforms, q, p = (t.contiguous() for t in (transforms, q, p))
    c, nq, np_ = transforms.shape[0], q.shape[0], p.shape[0]
    out = torch.empty((c, nq), dtype=torch.float32, device=dev)
    if c * nq == 0:
        return out
    if np_ == 0:
        return out.fill_(float("inf"))
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(lib.lcp_min_d2(
            transforms.data_ptr(), q.data_ptr(), p.data_ptr(),
            out.data_ptr(), c, nq, np_, stream), "lcp_min_d2")
    lcp_min_d2.launches += 1
    return out


#: kernel launches since the count was last reset (CUDA path only)
lcp_min_d2.launches = 0


def _lib():
    lib = _build.load("lcp")
    fn = lib.lcp_min_d2
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    fn = lib.lcp_min_d2_within
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [
            ctypes.c_float] * 2 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


#: cells per axis of the index are at most 1001 (side >= extent / 1000),
#: so a cell key (ix * ny + iy) * nz + iz fits an int32
_AXIS_CELLS = 1000
#: relative widening of the query box (see :func:`_query_box`)
_WIDEN = 2.0 ** -20


def grid_index(p: torch.Tensor, eps):
    """Cell index of the (np, 3) cloud ``p`` for a search radius ``eps``:
    ``(pts (np, 4) f32, keys (np,) int32, grid (7,) f32)``.

    A uniform grid of side ``L = max(float32(eps), extent / 1000)`` over
    P's bounding box ``lo``; a point's cell per axis is
    ``floor((x - lo) / L)`` in float32 with IEEE division (``L`` is a
    tensor, never a host scalar), its key ``(ix * ny + iy) * nz + iz``.
    ``pts`` holds P sorted by key as ``(x, y, z, 0)``, ``keys`` the
    sorted keys, ``grid`` ``[lo_x, lo_y, lo_z, L, nx, ny, nz]``. Plain
    tensor work on P's device (no host sync); ``p`` is non-empty and
    finite.
    """
    lo, hi = torch.aminmax(p, dim=0)
    ext = hi - lo
    side = (ext.amax() / _AXIS_CELLS).clamp(
        min=max(float(np.float32(eps)), float(np.finfo(np.float32).tiny)))
    dims = torch.floor(ext / side) + 1
    cell = torch.floor((p - lo) / side).to(torch.int32)
    n = dims.to(torch.int32)
    keys = (cell[:, 0] * n[1] + cell[:, 1]) * n[2] + cell[:, 2]
    keys, perm = torch.sort(keys)
    pts = torch.nn.functional.pad(p[perm], (0, 1))
    return pts, keys, torch.cat([lo, side.reshape(1), dims])


class GridIndex(NamedTuple):
    """The cell indexes of G clouds for one radius, concatenated
    (:func:`build_index`): cloud g's points and keys are rows
    ``offs[g]:offs[g + 1]`` of ``pts``/``keys``, its grid ``grids[g]``."""
    pts: torch.Tensor       # (N, 4) f32
    keys: torch.Tensor      # (N,) int32
    offs: torch.Tensor      # (G + 1,) int32, on the points' device
    grids: torch.Tensor     # (G, 7) f32
    sizes: tuple            # the G clouds' point counts (host ints)
    eps: float              # float32(eps) the grids were sized for

    def part(self, g: int):
        """Cloud g's ``(pts, keys, grid)``, as :func:`grid_index`
        returns them."""
        o = sum(self.sizes[:g])
        sl = slice(o, o + self.sizes[g])
        return self.pts[sl], self.keys[sl], self.grids[g]


def build_index(p: torch.Tensor, eps) -> GridIndex:
    """The cell index of ``p`` (np, 3), or of each cloud of ``p`` (G,
    np, 3), for the radius ``eps``: :func:`grid_index` per cloud,
    concatenated. Within a registration P and the verify radii are
    fixed, so the matcher builds each once per run
    (ops/lcp.py::VerifyIndex) and passes it to every verify call."""
    clouds = [p] if p.ndim == 2 else list(p)
    dev = p.device
    # a named range, so that a profile can count the index's kernels
    # with the verify's
    with torch.profiler.record_function("grid_index"):
        parts = [grid_index(c, eps) for c in clouds if c.shape[0] > 0]
    sizes = tuple(int(c.shape[0]) for c in clouds)
    if len(parts) != len(clouds):
        if parts:
            raise ValueError("build_index: some clouds are empty")
        return GridIndex(
            torch.zeros((0, 4), dtype=torch.float32, device=dev),
            torch.zeros(0, dtype=torch.int32, device=dev),
            torch.zeros(len(clouds) + 1, dtype=torch.int32, device=dev),
            torch.zeros((len(clouds), 7), dtype=torch.float32, device=dev),
            sizes, float(np.float32(eps)))
    offs = torch.zeros(len(sizes) + 1, dtype=torch.int32, device=dev)
    offs[1:] = torch.cumsum(torch.tensor(
        sizes, dtype=torch.int32), 0).to(dev)
    return GridIndex(torch.cat([t[0] for t in parts]),
                     torch.cat([t[1] for t in parts]), offs,
                     torch.stack([t[2] for t in parts]), sizes,
                     float(np.float32(eps)))


def _query_box(tx, ty, tz, grid, eps: float):
    """Per query: the inclusive cell range ``(lo (M, 3), hi (M, 3))``
    int64 that holds every P point within ``eps`` of ``(tx, ty, tz)``,
    and ``empty`` (M,) bool where there is none (a non-finite query,
    or a box outside the grid).

    Per axis the box runs from ``cell(t - e)`` to ``cell(t + e)`` with
    ``e = eps (1 + 2^-20) + 2^-20 max(|t|_inf, eps)``, which covers the
    rounding of ``t -/+ e`` and of the d^2 sum, so a point whose float32
    d^2 is ``<= float32(eps)^2`` lies inside it. ``cell`` is the
    expression :func:`grid_index` assigned P with, so it is monotone
    and the box conservative. The kernel computes the box the same
    way, in float32."""
    t = torch.stack([tx, ty, tz], dim=1)
    e32 = float(np.float32(eps))
    tmax = t.abs().amax(dim=1, keepdim=True).clamp(min=e32)
    e = e32 * (1.0 + _WIDEN) + _WIDEN * tmax
    lo, side, n = grid[0:3], grid[3], grid[4:7]
    flo = torch.floor(((t - e) - lo) / side)
    fhi = torch.floor(((t + e) - lo) / side)
    empty = ~torch.isfinite(t).all(dim=1) | (
        (fhi < 0) | (flo > n - 1)).any(dim=1)
    flo = torch.where(empty[:, None], 0.0, flo)
    fhi = torch.where(empty[:, None], 0.0, fhi)
    return (torch.maximum(flo, torch.zeros_like(flo)).long(),
            torch.minimum(fhi, n - 1).long(), empty)


def walk_ranges(tx, ty, tz, keys, grid, eps):
    """The ranges of the sorted index that the kernel walks for the
    (M,) queries ``(tx, ty, tz)``: ``(starts (M, K), counts (M, K))``
    int64, one key range per (x, y) column of each query's box (z is
    the fastest axis of a key), ``count`` 0 for a column outside the
    box. ``counts.sum()`` is the number of pair tests."""
    blo, bhi, empty = _query_box(tx, ty, tz, grid, eps)
    ny, nz = int(grid[5]), int(grid[6])
    span = (bhi - blo + 1).masked_fill(empty[:, None], 0)
    sx, sy = int(span[:, 0].max()), int(span[:, 1].max())
    starts, counts = [], []
    for dx in range(sx):
        for dy in range(sy):
            ix, iy = blo[:, 0] + dx, blo[:, 1] + dy
            live = (ix <= bhi[:, 0]) & (iy <= bhi[:, 1]) & ~empty
            base = (ix * ny + iy) * nz
            s0 = torch.searchsorted(keys, (base + blo[:, 2]).to(torch.int32))
            s1 = torch.searchsorted(keys, (base + bhi[:, 2]).to(torch.int32),
                                    right=True)
            starts.append(s0)
            counts.append(torch.where(live, s1 - s0, 0))
    if not starts:
        zero = torch.zeros((tx.shape[0], 0), dtype=torch.int64,
                           device=tx.device)
        return zero, zero
    return torch.stack(starts, 1), torch.stack(counts, 1)


def _walk_plain(transforms, q, pts, keys, grid, eps) -> torch.Tensor:
    """The plain walk of one cloud's index ``(pts, keys, grid)``:
    (C, nq) as :func:`lcp_min_d2_within` returns it."""
    c, nq = transforms.shape[0], q.shape[0]
    dev = q.device
    out = torch.full((c * nq,), float("inf"), dtype=torch.float32,
                     device=dev)
    if c * nq == 0 or pts.shape[0] == 0:
        return out.view(c, nq)
    tx, ty, tz = (t.reshape(-1) for t in _transformed(transforms, q))
    starts, counts = walk_ranges(tx, ty, tz, keys, grid, eps)
    k = starts.shape[1]
    if k == 0:
        return out.view(c, nq)
    rb = max(1, _elem_budget(dev) // max(1, int(counts.sum(dim=1).max())))
    eps2 = float(np.float32(eps) * np.float32(eps))
    for r0 in range(0, c * nq, rb):
        r1 = min(r0 + rb, c * nq)
        cnt = counts[r0:r1].reshape(-1)
        tot = int(cnt.sum())
        if tot == 0:
            continue
        seg = torch.repeat_interleave(
            torch.arange(cnt.shape[0], device=dev), cnt)
        first = torch.cumsum(cnt, 0) - cnt
        j = (starts[r0:r1].reshape(-1)[seg]
             + torch.arange(tot, device=dev) - first[seg])
        row = r0 + seg // k
        v = pts[j]
        d = tx[row] - v[:, 0]
        d.mul_(d)
        e = ty[row] - v[:, 1]
        d.add_(e.mul_(e))
        e = tz[row] - v[:, 2]
        d.add_(e.mul_(e))
        out.scatter_reduce_(0, row, d, "amin")
    return torch.where(out <= eps2, out, float("inf")).view(c, nq)


def _index_for(p, eps, index):
    """``index`` checked against ``p`` and ``eps``, or built."""
    if index is None:
        return build_index(p, eps)
    n_sets = 1 if p.ndim == 2 else p.shape[0]
    if (len(index.sizes) != n_sets
            or index.eps != float(np.float32(eps))
            or any(s != p.shape[-2] for s in index.sizes)):
        raise ValueError(f"lcp_min_d2_within: the index was built for "
                         f"{len(index.sizes)} clouds of {index.sizes} "
                         f"points at eps {index.eps}, not {n_sets} of "
                         f"{p.shape[-2]} at {float(np.float32(eps))}")
    return index


def lcp_min_d2_within_plain(transforms: torch.Tensor, q: torch.Tensor,
                            p: torch.Tensor, eps,
                            index: GridIndex | None = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`lcp_min_d2_within`: the same
    index and query box, walked with ``searchsorted`` over the key
    columns (:func:`walk_ranges`) and a ragged gather, blocked over the
    flattened (C * nq) rows, one pair at a time with the pairs axis.
    d^2 in the kernel's order, so the result is
    ``where(lcp_min_d2_plain <= eps2, lcp_min_d2_plain, inf)`` bit for
    bit."""
    if q.ndim == 2:
        if p.shape[0] == 0:
            return _walk_plain(transforms, q, p, None, None, eps)
        pts, keys, grid = _index_for(p, eps, index).part(0)
        return _walk_plain(transforms, q, pts, keys, grid, eps)
    if p.shape[1] == 0:
        return torch.full(transforms.shape[:2] + (q.shape[1],),
                          float("inf"), dtype=torch.float32,
                          device=q.device)
    index = _index_for(p, eps, index)
    return torch.stack([_walk_plain(transforms[g], q[g], *index.part(g),
                                    eps) for g in range(q.shape[0])])


def lcp_min_d2_within(transforms: torch.Tensor, q: torch.Tensor,
                      p: torch.Tensor, eps,
                      index: GridIndex | None = None) -> torch.Tensor:
    """(C, nq) f32: the min squared distance of every transformed query
    to P where it is ``<= float32(eps)^2``, ``+inf`` elsewhere (and for
    a non-finite transformed query). Bit for bit
    ``where(lcp_min_d2(...) <= eps2, lcp_min_d2(...), inf)``: a point
    beyond ``eps`` never changes a min below ``eps``, so the kernel
    tests only the points of the cells around each query. Arguments as
    :func:`lcp_min_d2`, plus the search radius ``eps`` (a number).

    Pairs axis: ``transforms`` (G, C, 4, 4), ``q`` (G, nq, 3) and ``p``
    (G, np, 3) verify G pairs' candidates in one launch and return (G,
    C, nq), each pair's as its own call would.

    ``index`` is P's cell index for ``eps`` (:func:`build_index`); the
    caller that verifies the same P many times builds it once. Without
    it the index is built on this call. CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    batched = q.ndim == 3
    if batched:
        if transforms.ndim != 4 or p.ndim != 3 or len(
                {transforms.shape[0], q.shape[0], p.shape[0]}) != 1:
            raise ValueError(
                f"lcp_min_d2_within: the pairs axis needs transforms (G, "
                f"C, 4, 4), q (G, nq, 3) and p (G, np, 3), got "
                f"{tuple(transforms.shape)}, {tuple(q.shape)}, "
                f"{tuple(p.shape)}")
        dev = _check("lcp_min_d2_within", transforms.flatten(0, 1),
                     q.flatten(0, 1), p.flatten(0, 1))
    else:
        dev = _check("lcp_min_d2_within", transforms, q, p)
    if dev.type == "cpu":
        return lcp_min_d2_within_plain(transforms, q, p, eps, index)
    n_sets = q.shape[0] if batched else 1
    per_pair = transforms.shape[-3]
    nq, np_ = q.shape[-2], p.shape[-2]
    out = torch.empty(transforms.shape[:-2] + (nq,), dtype=torch.float32,
                      device=dev)
    if out.numel() == 0:
        return out
    if np_ == 0:
        return out.fill_(float("inf"))
    index = _index_for(p, eps, index)
    transforms, q = transforms.contiguous(), q.contiguous()
    e32 = np.float32(eps)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(lib.lcp_min_d2_within(
            transforms.data_ptr(), q.data_ptr(), index.pts.data_ptr(),
            index.keys.data_ptr(), index.offs.data_ptr(),
            index.grids.data_ptr(), out.data_ptr(), n_sets * per_pair,
            per_pair, nq, float(e32), float(e32 * e32), stream),
            "lcp_min_d2_within")
    lcp_min_d2_within.launches += 1
    return out


#: kernel launches since the count was last reset (CUDA path only)
lcp_min_d2_within.launches = 0


def min_sq_dists_plain(tq: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`min_sq_dists`: the direct
    ``min_j |tq_m - p_j|^2`` with no transform, in the kernel's order."""
    return _min_d2_rows(tq[:, 0:1], tq[:, 1:2], tq[:, 2:3], p)


def min_sq_dists(tq: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(M,) f32 ``min_j |tq_m - p_j|^2`` of the (M, 3) rows ``tq`` to the
    (Np, 3) cloud ``p``, with no transform.

    It launches K1 with one identity transform, which reproduces ``tq``
    exactly (``((1 x + 0 y) + 0 z) + 0 = x`` in IEEE arithmetic), so it
    is bit-identical to :func:`min_sq_dists_plain`. This covers three
    TPU kernels of ``super4pcs_tpu/kernels/lcp_pallas.py``:
    ``_min_dist_kernel`` (K4a, via ``min_sq_dists``),
    ``_min_dist_stream_kernel`` (K4b, via ``min_sq_dists_streamed``) and,
    for transformed queries, ``_lcp_min_stream_kernel`` (K3, via
    ``candidate_min_sq_dists_streamed``, which is :func:`lcp_min_d2`).
    The TPU split each into a VMEM-resident P (up to 300k points) and a
    P streamed through the Pallas pipeline; on the card K1 always
    streams P through shared memory in 1024-point tiles, so one kernel
    serves every Np. CPU tensors take the plain version.
    """
    if tq.dtype != torch.float32 or tq.ndim != 2 or tq.shape[1] != 3:
        raise ValueError(f"min_sq_dists: tq must be float32 (M, 3), got "
                         f"{tq.dtype} {tuple(tq.shape)}")
    if tq.device.type == "cpu":
        return min_sq_dists_plain(tq, p)
    eye = torch.eye(4, dtype=torch.float32, device=tq.device)[None]
    return lcp_min_d2(eye, tq, p)[0]
