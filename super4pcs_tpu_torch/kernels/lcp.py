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
- :func:`lcp_min_d2` is the min over all of P, found by an exact
  branch-and-bound over a tiled index of P (:func:`tile_index`): a box
  whose bound is at least a query's running min is skipped, so the
  result is the brute force's bit for bit. It covers the TPU's
  streamed-P variant ``_lcp_min_stream_kernel`` (K3) and the
  untransformed ``_min_dist_kernel`` / ``_min_dist_stream_kernel`` (K4a
  / K4b) through :func:`min_sq_dists`. :func:`tiled_walk` is the
  kernel's walk in torch, for the CPU tests.
- :func:`nearest_within` is the refine's neighbour step on the card:
  per query under one transform, the point of P nearest it within a
  radius, from a walk of the same cell index as the verify's. It
  replaces no TPU kernel (the JAX refine's search is XLA).

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
from ..utils.graphs import launch_counter


#: float32 operations per pair test of both kernels (csrc/lcp.cu): 3
#: sub, 3 mul, 2 add and the min
PAIR_TEST_OPS = 9


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
    """The inputs' common device (``transforms`` may be None); raises on a
    wrong type, shape or a device that is neither the CPU nor CUDA."""
    dev = q.device
    for name, t, shape in (("transforms", transforms, (4, 4)),
                           ("q", q, (3,)), ("p", p, (3,))):
        if t is None:
            continue
        if t.dtype != torch.float32 or tuple(t.shape[1:]) != shape:
            raise ValueError(f"{what}: {name} must be float32 "
                             f"(N, {', '.join(map(str, shape))}), got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != dev:
            raise ValueError(f"{what}: inputs on different devices")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {dev}")
    return dev


#: points a tile of the brute force's index (one a lane), tiles a group
TILE = 32
GROUP = 32
#: Morton code bits per axis (3 x 21 = 63 bits in an int64)
_MORTON_BITS = 21
#: below this many queries the kernel's slots run over the candidates
CAND_INNER_NQ = 1024
#: group boxes a part stages in shared memory (32 KB; csrc/lcp.cu
#: refuses more)
MAX_PART_GROUPS = 1024


class TileIndex(NamedTuple):
    """The tiled index of a cloud P that :func:`lcp_min_d2` walks
    (:func:`tile_index`): P in Morton order, tiles of 32 consecutive
    points and groups of 32 consecutive tiles, each with its box."""
    pts: torch.Tensor        # (32 T, 4) f32: (x, y, z, 0), tail padded
    tile_box: torch.Tensor   # (T, 2, 4) f32: lo, hi of each tile
    group_box: torch.Tensor  # (G, 2, 4) f32: lo, hi of each group
    perm: torch.Tensor       # (np,) int64: pts[i, :3] = p[perm[i]]
    n_points: int            # np


def _spread3(v: torch.Tensor) -> torch.Tensor:
    """The low 21 bits of each int64 of ``v`` moved to every third bit."""
    v = v & 0x1FFFFF
    v = (v | (v << 32)) & 0x1F00000000FFFF
    v = (v | (v << 16)) & 0x1F0000FF0000FF
    v = (v | (v << 8)) & 0x100F00F00F00F00F
    v = (v | (v << 4)) & 0x10C30C30C30C30C3
    return (v | (v << 2)) & 0x1249249249249249


def tile_index(p: torch.Tensor) -> TileIndex:
    """The tiled index of the (np, 3) float32 cloud ``p``, built with
    torch ops on its device (no host sync).

    Each point is quantised to 21 bits per axis over P's bounding box
    (cubic cells), its 63-bit Morton code sorted once (stable). The
    sorted points are stored as float4 ``(x, y, z, 0)`` and the tail is
    padded to a multiple of :data:`TILE` by repeating the last point (a
    duplicate never changes a min, and every box stays tight). Tile k is
    points ``[32 k, 32 k + 32)``, group g tiles ``[32 g, 32 g + 32)``
    (the last group may hold fewer); each has its axis-aligned box.
    ``p`` is finite."""
    n, dev = p.shape[0], p.device
    if n == 0:
        box = torch.zeros((0, 2, 4), dtype=torch.float32, device=dev)
        return TileIndex(torch.zeros((0, 4), dtype=torch.float32,
                                     device=dev), box, box,
                         torch.zeros(0, dtype=torch.int64, device=dev), 0)
    lo, hi = torch.aminmax(p, dim=0)
    span = (hi - lo).amax().clamp(min=float(np.finfo(np.float32).tiny))
    top = (1 << _MORTON_BITS) - 1
    cell = ((p - lo) * (top / span)).long().clamp_(0, top)
    code = (_spread3(cell[:, 0]) | (_spread3(cell[:, 1]) << 1)
            | (_spread3(cell[:, 2]) << 2))
    perm = torch.sort(code, stable=True).indices
    n_tiles = -(-n // TILE)
    n_groups = -(-n_tiles // GROUP)
    idx = torch.cat([perm, perm[-1:].expand(n_tiles * TILE - n)])
    pts = torch.nn.functional.pad(p[idx], (0, 1))
    tlo, thi = torch.aminmax(pts.view(n_tiles, TILE, 4), dim=1)
    pad = n_groups * GROUP - n_tiles
    glo = torch.cat([tlo, tlo[-1:].expand(pad, 4)]).view(
        n_groups, GROUP, 4).amin(1)
    ghi = torch.cat([thi, thi[-1:].expand(pad, 4)]).view(
        n_groups, GROUP, 4).amax(1)
    return TileIndex(pts, torch.stack([tlo, thi], 1),
                     torch.stack([glo, ghi], 1), perm, n)


def _tiles_for(p: torch.Tensor, index: TileIndex | None) -> TileIndex:
    """``index`` checked against ``p``, or built."""
    if index is None:
        return tile_index(p)
    if index.n_points != p.shape[0] or index.pts.device != p.device:
        raise ValueError(f"lcp_min_d2: the tile index was built for "
                         f"{index.n_points} points on {index.pts.device}, "
                         f"not {p.shape[0]} on {p.device}")
    return index


def _sum_sq(d):
    """``(dx dx + dy dy) + dz dz`` over the last axis (the kernel's
    order)."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    return (x * x + y * y) + z * z


def _box_bound(t, lo, hi):
    """The kernel's lower bound of the d^2 of ``t`` (..., 3) to any point
    of the boxes ``[lo, hi]`` (..., 3): per axis the gap ``max(lo - t,
    t - hi, 0)``, then ``(gx gx + gy gy) + gz gz``, in float32."""
    return _sum_sq(torch.maximum(lo - t, t - hi).clamp_min(0.0))


def _box_box_bound(lo, hi, a, b):
    """The kernel's coarse bound of the boxes ``[lo, hi]`` against a warp's
    query box ``[a, b]``: per axis ``max(lo - b, a - hi, 0)``, which is at
    most :func:`_box_bound` of every query in ``[a, b]``."""
    return _sum_sq(torch.maximum(lo - b, a - hi).clamp_min(0.0))


def _mid_d2(t, lo, hi):
    """The kernel's seed key: the d^2 of ``t`` to the middle
    ``0.5 lo + 0.5 hi`` of each box."""
    return _sum_sq(t - (0.5 * lo + 0.5 * hi))


def tiled_walk(transforms: torch.Tensor, q: torch.Tensor,
               index: TileIndex, parts: int = 1):
    """The kernel's walk in torch: ``(out (C * nq,), pair tests, box
    tests)``, with the kernel's warps, order, skip rules and counts
    (``transforms`` None: the rows of ``q`` as they are, C = 1).

    Slots run over the queries (over the candidates below
    :data:`CAND_INNER_NQ` queries) and are cut into warps of 32, each
    with the box ``[a, b]`` of its finite transformed queries. The
    group list is cut into ``parts`` interleaved lists (part p: groups
    p, p + parts, ...; at most one part a group, as the launcher cuts
    them), walked one after another (one schedule of the kernel's
    parts), each pruning against the output the earlier ones left.
    Per part and warp: the seeds (among the groups overlapping ``[a,
    b]``, else the one nearest its centre, each query's nearest group
    middle, then that group's nearest tile middle), the distinct seed
    tiles visited in the order of their first query; then per run of 32
    groups the coarse tests against ``[a, b]`` and the warp's largest
    limit, each candidate's fine test per query, and in a group the same
    for its tiles (the seed tiles left out). A tile is visited when any
    query's fine test passes; all the warp's finite queries then test
    its 32 points. With ``parts`` 1 the kernel makes the same decisions,
    so the counts are its counting build's."""
    c = 1 if transforms is None else transforms.shape[0]
    nq = q.shape[0]
    m, dev = c * nq, q.device
    t = q if transforms is None else torch.stack(
        [x.reshape(-1) for x in _transformed(transforms, q)], 1)
    inner = nq < CAND_INNER_NQ
    if inner:
        t = t.view(c, nq, 3).transpose(0, 1).reshape(-1, 3)
    n_tiles, n_groups = index.tile_box.shape[0], index.group_box.shape[0]
    if n_groups == 0:
        return torch.full((m,), float("inf"), device=dev), 0, 0
    out = torch.where(torch.isnan(t).any(1), float("nan"), float("inf"))
    if m == 0:
        return out, 0, 0
    pairs = boxes = 0
    n_warps = -(-m // 32)
    live = torch.zeros(n_warps * 32, dtype=torch.bool, device=dev)
    live[:m] = torch.isfinite(t).all(1)
    live = live.view(n_warps, 32)
    tw = torch.zeros((n_warps * 32, 3), dtype=torch.float32, device=dev)
    tw[:m] = t
    tw = torch.where(live.view(-1, 1), tw, 0.0).view(n_warps, 32, 3)
    inf = torch.tensor(float("inf"), device=dev)
    a = torch.where(live[..., None], tw, inf).amin(1)
    b = torch.where(live[..., None], tw, -inf).amax(1)
    centre = 0.5 * a + 0.5 * b
    active = live.any(1)
    n_active = int(active.sum())
    pts = index.pts[:, :3].reshape(n_tiles, TILE, 3)
    tlo, thi = index.tile_box[:, 0, :3], index.tile_box[:, 1, :3]
    glo, ghi = index.group_box[:, 0, :3], index.group_box[:, 1, :3]
    lanes = torch.arange(32, device=dev)
    res = torch.full((n_warps, 32), float("inf"), device=dev)

    def limit(best, ext, w):
        return torch.minimum(best[w], ext[w])

    def warp_limit(best, ext, w):
        return torch.where(live[w], limit(best, ext, w), -inf).amax(1)

    def visit(best, ext, w, tile):
        # the fine test of each warp w against its tile, then the visit
        nonlocal pairs, boxes
        fb = _box_bound(tw[w], tlo[tile][:, None], thi[tile][:, None])
        boxes += int(live[w].sum())
        go = (live[w] & (fb < limit(best, ext, w))).any(1)
        w, tile = w[go], tile[go]
        if w.numel() == 0:
            return
        d2 = _sum_sq(tw[w][:, :, None, :] - pts[tile][:, None, :, :])
        best[w] = torch.where(live[w], torch.minimum(best[w], d2.amin(2)),
                              best[w])
        pairs += TILE * int(live[w].sum())

    parts = min(parts, n_groups)
    for part in range(parts):
        gl = torch.arange(part, n_groups, parts, device=dev)
        ng = gl.shape[0]
        best = torch.full((n_warps, 32), float("inf"), device=dev)
        ext = res.clone()
        warps = active.nonzero().squeeze(1)
        # seed groups: among the part's groups that overlap the warp's box,
        # the one whose middle is nearest each query, else the group
        # nearest the box's centre
        ov = _box_box_bound(glo[gl], ghi[gl], a[warps][:, None],
                            b[warps][:, None]) == 0
        boxes += 2 * ng * n_active
        lw = live[warps]
        boxes += int((lw.sum(1) * ov.sum(1)).sum())
        gb = torch.where(ov[:, None], _mid_d2(tw[warps][:, :, None],
                                              glo[gl], ghi[gl]), inf)
        sg = torch.where(gb.amin(2) < inf, gb.argmin(2),
                         ov.int().argmax(1)[:, None])
        centre_g = _box_bound(centre[warps][:, None], glo[gl],
                              ghi[gl]).argmin(1)
        sg = torch.where(ov.any(1)[:, None], sg, centre_g[:, None])
        # the tile of its seed group whose middle is nearest each query
        tids = gl[sg][..., None] * GROUP + lanes
        valid = tids < n_tiles
        tids = tids.clamp(max=n_tiles - 1)
        boxes += int((valid & lw[..., None]).sum())
        tb = torch.where(valid, _mid_d2(tw[warps][:, :, None], tlo[tids],
                                        thi[tids]), inf)
        st = torch.where(lw, tids.gather(2, tb.argmin(2, keepdim=True))[
            ..., 0], -1)
        seed = torch.full((n_warps, 32), -1, dtype=torch.int64, device=dev)
        seed[warps] = st
        # visit the distinct seed tiles, in the order of their first query
        first = lw.clone()
        for r in range(1, 32):
            first[:, r] &= (st[:, :r] != st[:, r:r + 1]).all(1)
        for r in range(32):
            sel = first[:, r]
            visit(best, ext, warps[sel], st[sel, r])
        for base in range(0, ng, 32):
            gis = gl[base:base + 32]
            wl = warp_limit(best, ext, warps)
            cand = _box_box_bound(glo[gis], ghi[gis], a[warps][:, None],
                                  b[warps][:, None]) < wl[:, None]
            boxes += len(gis) * n_active
            for k in range(len(gis)):
                g = int(gis[k])
                w = warps[cand[:, k]]
                if w.numel() == 0:
                    continue
                fb = _box_bound(tw[w], glo[g], ghi[g])
                boxes += int(live[w].sum())
                w = w[(live[w] & (fb < limit(best, ext, w))).any(1)]
                if w.numel() == 0:
                    continue
                tl = warp_limit(best, ext, w)
                tiles = torch.arange(g * GROUP, min(g * GROUP + GROUP,
                                                    n_tiles), device=dev)
                other = (tiles[None, :, None] != seed[w][:, None]).all(2)
                boxes += int(other.sum())
                tcand = other & (_box_box_bound(
                    tlo[tiles], thi[tiles], a[w][:, None],
                    b[w][:, None]) < tl[:, None])
                for j in range(len(tiles)):
                    wj = w[tcand[:, j]]
                    if wj.numel():
                        visit(best, ext, wj, tiles[j].expand(wj.numel()))
        res = torch.where(live, torch.minimum(res, best), res)
    flat_live = live.view(-1)[:m]
    out[flat_live] = res.view(-1)[:m][flat_live]
    if inner:
        out = out.view(nq, c).t().reshape(-1)
    return out, pairs, boxes


def lcp_min_d2_tiled_plain(transforms: torch.Tensor, q: torch.Tensor,
                           p: torch.Tensor, index: TileIndex | None = None,
                           parts: int = 1) -> torch.Tensor:
    """The kernel's branch-and-bound over P's tiled index, in torch
    (:func:`tiled_walk`), for the CPU tests: (C, nq), bit for bit
    :func:`lcp_min_d2_plain`. No path calls it."""
    c, nq = transforms.shape[0], q.shape[0]
    out, _, _ = tiled_walk(transforms, q, _tiles_for(p, index), parts)
    return out.view(c, nq)


def needed_tests(transforms: torch.Tensor | None, q: torch.Tensor,
                 index: TileIndex, ref: torch.Tensor, chunk: int = 4096):
    """The tests the finite queries need on ``index``, whatever walks it,
    for a measurement (``transforms`` None: the rows of ``q``, C = 1;
    ``ref`` the brute force's min, C * nq values; ``chunk`` rows at a
    time, a multiple of 32). A dict of totals:

    - ``pairs``: a query cannot rule out a tile whose bound is below its
      min, and a finite min is held by one tile at least: 32 pair tests
      for each such tile, and for one tile when there is none;
    - ``boxes``: the box tests that rule out every other tile, one for
      each group whose bound is at least the query's min and, in the
      other groups, one for each tile whose bound is (one less when no
      tile's bound is below the min: the tile that holds it may be one);
    - ``warp_pairs``: the pair tests of warps of 32 slots in the
      kernel's order (:func:`tiled_walk`) that test each tile one of
      their queries needs (one at least, where a min is finite) with all
      their finite queries; ``other_order_pairs`` the same with the
      slots in the other order.
    """
    c = 1 if transforms is None else transforms.shape[0]
    nq = q.shape[0]
    t = q if transforms is None else torch.stack(
        [x.reshape(-1) for x in _transformed(transforms, q)], 1)
    ref = ref.reshape(-1)
    tlo, thi = index.tile_box[:, 0, :3], index.tile_box[:, 1, :3]
    glo, ghi = index.group_box[:, 0, :3], index.group_box[:, 1, :3]
    n_tiles, n_groups = tlo.shape[0], glo.shape[0]
    per_group = torch.bincount(
        torch.arange(n_tiles, device=t.device) // GROUP,
        minlength=n_groups)

    def count(t, ref):
        m = t.shape[0]
        pad = -m % 32
        t = torch.cat([t, t.new_full((pad, 3), float("nan"))])
        ref = torch.cat([ref, ref.new_full((pad,), float("inf"))])
        pairs = boxes = warps = 0
        for r0 in range(0, m + pad, chunk):
            tc, rc = t[r0:r0 + chunk], ref[r0:r0 + chunk, None]
            live = torch.isfinite(tc).all(1)
            below = (_box_bound(tc[:, None], tlo, thi) < rc) & live[:, None]
            n_below = below.sum(1)
            open_ = (_box_bound(tc[:, None], glo, ghi) < rc) & live[:, None]
            n_open = open_.sum(1)
            # a finite min is held by one tile at least
            held = live & torch.isfinite(rc[:, 0])
            pairs += int(torch.where(held, n_below.clamp(min=1),
                                     n_below).sum())
            rule_out = (n_groups - n_open
                        + torch.where(open_, per_group, 0).sum(1) - n_below
                        - ((n_below == 0) & (n_open > 0)).long())
            boxes += int(torch.where(live, rule_out, 0).sum())
            lanes = live.view(-1, 32).sum(1)
            union = torch.maximum(below.view(-1, 32, n_tiles).any(1).sum(1),
                                  held.view(-1, 32).any(1).long())
            warps += int((lanes * union).sum())
        return TILE * pairs, boxes, TILE * warps

    if n_tiles == 0:
        return dict(pairs=0, boxes=0, warp_pairs=0, other_order_pairs=0)
    pairs, boxes, warps_q = count(t, ref)
    warps_c = warps_q if c == 1 or nq == 1 else count(
        t.view(c, nq, 3).transpose(0, 1).reshape(-1, 3),
        ref.view(c, nq).t().reshape(-1))[2]
    inner = nq < CAND_INNER_NQ
    return dict(pairs=pairs, boxes=boxes,
                warp_pairs=warps_c if inner else warps_q,
                other_order_pairs=warps_q if inner else warps_c)


def lcp_min_d2(transforms: torch.Tensor, q: torch.Tensor,
               p: torch.Tensor, index: TileIndex | None = None
               ) -> torch.Tensor:
    """(C, nq) f32 min squared distances of every transformed query to
    P. ``transforms`` (C, 4, 4), ``q`` (nq, 3), ``p`` (np, 3), all
    float32 on one device; ``index`` is P's :func:`tile_index` (built on
    this call when not given). A query with a NaN transformed coordinate
    gives NaN, one with an infinite one +inf (as the plain version).
    CPU tensors take the plain version; CUDA tensors launch the
    branch-and-bound kernel, bit for bit the plain version's min."""
    dev = _check("lcp_min_d2", transforms, q, p)
    if dev.type == "cpu":
        if index is not None:
            _tiles_for(p, index)
        return lcp_min_d2_plain(transforms, q, p)
    out, parts = _launch_tiles(transforms, q, p, index, None)
    lcp_min_d2.launches += parts > 0
    return out


#: kernel launches since the count was last reset (CUDA path only)
lcp_min_d2.launches = 0
launch_counter(lcp_min_d2, "launches")


def tile_parts(total: int, n_groups: int, sms: int) -> int:
    """The number of parts the launcher splits the group list into for
    ``total`` = C * nq slots on a card of ``sms`` SMs: at most
    :data:`MAX_PART_GROUPS` groups a part, and enough parts for two
    blocks of 128 slots per SM, at most one a group."""
    blocks = -(-total // 128)
    parts = max(-(-n_groups // MAX_PART_GROUPS), -(-2 * sms // blocks))
    return min(parts, n_groups, 65535)


def _launch_tiles(transforms, q, p, index, counts):
    """(out, the number of parts of the group list the kernel was
    launched with, 0 if it was not) on the card; ``transforms`` None
    takes the rows of ``q`` as they are (C = 1). The launch's shape is
    decided here: the parts (:func:`tile_parts`) and the slot order
    (over the candidates below :data:`CAND_INNER_NQ` queries)."""
    q, p = q.contiguous(), p.contiguous()
    if transforms is not None:
        transforms = transforms.contiguous()
    c = 1 if transforms is None else transforms.shape[0]
    nq, np_ = q.shape[0], p.shape[0]
    out = torch.empty((c, nq), dtype=torch.float32, device=q.device)
    if c * nq == 0:
        return out, 0
    if np_ == 0:
        return out.fill_(float("inf")), 0
    index = _tiles_for(p, index)
    n_tiles, n_groups = index.tile_box.shape[0], index.group_box.shape[0]
    parts = tile_parts(c * nq, n_groups, torch.cuda.get_device_properties(
        q.device).multi_processor_count)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _build.check(lib.lcp_min_d2_tiles(
            0 if transforms is None else transforms.data_ptr(),
            q.data_ptr(), index.pts.data_ptr(),
            index.tile_box.data_ptr(), index.group_box.data_ptr(),
            out.data_ptr(), 0 if counts is None else counts.data_ptr(), c,
            nq, n_tiles, n_groups, parts, int(nq < CAND_INNER_NQ), stream),
            "lcp_min_d2")
    return out, parts


def lcp_min_d2_counts(transforms: torch.Tensor, q: torch.Tensor,
                      p: torch.Tensor, index: TileIndex | None = None):
    """``(out, pair tests, box tests, parts)`` of one launch of the
    kernel's counting build (CUDA tensors only): the work its walk did
    on these inputs, and the parts of the group list it was launched
    with (0: not launched), for a measurement. ``out`` is
    :func:`lcp_min_d2`'s (``transforms`` None: :func:`min_sq_dists`'
    rows, C = 1); the launch counts in ``lcp_min_d2.launches``."""
    dev = _check("lcp_min_d2_counts", transforms, q, p)
    if dev.type != "cuda":
        raise ValueError("lcp_min_d2_counts: the counting build runs on "
                         "the card; tiled_walk counts on the CPU")
    counts = torch.zeros(2, dtype=torch.int64, device=dev)
    out, parts = _launch_tiles(transforms, q, p, index, counts)
    lcp_min_d2.launches += parts > 0
    pairs, boxes = counts.tolist()
    return out, pairs, boxes, parts


def _lib():
    lib = _build.load("lcp")
    fn = lib.lcp_min_d2_tiles
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    fn = lib.lcp_min_d2_within
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [
            ctypes.c_float] * 2 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    fn = lib.refine_nearest_within
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [
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


def pair_tests(transforms: torch.Tensor, q: torch.Tensor, p: torch.Tensor,
               eps, index: GridIndex | None = None) -> int:
    """The pair tests :func:`lcp_min_d2_within` makes on these inputs
    (the key ranges of :func:`walk_ranges`, which the kernel walks),
    summed over the pairs with the pairs axis."""
    if p.shape[-2] == 0 or q.shape[-2] == 0:
        return 0
    index = _index_for(p, eps, index)
    if q.ndim == 2:
        transforms, q = transforms[None], q[None]
    total = 0
    for g in range(q.shape[0]):
        _, keys, grid = index.part(g)
        tx, ty, tz = (t.reshape(-1)
                      for t in _transformed(transforms[g], q[g]))
        total += int(walk_ranges(tx, ty, tz, keys, grid, eps)[1].sum())
    return total


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
launch_counter(lcp_min_d2_within, "launches")


def _cloud_index(p, radius, index):
    """``index``, one cloud's ``(pts, keys, grid)`` as :func:`grid_index`
    returns it, checked against ``p``; built at ``radius`` when None."""
    if index is None:
        return grid_index(p, radius)
    pts, keys, grid = index
    if (pts.shape[0] != p.shape[0] or keys.shape[0] != p.shape[0]
            or tuple(grid.shape) != (7,)
            or any(t.device != p.device for t in index)):
        raise ValueError(f"nearest_within: the index holds {pts.shape[0]} "
                         f"points on {pts.device}, not {p.shape[0]} on "
                         f"{p.device}")
    return index


def _no_neighbour(nq: int, dev) -> torch.Tensor:
    out = torch.zeros((nq, 4), dtype=torch.float32, device=dev)
    out[:, 3] = float("inf")
    return out


def nearest_within_plain(transform: torch.Tensor, q: torch.Tensor,
                         p: torch.Tensor, radius, index=None
                         ) -> torch.Tensor:
    """Plain PyTorch version of :func:`nearest_within`: the same index and
    query box, walked with ``searchsorted`` over the key columns
    (:func:`walk_ranges`) and a ragged gather, blocked over the queries;
    the least d^2 of each query's candidates within ``radius``, then the
    least position among the candidates at that d^2. Bit for bit the
    kernel."""
    nq, dev = q.shape[0], q.device
    out = _no_neighbour(nq, dev)
    if nq == 0 or p.shape[0] == 0:
        return out
    pts, keys, grid = _cloud_index(p, radius, index)
    tx, ty, tz = (t.reshape(-1) for t in _transformed(transform[None], q))
    starts, counts = walk_ranges(tx, ty, tz, keys, grid, radius)
    k = starts.shape[1]
    if k == 0:
        return out
    r2 = float(np.float32(radius) * np.float32(radius))
    rb = max(1, _elem_budget(dev) // max(1, int(counts.sum(dim=1).max())))
    for r0 in range(0, nq, rb):
        r1 = min(r0 + rb, nq)
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
        keep = d <= r2
        row, j, d = row[keep], j[keep], d[keep]
        best = out[:, 3].scatter_reduce(0, row, d, "amin")
        tie = d == best[row]
        at = torch.full((nq,), pts.shape[0], dtype=torch.int64,
                        device=dev).scatter_reduce(0, row[tie], j[tie],
                                                   "amin")
        found = at < pts.shape[0]
        out[found, :3] = pts[at[found], :3]
        out[found, 3] = best[found]
    return out


def nearest_within(transform: torch.Tensor, q: torch.Tensor,
                   p: torch.Tensor, radius, index=None) -> torch.Tensor:
    """(nq, 4) f32: for each query of ``q`` (nq, 3) moved by ``transform``
    (4, 4), the point of P (np, 3) nearest it within ``radius`` and its
    squared distance, ``(x, y, z, d^2)``; ``(0, 0, 0, +inf)`` where no
    point lies within ``radius`` (a non-finite query included). d^2 in
    the verify's order; of equally near points, the one first in the
    index's key order. The refine's neighbour step
    (ops/refine.py::refine_transform).

    ``index`` is P's cell index at ``radius``, one cloud's ``(pts, keys,
    grid)`` (:func:`grid_index`, or ``GridIndex.part``); without it the
    index is built on this call. CPU tensors take the plain version;
    CUDA tensors launch the kernel."""
    dev = _check("nearest_within", transform[None], q, p)
    if dev.type == "cpu":
        return nearest_within_plain(transform, q, p, radius, index)
    nq, np_ = q.shape[0], p.shape[0]
    if nq == 0 or np_ == 0:
        return _no_neighbour(nq, dev)
    pts, keys, grid = _cloud_index(p, radius, index)
    transform, q = transform.contiguous(), q.contiguous()
    out = torch.empty((nq, 4), dtype=torch.float32, device=dev)
    r32 = np.float32(radius)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(lib.refine_nearest_within(
            transform.data_ptr(), q.data_ptr(), pts.data_ptr(),
            keys.data_ptr(), grid.data_ptr(), out.data_ptr(), nq, np_,
            float(r32), float(r32 * r32), stream), "nearest_within")
    nearest_within.launches += 1
    return out


#: kernel launches since the count was last reset (CUDA path only)
nearest_within.launches = 0
launch_counter(nearest_within, "launches")


def min_sq_dists_plain(tq: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`min_sq_dists`: the direct
    ``min_j |tq_m - p_j|^2`` with no transform, in the kernel's order."""
    return _min_d2_rows(tq[:, 0:1], tq[:, 1:2], tq[:, 2:3], p)


def min_sq_dists(tq: torch.Tensor, p: torch.Tensor,
                 index: TileIndex | None = None) -> torch.Tensor:
    """(M,) f32 ``min_j |tq_m - p_j|^2`` of the (M, 3) rows ``tq`` to the
    (Np, 3) cloud ``p``, with no transform; ``index`` as for
    :func:`lcp_min_d2`.

    It launches the kernel of :func:`lcp_min_d2` on the rows as they are
    (no transform), so it is bit-identical to :func:`min_sq_dists_plain`,
    NaN rows giving NaN and infinite ones +inf. This covers three TPU
    kernels of ``super4pcs_tpu/kernels/lcp_pallas.py``:
    ``_min_dist_kernel`` (K4a, via ``min_sq_dists``),
    ``_min_dist_stream_kernel`` (K4b, via ``min_sq_dists_streamed``) and,
    for transformed queries, ``_lcp_min_stream_kernel`` (K3, via
    ``candidate_min_sq_dists_streamed``, which is :func:`lcp_min_d2`).
    The TPU split each into a VMEM-resident P (up to 300k points) and a
    P streamed through the Pallas pipeline; on the card the tiled index
    serves every Np. CPU tensors take the plain version; the launch
    counts in ``lcp_min_d2.launches``.
    """
    if _check("min_sq_dists", None, tq, p).type == "cpu":
        if index is not None:
            _tiles_for(p, index)
        return min_sq_dists_plain(tq, p)
    out, parts = _launch_tiles(None, tq, p, index, None)
    lcp_min_d2.launches += parts > 0
    return out[0]
