"""K2: row-capped band capture (the Super4PCS pair-creation stage,
ref:src/super4pcs/pairCreationFunctor.h:120-204) for the rowcap engine.

The CUDA kernel (``csrc/rowcap.cu``) replaces the TPU kernel
``super4pcs_tpu/kernels/rowcap_pallas.py::_kernel`` + ``_kernel_body``
whole: the band capture, its in-kernel pair filters (normals, color and
translation, angle) and its tile-pair rejection. Its note says what
bounds it and how it is laid out. The capture contract is the JAX
package's, unchanged:

- ``n_pad = round_up(n, 2048)``, 512-column segments, and
  ``row_cap == slots_for(n, row_cap)`` slots per row;
- each row keeps its first ``seg_q = row_cap / (n_pad / 512)`` hits of
  every segment, in column order, in slots ``seg * seg_q + k``;
- ``-1`` marks an empty slot of ``cols``, ``0x7fffffff`` one of ``h``;
- padded columns sit at x = 1e18, and a pair needs ``j < n`` and
  ``i != j``; per-row counts ``rc`` are exact.

A call captures one edge over one point set, or T edges over G point
sets at once (the trial axis: the JAX package's ``vmap`` over a step's
bases and pairs, one launch for all of them); trial ``t`` belongs to
set ``t // (T // G)``.

:func:`rowcap_capture` sends a CPU tensor to
:func:`rowcap_capture_plain` and launches the kernel for a CUDA tensor
(or raises). Both compute d^2 as ``(|a|^2 + |b|^2) - 2 a.b`` with the
dot product written out as ``(ax bx + ay by) + az bz``, each filter
predicate in one fixed order (see :func:`rowcap_capture_plain`), and
the hash as the port's own join hash (ops/congruent.py), so they agree
bit for bit. The plain version applies no tile-pair rejection: the
kernel's is conservative, so its output is the same either way.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

ROW_TILE = 256      # rows of a tile-pair rejection tile
COL_TILE = 512      # columns per segment (the capture stratum)
SENT = 2147483647   # empty-slot join hash
_PAD = 1.0e18
_HP = (73856093, 19349669, 83492791)


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def slots_for(nq: int, target_row_cap: int) -> int:
    """Output slots per row: ``target_row_cap`` rounded UP to a whole
    number of per-segment quota slots (segments = padded-n / COL_TILE).
    The matcher uses this as the effective join row_cap (k1 = n_pad *
    slots rows)."""
    n_pad = _round_up(nq, 2048)
    segs = n_pad // COL_TILE
    seg_q = max(1, -(-target_row_cap // segs))
    return segs * seg_q


def cell_hash_of(e: list, cell: torch.Tensor) -> torch.Tensor:
    """int32 join hash of invariant-point components ``e`` (x, y, z
    tensors): ``floor(e / cell)`` cells times the primes, XORed, with
    int32 wrap-around (computed in int64, low 32 bits as signed).
    ``cell`` is a 0-d float32 tensor on the data's device, so the
    division is IEEE on every device."""
    h = None
    for ec, hp in zip(e, _HP):
        hc = torch.floor(ec / cell).to(torch.int64) * hp
        h = hc if h is None else h ^ hc
    h = h & 0xFFFFFFFF
    return torch.where(h >= 1 << 31, h - (1 << 32), h).to(torch.int32)


def _scalar(v, dev) -> torch.Tensor:
    """0-d float32 tensor on ``dev``. A number is filled in place on the
    device: creating it from host memory would synchronize the stream."""
    if torch.is_tensor(v):
        return v.to(device=dev, dtype=torch.float32)
    return torch.full((), float(v), dtype=torch.float32, device=dev)


def _norm3(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1])
                      + v[..., 2] * v[..., 2])


def filter_scores(pos, rgb, base_pos, base_rgb, e0: int, e1: int,
                  max_color_distance: float,
                  max_translation_distance: float) -> torch.Tensor:
    """Separable color/translation endpoint scores, (..., 2, n) float32
    for ``pos``/``rgb`` (..., n, 3) and ``base_pos``/``base_rgb`` (...,
    4, 3): row 0 scores a pair's first endpoint against base point
    ``e0``, row 1 its second against ``e1`` (the JAX package's
    ``_filter_scores``). A pair passes iff ``row + col >= 2``:

    - translation fail -> -10 (sinks any partner);
    - no color check (either endpoint or the base lacks color) -> 2;
    - color checked and good -> 1; checked and bad -> 0.

    The reference checks color only when both endpoints and the base
    carry it (ref:4pcs.cc:161-171), which the 2 + 0 = 2 escape keeps.
    """
    scores = []
    for b in (e0, e1):
        s = torch.full(pos.shape[:-1], 2.0, dtype=torch.float32,
                       device=pos.device)
        if max_color_distance > 0:
            has = rgb[..., 0] >= 0
            base_has = ((base_rgb[..., e0, 0] >= 0)
                        & (base_rgb[..., e1, 0] >= 0))[..., None]
            good = _norm3(rgb - base_rgb[..., b, None, :]) \
                < max_color_distance
            s = torch.where(base_has & has,
                            torch.where(good, 1.0, 0.0), s)
        if max_translation_distance > 0:
            far = (_norm3(pos - base_pos[..., b, None, :])
                   >= max_translation_distance)
            s = torch.where(far, -10.0, s)
        scores.append(s)
    return torch.stack(scores, dim=-2)


def tile_bounds(pos: torch.Tensor, n_pad: int, tile: int) -> torch.Tensor:
    """(n_pad / tile, 4) float32 bounding spheres ``[cx, cy, cz, r]`` of
    each ``tile``-point slice of the padded layout (real points only).
    An empty tile gets c = 1e18 and r = 0, so it rejects against any
    real tile."""
    n = pos.shape[0]
    nt = n_pad // tile
    dev = pos.device
    pp = torch.zeros((n_pad, 3), dtype=torch.float32, device=dev)
    pp[:n] = pos
    rm = (torch.arange(n_pad, device=dev) < n).view(nt, tile)
    p3 = pp.view(nt, tile, 3)
    cnt = rm.sum(dim=1)
    c = (p3 * rm[..., None]).sum(dim=1) / torch.clamp(cnt, min=1)[:, None]
    r = (_norm3(p3 - c[:, None, :]) * rm).amax(dim=1)
    c = torch.where(cnt[:, None] > 0, c, _PAD)
    r = torch.where(cnt > 0, r, 0.0)
    return torch.cat([c, r[:, None]], dim=1)


def reject_bounds(pos: torch.Tensor):
    """The row-tile and column-segment bounding spheres of ``pos`` (n,
    3), or of each set of ``pos`` (G, n, 3), that the kernel's tile-pair
    rejection reads: ``(rowb (..., n_pad / 256, 4), colb (..., n_pad /
    512, 4))``. They depend on the points only, so a caller with fixed
    points computes them once."""
    if pos.ndim == 3:
        per_set = [reject_bounds(p) for p in pos]
        return (torch.stack([r for r, _ in per_set]),
                torch.stack([c for _, c in per_set]))
    n_pad = _round_up(pos.shape[0], 2048)
    return (tile_bounds(pos, n_pad, ROW_TILE),
            tile_bounds(pos, n_pad, COL_TILE))


def tile_reject_mask(rowb: torch.Tensor, colb: torch.Tensor, lo2,
                     hi2) -> torch.Tensor:
    """(n_rt, n_ct) bool: the (row tile, column segment) pairs whose
    bounding spheres cannot meet the band ``lo2 <= d^2 <= hi2``, the
    kernel's rejection predicate (``rowcap_pallas.py:169-180``) with its
    slack ``1e-5 * (hi + dc) + 1e-12`` against float32 rounding."""
    dv = rowb[:, None, :3] - colb[None, :, :3]
    dc = _norm3(dv)
    rsum = rowb[:, None, 3] + colb[None, :, 3]
    lo = torch.sqrt(torch.clamp(torch.as_tensor(lo2, dtype=torch.float32,
                                                device=rowb.device),
                                min=0.0))
    hi = torch.sqrt(torch.as_tensor(hi2, dtype=torch.float32,
                                    device=rowb.device))
    slack = 1.0e-5 * (hi + dc) + 1.0e-12
    return (dc - rsum > hi + slack) | (dc + rsum < lo - slack)


def _n_trials(q, per_trial, planes) -> int:
    """T of a batched call: the length of the per-trial arguments (the
    number of sets G when there are none); T must be a multiple of G."""
    g = q.shape[0]
    sizes = {v.numel() for v in per_trial
             if torch.is_tensor(v) and v.ndim > 0 and v.numel() != 1}
    sizes |= {t.shape[0] for t in planes if t is not None}
    t = max(sizes | {g})
    if len(sizes - {t}) or t % g:
        raise ValueError(f"rowcap_capture: per-trial arguments of "
                         f"lengths {sorted(sizes)} for {g} point sets "
                         f"(T must be a multiple of G)")
    return t


def _at(v, t: int):
    """Trial ``t``'s value of a per-trial argument (a number or a
    one-element tensor is shared by every trial)."""
    if torch.is_tensor(v) and v.numel() > 1:
        return v.reshape(-1)[t]
    return v


def rowcap_capture_plain(q: torch.Tensor, lo2, hi2, row_cap: int, inv=0.0,
                         cell=1.0, emit_hash: bool = False, *,
                         normals=None, aux=None, rcscore=None, nang=0.0,
                         nthr=0.0, cmax=None, row_block: int = 1024):
    """Plain PyTorch version of the kernel, with the arguments of
    :func:`rowcap_capture` (no ``bounds``: it rejects nothing): one
    capture for ``q`` (n, 3), or the trial axis for ``q`` (G, n, 3), one
    trial at a time."""
    if q.ndim == 3:
        nt = _n_trials(q, (lo2, hi2, inv, nang), (aux, rcscore))
        per_set = nt // q.shape[0]
        outs = [_capture_plain(
            q[t // per_set], _at(lo2, t), _at(hi2, t), row_cap,
            _at(inv, t), cell, emit_hash,
            normals=None if normals is None else normals[t // per_set],
            aux=None if aux is None else aux[t],
            rcscore=None if rcscore is None else rcscore[t],
            nang=_at(nang, t), nthr=nthr, cmax=cmax, row_block=row_block)
            for t in range(nt)]
        return tuple(torch.stack(x) for x in zip(*outs))
    return _capture_plain(q, lo2, hi2, row_cap, inv, cell, emit_hash,
                          normals=normals, aux=aux, rcscore=rcscore,
                          nang=nang, nthr=nthr, cmax=cmax,
                          row_block=row_block)


def _capture_plain(q: torch.Tensor, lo2, hi2, row_cap: int, inv, cell,
                   emit_hash: bool, *, normals, aux, rcscore, nang, nthr,
                   cmax, row_block: int):
    """One capture of :func:`rowcap_capture_plain`.

    ``normals`` (n, 3) turns the normal band on, ``rcscore`` (2, n) the
    color/translation scores, ``cmax`` the angle test; ``aux`` (2, n)
    holds ``pos . seg`` (row 0) and ``|n|^2`` (row 1). Each predicate
    in the kernel's order:

    - normals: ``ndot = (nx_i nx_j + ny_i ny_j) + nz_i nz_j``,
      ``dminus = sqrt(max((n2_i + n2_j) - 2 ndot, 0))`` and ``dplus``
      with ``+``; the pair passes when ``~(n2_i > 0 & n2_j > 0)`` or
      ``min(|dminus - nang|, |dplus - nang|) <= nthr``;
    - scores: ``rs_i + cs_j >= 2``;
    - angle: ``(bseg_j - aseg_i) >= cmax * sqrt(max(d2, 0))``.
    """
    n = q.shape[0]
    n_pad = _round_up(n, 2048)
    segs = n_pad // COL_TILE
    seg_q = row_cap // segs
    dev = q.device
    lo2, hi2, inv, cell, nang, nthr = (_scalar(v, dev) for v in (
        lo2, hi2, inv, cell, nang, nthr))
    qp = torch.zeros((n_pad, 3), dtype=torch.float32, device=dev)
    qp[:n] = q
    qp[n:, 0] = _PAD
    x, y, z = qp[:, 0], qp[:, 1], qp[:, 2]
    sq = (x * x + y * y) + z * z
    j = torch.arange(n_pad, device=dev)

    def plane(rows, fill=0.0):
        # (k, n) per-point rows, zero-padded to n_pad columns
        out = torch.full((rows.shape[0], n_pad), fill, dtype=torch.float32,
                         device=dev)
        out[:, :n] = rows
        return out

    if normals is not None:
        nrm = plane(normals.T)
        n2 = plane(aux[1:2])[0]
    if rcscore is not None:
        score = plane(rcscore)
    if cmax is not None:
        seg = plane(aux[0:1])[0]
        cmax = _scalar(cmax, dev)
    cols = torch.full((n_pad, row_cap), -1, dtype=torch.int32, device=dev)
    rc = torch.zeros(n_pad, dtype=torch.int32, device=dev)
    k = min(seg_q, COL_TILE)
    for r0 in range(0, n, row_block):
        r1 = min(r0 + row_block, n)
        a = qp[r0:r1]
        dot = ((a[:, 0:1] * x + a[:, 1:2] * y) + a[:, 2:3] * z)
        d2 = (sq[r0:r1, None] + sq[None, :]) - 2.0 * dot
        hit = ((d2 >= lo2) & (d2 <= hi2) & (j < n)
               & (j[None, :] != j[r0:r1, None]))
        if normals is not None:
            ndot = ((nrm[0, r0:r1, None] * nrm[0]
                     + nrm[1, r0:r1, None] * nrm[1])
                    + nrm[2, r0:r1, None] * nrm[2])
            ssum = n2[r0:r1, None] + n2[None, :]
            dminus = torch.sqrt(torch.clamp(ssum - 2.0 * ndot, min=0.0))
            dplus = torch.sqrt(torch.clamp(ssum + 2.0 * ndot, min=0.0))
            nd = torch.minimum((dminus - nang).abs(), (dplus - nang).abs())
            both = (n2[r0:r1, None] > 0) & (n2[None, :] > 0)
            hit &= ~both | (nd <= nthr)
        if rcscore is not None:
            hit &= (score[0, r0:r1, None] + score[1]) >= 2.0
        if cmax is not None:
            dist = torch.sqrt(torch.clamp(d2, min=0.0))
            hit &= (seg[None, :] - seg[r0:r1, None]) >= cmax * dist
        rc[r0:r1] = hit.sum(dim=1, dtype=torch.int32)
        # first k hits of each segment, in column order: the k smallest
        # hit column ids (misses keyed past every column)
        key = torch.where(hit, j, n_pad).view(r1 - r0, segs, COL_TILE)
        first = torch.topk(key, k, dim=2, largest=False,
                           sorted=True).values
        first = torch.where(first < n_pad, first, -1)
        cols.view(n_pad, segs, seg_q)[r0:r1, :, :k] = first.to(torch.int32)
    if not emit_hash:
        return cols, rc
    valid = cols >= 0
    b = qp[cols.clamp(min=0).long()]                  # (n_pad, row_cap, 3)
    e = [qp[:, c:c + 1] + inv * (b[..., c] - qp[:, c:c + 1])
         for c in range(3)]
    h = torch.where(valid, cell_hash_of(e, cell), SENT)
    return cols, rc, h


def _ptr(t) -> int | None:
    """Data pointer of a tensor, None (a null pointer) for None."""
    return None if t is None else t.data_ptr()


def _per_trial(v, nt: int, dev) -> torch.Tensor:
    """(nt,) float32 on ``dev``: a per-trial argument, or a shared
    number repeated."""
    v = _scalar(v, dev).reshape(-1)
    return v.expand(nt) if v.numel() == 1 else v


def rowcap_capture(q: torch.Tensor, lo2, hi2, row_cap: int, inv=0.0,
                   cell=1.0, emit_hash: bool = False, *, normals=None,
                   aux=None, rcscore=None, nang=0.0, nthr=0.0, cmax=None,
                   bounds=None):
    """Band captures of base edges over the float32 points ``q``: one
    edge over ``q`` (n, 3), or T edges over the G point sets of ``q``
    (G, n, 3), trial ``t`` over set ``t // (T // G)``, in one launch.

    ``lo2``/``hi2`` bound the squared distance band; ``inv``/``cell``
    define the join hash of edge 0 (``emit_hash``). Scalars may be
    Python floats or tensors on q's device (no host sync); with the
    trial axis ``lo2``, ``hi2``, ``inv`` and ``nang`` may be (T,)
    tensors, one value per trial.

    Filters (see :func:`rowcap_capture_plain` for their arithmetic):
    ``normals`` (n, 3) (per set: (G, n, 3)) with the base edge's normal
    angle ``nang`` and the threshold ``nthr``; ``rcscore`` (2, n) (per
    trial: (T, 2, n)) from :func:`filter_scores`; ``cmax`` (the cosine
    of the maximum angle) turns the angle test on. ``aux`` (2, n) (per
    trial: (T, 2, n)) carries ``pos . seg`` and ``|n|^2`` for the normal
    and angle tests. ``bounds`` = (rowb, colb) from :func:`reject_bounds`
    of ``q`` turns the kernel's tile-pair rejection on; the output is
    the same with or without it.

    Returns ``(cols (n_pad, row_cap) int32, rc (n_pad,) int32)``, plus
    ``h (n_pad, row_cap) int32`` with ``emit_hash``; with the trial axis
    each gains a leading T. ``rowcap_capture.launches`` counts launches
    (one per call), ``captures`` the trials they covered.
    """
    if q.dtype != torch.float32 or q.ndim not in (2, 3) or q.shape[-1] != 3:
        raise ValueError(f"rowcap_capture: q must be float32 (n, 3) or "
                         f"(G, n, 3), got {q.dtype} {tuple(q.shape)}")
    single = q.ndim == 2
    n = q.shape[-2]
    if row_cap != slots_for(n, row_cap):
        raise ValueError("rowcap_capture: row_cap must be pre-rounded via "
                         "slots_for()")
    use_normals = normals is not None
    use_rowcol = rcscore is not None
    use_angle = cmax is not None
    filtered = use_normals or use_rowcol or use_angle
    if (use_normals or use_angle) and aux is None:
        raise ValueError("rowcap_capture: the normal and angle tests "
                         "need aux")
    dev = q.device
    n_pad = _round_up(n, 2048)
    rowb, colb = (None, None) if bounds is None else bounds
    if single:
        q, normals, aux, rcscore, rowb, colb = (
            None if t is None else t[None]
            for t in (q, normals, aux, rcscore, rowb, colb))
    g = q.shape[0]
    nt = _n_trials(q, (lo2, hi2, inv, nang), (aux, rcscore))
    for name, t, shape in (("normals", normals, (g, n, 3)),
                           ("aux", aux, (nt, 2, n)),
                           ("rcscore", rcscore, (nt, 2, n)),
                           ("bounds[0]", rowb, (g, n_pad // ROW_TILE, 4)),
                           ("bounds[1]", colb, (g, n_pad // COL_TILE, 4))):
        if t is not None and (t.dtype != torch.float32
                              or tuple(t.shape) != shape
                              or t.device != dev):
            lead = 1 if single else 0
            raise ValueError(f"rowcap_capture: {name} must be float32 "
                             f"{shape[lead:]} on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)[lead:]} on {t.device}")
    if dev.type == "cpu":
        out = rowcap_capture_plain(
            q, lo2, hi2, row_cap, inv, cell, emit_hash, normals=normals,
            aux=aux, rcscore=rcscore, nang=nang, nthr=nthr, cmax=cmax)
        return tuple(o[0] for o in out) if single else out
    if dev.type != "cuda":
        raise ValueError(f"rowcap_capture: unsupported device {dev}")
    vals = [lo2, hi2, inv, cell]
    if filtered:
        vals += [nang, nthr, 0.0 if cmax is None else cmax]
    geo = torch.stack([_per_trial(v, nt, dev) for v in vals],
                      dim=1).contiguous()
    q = q.contiguous()
    normals, aux, rcscore, rowb, colb = (
        None if t is None else t.contiguous()
        for t in (normals, aux, rcscore, rowb, colb))
    seg_q = row_cap // (n_pad // COL_TILE)
    # the kernel's padded float4 planes: points and normals per set, the
    # scores/angle plane per trial
    rows = (g * (1 + int(use_normals))
            + nt * int(use_rowcol or use_angle)) * n_pad
    work = torch.empty((rows, 4), dtype=torch.float32, device=dev)
    cols = torch.empty((nt, n_pad, row_cap), dtype=torch.int32, device=dev)
    rc = torch.zeros((nt, n_pad), dtype=torch.int32, device=dev)
    h = (torch.empty((nt, n_pad, row_cap), dtype=torch.int32, device=dev)
         if emit_hash else None)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(lib.rowcap_capture(
            q.data_ptr(), n, n_pad, nt, nt // g, geo.data_ptr(),
            geo.shape[1], seg_q, row_cap, int(emit_hash), _ptr(normals),
            _ptr(aux), _ptr(rcscore), int(use_normals), int(use_rowcol),
            int(use_angle), _ptr(rowb), _ptr(colb), int(rowb is not None),
            work.data_ptr(), cols.data_ptr(), rc.data_ptr(), _ptr(h),
            stream),
            "rowcap_capture")
    rowcap_capture.launches += 1
    rowcap_capture.captures += nt
    rowcap_capture.filtered_launches += int(filtered)
    out = (cols, rc, h) if emit_hash else (cols, rc)
    return tuple(o[0] for o in out) if single else out


#: kernel launches since the count was last reset (CUDA path only); a
#: launch covers every trial of its call
rowcap_capture.launches = 0
#: the trials (base-edge captures) those launches covered
rowcap_capture.captures = 0
#: of the launches, those with at least one pair filter on
rowcap_capture.filtered_launches = 0


def _lib():
    lib = _build.load("rowcap")
    fn = lib.rowcap_capture
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, i, i, i, p, i, i, i, i, p, p, p, i, i, i,
                       p, p, i, p, p, p, p, p]
        fn.restype = ctypes.c_int
    return lib


def edge_args(pos, base_pos, pair_distance_epsilon, normal=None,
              rgb=None, base_norm=None, base_rgb=None,
              max_normal_difference: float = -1.0,
              max_color_distance: float = -1.0,
              max_translation_distance: float = -1.0,
              max_angle: float = -1.0) -> list:
    """The band and filter arguments of both base edges' captures: two
    dicts of keyword arguments (``lo2``, ``hi2`` and the active
    filters' planes and scalars) for :func:`rowcap_capture` and
    :func:`rowcap_capture_plain`, built as ``rowcap_pallas.py:502-579``
    builds them: for one base, ``pos`` (n, 3) and ``base_pos`` (4, 3),
    or for the trial axis, ``pos`` (G, n, 3) and ``base_pos`` (T, 4, 3)
    (per-trial values with a leading T). See
    :func:`extract_pairs_rowcap_both`."""
    single = pos.ndim == 2
    if single:
        pos, normal, rgb, base_pos, base_norm, base_rgb = (
            None if t is None else t[None]
            for t in (pos, normal, rgb, base_pos, base_norm, base_rgb))
    dev = pos.device
    nt = base_pos.shape[0]
    gt = torch.arange(nt, device=dev) // (nt // pos.shape[0])
    eps = _scalar(pair_distance_epsilon, dev)
    dists = torch.stack([_norm3(base_pos[:, 0] - base_pos[:, 1]),
                         _norm3(base_pos[:, 2] - base_pos[:, 3])])
    lo = torch.clamp(dists - eps, min=0.0)
    hi = dists + eps
    use_normals = max_normal_difference > 0
    use_angle = max_angle > 0
    use_scores = max_color_distance > 0 or max_translation_distance > 0
    if use_normals:
        n2 = ((normal[..., 0] * normal[..., 0]
               + normal[..., 1] * normal[..., 1])
              + normal[..., 2] * normal[..., 2])
        nang = torch.stack([_norm3(base_norm[:, 0] - base_norm[:, 1]),
                            _norm3(base_norm[:, 2] - base_norm[:, 3])])
    tpos = pos[gt] if use_angle or use_scores else None
    out = []
    for e, (e0, e1) in enumerate(((0, 1), (2, 3))):
        kw = dict(lo2=lo[e] * lo[e], hi2=hi[e] * hi[e])
        if use_normals or use_angle:
            row0 = torch.zeros((nt, pos.shape[1]), dtype=torch.float32,
                               device=dev)
            if use_angle:
                seg = base_pos[:, e1] - base_pos[:, e0]
                seg = seg / torch.clamp(_norm3(seg), min=1e-30)[:, None]
                row0 = ((tpos[..., 0] * seg[:, 0:1]
                         + tpos[..., 1] * seg[:, 1:2])
                        + tpos[..., 2] * seg[:, 2:3])
                kw["cmax"] = math.cos(max_angle * math.pi / 180.0)
            kw["aux"] = torch.stack(
                [row0, n2[gt] if use_normals else torch.zeros_like(row0)],
                dim=1)
        if use_normals:
            kw.update(normals=normal, nang=nang[e],
                      nthr=0.5 * max_normal_difference * math.pi / 180.0)
        if use_scores:
            kw["rcscore"] = filter_scores(
                tpos, rgb[gt], base_pos, base_rgb, e0, e1,
                max_color_distance, max_translation_distance)
        if single:
            kw = {k: v[0] if torch.is_tensor(v) else v
                  for k, v in kw.items()}
        out.append(kw)
    return out


def extract_pairs_rowcap_both(pos, base_pos, pair_distance_epsilon,
                              row_cap: int, invariant1=None,
                              cell_size: float | None = None,
                              normal=None, rgb=None, base_norm=None,
                              base_rgb=None,
                              max_normal_difference: float = -1.0,
                              max_color_distance: float = -1.0,
                              max_translation_distance: float = -1.0,
                              max_angle: float = -1.0,
                              tile_reject: bool = True, bounds=None):
    """Both base edges' band captures (one launch per edge; edge 0 also
    emits the join hash when ``invariant1``/``cell_size`` are given),
    for one base or for the trial axis.

    The contract of the JAX package's
    ``extract_pairs_rowcap_pallas_both``: per edge ``(cols, valid,
    count, dropped)`` with ``cols`` the flattened ``max(cols, 0)``
    table, int32 (slot ``s`` holds the ordered pair ``(s // row_cap,
    cols[s])``), ``count`` the exact pre-cap hit count and ``dropped``
    the hits that missed the table; then ``h1`` (n_pad * row_cap,)
    int32 when the hash is requested. With the trial axis every output
    gains a leading T (counts are (T,)).

    The normal, color, translation and angle filters (off at their -1
    defaults) are the reference's per-pair predicates in the ordered
    form of ops/pairs.ordered_pair_mask (planes from :func:`edge_args`).
    ``tile_reject`` turns the kernel's tile-pair rejection on, with
    ``bounds`` (from :func:`reject_bounds` of ``pos``) computed here
    when not given.

    pos: (n, 3) centered Q samples and base_pos (4, 3), edges (0, 1)
    and (2, 3); or pos (G, n, 3) and base_pos (T, 4, 3), trial ``t`` on
    set ``t // (T // G)``, with ``invariant1`` (T,). Distance band:
    squared-vs-squared around each edge's length
    (ref:pairCreationFunctor.h:151-160).
    """
    emit_hash = invariant1 is not None
    if not tile_reject or pos.device.type != "cuda":
        bounds = None
    elif bounds is None:
        bounds = reject_bounds(pos)
    args = edge_args(pos, base_pos, pair_distance_epsilon, normal, rgb,
                     base_norm, base_rgb, max_normal_difference,
                     max_color_distance, max_translation_distance,
                     max_angle)
    results = []
    h1 = None
    for e, kw in enumerate(args):
        if emit_hash and e == 0:
            cols, rc, h = rowcap_capture(
                pos, row_cap=row_cap, inv=invariant1, cell=cell_size,
                emit_hash=True, bounds=bounds, **kw)
            h1 = h.flatten(-2)
        else:
            cols, rc = rowcap_capture(pos, row_cap=row_cap, bounds=bounds,
                                      **kw)
        ce = cols.flatten(-2)
        valid = ce >= 0
        count = rc.sum(dim=-1, dtype=torch.int64)
        found = valid.sum(dim=-1, dtype=torch.int64)
        results.append((ce.clamp(min=0), valid, count, count - found))
    if emit_hash:
        return tuple(results) + (h1,)
    return tuple(results)
