"""Inputs of the grid join's tests over the capture kernel's tables
(``find_congruent_quads_grid`` with ``table_hash``, the route of the join
kernel, ``kernels/join.py``), shared by the CPU tests and the card's.
No jax: the card's tests run without it."""

import numpy as np
import torch

from super4pcs_tpu_torch.kernels import rowcap as k2
from super4pcs_tpu_torch.ops import congruent as tc

#: the empty-slot hash and the top group, which the join never matches
SENT = 0x7FFFFFFF
TOP_GROUP = 0x7FFFFFFE


def bumpy(rng, n):
    """(n, 3) float32 points on a bumped unit sphere."""
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    bump = (1 + 0.3 * np.sin(5 * v[:, 0]) * np.cos(3 * v[:, 1])
            + 0.2 * np.sin(4 * v[:, 2]))
    return (v * bump[:, None]).astype(np.float32)


def top_cell(span: int = 400):
    """Integer cell coordinates (x, y, z), |y|, |z| <= ``span`` and x as
    small as found, whose join hash has the top group."""
    inv = pow(73856093, -1, 1 << 32)
    best = None
    for y in range(-span, span + 1):
        for z in range(-span, span + 1):
            rest = ((y * 19349669) ^ (z * 83492791)) & 0xFFFFFFFF
            for h in (TOP_GROUP, SENT):
                x = ((h ^ rest) * inv) & 0xFFFFFFFF
                x = x - (1 << 32) if x >= 1 << 31 else x
                if best is None or abs(x) < abs(best[0]):
                    best = (x, y, z)
    return best


def join_inputs(seed, dev, n=300, sets=1, per_set=2, row_cap=32,
                delta=0.05, factor=1.0, cells=16, q_budget=256,
                probe_budget=512, capacity=256, cone=0.3, offset=None,
                filters=None):
    """The arguments of one grid join over K2's tables: G = ``sets``
    bumped spheres of ``n`` points (moved by ``offset``), ``per_set``
    random bases on each, both edges captured with the join hash (the
    filter variants with ``filters``, the normal and color filters'
    (degrees, distance) on radial normals and colors abs(p) * 200). The radius and cell are the matcher's
    (``2 delta factor`` and ``4 delta``). Returns (args, kwargs) of
    ``find_congruent_quads_grid``."""
    rng = np.random.default_rng(seed)
    pts = np.stack([bumpy(rng, n) for _ in range(sets)])
    nt = sets * per_set
    ids = np.stack([rng.choice(n, 4, replace=False) for _ in range(nt)])
    base = np.stack([pts[t // per_set][ids[t]] for t in range(nt)])
    if offset is not None:
        pts = pts + np.asarray(offset, np.float32)
        base = base + np.asarray(offset, np.float32)
    s1, s2 = base[:, 1] - base[:, 0], base[:, 3] - base[:, 2]
    cos_a = np.sum(s1 / np.linalg.norm(s1, axis=1, keepdims=True)
                   * s2 / np.linalg.norm(s2, axis=1, keepdims=True), axis=1)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    q, bpos = t(pts), t(base)
    inv1 = t(rng.uniform(0.2, 0.8, nt))
    inv2 = t(rng.uniform(0.2, 0.8, nt))
    cap = k2.slots_for(n, row_cap)
    cell = 4.0 * delta
    r = 2.0 * delta * factor
    fkw = {}
    if filters:
        nrm = pts / np.linalg.norm(pts, axis=-1, keepdims=True)
        rgb = np.abs(pts) * 200.0
        fkw = dict(normal=t(nrm), rgb=t(rgb),
                   base_norm=t(np.stack([nrm[i // per_set][ids[i]]
                                         for i in range(nt)])),
                   base_rgb=t(np.stack([rgb[i // per_set][ids[i]]
                                        for i in range(nt)])),
                   max_normal_difference=filters[0],
                   max_color_distance=filters[1])
    (c1, v1, _, _), (c2, v2, _, _), h1 = k2.extract_pairs_rowcap_both(
        q, bpos, r, cap, invariant1=inv1, cell_size=cell, **fkw)
    args = [q, c1, v1, c2, v2, inv1, inv2, r, t(cos_a), cone, capacity]
    kwargs = dict(cell_candidates=cells, q_budget=q_budget, row_cap=cap,
                  probe_budget=probe_budget, cell_size=cell, table_hash=h1)
    return args, kwargs


#: the named cases of :func:`case` (small shapes, every branch)
NAMES = ["cone", "no_cone", "window_3", "two_sets", "probe_budget_overflow",
         "capacity_overflow", "one_candidate", "thirty_two_candidates", "empty_trials",
         "no_group_above", "top_group_slots", "top_group_probes",
         "filtered", "odd_sizes"]


def case(name, dev):
    """(args, kwargs) of one named case:

    - ``cone``, ``no_cone`` (4PCS: no direction test), ``window_3``
      (search factor 1.5: a 3^3 probe window), ``two_sets`` (G = 2);
    - ``probe_budget_overflow``: more probes hit than the probe budget;
      ``capacity_overflow``: more quads pass than the capacity;
    - ``one_candidate``, ``thirty_two_candidates``: L = 1 and L = 32;
    - ``empty_trials``: trial 0 has no valid second-side slot, trial 1 no
      valid table slot (no probe kept: the dead slots' fill);
    - ``no_group_above``: every table slot valid with the least hash, so
      no group lies at or above probe 0's (the fill past the table);
    - ``top_group_slots``: valid table slots whose hash has the top
      group, which no probe matches;
    - ``top_group_probes``: the cloud moved so that probes land in a
      cell whose hash has the top group;
    - ``filtered``: the capture's normal and color filters;
    - ``odd_sizes``: budgets and capacities that are no multiple of 16,
      so that the kernel's flag rows start unaligned.
    """
    kw = {}
    if name == "no_cone":
        kw = dict(cone=-1.0)
    elif name == "window_3":
        kw = dict(factor=1.5)
    elif name == "two_sets":
        kw = dict(sets=2)
    elif name == "probe_budget_overflow":
        kw = dict(probe_budget=64, cone=-1.0)
    elif name == "capacity_overflow":
        kw = dict(capacity=16, cone=-1.0)
    elif name == "one_candidate":
        kw = dict(cells=1)
    elif name == "thirty_two_candidates":
        kw = dict(cells=32, delta=0.08)
    elif name == "filtered":
        kw = dict(filters=(20.0, 150.0), delta=0.08)
    elif name == "odd_sizes":
        kw = dict(q_budget=101, probe_budget=99, cells=3, capacity=37,
                  per_set=3, cone=-1.0)
    elif name == "top_group_probes":
        x, y, z = top_cell()
        cell = 4.0 * 0.05
        # the sphere's centre near the cell's corner: some probe windows
        # cover it
        kw = dict(offset=(x * cell, y * cell, z * cell), n=400)
    args, kwargs = join_inputs(7 + NAMES.index(name), dev, **kw)
    h1 = kwargs["table_hash"]
    if name == "empty_trials":
        args[4] = args[4].clone()
        args[4][0] = False
        h1 = h1.clone()
        h1[1] = SENT
    elif name == "no_group_above":
        h1 = torch.full_like(h1, -(1 << 31))
    elif name == "top_group_slots":
        idx = torch.arange(h1.shape[1], device=dev)
        live = h1 != SENT
        h1 = torch.where(live & (idx % 6 == 0), TOP_GROUP, h1)
        h1 = torch.where(live & (idx % 6 == 3), SENT, h1)
    kwargs["table_hash"] = h1
    return args, kwargs


def top_group_probed(args, kwargs) -> bool:
    """Whether some valid probe of the join falls in a top-group cell."""
    q, c1, v1, c2, v2, inv1, inv2, r = args[:8]
    cell = kwargs["cell_size"]
    w = tc.probe_window(r, cell)
    row_cap = kwargs["row_cap"]
    qb = min(kwargs["q_budget"], v2.shape[1])
    cell_t = torch.full((), cell, dtype=torch.float32, device=q.device)
    for t in range(v2.shape[0]):
        sel = torch.nonzero(v2[t])[:qb, 0]
        pts = q[t // (v2.shape[0] // q.shape[0])]
        a, b = pts[sel // row_cap], pts[c2[t, sel].long()]
        e2 = a + inv2[t] * (b - a)
        base = torch.floor((e2 - r) / cell_t).long()
        probe = base[:, None, :] + tc._window_offsets(w, q.device)
        if bool(((tc._cell_hash(probe) & ~1) == TOP_GROUP).any()):
            return True
    return False
