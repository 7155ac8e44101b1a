"""The two grid joins on one allpairs base at nq = 4096, on the CPU.

The JAX package's ``find_congruent_quads_grid`` finds each probe's cell
range with a bucket-seeded binary search of bounded rounds; the PyTorch
port's searches at full depth (``torch.searchsorted``). The rounds are
exact up to log2(k1) rows per range, and an allpairs table at nq = 4096
holds k1 = 16.7M rows, so this compares the two on one base of
chip_smoke.py's phase 5i (the scale fixture of tools/scale_hier_16k.py
at 50,000 points, Q sampled to 4096 at delta 0.05, seed 21; the step's
join arguments): exact pre-cap quad counts, cell drops, the probe
subsample, and the valid quads as sets, at the step's capacity (8192)
and at a capacity that holds every quad.

Usage: python tools/allpairs_join_depth.py [base=0] [capacity=1048576]
(about 3 GB of memory and a minute or two of CPU).
"""
import _path  # noqa: F401
import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from super4pcs_tpu.ops import congruent as jc
import super4pcs_tpu_torch as s4t
from super4pcs_tpu_torch import matcher as tm
from super4pcs_tpu_torch.ops import congruent as tc
from super4pcs_tpu_torch.ops import geometry, sampling, select

kv = dict(item.split("=", 1) for item in sys.argv[1:])
BASE = int(kv.get("base", 0))
BIG = int(kv.get("capacity", 1 << 20))
N, NQ, DELTA, S = 50_000, 4096, 0.05, 1.4

rng = np.random.default_rng(21)
v = rng.normal(size=(N, 3))
v /= np.linalg.norm(v, axis=1, keepdims=True)
bump = (1 + 0.3 * np.sin(5 * v[:, 0]) * np.cos(3 * v[:, 1])
        + 0.2 * np.sin(4 * v[:, 2]))
pos = (v * bump[:, None]).astype(np.float32)
th = 0.8
rot = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0],
                [0, 0, 1]], np.float32)
q = (((pos @ rot.T) + np.float32([0.1, -0.05, 0.2])) / S).astype(np.float32)
q += rng.normal(scale=0.008, size=q.shape).astype(np.float32)

# the 5i matcher's samples, centering and step arguments
opts = s4t.Options(delta=DELTA, sample_size=NQ, scale_max_q=NQ,
                   scale_hierarchical=False, estimate_scale=True,
                   random_seed=21)
srng = np.random.default_rng(opts.random_seed)
sp = sampling.sample_for_matching(s4t.PointCloud(pos), DELTA, NQ, False,
                                  srng)
sq = sampling.sample_for_matching(s4t.PointCloud(q), DELTA, NQ, True, srng)
p_pos = torch.as_tensor(sp.pos - sp.pos.mean(0))
q_pos = torch.as_tensor(sq.pos - sq.pos.mean(0))
nq = q_pos.shape[0]
diam = geometry.estimate_diameter(q_pos.numpy(), 1000, srng)
gen = torch.Generator()
gen.manual_seed(tm._step_seed(opts.random_seed, 0))
draws = select.draw_base_indices(gen, p_pos.shape[0], 4,
                                 opts.n_triangle_trials)
q_rots = torch.randint(0, nq * nq, (4,), generator=gen)
ids, inv1, inv2, ok = select.select_base(p_pos, diam, *draws)
b = p_pos[ids[BASE]]
s1, s2 = b[1] - b[0], b[3] - b[2]
n1, n2 = torch.linalg.vector_norm(s1), torch.linalg.vector_norm(s2)
cos_a = ((s1 / n1) * (s2 / n2)).sum()
ratio = n1 / n2
thr = 2.0 * DELTA                          # DISTANCE_FACTOR * delta
kw = dict(distance_threshold=thr, cone_cos_tolerance=opts.cone_cos_tolerance,
          cell_candidates=opts.cell_candidates, q_budget=None, row_cap=nq,
          probe_budget=None, cell_size=2.0 * thr, allpairs_cols=True,
          q_uniform=True, scale_band=geometry.SCALE_RATIO_DEV)
valid = (np.arange(nq * nq) % (nq + 1)) != 0
k_quads = tm._round_up(min(max(8 * nq, 512), 8192), 128)
static = ("distance_threshold", "cone_cos_tolerance", "capacity",
          "cell_candidates", "q_budget", "row_cap", "probe_budget",
          "cell_size", "scale_band", "allpairs_cols", "q_uniform")
jgrid = jax.jit(jc.find_congruent_quads_grid, static_argnames=static)


def quad_set(quads, ok):
    return {tuple(r) for r in np.asarray(quads)[np.asarray(ok)]}


out = dict(nq=nq, k1=nq * nq, base=BASE, base_valid=bool(ok[BASE]),
           inv1=float(inv1[BASE]), inv2=float(inv2[BASE]),
           cos_alpha=float(cos_a), seg_ratio=float(ratio),
           q_rot=int(q_rots[BASE]))
for cap in (k_quads, BIG):
    t0 = time.perf_counter()
    ref = jgrid(jnp.asarray(q_pos.numpy()), None, jnp.asarray(valid), None,
                jnp.asarray(valid), jnp.float32(inv1[BASE]),
                jnp.float32(inv2[BASE]), base_cos_alpha=jnp.float32(cos_a),
                q_rot=jnp.int32(int(q_rots[BASE])),
                seg_ratio=jnp.float32(ratio), capacity=cap, **kw)
    ref = jax.device_get(ref)
    t_jax = time.perf_counter() - t0
    t0 = time.perf_counter()
    with torch.no_grad():
        got = tc.find_congruent_quads_grid(
            q_pos, None, torch.as_tensor(valid), None,
            torch.as_tensor(valid), inv1[BASE], inv2[BASE],
            base_cos_alpha=cos_a, q_rot=q_rots[BASE], seg_ratio=ratio,
            capacity=cap, **kw)
    t_port = time.perf_counter() - t0
    js, ps = quad_set(ref[0], ref[1]), quad_set(got[0], got[1])
    out[f"capacity_{cap}"] = dict(
        jax=dict(count=int(ref[2]), dropped=int(ref[3]),
                 q_subsampled=int(ref[4]), kept=len(js),
                 cpu_seconds=round(t_jax, 3)),
        port=dict(count=int(got[2]), dropped=int(got[3]),
                  q_subsampled=int(got[4]), kept=len(ps),
                  cpu_seconds=round(t_port, 3)),
        common=len(js & ps), jax_only=len(js - ps), port_only=len(ps - js))
    print(json.dumps({f"capacity_{cap}": out[f"capacity_{cap}"]}),
          flush=True)
print(json.dumps(out))
