"""The port's banded pair engine (super4pcs_tpu_torch.ops.band_extract)
against the JAX package's (super4pcs_tpu.ops.band_extract), on the CPU,
on numpy inputs made from a seed.

- The index build: members, occ, centers, g and the meta equal; the
  sorted table is compared by its entries' float64 squared center
  distances, within ``_TABLE_TOL``: XLA's CPU backend contracts the
  table's cross term into FMAs and the port writes it out, so entries
  whose squared distances lie within float32 rounding of each other may
  sort either way. Wherever an entry's distance is apart from both
  neighbours by more than the tolerance, the ids are equal.
- The extraction, with the JAX index carried across
  (``band_index_from_jax``), equals the JAX function bit for bit:
  pairs, validity, count and drops, called unjitted as the JAX
  package's own tests call it. One exclusion: a candidate whose float64
  angle to the base edge lies within ``_ANGLE_TOL`` radians of the
  ``max_angle`` gate may be decided either way (``torch.acos`` and
  ``jnp.arccos`` may differ in the last bit); such candidates are
  counted and must be rare.
- The trial axis: a T-trial call equals T single calls, on one index
  and on a batched index of two clouds.
- End to end: the JAX package's forced-banded registration fixtures
  and gates (tests/test_matcher.py, tests/test_parallel.py) through
  the port, a JAX banded run's state resumed by the port, and the band
  index of a padded batch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import super4pcs_tpu as s4j
import super4pcs_tpu_torch as s4t
from super4pcs_tpu.ops import band_extract as jband
from super4pcs_tpu.ops.pairs import PairFilterConfig as JCfg
from super4pcs_tpu.parallel.batch import _Q_SENTINEL as JAX_SENTINEL
from super4pcs_tpu_torch import matcher as tmatcher
from super4pcs_tpu_torch.ops import band_extract as tband
from super4pcs_tpu_torch.ops.pairs import PairFilterConfig as TCfg
from super4pcs_tpu_torch.parallel import register_batch
from super4pcs_tpu_torch.parallel.batch import _Q_SENTINEL
from tests._torch_threads import one_torch_thread_per_worker  # noqa: F401
from tests.test_matcher import bumpy_cloud, rot_tr_diff

#: squared center distance within which two table entries may sort
#: either way (float32 rounding of |a|^2 + |b|^2 - 2 a.b at unit scale)
_TABLE_TOL = 1e-5
#: radians from the max_angle gate within which a candidate is excluded
_ANGLE_TOL = 1e-6


def _cloud(rng, n):
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    bump = 1.0 + 0.3 * np.sin(5 * v[:, 0]) * np.cos(3 * v[:, 1])
    return (v * bump[:, None]).astype(np.float32)


def _carried(ji):
    """The JAX index's leaves and meta, as numpy and ints."""
    return tband.band_index_from_jax(dict(
        members=ji.members, occ=ji.occ, centers=ji.centers,
        sorted_pair=ji.sorted_pair, g=ji.g, m=ji.m, n=ji.n, pc=ji.pc,
        member_dropped=ji.member_dropped, m_real=ji.m_real))


def _table_d2(centers, sp, m):
    c = np.asarray(centers, np.float64)
    sp = np.asarray(sp, np.int64)
    return ((c[sp // m] - c[sp % m]) ** 2).sum(-1)


def _assert_tables_agree(centers, j_sp, t_sp, m):
    """Both tables ascend in float64 squared distance up to _TABLE_TOL
    and agree within it position by position; cut where neighbouring
    distances differ by more than the tolerance, each segment holds the
    same ids (lattice centers tie exactly, (a, b) with (b, a) at least),
    and a segment of one entry the same id."""
    j_sp, t_sp = np.asarray(j_sp, np.int64), np.asarray(t_sp, np.int64)
    dj, dt = _table_d2(centers, j_sp, m), _table_d2(centers, t_sp, m)
    assert (np.diff(dj) >= -_TABLE_TOL).all()
    assert (np.diff(dt) >= -_TABLE_TOL).all()
    assert np.abs(dj - dt).max() <= _TABLE_TOL
    seg = np.concatenate([[0], np.cumsum(np.diff(dj) > _TABLE_TOL)])
    assert seg[-1] > 0
    np.testing.assert_array_equal(j_sp[np.lexsort((j_sp, seg))],
                                  t_sp[np.lexsort((t_sp, seg))])


def _assert_index_equal(ji, ti):
    for k in ("members", "occ", "centers", "g"):
        np.testing.assert_array_equal(np.asarray(getattr(ji, k)),
                                      getattr(ti, k).numpy(), err_msg=k)
    for k in ("m", "n", "pc", "member_dropped", "m_real"):
        assert getattr(ji, k) == getattr(ti, k), k


# ---------------------------------------------------------------------------
# (a) the index
# ---------------------------------------------------------------------------


def _dense_cluster(rng):
    """A sphere plus 60 points packed into one cell (the member cap)."""
    pos = _cloud(rng, 340)
    blob = (0.3 + 0.01 * rng.uniform(size=(60, 3))).astype(np.float32)
    return np.concatenate([pos, blob])


@pytest.mark.parametrize("case", ["sphere", "budget", "member-cap"])
def test_band_index_equals_jax(rng, case):
    kw = {}
    if case == "sphere":
        pos, delta = _cloud(rng, 400), 0.05
    elif case == "budget":          # the cell size doubles to fit
        pos, delta, kw = _cloud(rng, 1500), 0.01, dict(cell_budget=256)
    else:
        pos, delta, kw = _dense_cluster(rng), 0.05, dict(pc=8)
    ji = jband.build_band_index(pos, delta, **kw)
    ti = tband.build_band_index(pos, delta, **kw)
    _assert_index_equal(ji, ti)
    _assert_tables_agree(ti.centers.numpy(), ji.sorted_pair,
                         ti.sorted_pair.numpy(), ti.m)
    if case == "budget":
        assert ti.m <= 256 and float(ti.g) > 2 * delta
    if case == "member-cap":
        assert ti.member_dropped > 0
        # all in one cell: the JAX package's count
        z = tband.build_band_index(np.zeros((50, 3), np.float32), 0.05,
                                   pc=8)
        assert z.member_dropped == 42 and int(z.occ[0]) == 50


def test_batched_band_index_equals_jax(rng):
    """Two sentinel-padded clouds: every leaf and meta as the JAX
    package's; each set's real cell pairs in the order of its own
    table, the pairs with a padding cell after them (the JAX package
    sorts those by a float32 d2 that cancels to noise, see
    ops/band_extract.py)."""
    a = _cloud(rng, 300)
    b = _cloud(rng, 120)
    n = 300
    qa = a - a.mean(0)
    qb = np.concatenate([b - b.mean(0),
                         np.full((n - 120, 3), JAX_SENTINEL, np.float32)])
    assert _Q_SENTINEL == JAX_SENTINEL
    ji = jband.build_batched_band_index([qa, qb], 0.05)
    ti = tband.build_batched_band_index([qa, qb], 0.05)
    _assert_index_equal(ji, ti)
    m = ti.m
    for g, q in enumerate((qa, b - b.mean(0))):
        own = tband.build_band_index(q, 0.05)
        real = own.m * own.m
        sp = ti.sorted_pair[g].numpy().astype(np.int64)
        # the real prefix is the set's own table, ids at stride m
        ab = np.stack([sp[:real] // m, sp[:real] % m], 1)
        np.testing.assert_array_equal(
            ab[:, 0] * own.m + ab[:, 1], own.sorted_pair.numpy())
        assert (np.maximum(sp[real:] // m, sp[real:] % m) >= own.m).all()
        j_sp = np.asarray(ji.sorted_pair[g]).astype(np.int64)
        j_real = j_sp[np.maximum(j_sp // m, j_sp % m) < own.m]
        _assert_tables_agree(ti.centers[g].numpy(), j_real, sp[:real], m)


def test_padded_set_band_search_covers_its_own(rng):
    """The band search on a padded set of a batched index finds the same
    real cell pairs as on the set's own index (pairs with a padding cell
    are at +inf in the table and in its probes)."""
    a, b = _cloud(rng, 300), _cloud(rng, 90)
    qb = np.concatenate([b, np.full((210, 3), _Q_SENTINEL, np.float32)])
    bi = tband.build_batched_band_index([a, qb], 0.05)
    own = tband.build_band_index(b, 0.05)
    assert bi.m > own.m
    # values off the lattice distances sqrt(k) g, where exactly tied
    # entries sort in float32 noise and a search may stop among them
    assert float(own.g) == np.float32(0.1)
    vals = torch.tensor([0.0237, 0.1113, 0.3571, 0.8261, 1.4129, 2.2017],
                        dtype=torch.float32)
    lo_b = tband._searchsorted_table(bi, vals,
                                     torch.ones(6, dtype=torch.long))
    lo_o = tband._searchsorted_table(own, vals, None)
    np.testing.assert_array_equal(lo_b.numpy(), lo_o.numpy())


# ---------------------------------------------------------------------------
# (b) the extraction against the JAX function
# ---------------------------------------------------------------------------

_FILTERS = dict(max_normal_difference=25.0, max_color_distance=0.5,
                max_translation_distance=1.6, max_angle=80.0)


def _case(name, rng):
    """Inputs and call arguments of each situation of
    tests/test_band_extract.py."""
    # one cloud size and window for most cases: the JAX function runs
    # op by op, and its ops compile once per shape
    n = 400
    pos = _dense_cluster(rng) if name.startswith("window") else _cloud(rng, n)
    normal = np.zeros_like(pos)
    rgb = np.full_like(pos, -1.0)
    kw, build, eps = {}, {}, 0.1
    if name == "filters":
        normal = rng.normal(size=(n, 3)).astype(np.float32)
        normal /= np.linalg.norm(normal, axis=1, keepdims=True)
        rgb = rng.uniform(0, 1, size=(n, 3)).astype(np.float32)
        rgb[rng.uniform(size=n) < 0.3] = -1.0
        eps = 0.12
        kw = dict(cfg=_FILTERS, cell_pair_cap=65536)
    elif name == "distance" or name.startswith("capacity"):
        # the whole band fits the window: capacity compaction below and
        # above the raw hit count
        kw = dict(cell_pair_cap=65536)
    elif name.startswith("window"):
        # window overflow (64 entries) with rotation, over a cloud with a
        # cell beyond the member cap
        build = dict(pc=8)
        kw = dict(cell_pair_cap=64, rot_offset=int(name.split("-")[1]))
    base = rng.choice(len(pos), 4, replace=False)
    ji = jband.build_band_index(pos, delta=0.05, **build)
    return pos, normal, rgb, base, eps, ji, kw


def _jax_call(ji, pos, normal, rgb, base, e0, e1, eps, cfg=None,
              rot_offset=None, **kw):
    out = jband.extract_pairs_banded(
        ji, jnp.asarray(pos), jnp.asarray(normal), jnp.asarray(rgb),
        jnp.asarray(pos[base]), jnp.asarray(normal[base]),
        jnp.asarray(rgb[base]), e0, e1, eps, JCfg(**(cfg or {})),
        rot_offset=None if rot_offset is None else jnp.int32(rot_offset),
        **kw)
    return tuple(np.asarray(o) for o in out)


def _port_call(ti, pos, normal, rgb, base, e0, e1, eps, cfg=None, **kw):
    t = torch.as_tensor
    out = tband.extract_pairs_banded(
        ti, t(pos), t(normal), t(rgb), t(pos[base]), t(normal[base]),
        t(rgb[base]), e0, e1, eps, TCfg(**(cfg or {})), **kw)
    return tuple(o.numpy() for o in out)


def _angle_edge(pos, pairs, base, e0, e1, max_angle):
    """Slots whose pair's float64 angle to the base edge lies within
    _ANGLE_TOL of the gate."""
    p = pos.astype(np.float64)
    d = p[pairs[:, 1]] - p[pairs[:, 0]]
    seg = p[base[e1]] - p[base[e0]]
    seg /= np.linalg.norm(seg)
    cos = (d @ seg) / np.maximum(np.linalg.norm(d, axis=1), 1e-30)
    ang = np.arccos(np.clip(cos, -1.0, 1.0))
    return np.abs(ang - np.deg2rad(max_angle)) <= _ANGLE_TOL


@pytest.mark.parametrize("name", [
    "distance", "filters", "window-0", "window-977", "window-31415",
    "capacity-full", "capacity-half"])
def test_extraction_bit_identical_to_jax(rng, name):
    pos, normal, rgb, base, eps, ji, kw = _case(name, rng)
    ti = _carried(ji)
    edges = (((0, 1), (2, 3)) if name in ("distance", "filters")
             else ((0, 1),))
    for e0, e1 in edges:
        call_kw = dict(kw)
        if name.startswith("capacity"):
            raw = _port_call(ti, pos, normal, rgb, base, e0, e1, eps, **kw)
            assert int(raw[3]) == 0
            hits = int(raw[2])
            call_kw["capacity"] = (hits + 64 if name == "capacity-full"
                                   else max(hits // 2, 1))
        want = _jax_call(ji, pos, normal, rgb, base, e0, e1, eps, **call_kw)
        got = _port_call(ti, pos, normal, rgb, base, e0, e1, eps, **call_kw)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[3], want[3])
        if name == "filters":
            edge = _angle_edge(pos, got[0], base, e0, e1,
                               _FILTERS["max_angle"])
            differ = got[1] != want[1]
            assert (edge & (got[1] | want[1])).sum() <= 2
            assert not (differ & ~edge).any()
            assert int(got[2]) == int(got[1].sum())
            assert int(want[2]) == int(want[1].sum())
            assert int(got[2]) > 0
        else:
            np.testing.assert_array_equal(got[1], want[1])
            assert int(got[2]) == int(want[2])
        if name.startswith("window"):
            assert int(got[3]) > 0          # the window overflowed
            assert ti.member_dropped > 0
        if name == "capacity-half":
            assert int(got[3]) == int(got[2]) - call_kw["capacity"]
        if name == "distance":
            assert int(got[3]) == 0 and int(got[2]) > 0


# ---------------------------------------------------------------------------
# (c) the trial axis
# ---------------------------------------------------------------------------


def test_batched_call_equals_single_calls(rng, monkeypatch):
    """T = 3 trials of one cloud (window overflow, rotations, capacity
    compaction, all filters) in one call equal three single calls, and
    equal the same call run one trial per chunk (as when a step's
    planes would pass the memory budget)."""
    n = 300
    pos = _cloud(rng, n)
    normal = rng.normal(size=(n, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    rgb = rng.uniform(0, 1, size=(n, 3)).astype(np.float32)
    ti = tband.build_band_index(pos, 0.05)
    bases = np.stack([rng.choice(n, 4, replace=False) for _ in range(3)])
    offs = [0, 977, 31415]
    t = torch.as_tensor
    cfg = TCfg(**_FILTERS)
    for e0, e1 in ((0, 1), (2, 3)):
        got = tband.extract_pairs_banded(
            ti, t(pos), t(normal), t(rgb), t(pos[bases]), t(normal[bases]),
            t(rgb[bases]), e0, e1, 0.12, cfg, 256, rot_offset=t(offs),
            capacity=500, expand_cap=256 * 6)
        for k in range(3):
            one = tband.extract_pairs_banded(
                ti, t(pos), t(normal), t(rgb), t(pos[bases[k]]),
                t(normal[bases[k]]), t(rgb[bases[k]]), e0, e1, 0.12, cfg,
                256, rot_offset=offs[k], capacity=500, expand_cap=256 * 6)
            for a, b in zip(got, one):
                assert torch.equal(a[k], b)
        with monkeypatch.context() as mp:
            mp.setattr(tband, "_trial_chunk", lambda dev, nt, slots: 1)
            chunked = tband.extract_pairs_banded(
                ti, t(pos), t(normal), t(rgb), t(pos[bases]),
                t(normal[bases]), t(rgb[bases]), e0, e1, 0.12, cfg, 256,
                rot_offset=t(offs), capacity=500, expand_cap=256 * 6)
        for a, b in zip(got, chunked):
            assert torch.equal(a, b)


def test_batched_index_call_equals_per_set_calls(rng):
    """T = 4 trials over a batched index of two clouds (the second
    sentinel-padded) equal single calls on each set's slice of the
    batched index."""
    n = 240
    qa = _cloud(rng, n)
    b = _cloud(rng, 150)
    qb = np.concatenate([b, np.full((n - 150, 3), _Q_SENTINEL, np.float32)])
    bi = tband.build_batched_band_index([qa, qb], 0.05)
    q = torch.as_tensor(np.stack([qa, qb]))
    zeros = torch.zeros_like(q)
    none = torch.full_like(q, -1.0)
    bases = torch.as_tensor(np.stack([qa[rng.choice(n, 4, replace=False)]
                                      for _ in range(2)]
                                     + [b[rng.choice(150, 4, replace=False)]
                                        for _ in range(2)]))
    offs = torch.tensor([3, 500, 71, 9])
    got = tband.extract_pairs_banded(
        bi, q, zeros, none, bases, torch.zeros_like(bases),
        torch.full_like(bases, -1.0), 0, 1, 0.1, TCfg(), 512,
        rot_offset=offs, capacity=800)
    for t in range(4):
        g = t // 2
        one_idx = tband.BandIndex(
            members=bi.members[g], occ=bi.occ[g], centers=bi.centers[g],
            sorted_pair=bi.sorted_pair[g], g=bi.g[g], m=bi.m, n=bi.n,
            pc=bi.pc, member_dropped=0)
        one = tband.extract_pairs_banded(
            one_idx, q[g], zeros[g], none[g], bases[t],
            torch.zeros_like(bases[t]), torch.full_like(bases[t], -1.0),
            0, 1, 0.1, TCfg(), 512, rot_offset=int(offs[t]), capacity=800)
        for a, o in zip(got, one):
            assert torch.equal(a[t], o)
    # no sentinel row is ever a member, so no pair touches one
    pairs, valid = got[0][2:], got[1][2:]
    assert (pairs[valid] < 150).all() and int(valid.sum()) > 0


# ---------------------------------------------------------------------------
# (d) and (e) end to end
# ---------------------------------------------------------------------------


def _fixture(rng, make_transform, n=300, max_translation=0.5):
    pos = bumpy_cloud(rng, n)
    mat = make_transform(max_translation=max_translation)
    inv = np.linalg.inv(mat)
    q = (pos @ inv[:3, :3].T + inv[:3, 3]).astype(np.float32)
    return pos, q, mat


_MATCHER_OPTS = dict(delta=0.05, sample_size=300, max_time_seconds=30,
                     bases_per_step=8, max_quads=2048, max_candidates=4096,
                     random_seed=7, pair_engine="banded")


@pytest.mark.parametrize("pressure", [False, True])
def test_forced_banded_registration(rng, make_transform, pressure):
    """tests/test_matcher.py's forced-banded registration and its
    overflow-pressure options (a 128-entry window and 2048 candidate
    slots: the band overflows and the drops are counted) through the
    port: LCP > 0.8 and the reference's pose gates."""
    pos, q, mat = _fixture(rng, make_transform)
    kw = dict(_MATCHER_OPTS)
    if pressure:
        kw.update(max_time_seconds=120, band_cell_pair_cap=128,
                  band_expand_cap=2048)
    opts = s4t.Options(**kw).configure_overlap(0.9)
    assert tmatcher.resolve_pair_engine(opts, 300) == "banded"
    m = s4t.MatchSuper4PCS(opts, device="cpu")
    res = m.compute_transformation(s4t.PointCloud(pos), s4t.PointCloud(q))
    assert m._band_index is not None and res.stats["band_cells"] > 0
    assert res.score > 0.8, (res.score, res.stats)
    rot_diff, tr_diff = rot_tr_diff(res.transform, mat)
    assert rot_diff <= 0.2 and tr_diff <= 0.1, (rot_diff, tr_diff)
    if pressure:
        assert res.stats["pairs_overflow"] > 0


def test_banded_run_resumes_jax_state_with_its_keys(rng, make_transform):
    """The JAX package's forced-banded matcher set up on the same
    fixture (its search is left out: it compiles for ~10 s): its stats'
    counters are the port's, the band keys with equal values, and its
    exported state, resumed by the port's banded matcher, continues to
    the gates."""
    pos, q, mat = _fixture(rng, make_transform)
    jm = s4j.MatchSuper4PCS(s4j.Options(**_MATCHER_OPTS)
                            .configure_overlap(0.9))
    jm._init(s4j.PointCloud(pos), s4j.PointCloud(q))
    state = jm.export_state()
    tm = s4t.MatchSuper4PCS(s4t.Options(**_MATCHER_OPTS)
                            .configure_overlap(0.9), device="cpu")
    rt = tm.compute_transformation(s4t.PointCloud(pos), s4t.PointCloud(q),
                                   resume_state=state)
    jkeys = set(jm._stats) - {"initial_verify_seconds"}
    assert jkeys <= set(rt.stats), jkeys - set(rt.stats)
    for k in ("band_cells", "band_cell_size", "band_member_dropped"):
        assert rt.stats[k] == jm._stats[k], k
    assert rt.n_trials > state["trial"] == 0
    assert rt.score > 0.8
    rot_diff, tr_diff = rot_tr_diff(rt.transform, mat)
    assert rot_diff <= 0.2 and tr_diff <= 0.1


def test_register_batch_banded_engine(rng, make_transform):
    """tests/test_parallel.py's banded x batch test through the port: a
    ragged batch of two pairs, each within the gates, against the
    single-pair banded matcher on pair a."""
    pos_a, q_a, mat_a = _fixture(rng, make_transform, 140, 0.4)
    pos_b, q_b, mat_b = _fixture(rng, make_transform, 90, 0.4)
    opts = s4t.Options(delta=0.05, sample_size=140, max_time_seconds=60,
                       bases_per_step=4, max_quads=512, max_candidates=512,
                       random_seed=5, pair_engine="banded",
                       ).configure_overlap(0.9)
    results = register_batch(
        [(s4t.PointCloud(pos_a), s4t.PointCloud(q_a)),
         (s4t.PointCloud(pos_b), s4t.PointCloud(q_b))], opts, device="cpu")
    assert results[1].stats["q_padded"] > 0
    assert results[0].stats["band_cells"] > 0
    for res, mat in zip(results, (mat_a, mat_b)):
        assert res.score > 0.8, res.score
        rot_diff, tr_diff = rot_tr_diff(res.transform, mat)
        assert rot_diff <= 0.2 and tr_diff <= 0.1
    single = s4t.MatchSuper4PCS(opts, device="cpu").compute_transformation(
        s4t.PointCloud(pos_a), s4t.PointCloud(q_a))
    assert abs(single.score - results[0].score) < 0.1


def test_entry_points_resolve_banded():
    """Above nq = 65536 "auto" resolves to banded, as in the JAX
    package; an explicit "banded" holds at any nq."""
    from super4pcs_tpu import matcher as jmatcher
    for nq, kw in ((131072, {}), (65537, {}), (300, dict(
            pair_engine="banded")), (5000, dict(pair_engine="banded"))):
        assert tmatcher.resolve_pair_engine(s4t.Options(**kw), nq) == \
            jmatcher.resolve_pair_engine(s4j.Options(**kw), nq) == "banded"


def test_cli_pair_engine_banded(rng, make_transform, tmp_path, capsys):
    """``super4pcs-torch ... --tpu-opts pair_engine=banded`` registers
    through the banded engine on the CPU: exit 0, and the Polyworks
    matrix within the pose gates."""
    from super4pcs_tpu_torch import cli as tcli
    from super4pcs_tpu_torch import io as tio
    pos, q, mat = _fixture(rng, make_transform, 200, 0.3)
    p1, p2, out = (str(tmp_path / f) for f in ("p.ply", "q.ply", "m.txt"))
    tio.write_ply(p1, s4t.PointCloud(pos))
    tio.write_ply(p2, s4t.PointCloud(q))
    rc = tcli.main(["s", "-i", p1, p2, "-o", "0.9", "-d", "0.05", "-n",
                    "200", "-t", "30", "-m", out, "--tpu-opts",
                    "pair_engine=banded,bases_per_step=8,max_quads=2048,"
                    "random_seed=7"], device="cpu")
    assert rc == 0
    assert "Score: " in capsys.readouterr().out
    lines = open(out).read().splitlines()
    got = np.array([[float(x) for x in ln.split()] for ln in lines[2:]])
    rot_diff, tr_diff = rot_tr_diff(got, mat)
    assert rot_diff <= 0.2 and tr_diff <= 0.1


def test_banded_capacities_match_jax(rng):
    """The banded step's pair, quad and candidate capacities are the
    JAX package's (16 nq pairs, not rowcap's 64 nq), at the search
    factors an escalation climbs."""
    from super4pcs_tpu import matcher as jmatcher
    pos = _cloud(rng, 300)
    ji = jband.build_band_index(pos, 0.05)
    ti = tband.build_band_index(pos, 0.05)
    for kw in ({}, dict(search_delta_factor=2.0), dict(max_pairs=4096)):
        jo = s4j.Options(pair_engine="banded", **kw)
        to = s4t.Options(pair_engine="banded", **kw)
        _, jcaps = jmatcher.build_step(jo, 300, 0.3, band_index=ji)
        _, tcaps = tmatcher.build_step(to, 300, 0.3, ti)
        assert tcaps == jcaps, kw
