"""The grid join over the capture kernel's tables: the join kernel
(``kernels/join.py``, ``csrc/join.cu``) against the plain join, the rule
that routes a join to it, and its wrapper's checks.

The CPU tests hold the route rule (``kernels/join.py::takes``, and the
matcher's cost model that follows it), the wrapper's checks, that no
CPU join reaches the kernel, and the shared cases
(``tests/_join_cases.py``) to the branches they are named for. The tests
marked ``cuda`` skip without a card; on a machine with one (no jax
needed, hence no conftest):

    python -m pytest --noconftest tests/test_torch_grid_join.py -q
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

import super4pcs_tpu_torch as s4t
from super4pcs_tpu_torch import matcher
from super4pcs_tpu_torch.kernels import join
from super4pcs_tpu_torch.kernels import rowcap as k2
from super4pcs_tpu_torch.ops import congruent as tc

import _join_cases as jc


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _plain(monkeypatch, args, kwargs):
    """The plain join of the same inputs on their device."""
    with monkeypatch.context() as m:
        m.setattr(join, "takes", lambda *a: False)
        return tc.find_congruent_quads_grid(*args, **kwargs)


def _same(got, want) -> bool:
    return all(a.dtype == b.dtype and torch.equal(a, b)
               for a, b in zip(got, want))


# ------------------------------------------------------------ CPU: the route

def _route_inputs():
    """The capture kernel's join inputs of one trial, small."""
    args, kwargs = jc.join_inputs(3, "cpu", per_set=1)
    q, c1, v1, c2, v2 = args[:5]
    return dict(pairs1=c1[0], valid1=v1[0], pairs2=c2[0], valid2=v2[0],
                table_hash=kwargs["table_hash"][0],
                row_cap=kwargs["row_cap"], direction_bins="cone",
                cone_cos_tolerance=0.3, scale_band=-1.0,
                allpairs_cols=False, q_uniform=False,
                probe_budget=512, cell_candidates=16)


#: inputs of the capture kernel's route changed one at a time, and
#: whether the join kernel takes them
_ROUTES = {
    "capture_kernel": ({}, True),
    "four_pcs_no_direction_test": (dict(cone_cos_tolerance=-1.0), True),
    "healpix_bins_in_four_pcs": (dict(direction_bins="healpix",
                                      cone_cos_tolerance=-1.0), True),
    "thirty_two_candidates": (dict(cell_candidates=32), True),
    "xla_route_no_table_hash": (dict(table_hash=None), False),
    "explicit_pair_tables": ("explicit", False),
    "allpairs_table": (dict(allpairs_cols=True), False),
    "strided_probe_walk": (dict(q_uniform=True), False),
    "healpix_bins": (dict(direction_bins="healpix"), False),
    "scale_band": (dict(scale_band=0.05), False),
    "no_probe_budget": (dict(probe_budget=None), False),
    "no_row_cap": (dict(row_cap=None), False),
    "thirty_three_candidates": (dict(cell_candidates=33), False),
}


@pytest.mark.parametrize("name", sorted(_ROUTES))
def test_route_rule(name):
    """``takes`` accepts the capture kernel's joins (cone test or none)
    and refuses the K2x route's, the explicit tables of the dense and
    banded engines, the allpairs table and its probe walk, HEALPix
    bins, similarity mode's scale band, a join without a probe budget
    and more than 32 candidates a cell."""
    change, want = _ROUTES[name]
    kw = _route_inputs()
    if change == "explicit":
        rows = torch.arange(kw["valid1"].shape[0]) // kw["row_cap"]
        kw["pairs1"] = torch.stack([rows, kw["pairs1"].long()], -1)
        kw["pairs2"] = torch.stack([rows, kw["pairs2"].long()], -1)
    else:
        kw.update(change)
    assert join.takes(**kw) is want


def test_no_cpu_join_reaches_the_kernel(monkeypatch):
    """On the CPU the capture kernel's joins run the plain join, and the
    wrapper's CPU path is that plain join: the same outputs, no
    launch."""
    def refuse(*a, **k):
        raise AssertionError("the join kernel launched on the CPU")

    monkeypatch.setattr(join, "_launch", refuse)
    args, kwargs = jc.case("two_sets", "cpu")
    before = join.grid_join.launches
    plain = tc.find_congruent_quads_grid(*args, **kwargs)
    q, c1, v1, c2, v2, inv1, inv2, r, cos_a, cone, cap = args
    via = join.grid_join(q, c1, v1, c2, v2, kwargs["table_hash"], inv1, inv2,
                         r, cos_a, cone, cap, kwargs["cell_candidates"],
                         kwargs["q_budget"], kwargs["row_cap"],
                         kwargs["probe_budget"], kwargs["cell_size"])
    assert _same(via, plain)
    one = join.grid_join(q[0], c1[0], v1[0], c2[0], v2[0],
                         kwargs["table_hash"][0], inv1[0], inv2[0], r,
                         cos_a[0], cone, cap, kwargs["cell_candidates"],
                         kwargs["q_budget"], kwargs["row_cap"],
                         kwargs["probe_budget"], kwargs["cell_size"])
    assert _same(one, tuple(o[0] for o in plain))
    assert join.grid_join.launches == before


def _bad(name):
    """The wrapper's arguments with one made wrong."""
    args, kwargs = jc.join_inputs(3, "cpu")
    q, c1, v1, c2, v2, inv1, inv2, r, cos_a, cone, cap = args
    kw = dict(pos=q, cols1=c1, valid1=v1, cols2=c2, valid2=v2,
              table_hash=kwargs["table_hash"], invariant1=inv1,
              invariant2=inv2, distance_threshold=r, base_cos_alpha=cos_a,
              cone_cos_tolerance=cone, capacity=cap,
              cell_candidates=16, q_budget=256, row_cap=kwargs["row_cap"],
              probe_budget=512, cell_size=kwargs["cell_size"])
    fix = {
        "pos_float64": dict(pos=q.double()),
        "pos_not_3d": dict(pos=q[..., :2]),
        "cols1_int64": dict(cols1=c1.long()),
        "table_hash_short": dict(table_hash=kwargs["table_hash"][:, 1:]),
        "cols2_rows": dict(cols2=c2[:1]),
        "valid2_not_bool": dict(valid2=v2.int()),
        "trials_over_sets": dict(pos=torch.cat([q, q, q])),
        "table_not_in_rows": dict(row_cap=kwargs["row_cap"] + 1),
        "no_candidates": dict(cell_candidates=0),
        "thirty_three_candidates": dict(cell_candidates=33),
        "no_probe_budget": dict(probe_budget=0),
        "no_capacity": dict(capacity=0),
        "meta_device": "meta",
    }[name]
    if fix == "meta":
        for k in ("pos", "cols1", "valid1", "cols2", "valid2",
                  "table_hash"):
            kw[k] = kw[k].to("meta")
    else:
        kw.update(fix)
    return kw


@pytest.mark.parametrize("name", [
    "pos_float64", "pos_not_3d", "cols1_int64", "table_hash_short",
    "cols2_rows", "valid2_not_bool", "trials_over_sets",
    "table_not_in_rows", "no_candidates", "thirty_three_candidates",
    "no_probe_budget", "no_capacity", "meta_device"])
def test_wrapper_checks(name):
    """The wrapper raises on what the kernel does not take: the dtypes
    and shapes of its tables, trials that do not split over the point
    sets, tables not in whole rows, 0 or more than 32 candidates a
    cell, no probe budget or capacity, a device other than the CPU and
    CUDA."""
    with pytest.raises(ValueError):
        join.grid_join(**_bad(name))


@pytest.mark.parametrize("name", jc.NAMES)
def test_join_cases_reach_their_branches(name):
    """Each shared case, through the plain join on the CPU, shows what it
    is named for (the card tests hold the kernel to these outputs)."""
    args, kwargs = jc.case(name, "cpu")
    quads, valid, count, dropped, qsub = tc.find_congruent_quads_grid(
        *args, **kwargs)
    assert valid.sum(dim=1).tolist() == torch.clamp(
        count, max=args[10]).tolist()
    if name in ("empty_trials", "no_group_above"):
        assert count.tolist() == [0, 0]
        assert dropped.tolist() == [0, 0]
        return
    assert bool((count > 0).all())
    if name == "probe_budget_overflow":
        wide = dict(kwargs, probe_budget=100_000)
        more = tc.find_congruent_quads_grid(*args, **wide)
        assert bool((more[2] > count).all())
        assert bool((dropped > more[3]).all())
    elif name == "capacity_overflow":
        assert bool((count > args[10]).any())
    elif name == "top_group_probes":
        assert jc.top_group_probed(args, kwargs)
    elif name == "top_group_slots":
        h1 = kwargs["table_hash"]
        assert bool(((h1 & ~1) == jc.TOP_GROUP)[args[2]].any())
    elif name == "window_3":
        assert tc.probe_window(args[7], kwargs["cell_size"]) == 3
    elif name == "thirty_two_candidates":
        assert bool((dropped > 0).all())


_ENGINES = {
    "rowcap": dict(delta=0.02, bases_per_step=16, pair_engine="rowcap"),
    "rowcap_4pcs": dict(delta=0.02, bases_per_step=16, pair_engine="rowcap"),
    "rowcap_xla": dict(delta=0.02, bases_per_step=16, pair_engine="rowcap",
                       rowcap_kernel="xla"),
    "rowcap_healpix": dict(delta=0.02, bases_per_step=16,
                           pair_engine="rowcap", direction_bins="healpix"),
    "dense": dict(delta=0.05, bases_per_step=16, pair_engine="dense",
                  force_grid_join=True),
    "allpairs": dict(delta=0.05, estimate_scale=True),
}


@pytest.mark.parametrize("name", sorted(_ENGINES))
def test_cost_model_counts_the_route(name):
    """The step's cost model counts the join kernel's bytes and
    operations for a card's join over the capture kernel's tables
    (cone test or 4PCS), and the plain join's elsewhere: on the CPU, on
    the XLA route, with HEALPix bins, on the dense engine's explicit
    tables and on the allpairs table."""
    nq = 3000
    cone = -1.0 if name == "rowcap_4pcs" else 0.3
    step, _ = matcher.build_step(s4t.Options(**_ENGINES[name]), nq, cone)
    stage = (1, 64, nq, 1234, 98765)
    cpu = step.cost_model(1234, [stage])
    card = step.cost_model(1234, [stage], "cuda")
    kernel = name in ("rowcap", "rowcap_4pcs")
    assert (card["join"] != cpu["join"]) is kernel
    for phase in ("select_extract", "fit", "verify"):
        assert card[phase] == cpu[phase]
    if kernel:
        assert card["join"]["hbm_bytes"] < cpu["join"]["hbm_bytes"]


def test_join_kernel_steps_read_zero_on_the_cpu():
    """A CPU registration's span table carries ``join_kernel_steps`` at
    0: its steps join with the plain join."""
    rng = np.random.default_rng(5)
    target = jc.bumpy(rng, 200)
    source = target[::-1].copy()
    res = s4t.register(target, source, overlap=0.9, delta=0.05,
                       sample_size=100, max_time_seconds=5, device="cpu")
    spans = res.stats["spans"]
    assert spans["join_kernel_steps"] == 0
    assert sum(row["count"] for path, row in spans["spans"].items()
               if path.split("/")[-1] == "step") >= 1


# --------------------------------------------------------------- the card

@pytest.mark.cuda
@pytest.mark.parametrize("name", jc.NAMES)
def test_join_kernel_bit_identical_to_plain(dev, monkeypatch, name):
    """Each shared case on the card: the kernel's outputs are the plain
    join's, bit for bit and in their order, in one launch."""
    args, kwargs = jc.case(name, dev)
    before = join.grid_join.launches
    got = tc.find_congruent_quads_grid(*args, **kwargs)
    torch.cuda.synchronize()
    assert join.grid_join.launches == before + 1
    assert _same(got, _plain(monkeypatch, args, kwargs))


def _cell_inputs(dev, sets, factor=1.0, filters=None, seed=21):
    """The cells' join: nq 8192, row cap 160, 16 bases a set, L 16, the
    matcher's probe budget at the window of ``factor``, capacity 8192,
    delta 0.01 on a unit-scale scan."""
    w = tc.probe_window(0.02 * factor, 0.04)
    return jc.join_inputs(
        seed, dev, n=8192, sets=sets, per_set=16, row_cap=160, delta=0.01,
        factor=factor, q_budget=None, probe_budget=(2 * 8192 * w ** 3) // 8,
        capacity=8192, filters=filters)


@pytest.mark.cuda
@pytest.mark.parametrize("sets,factor,filters", [
    (1, 1.0, None), (4, 1.0, None), (1, 1.5, None), (4, 2.0, None),
    (1, 1.0, (20.0, 60.0))])
def test_join_kernel_at_the_cells_shapes(dev, monkeypatch, sets, factor,
                                         filters):
    """T 16 and T 64 at the cells' shapes (nq 8192, row cap 160, L 16,
    probe budget 16,384 at w 2 and 55,296 at w 3), and K2's filtered
    tables with the rgbn cell's filters: the plain join's outputs, bit
    for bit."""
    args, kwargs = _cell_inputs(dev, sets, factor, filters)
    assert k2.slots_for(8192, 160) == kwargs["row_cap"] == 160
    got = tc.find_congruent_quads_grid(*args, **kwargs)
    want = _plain(monkeypatch, args, kwargs)
    torch.cuda.synchronize()
    assert _same(got, want)
    assert int(want[2].sum()) > 0


@pytest.mark.cuda
def test_a_trials_join_does_not_depend_on_its_batch(dev):
    """Trials of a T 64 call (four sets of 16) equal the same trials
    joined as a T 16 call on their own set."""
    args, kwargs = _cell_inputs(dev, 4)
    full = tc.find_congruent_quads_grid(*args, **kwargs)
    for s in (0, 3):
        lo, hi = 16 * s, 16 * (s + 1)
        part = [a[lo:hi] if torch.is_tensor(a) and a.ndim >= 1
                and a.shape[0] == 64 else a for a in args]
        part[0] = args[0][s:s + 1]
        kw = dict(kwargs, table_hash=kwargs["table_hash"][lo:hi])
        one = tc.find_congruent_quads_grid(*part, **kw)
        assert _same(one, tuple(o[lo:hi] for o in full))


def _pool(traffic: str, pairs: int):
    """The first call of the benchmark's scan100k ``traffic`` pool: its
    first ``pairs`` pairs (as PointClouds) and the cell's options."""
    here = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "benchmark")
    if here not in sys.path:
        sys.path.insert(0, here)
    import generate

    def load(*parts):
        with open(os.path.join(here, *parts)) as f:
            return json.load(f)
    config = load("configs", "scan100k.json")
    tr = load("traffic", f"{traffic}.json")
    call = generate.make_calls(config["data"], dict(tr, calls=1),
                               tr["pool_seed"])[0]
    opts = s4t.Options(**config["options"],
                       random_seed=call["random_seed"]).configure_overlap(
        *config["overlap"])
    clouds = [(s4t.PointCloud(p["target"]), s4t.PointCloud(p["source"]))
              for p in call["pairs"][:pairs]]
    return clouds, opts


def _steps(spans) -> int:
    return sum(row["count"] for path, row in spans["spans"].items()
               if path.split("/")[-1] == "step")


@pytest.mark.cuda
def test_registration_through_either_join(dev, monkeypatch):
    """A pool pair of the scan100k cell through the join kernel and
    through the plain join: the same transform, score, trials, base and
    congruent ids and join telemetry; ``join_kernel_steps`` counts
    every step the kernel joined, and 0 through the plain join."""
    (pair,), opts = _pool("pair", 1)
    runs = []
    for kernel in (True, False):
        with monkeypatch.context() as m:
            if not kernel:
                m.setattr(join, "takes", lambda *a: False)
            mt = s4t.MatchSuper4PCS(opts, device=dev)
            res = mt.compute_transformation(*pair)
            runs.append((res, mt.export_state()))
    (a, sa), (b, sb) = runs
    assert np.array_equal(a.transform, b.transform)
    assert (a.score, a.n_trials) == (b.score, b.n_trials)
    assert sa["base_ids"] == sb["base_ids"]
    assert sa["congruent_ids"] == sb["congruent_ids"]
    for k in matcher._TELEMETRY:
        assert a.stats[k] == b.stats[k], k
    assert a.stats["spans"]["join_kernel_steps"] == _steps(a.stats["spans"])
    assert a.stats["spans"]["join_kernel_steps"] >= 1
    assert b.stats["spans"]["join_kernel_steps"] == 0


@pytest.mark.cuda
def test_batch_registration_through_either_join(dev, monkeypatch):
    """A register_batch of the graph4 pool's first call (4 pairs, T 64)
    through the join kernel and through the plain join: the same
    transforms, scores, trials and telemetry pair by pair."""
    from super4pcs_tpu_torch.parallel import register_batch
    pairs, opts = _pool("graph4", 4)
    runs = []
    for kernel in (True, False):
        with monkeypatch.context() as m:
            if not kernel:
                m.setattr(join, "takes", lambda *a: False)
            runs.append(register_batch(pairs, opts, device=dev))
    for a, b in zip(*runs):
        assert np.array_equal(a.transform, b.transform)
        assert (a.score, a.n_trials) == (b.score, b.n_trials)
        telemetry = set(matcher._TELEMETRY) & set(a.stats)
        assert telemetry and telemetry == set(matcher._TELEMETRY) & set(
            b.stats)
        for k in telemetry:
            assert a.stats[k] == b.stats[k], k
    spans = runs[0][0].stats["spans"]
    assert spans["join_kernel_steps"] == _steps(spans) >= 1
    assert runs[1][0].stats["spans"]["join_kernel_steps"] == 0
