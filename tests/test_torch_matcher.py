"""End-to-end registrations of the PyTorch port on the CPU (the kernels'
plain versions), held to the same gates as the JAX package on the same
fixtures, and the JAX package's exported RANSAC state resumed by the
port."""

import numpy as np
import pytest

import super4pcs_tpu as s4j
import super4pcs_tpu_torch as s4t
from super4pcs_tpu_torch import matcher as tmatcher


def _bumpy(rng, n):
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    bump = (1 + 0.3 * np.sin(5 * v[:, 0]) * np.cos(3 * v[:, 1])
            + 0.2 * np.sin(4 * v[:, 2]))
    return (v * bump[:, None]).astype(np.float32)


@pytest.fixture(scope="module")
def recipe():
    """The verify-skill recipe: a 500-point bumpy sphere (unique pose)
    and a rigidly moved copy."""
    target = _bumpy(np.random.default_rng(11), 500)
    ang = 1.1
    R = np.array([[np.cos(ang), -np.sin(ang), 0],
                  [np.sin(ang), np.cos(ang), 0], [0, 0, 1]], np.float32)
    t = np.array([.4, -.2, .7], np.float32)
    source = (target - t) @ R
    return target, source


_RECIPE = dict(delta=0.05, sample_size=500, max_time_seconds=30)


def _median_err(res, source, target):
    moved = source @ res.transform[:3, :3].T + res.transform[:3, 3]
    return float(np.median(np.linalg.norm(moved - target, axis=1)))


def test_verify_recipe_both_packages(recipe):
    """Both packages' register (dense engine) reach LCP > 0.95 and a
    median error < 0.05 on the same inputs."""
    target, source = recipe
    rj = s4j.register(target, source, overlap=0.9, **_RECIPE)
    rt = s4t.register(target, source, overlap=0.9, device="cpu", **_RECIPE)
    for res in (rj, rt):
        assert res.score > 0.95
        assert _median_err(res, source, target) < 0.05
    assert rt.improved and rt.n_trials > 0
    for key in ("pairs_overflow", "quads_overflow", "cands_overflow",
                "n_congruent", "cell_dropped", "q_sampled_out",
                "search_seconds"):
        assert key in rt.stats and key in rj.stats


def test_rowcap_engine_known_pose():
    """The rowcap engine (capture kernel's plain version + grid join
    with the kernel-emitted hash) at nq = 2300 recovers a known pose."""
    rng = np.random.default_rng(5)
    target = _bumpy(rng, 2300)
    ang = 0.8
    R = np.array([[np.cos(ang), -np.sin(ang), 0],
                  [np.sin(ang), np.cos(ang), 0], [0, 0, 1]], np.float32)
    source = (target @ R.T + np.float32([.1, -.05, .2])).astype(np.float32)
    opts = s4t.Options(delta=0.03, sample_size=2300, max_time_seconds=50,
                       pair_engine="rowcap", bases_per_step=4,
                       verify_top_k=256, max_candidates=2048)
    assert tmatcher.resolve_pair_engine(opts, 2300) == "rowcap"
    calls = []

    def visitor(fraction, lcp, transform):
        calls.append(fraction)

    m = s4t.MatchSuper4PCS(opts.configure_overlap(0.9), device="cpu")
    res = m.compute_transformation(s4t.PointCloud(target),
                                   s4t.PointCloud(source), visitor=visitor)
    assert res.score > 0.95
    assert _median_err(res, source, target) < 0.05
    assert calls[0] == 0.0 and calls[-1] > 0
    assert res.stats["pairs_overflow"] > 0       # the row cap binds
    gt = np.eye(4)
    gt[:3, :3] = R.T
    gt[:3, 3] = -R.T @ np.array([.1, -.05, .2])
    rot_diff, tr_diff = s4t.reference_pose_diff(res.transform, gt)
    assert rot_diff <= 0.2 and tr_diff <= 0.1


@pytest.fixture(scope="module")
def filtered_pair():
    """A 2300-point bumpy sphere with radial normals and colors
    abs(pos) * 200 (tools/parity_configs.py:105-121), and a rigidly
    moved copy carrying the rotated normals and the same colors."""
    pos = _bumpy(np.random.default_rng(5), 2300)
    normal = pos / np.linalg.norm(pos, axis=1, keepdims=True)
    rgb = (np.abs(pos) * 200).astype(np.float32)
    ang = 0.8
    R = np.array([[np.cos(ang), -np.sin(ang), 0],
                  [np.sin(ang), np.cos(ang), 0], [0, 0, 1]], np.float32)
    t = np.float32([.1, -.05, .2])
    q = (pos @ R.T + t).astype(np.float32)
    qn = (normal @ R.T).astype(np.float32)
    gt = np.eye(4)
    gt[:3, :3] = R.T
    gt[:3, 3] = -R.T @ t
    return (pos, normal, rgb), (q, qn, rgb), gt


_FILTERED = dict(delta=0.03, sample_size=2300, max_time_seconds=50,
                 bases_per_step=4, verify_top_k=256, max_candidates=2048,
                 max_normal_difference=20.0, max_color_distance=60.0)


def test_filtered_rowcap_registration(filtered_pair, monkeypatch):
    """The filtered registration (BASELINE Config 3's normal and color
    filters) through the rowcap engine at nq = 2300 on the CPU: the
    capture receives the filters and Options.rowcap_tile_reject, and the
    port clears LCP > 0.95, rotDiff <= 0.2 and trDiff <= 0.1."""
    (p, pn, pc), (q, qn, qc), gt = filtered_pair
    seen = []
    capture = tmatcher.rowcap_kernel.extract_pairs_rowcap_both

    def recorder(*a, **kw):
        seen.append(kw)
        return capture(*a, **kw)

    monkeypatch.setattr(tmatcher.rowcap_kernel, "extract_pairs_rowcap_both",
                        recorder)
    opts = s4t.Options(pair_engine="rowcap", rowcap_tile_reject=False,
                       **_FILTERED).configure_overlap(0.9)
    assert tmatcher.resolve_pair_engine(opts, 2300) == "rowcap"
    res = s4t.MatchSuper4PCS(opts, device="cpu").compute_transformation(
        s4t.PointCloud(p, normal=pn, rgb=pc),
        s4t.PointCloud(q, normal=qn, rgb=qc))
    assert seen and all(kw["tile_reject"] is False
                        and kw["max_normal_difference"] == 20.0
                        and kw["max_color_distance"] == 60.0
                        and kw["normal"] is not None for kw in seen)
    assert res.score > 0.95
    rot_diff, tr_diff = s4t.reference_pose_diff(res.transform, gt)
    assert rot_diff <= 0.2 and tr_diff <= 0.1
    # the filters cut the pairs the capture finds
    assert 0 < res.stats["n_pairs"]


def test_filtered_registration_jax_package_same_gates(filtered_pair):
    """The JAX package on the same filtered fixture clears the same
    gates. Its rowcap step (the XLA approx_max_k capture on the CPU)
    takes minutes to compile, so it runs its dense engine here, which
    applies the same filters; parity of the two packages is statistical
    (their random draws differ), so both must pass."""
    (p, pn, pc), (q, qn, qc), gt = filtered_pair
    opts = s4j.Options(pair_engine="dense", search_escalation_stages=0,
                       **_FILTERED).configure_overlap(0.9)
    res = s4j.MatchSuper4PCS(opts).compute_transformation(
        s4j.PointCloud(p, normal=pn, rgb=pc),
        s4j.PointCloud(q, normal=qn, rgb=qc))
    assert res.score > 0.95
    rot_diff, tr_diff = s4t.reference_pose_diff(res.transform, gt)
    assert rot_diff <= 0.2 and tr_diff <= 0.1


def test_resume_from_jax_state(recipe):
    """The JAX matcher's exported state, with its trial budget spent,
    resumes in the port unchanged: same transform, same global
    transform (the port's own sampling and centering of the clouds
    reproduce the JAX package's)."""
    target, source = recipe
    jm = s4j.MatchSuper4PCS(
        s4j.Options().configure_overlap(0.9).replace(**_RECIPE))
    rj = jm.compute_transformation(s4j.PointCloud(target),
                                   s4j.PointCloud(source))
    state = jm.export_state()
    assert state["trial"] >= jm.number_of_trials
    assert state["best_lcp"] == 1.0

    tm = s4t.MatchSuper4PCS(
        s4t.Options().configure_overlap(0.9).replace(**_RECIPE),
        device="cpu")
    rt = tm.compute_transformation(s4t.PointCloud(target),
                                   s4t.PointCloud(source),
                                   resume_state=state)
    assert rt.n_trials == state["trial"]
    assert rt.score == rj.score
    np.testing.assert_allclose(rt.transform, rj.transform, atol=1e-6)
    np.testing.assert_allclose(tm._global_transform(),
                               jm._global_transform(), atol=1e-6)
    np.testing.assert_allclose(tm._transform, np.asarray(jm._transform),
                               atol=0)
    # the port's own export round-trips through the converter
    again = tmatcher.state_from_jax(tm.export_state())
    np.testing.assert_array_equal(again["transform"], tm._transform)
    with pytest.raises(ValueError):
        tmatcher.state_from_jax({"trial": 1})


def test_not_ported_paths_raise():
    pts = s4t.PointCloud(_bumpy(np.random.default_rng(0), 100))
    # the banded engine is ported (tests/test_torch_band_extract.py): a
    # self-match starts at LCP 1 and returns at once, with its index
    banded = s4t.MatchSuper4PCS(s4t.Options(delta=0.05, pair_engine="banded"),
                                device="cpu").compute_transformation(pts, pts)
    assert banded.score == 1.0 and banded.stats["band_cells"] > 0
    # bases-axis sharding is ported (tests/test_torch_sharded.py): a mesh
    # whose size divides bases_per_step runs, another is a ValueError
    from super4pcs_tpu_torch.parallel import make_mesh
    sharded = s4t.MatchSuper4PCS(
        s4t.Options(delta=0.05, bases_per_step=4),
        mesh=make_mesh(["cpu"] * 2)).compute_transformation(pts, pts)
    assert sharded.score == 1.0
    with pytest.raises(ValueError, match="divisible"):
        s4t.MatchSuper4PCS(s4t.Options(bases_per_step=3),
                           mesh=make_mesh(["cpu"] * 2))
    with pytest.raises(NotImplementedError):
        tmatcher.resolve_pair_engine(
            s4t.Options(estimate_scale=True, pair_engine="rowcap"), 4096)
    # similarity mode is ported (tests/test_torch_scale.py): a self-match
    # starts at LCP 1 and returns at once
    same = s4t.MatchSuper4PCS(s4t.Options(delta=0.05, estimate_scale=True),
                              device="cpu").compute_transformation(pts, pts)
    assert same.score == 1.0 and same.n_trials == 0
    # HEALPix bins are ported: the step builds on both engines
    for nq in (500, 4096):
        step, caps = tmatcher.build_step(
            s4t.Options(direction_bins="healpix"), nq, 0.3)
        assert callable(step) and len(caps) == 3
    assert tmatcher.resolve_pair_engine(s4t.Options(), 70000) == "banded"
    empty = s4t.MatchSuper4PCS(s4t.Options(), device="cpu") \
        .compute_transformation(s4t.PointCloud(np.zeros((0, 3))), pts)
    assert empty.score == 1e9 and empty.n_trials == 0


def test_capacity_resolution_matches_jax():
    """The port sizes its buffers (pairs, quads, candidates) and its
    step width as the JAX package does, for both engines."""
    from super4pcs_tpu import matcher as jmatcher
    for nq, kw in ((500, {}), (2048, {}), (8192, {}), (40000, {}),
                   (3000, dict(search_delta_factor=2.0)),
                   (1000, dict(max_quads=1000, max_candidates=999))):
        jo = s4j.Options(**kw)
        to = s4t.Options(**kw)
        assert (tmatcher.resolve_bases_per_step(to, nq)
                == jmatcher.resolve_bases_per_step(jo, nq))
        _, caps = tmatcher.build_step(to, nq, 0.3)
        jstep, jcaps = jmatcher.build_step(jo, nq, 0.3)
        assert caps == jcaps
