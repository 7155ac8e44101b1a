"""``register_sequence`` of the PyTorch port against the JAX package's:
the merged-set helpers, scans given as files, the error paths, and the
protocol itself (which merged cloud each step registers against, how
the previous scan is placed, the reference's pose diffs) with a stub in
place of both packages' matchers. The JAX package's real sequence runs
take minutes on the CPU (tests/test_sequence.py), so only the port runs
a real one here: a small 3-scan sequence held to the reference's gates
(rotDiff <= 0.2, trDiff <= 0.1, ref:tests/matching.cc:333-335)."""

import types

import numpy as np
import pytest

from super4pcs_tpu import sequence as jseq
from super4pcs_tpu.cloud import PointCloud as JCloud
from super4pcs_tpu_torch import Options, register_sequence
from super4pcs_tpu_torch import io as tio
from super4pcs_tpu_torch import sequence as tseq
from super4pcs_tpu_torch.cloud import PointCloud as TCloud


def _quat(axis, angle):
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    return (np.cos(angle / 2), *(axis * np.sin(angle / 2)))


def _gts(n):
    """Conf-semantics ground truths T(p) = R (p - t) of bench.py's
    synthetic sequence."""
    quats = [_quat([0, 0, 1], 0.0), _quat([0, 1, 0], 0.9),
             _quat([1, 0, 1], -0.7), _quat([1, 1, 0], 1.3)]
    trs = [[0, 0, 0], [0.10, -0.05, 0.08], [-0.07, 0.12, 0.02],
           [0.04, 0.06, -0.11]]
    out = []
    for q, t in list(zip(quats, trs))[:n]:
        m = np.eye(4)
        m[:3, :3] = tseq._quat_to_rot(*q)
        m[:3, 3] = -m[:3, :3] @ np.asarray(t, np.float64)
        out.append(m.astype(np.float32))
    return out


def _bumpy(rng, n):
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    bump = (1 + 0.3 * np.sin(5 * v[:, 0]) * np.cos(3 * v[:, 1])
            + 0.2 * np.sin(4 * v[:, 2]))
    return (v * bump[:, None]).astype(np.float32)


def _scans(model, starts, width, gts):
    """Overlapping x-slabs of the model, each moved into its own frame
    by its ground truth (so inv(gt) places it back)."""
    x = model[:, 0]
    lo, hi = x.min(), x.max()
    out = []
    for s, m in zip(starts, gts):
        a = lo + s * (hi - lo)
        v = model[(x >= a) & (x <= a + width * (hi - lo))]
        out.append((v @ m[:3, :3].T + m[:3, 3]).astype(np.float32))
    return out


def _cloud_pair(rng, n, normals, colors):
    pos = rng.normal(size=(n, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32) if normals else None
    rgb = rng.uniform(0, 255, (n, 3)).astype(np.float32) if colors else None
    return (JCloud(pos=pos, normal=nrm, rgb=rgb),
            TCloud(pos=pos, normal=nrm, rgb=rgb))


def _same(a, b):
    np.testing.assert_array_equal(a.pos, b.pos)
    for k in ("normal", "rgb"):
        x, y = getattr(a, k), getattr(b, k)
        assert (x is None) == (y is None), k
        if x is not None:
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("first,second", [
    (None, (True, True)), ((False, False), (False, False)),
    ((True, False), (True, True)), ((True, True), (False, True)),
    ((True, True), (True, True))])
def test_merge_matches_jax(rng, first, second):
    ja, ta = (_cloud_pair(rng, 7, *first) if first is not None
              else (None, None))
    jb, tb = _cloud_pair(rng, 5, *second)
    _same(jseq._merge(ja, jb), tseq._merge(ta, tb))


@pytest.mark.parametrize("ext", [".ply", ".obj", ".ptx"])
def test_as_cloud_of_a_file_matches_jax(tmp_path, rng, monkeypatch, ext):
    from super4pcs_tpu.io import native
    monkeypatch.setenv("SUPER4PCS_TPU_NO_NATIVE", "1")
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", False)
    _, cloud = _cloud_pair(rng, 6, True, False)
    path = tmp_path / f"scan{ext}"
    if ext == ".ply":
        tio.write_ply(str(path), cloud)
    elif ext == ".obj":
        tio.write_obj(str(path), cloud)
    else:
        path.write_text("\n".join(
            ["3", "2"] + ["0 0 0"] * 8
            + [f"{p[0]} {p[1]} {p[2]} 0.5" for p in cloud.pos]) + "\n")
    for scan in (str(path), path):
        _same(jseq._as_cloud(scan), tseq._as_cloud(scan))
    assert tseq._as_cloud(cloud) is cloud
    with pytest.raises(ValueError):
        tseq._as_cloud(str(tmp_path / "scan.stl"))


@pytest.mark.parametrize("case", ["algorithm", "gt_length"])
def test_error_paths_match_jax(rng, case):
    pts = rng.normal(size=(20, 3)).astype(np.float32)
    kw = (dict(algorithm="icp") if case == "algorithm"
          else dict(gt_transforms=[np.eye(4, dtype=np.float32)]))
    for mod, cls in ((jseq, JCloud), (tseq, TCloud)):
        with pytest.raises(ValueError):
            mod.register_sequence([cls(pos=pts), cls(pos=pts)], **kw)


def _stub(calls, transforms):
    """A matcher that records the device it is built for and the (P, Q)
    it is given, and returns the next of ``transforms``."""
    class Stub:
        def __init__(self, options, logger=None, mesh=None, device=None):
            assert mesh is None
            self.device = device

        def compute_transformation(self, P, Q):
            calls.append((self.device, P.pos, Q.pos))
            return types.SimpleNamespace(transform=transforms.pop(0))
    return Stub


@pytest.mark.parametrize("algorithm", ["super4pcs", "4pcs"])
@pytest.mark.parametrize("with_gt", [True, False])
def test_protocol_matches_jax(rng, monkeypatch, algorithm, with_gt):
    """Same merged clouds, same placements and same pose diffs as the
    JAX package, step by step, for GT-inverse and estimated placement.
    The stub returns noisy poses, so the estimated mode's chaining is
    exercised with transforms that are not the ground truth."""
    gts = _gts(4)
    scans = _scans(_bumpy(rng, 600), [0.0, 0.15, 0.3, 0.35], 0.65, gts)
    est = [g.copy() for g in gts[1:]]
    for m in est:
        m[:3, 3] += rng.normal(scale=0.01, size=3).astype(np.float32)
    name = "MatchSuper4PCS" if algorithm == "super4pcs" else "Match4PCS"
    seen, out = {}, {}
    for label, mod, cloud in (("jax", jseq, JCloud), ("port", tseq, TCloud)):
        calls = seen[label] = []
        monkeypatch.setattr(mod, name, _stub(calls, list(est)))
        kw = dict(device="cpu") if label == "port" else {}
        out[label] = mod.register_sequence(
            [cloud(pos=s) for s in scans], Options() if label == "port"
            else None, gt_transforms=gts if with_gt else None,
            algorithm=algorithm, **kw)
    assert len(seen["jax"]) == len(seen["port"]) == 3
    for (_, jp, jq), (dev, tp, tq) in zip(seen["jax"], seen["port"]):
        assert dev == "cpu"
        np.testing.assert_array_equal(jp, tp)
        np.testing.assert_array_equal(jq, tq)
    for a, b in zip(out["jax"], out["port"]):
        assert (a.index, a.rot_diff, a.tr_diff) == (b.index, b.rot_diff,
                                                    b.tr_diff)
        np.testing.assert_array_equal(a.transform, b.transform)
        assert (b.rot_diff is None) == (not with_gt)


def test_mesh_is_not_ported(rng):
    # the mesh is ported (tests/test_torch_sharded.py): each step's
    # matcher runs on it, and a mesh that does not divide the bases is a
    # ValueError
    from super4pcs_tpu_torch.parallel import make_mesh
    pts = TCloud(pos=rng.normal(size=(20, 3)).astype(np.float32))
    steps = register_sequence([pts, pts], mesh=make_mesh(["cpu"] * 2),
                              device="cpu")
    assert len(steps) == 1 and steps[0].result.score == 1.0
    with pytest.raises(ValueError, match="divisible"):
        register_sequence([pts, pts], Options(bases_per_step=3),
                          mesh=make_mesh(["cpu"] * 2), device="cpu")


def test_register_sequence_on_cpu_meets_reference_gates(tmp_path):
    """Three views of a 1500-point bumpy sphere (views 65% wide, starts
    0 / 0.1 / 0.2), read from PLY files, GT placement, on the CPU: every
    step within rotDiff <= 0.2 and trDiff <= 0.1, with the LCP above the
    terminate threshold."""
    gts = _gts(3)
    scans = _scans(_bumpy(np.random.default_rng(7), 1500), [0.0, 0.1, 0.2],
                   0.65, gts)
    files = []
    for k, s in enumerate(scans):
        files.append(str(tmp_path / f"scan{k}.ply"))
        tio.write_ply(files[-1], TCloud(pos=s))
    # the trial estimate, not the wall clock, bounds each step (a clock
    # budget would make the outcome depend on the machine's load)
    opts = Options(delta=0.04, sample_size=150, max_time_seconds=600,
                   bases_per_step=8, max_quads=1024, max_candidates=2048,
                   random_seed=5).configure_overlap(0.5, 0.6)
    steps = register_sequence(files, opts, gt_transforms=gts, device="cpu")
    assert [st.index for st in steps] == [1, 2]
    for st in steps:
        assert st.result.improved and st.result.score > 0.6
        assert st.rot_diff <= 0.2 and st.tr_diff <= 0.1, st.index
