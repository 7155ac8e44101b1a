"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked ``cuda`` and skips without a CUDA
device. On a machine with one (no jax needed, hence no conftest):

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

import super4pcs_tpu_torch as s4t
from super4pcs_tpu_torch.kernels import lcp as k1
from super4pcs_tpu_torch.kernels import rowcap as k2
from super4pcs_tpu_torch.kernels import rowcap_layout as k2x
from super4pcs_tpu_torch.ops import masking, refine, sampling

from _tile_cases import NAMES as TILE_CASES
from _tile_cases import case as tile_case
from _tile_cases import kd_sphere, near_identity, same_bits
from _within_cases import case as within_case

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _transforms(rng, c):
    out = np.tile(np.eye(4, dtype=np.float32), (c, 1, 1))
    for i in range(c):
        q, r = np.linalg.qr(rng.normal(size=(3, 3)))
        out[i, :3, :3] = q * np.sign(np.diag(r))
        out[i, :3, 3] = rng.uniform(-0.2, 0.2, 3)
    return out


@pytest.mark.parametrize("c,nq,np_", [(1, 1, 1), (3, 100, 1025),
                                      (64, 700, 3000), (513, 64, 2048),
                                      (2, 300, 0)])
def test_lcp_kernel_bit_identical_to_plain(dev, c, nq, np_):
    rng = np.random.default_rng(c + nq + np_)
    tr = torch.as_tensor(_transforms(rng, c), device=dev)
    q = torch.as_tensor(rng.uniform(-1, 1, (nq, 3)), dtype=torch.float32,
                        device=dev)
    p = torch.as_tensor(rng.uniform(-1, 1, (np_, 3)), dtype=torch.float32,
                        device=dev)
    before = k1.lcp_min_d2.launches
    got = k1.lcp_min_d2(tr, q, p)
    ref = k1.lcp_min_d2_plain(tr, q, p)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert k1.lcp_min_d2.launches == before + (np_ > 0)


@pytest.mark.parametrize("name", TILE_CASES)
def test_lcp_tiles_kernel_boundary_cases(dev, name):
    """The CPU tests' boundary cases of the tiled brute force on the card
    (tests/_tile_cases.py): a kd-ordered sphere under near-true poses,
    random transforms, points on box faces and duplicated, queries
    equidistant from two tiles, Np = 1, 31, 32, 33, 1025, Q_PAD rows,
    NaN and +-inf transforms, no candidates, no queries, empty P. Then
    min_sq_dists on the same rows with NaN and +-inf rows among them."""
    tr, q, p = (torch.as_tensor(a, device=dev) for a in tile_case(name))
    before = k1.lcp_min_d2.launches
    got = k1.lcp_min_d2(tr, q, p)
    ref = k1.lcp_min_d2_plain(tr, q, p)
    torch.cuda.synchronize()
    assert same_bits(got, ref)
    launched = tr.shape[0] * q.shape[0] > 0 and p.shape[0] > 0
    assert k1.lcp_min_d2.launches == before + launched
    rows = q.clone()
    if rows.shape[0] > 3:
        rows[0, 1], rows[2, 2] = float("inf"), float("-inf")
        rows[1] = float("nan")
    got = k1.min_sq_dists(rows, p)
    torch.cuda.synchronize()
    assert same_bits(got, k1.min_sq_dists_plain(rows, p))


def test_lcp_tiles_kernel_splits_the_groups_of_a_small_batch(dev):
    """C * nq <= 64 against Np = 200,000: the launcher splits the group
    list over blockIdx.y, one part a group, and folds the parts' mins
    with atomicMin; the result is the plain version's bit for bit."""
    rng = np.random.default_rng(12)
    p = torch.as_tensor(kd_sphere(rng, 200_000), device=dev)
    q = torch.as_tensor(kd_sphere(rng, 32), device=dev)
    tr = torch.as_tensor(near_identity(rng, 2), device=dev)
    idx = k1.tile_index(p)
    assert k1.lcp_min_d2_counts(tr, q, p, idx)[3] > 1
    got = k1.lcp_min_d2(tr, q, p, idx)
    got_m = k1.min_sq_dists(q, p, idx)
    torch.cuda.synchronize()
    assert torch.equal(got, k1.lcp_min_d2_plain(tr, q, p))
    assert torch.equal(got_m, k1.min_sq_dists_plain(q, p))


@pytest.mark.parametrize("c,nq", [(16, 4096), (256, 256)])
def test_lcp_tiles_kernel_counts_equal_the_walk(dev, c, nq):
    """With one part (C * nq fills the card) the kernel makes the plain
    walk's decisions, its slots over the queries (nq = 4096) or over the
    candidates (nq = 256): its counting build returns the same min and
    the same pair tests and box tests as kernels/lcp.py::tiled_walk, and
    its launch counts."""
    rng = np.random.default_rng(13)
    p = torch.as_tensor(kd_sphere(rng, 20000), device=dev)
    q = torch.as_tensor(kd_sphere(rng, nq), device=dev)
    tr = torch.as_tensor(near_identity(rng, c), device=dev)
    idx = k1.tile_index(p)
    before = k1.lcp_min_d2.launches
    out, pairs, boxes, parts = k1.lcp_min_d2_counts(tr, q, p, idx)
    walk, w_pairs, w_boxes = k1.tiled_walk(tr, q, idx)
    assert parts == 1
    assert k1.lcp_min_d2.launches == before + 1
    assert same_bits(out.view(-1), walk)
    assert same_bits(out, k1.lcp_min_d2_plain(tr, q, p))
    assert (pairs, boxes) == (w_pairs, w_boxes)
    assert pairs < 0.2 * c * nq * 20000


def _within_contract(tr, q, p, eps):
    """``where(lcp_min_d2_plain <= eps2, ., inf)``, the contract of
    lcp_min_d2_within."""
    ref = k1.lcp_min_d2_plain(tr, q, p)
    eps2 = float(np.float32(eps) * np.float32(eps))
    return torch.where(ref <= eps2, ref, float("inf"))


@pytest.mark.parametrize("eps", [0.05, 0.3])
@pytest.mark.parametrize("c,nq,np_", [(1, 1, 1), (3, 100, 1025),
                                      (64, 700, 3000), (513, 64, 2048),
                                      (2, 300, 0)])
def test_lcp_within_kernel_bit_identical_to_plain(dev, c, nq, np_, eps):
    """The grid-pruned verify against its contract and its plain walk,
    with a Q_PAD row and a NaN transform among the inputs."""
    rng = np.random.default_rng(c + nq + np_)
    tr = torch.as_tensor(_transforms(rng, c), device=dev)
    q = torch.as_tensor(rng.uniform(-1, 1, (nq, 3)), dtype=torch.float32,
                        device=dev)
    p = torch.as_tensor(rng.uniform(-1, 1, (np_, 3)), dtype=torch.float32,
                        device=dev)
    if nq > 1:
        q[-1] = 1.0e17
    if c > 1:
        tr[1, 0, 0] = float("nan")
    before = k1.lcp_min_d2_within.launches
    got = k1.lcp_min_d2_within(tr, q, p, eps)
    torch.cuda.synchronize()
    assert torch.equal(got, _within_contract(tr, q, p, eps))
    assert torch.equal(got, k1.lcp_min_d2_within_plain(tr, q, p, eps))
    assert k1.lcp_min_d2_within.launches == before + (np_ > 0)


@pytest.mark.parametrize("name", ["at_eps", "at_eps_inexact", "q_pad",
                                  "nan_transform", "eps_above_extent"])
def test_lcp_within_kernel_boundary_cases(dev, name):
    """The CPU tests' boundary cases on the card: lattice points at
    exactly eps on cell boundaries, Q_PAD rows, NaN and inf transforms,
    eps above P's extent. The kernel's box must take the cells that
    torch's division gave P's points in the index."""
    tr, q, p, eps = (torch.as_tensor(a, device=dev)
                     if isinstance(a, np.ndarray) else a
                     for a in within_case(name))
    before = k1.lcp_min_d2_within.launches
    got = k1.lcp_min_d2_within(tr, q, p, eps)
    torch.cuda.synchronize()
    assert torch.equal(got, _within_contract(tr, q, p, eps))
    assert k1.lcp_min_d2_within.launches == before + 1
    if name == "at_eps":
        assert bool(torch.isfinite(got).all())  # d^2 == eps^2 counts


def test_lcp_within_kernel_on_kd_ordered_sphere(dev):
    """The matcher's layout: kd-ordered Q near a voxel-like P, eps at
    the sampling step, small rigid motions."""
    rng = np.random.default_rng(5)
    p, _, _ = _kd_sphere(rng, 20000, dev)
    q, _, _ = _kd_sphere(rng, 4096, dev)
    tr = torch.as_tensor(_transforms(rng, 16), device=dev)
    tr[:, :3, :3] = torch.eye(3, device=dev)
    tr[:, :3, 3] *= 0.05
    got = k1.lcp_min_d2_within(tr, q, p, 0.02)
    torch.cuda.synchronize()
    assert torch.equal(got, _within_contract(tr, q, p, 0.02))
    assert int(torch.isfinite(got).sum()) > 0


@pytest.mark.parametrize("n,cap,emit", [(700, 24, True), (2500, 40, True),
                                        (2500, 40, False), (5000, 8, True)])
def test_rowcap_kernel_bit_identical_to_plain(dev, n, cap, emit):
    rng = np.random.default_rng(n + cap)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    q = torch.as_tensor(v * (1 + 0.2 * np.sin(4 * v[:, :1])),
                        dtype=torch.float32, device=dev)
    row_cap = k2.slots_for(n, cap)
    geo = torch.tensor([0.3, 0.42, 0.37, 0.08], device=dev)
    before = k2.rowcap_capture.launches
    got = k2.rowcap_capture(q, geo[0], geo[1], row_cap, inv=geo[2],
                            cell=geo[3], emit_hash=emit)
    ref = k2.rowcap_capture_plain(q, geo[0], geo[1], row_cap, geo[2],
                                  geo[3], emit)
    torch.cuda.synchronize()
    assert len(got) == len(ref) == (3 if emit else 2)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert int(got[1].sum()) > 0
    assert k2.rowcap_capture.launches == before + 1


def _kd_sphere(rng, n, dev):
    """Bumpy sphere in kd order (the matcher's Q order), radial normals
    and colors abs(pos) * 200, on the card."""
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    pos = (v * (1 + 0.2 * np.sin(4 * v[:, :1]))).astype(np.float32)
    pos = pos[sampling.kd_argsort(pos)]
    nrm = pos / np.linalg.norm(pos, axis=1, keepdims=True)
    rgb = np.abs(pos) * 200
    return (torch.as_tensor(x, dtype=torch.float32, device=dev)
            for x in (pos, nrm, rgb))


@pytest.mark.parametrize("filters", [
    dict(max_normal_difference=20.0),
    dict(max_color_distance=60.0, max_translation_distance=1.3),
    dict(max_angle=80.0),
    dict(max_normal_difference=20.0, max_color_distance=60.0,
         max_translation_distance=1.3, max_angle=80.0)])
@pytest.mark.parametrize("n", [2500, 9000])
def test_filtered_rejected_capture_bit_identical_to_plain(dev, n, filters):
    """Both edges with filters, rejection on and off, against the plain
    version fed the same planes: every table bit-identical, and the
    filtered launches counted."""
    rng = np.random.default_rng(n)
    q, nrm, rgb = _kd_sphere(rng, n, dev)
    ids = torch.as_tensor(rng.choice(n, 4, replace=False), device=dev)
    row_cap = k2.slots_for(n, 40)
    args = (q, q[ids], 0.02, row_cap)
    kw = dict(invariant1=torch.tensor(0.4, device=dev), cell_size=0.04,
              normal=nrm, rgb=rgb, base_norm=nrm[ids], base_rgb=rgb[ids],
              **filters)
    before = (k2.rowcap_capture.launches,
              k2.rowcap_capture.filtered_launches)
    on = k2.extract_pairs_rowcap_both(*args, tile_reject=True, **kw)
    off = k2.extract_pairs_rowcap_both(*args, tile_reject=False, **kw)
    torch.cuda.synchronize()
    assert k2.rowcap_capture.launches == before[0] + 4
    assert k2.rowcap_capture.filtered_launches == before[1] + 4
    plain = k2.extract_pairs_rowcap_both(
        *(a.cpu() if torch.is_tensor(a) else a for a in args),
        **{k: v.cpu() if torch.is_tensor(v) else v for k, v in kw.items()})
    for a, b, c in zip(on, off, plain):
        for xa, xb, xc in zip(*(t if isinstance(t, tuple) else (t,)
                                for t in (a, b, c))):
            assert torch.equal(xa, xb)
            assert torch.equal(xa.cpu(), xc)
    assert int(on[0][2]) > 0


def test_rejection_fires_on_kd_ordered_q(dev):
    """The bounds of a kd-ordered cloud reject most tile pairs of a thin
    band, and the kernel with rejection equals the plain version."""
    rng = np.random.default_rng(3)
    q, _, _ = _kd_sphere(rng, 8192, dev)
    rowb, colb = k2.reject_bounds(q)
    lo2, hi2 = torch.tensor(0.09, device=dev), torch.tensor(0.1, device=dev)
    assert float(k2.tile_reject_mask(rowb, colb, lo2, hi2).float().mean()) \
        > 0.3
    row_cap = k2.slots_for(8192, 160)
    got = k2.rowcap_capture(q, lo2, hi2, row_cap, bounds=(rowb, colb))
    ref = k2.rowcap_capture_plain(q, lo2, hi2, row_cap)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("m,np_", [(1, 1), (700, 3000), (4097, 2100)])
def test_min_sq_dists_bit_identical_to_plain(dev, m, np_):
    """K4a/K4b: K1 with the identity transform against the direct plain
    version."""
    rng = np.random.default_rng(m + np_)
    tq = torch.as_tensor(rng.uniform(-1, 1, (m, 3)), dtype=torch.float32,
                         device=dev)
    p = torch.as_tensor(rng.uniform(-1, 1, (np_, 3)), dtype=torch.float32,
                        device=dev)
    before = k1.lcp_min_d2.launches
    got = k1.min_sq_dists(tq, p)
    ref = k1.min_sq_dists_plain(tq, p)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert k1.lcp_min_d2.launches == before + 1


@pytest.mark.parametrize("n,cap,frac", [(0, 8, 0.5), (1000, 64, 0.01),
                                        (1000, 64, 0.5),
                                        (1 << 20, 4096, 0.003)])
def test_masked_indices_on_the_card_equal_cpu(dev, n, cap, frac):
    """The sync-free compaction every join runs, on the card, against
    the same function on the CPU (which tests/test_torch_ops.py holds
    against the JAX package): a flat mask, and a mask compacted row by
    row in one flat prefix sum (few long rows and many short ones)."""
    rng = np.random.default_rng(n + cap)
    mask = torch.as_tensor(rng.uniform(size=n) < frac)
    mask2 = torch.as_tensor(rng.uniform(size=(n // 40 + 1, 40)) < frac)
    mask3 = torch.as_tensor(rng.uniform(size=(3, n)) < frac)
    for m in (mask, mask2, mask3):
        ref = masking.masked_indices(m, cap)
        got = masking.masked_indices(m.to(dev), cap)
        for r, g in zip(ref, got):
            assert g.device.type == "cuda"
            assert torch.equal(g.cpu(), r)


def test_register_recipe_on_the_card(dev):
    """The 500-point known-pose recipe through register on the card."""
    rng = np.random.default_rng(11)
    v = rng.normal(size=(500, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    bump = (1 + 0.3 * np.sin(5 * v[:, 0]) * np.cos(3 * v[:, 1])
            + 0.2 * np.sin(4 * v[:, 2]))
    target = (v * bump[:, None]).astype(np.float32)
    ang = 1.1
    R = np.array([[np.cos(ang), -np.sin(ang), 0],
                  [np.sin(ang), np.cos(ang), 0], [0, 0, 1]], np.float32)
    source = (target - np.array([.4, -.2, .7], np.float32)) @ R
    before = k1.lcp_min_d2_within.launches
    res = s4t.register(target, source, overlap=0.9, delta=0.05,
                       sample_size=500, max_time_seconds=30, device=dev)
    moved = source @ res.transform[:3, :3].T + res.transform[:3, 3]
    assert res.score > 0.95
    assert np.median(np.linalg.norm(moved - target, axis=1)) < 0.05
    assert k1.lcp_min_d2_within.launches > before


def test_cli_on_the_card(dev, tmp_path, capsys):
    """The ``super4pcs-torch`` CLI with its default device, on the
    recipe's clouds written as PLY: exit 0, the verify kernel launched,
    and the Polyworks matrix moves the source onto the target."""
    from super4pcs_tpu_torch import cli, io as sio
    rng = np.random.default_rng(11)
    v = rng.normal(size=(500, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    bump = (1 + 0.3 * np.sin(5 * v[:, 0]) * np.cos(3 * v[:, 1])
            + 0.2 * np.sin(4 * v[:, 2]))
    target = (v * bump[:, None]).astype(np.float32)
    ang = 1.1
    R = np.array([[np.cos(ang), -np.sin(ang), 0],
                  [np.sin(ang), np.cos(ang), 0], [0, 0, 1]], np.float32)
    source = (target - np.array([.4, -.2, .7], np.float32)) @ R
    p1, p2, mat = (str(tmp_path / n) for n in ("t.ply", "s.ply", "m.txt"))
    sio.write_ply(p1, s4t.PointCloud(target))
    sio.write_ply(p2, s4t.PointCloud(source))
    before = k1.lcp_min_d2_within.launches
    assert cli.main(["super4pcs-torch", "-i", p1, p2, "-o", "0.9", "-d",
                     "0.05", "-n", "500", "-t", "30", "-m", mat]) == 0
    assert "Score: " in capsys.readouterr().out
    assert k1.lcp_min_d2_within.launches > before
    rows = open(mat).read().splitlines()[2:]
    m = np.array([[float(x) for x in r.split()] for r in rows])
    moved = source @ m[:3, :3].T + m[:3, 3]
    assert np.median(np.linalg.norm(moved - target, axis=1)) < 0.05


def test_allpairs_scale_registration_on_the_card(dev):
    """Similarity mode through the allpairs engine on the card (the
    allpairs test fixture of tests/test_matcher.py:767-801 on a fixed
    pose): the engine resolves, the pruned verify launches, no capture
    kernel does, and the JAX test's gates hold."""
    rng = np.random.default_rng(42)
    v = rng.normal(size=(96, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    bump = (1 + 0.3 * np.sin(5 * v[:, 0]) * np.cos(3 * v[:, 1])
            + 0.2 * np.sin(4 * v[:, 2]))
    pos = (v * bump[:, None]).astype(np.float32)
    ang, s = 0.8, 1.4
    R = np.array([[np.cos(ang), -np.sin(ang), 0],
                  [np.sin(ang), np.cos(ang), 0], [0, 0, 1]], np.float32)
    q = ((pos @ R.T + np.float32([0.1, -0.05, 0.2])) / s).astype(np.float32)
    opts = s4t.Options(delta=0.04, sample_size=96, max_time_seconds=60,
                       bases_per_step=8, estimate_scale=True,
                       pair_engine="allpairs", max_quads=2048,
                       max_candidates=8192,
                       random_seed=21).configure_overlap(0.8, 0.9)
    assert s4t.matcher.resolve_pair_engine(opts, 96) == "allpairs"
    before = (k1.lcp_min_d2_within.launches, k2.rowcap_capture.launches)
    res = s4t.MatchSuper4PCS(opts, device=dev).compute_transformation(
        s4t.PointCloud(pos), s4t.PointCloud(q))
    assert k1.lcp_min_d2_within.launches > before[0]
    assert k2.rowcap_capture.launches == before[1]
    assert res.score > 0.8
    est = np.linalg.norm(res.transform[:3, :3], axis=0).mean()
    assert abs(est - s) < 0.05
    moved = q @ res.transform[:3, :3].T + res.transform[:3, 3]
    assert np.median(np.linalg.norm(moved - pos, axis=1)) < 0.04


@pytest.mark.parametrize("filters", [{}, dict(
    max_normal_difference=20.0, max_color_distance=60.0,
    max_translation_distance=1.3, max_angle=80.0)])
def test_batched_capture_bit_identical_to_plain(dev, filters):
    """K2 over the trial axis: T = 6 trials of G = 2 clouds in one
    launch per edge (rejection on, the join hash on edge 0), every
    trial's tables bit-identical to the plain version's; the launches
    count 2 and the captures 12."""
    rng = np.random.default_rng(17)
    n = 5000
    clouds = [_kd_sphere(rng, n, dev) for _ in range(2)]
    q, nrm, rgb = (torch.stack(x) for x in zip(*clouds))
    ids = torch.as_tensor(np.stack([rng.choice(n, 4, replace=False)
                                    for _ in range(6)]), device=dev)
    g_of = torch.arange(6, device=dev)[:, None] // 3
    args = (q, q[g_of, ids], 0.02, k2.slots_for(n, 40))
    kw = dict(invariant1=torch.linspace(0.2, 0.7, 6, device=dev),
              cell_size=0.04, normal=nrm, rgb=rgb,
              base_norm=nrm[g_of, ids], base_rgb=rgb[g_of, ids], **filters)
    before = (k2.rowcap_capture.launches, k2.rowcap_capture.captures)
    got = k2.extract_pairs_rowcap_both(*args, tile_reject=True, **kw)
    torch.cuda.synchronize()
    assert (k2.rowcap_capture.launches,
            k2.rowcap_capture.captures) == (before[0] + 2, before[1] + 12)
    plain = k2.extract_pairs_rowcap_both(
        *(a.cpu() if torch.is_tensor(a) else a for a in args),
        **{k: v.cpu() if torch.is_tensor(v) else v for k, v in kw.items()})
    for a, c in zip(got, plain):
        for xa, xc in zip(*(t if isinstance(t, tuple) else (t,)
                            for t in (a, c))):
            assert torch.equal(xa.cpu(), xc)
    assert (got[0][2] > 0).all()


def test_batched_verify_bit_identical_to_plain(dev):
    """K1 over the pairs axis with indexes built once: one launch for
    two pairs (one of them sentinel-padded), equal to the plain walk
    per pair."""
    from super4pcs_tpu_torch.ops import lcp as ops_lcp
    rng = np.random.default_rng(5)
    p = torch.stack([next(_kd_sphere(rng, 3000, dev)) for _ in range(2)])
    q = p[:, ::3].clone() + 0.002
    q[1, -50:] = 2.0e17
    tr = torch.stack([torch.as_tensor(_transforms(rng, 64), device=dev)
                      for _ in range(2)])
    tr[:, :, :3, :3] = torch.eye(3, device=dev)
    index = ops_lcp.VerifyIndex(p)
    before = k1.lcp_min_d2_within.launches
    got = k1.lcp_min_d2_within(tr, q, p, 0.03, index.get(1, 0.03))
    torch.cuda.synchronize()
    assert k1.lcp_min_d2_within.launches == before + 1
    for g in range(2):
        assert torch.equal(got[g], k1.lcp_min_d2_within_plain(
            tr[g], q[g], p[g], 0.03))
    assert int(torch.isfinite(got).sum()) > 0


def test_step_over_two_pairs_on_the_card(dev):
    """A G = 2 rowcap step on the card equals two G = 1 steps given the
    same draws, output for output."""
    from super4pcs_tpu_torch import matcher
    from super4pcs_tpu_torch.ops import lcp as ops_lcp, select
    rng = np.random.default_rng(9)
    n = 3000
    opts = s4t.Options(delta=0.02, bases_per_step=4, pair_engine="rowcap",
                       verify_top_k=256, max_candidates=2048)
    step, _ = matcher.build_step(opts, n, 0.3)
    pos = torch.stack([next(_kd_sphere(rng, n, dev)) for _ in range(2)])
    z = torch.zeros_like(pos)
    arrs = (pos, z, z - 1, pos.flip(1).contiguous(), z, z - 1)
    bounds = k2.reject_bounds(arrs[3])
    diam = torch.tensor([2.0, 2.0], device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    both = step(gen, diam, *arrs, bounds, ops_lcp.VerifyIndex(pos))
    for g in range(2):
        gen.manual_seed(4)
        if g == 1:
            select.draw_base_indices(gen, n, 4, opts.n_triangle_trials)
        one = step(gen, diam[g:g + 1], *(a[g:g + 1] for a in arrs),
                   tuple(b[g:g + 1] for b in bounds),
                   ops_lcp.VerifyIndex(pos[g:g + 1]))
        for k, v in one.items():
            assert torch.equal(both[k][g], v[0]), k


def test_banded_extraction_on_the_card_equals_cpu(dev):
    """The banded engine's index built on the card equals the CPU's, and
    a T = 4 extraction (window overflow, rotations, all filters) on the
    card equals the CPU's per trial: bit for bit with capacity
    compaction and no angle gate; with the angle gate, in the raw slot
    layout, outside 1e-6 rad of the gate (torch.acos on the two
    devices may differ in the last bit)."""
    from super4pcs_tpu_torch.ops import band_extract as tb
    from super4pcs_tpu_torch.ops.pairs import PairFilterConfig
    rng = np.random.default_rng(17)
    n = 4000
    pos = next(_kd_sphere(rng, n, "cpu"))
    normal = pos / torch.linalg.vector_norm(pos, dim=1, keepdim=True)
    rgb = torch.as_tensor(rng.uniform(0, 1, (n, 3)), dtype=torch.float32)
    ci = tb.build_band_index(pos.numpy(), 0.02)
    gi = tb.build_band_index(pos.numpy(), 0.02, device=dev)
    for k in ("members", "occ", "centers", "sorted_pair", "g"):
        assert torch.equal(getattr(gi, k).cpu(), getattr(ci, k)), k
    bases = torch.as_tensor(np.stack([rng.choice(n, 4, replace=False)
                                      for _ in range(4)]))
    offs = torch.tensor([0, 17, 977, 31415])
    filt = dict(max_normal_difference=30.0, max_color_distance=0.6,
                max_translation_distance=1.5)
    for cfg, capacity in ((PairFilterConfig(**filt), 20000),
                          (PairFilterConfig(max_angle=70.0, **filt), None)):
        outs = []
        for idx, d in ((ci, "cpu"), (gi, dev)):
            a = [t.to(d) for t in (pos, normal, rgb)]
            outs.append([o.cpu() for o in tb.extract_pairs_banded(
                idx, *a, a[0][bases], a[1][bases], a[2][bases], 0, 1, 0.04,
                cfg, 2048, rot_offset=offs.to(d), capacity=capacity,
                expand_cap=2048 * 24)])
        (cp, cv, cc, cd), (gp, gv, gc, gd) = outs
        assert torch.equal(gp, cp) and torch.equal(gd, cd)
        assert int(cd.min()) > 0 and int(cc.min()) > 0
        if capacity is not None:
            assert torch.equal(gv, cv) and torch.equal(gc, cc)
            continue
        p = pos.double()
        for t in range(4):
            seg = p[bases[t, 1]] - p[bases[t, 0]]
            d = p[cp[t, :, 1].long()] - p[cp[t, :, 0].long()]
            ang = torch.arccos(torch.clamp(
                (d @ seg) / seg.norm() / d.norm(dim=1).clamp(min=1e-30),
                -1.0, 1.0))
            edge = (ang - np.deg2rad(70.0)).abs() <= 1e-6
            assert not ((gv[t] != cv[t]) & ~edge).any()
            assert int(gc[t]) == int(gv[t].sum())


def test_banded_registration_on_the_card(dev):
    """Phase 5k's options resolve to the banded engine; the recipe with
    ``pair_engine="banded"`` on the card builds its index there, launches
    the verify kernel and meets the recipe's gates."""
    from super4pcs_tpu_torch import matcher
    o5k = s4t.Options(delta=0.01, sample_size=8192, pair_engine="banded")
    assert matcher.resolve_pair_engine(o5k, 8192) == "banded"
    rng = np.random.default_rng(11)
    v = rng.normal(size=(500, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    bump = (1 + 0.3 * np.sin(5 * v[:, 0]) * np.cos(3 * v[:, 1])
            + 0.2 * np.sin(4 * v[:, 2]))
    target = (v * bump[:, None]).astype(np.float32)
    ang = 1.1
    R = np.array([[np.cos(ang), -np.sin(ang), 0],
                  [np.sin(ang), np.cos(ang), 0], [0, 0, 1]], np.float32)
    source = (target - np.array([.4, -.2, .7], np.float32)) @ R
    opts = s4t.Options(delta=0.05, sample_size=500, max_time_seconds=30,
                       pair_engine="banded").configure_overlap(0.9)
    before = k1.lcp_min_d2_within.launches
    m = s4t.MatchSuper4PCS(opts, device=dev)
    res = m.compute_transformation(s4t.PointCloud(target),
                                   s4t.PointCloud(source))
    assert m._band_index.sorted_pair.device.type == "cuda"
    assert res.stats["band_cells"] > 0
    moved = source @ res.transform[:3, :3].T + res.transform[:3, 3]
    assert res.score > 0.95
    assert np.median(np.linalg.norm(moved - target, axis=1)) < 0.05
    assert k1.lcp_min_d2_within.launches > before


def test_mesh_of_one_card_twice_equals_the_unsharded_step(dev):
    """A rowcap matcher over ``make_mesh(["cuda:0"] * 2)`` gives the
    unsharded matcher's step outputs bit for bit (no candidate dropped,
    each scored exactly: at most verify_top_k of them), and the launch
    counters count both shards: twice the verify launches, and the
    capture launches of each shard over its half of the bases."""
    from super4pcs_tpu_torch.parallel import make_mesh
    rng = np.random.default_rng(3)
    n = 3000
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    bump = (1 + 0.3 * np.sin(5 * v[:, 0]) * np.cos(3 * v[:, 1])
            + 0.2 * np.sin(4 * v[:, 2]))
    p = (v * bump[:, None]).astype(np.float32)
    ang = 0.8
    R = np.array([[np.cos(ang), -np.sin(ang), 0],
                  [np.sin(ang), np.cos(ang), 0], [0, 0, 1]], np.float32)
    q = (p @ R.T + np.float32([0.1, -0.05, 0.2])).astype(np.float32)
    opts = s4t.Options(delta=0.02, sample_size=n, bases_per_step=4,
                       pair_engine="rowcap", max_candidates=8192,
                       verify_top_k=8192)
    single = s4t.MatchSuper4PCS(opts, device=dev)
    sharded = s4t.MatchSuper4PCS(opts, mesh=make_mesh(["cuda:0"] * 2))
    for m in (single, sharded):
        m._init(s4t.PointCloud(p), s4t.PointCloud(q))

    def launches():
        return (k2.rowcap_capture.launches, k2.rowcap_capture.captures,
                k1.lcp_min_d2_within.launches)

    for step in range(3):
        before = launches()
        a = single._run_step(step)
        mid = launches()
        b = sharded._run_step(step)
        after = launches()
        one = [y - x for x, y in zip(before, mid)]
        two = [y - x for x, y in zip(mid, after)]
        assert one == [2, 8, 1] and two == [4, 8, 2], (one, two)
        assert int(a["cands_dropped"]) == 0 == int(b["cands_dropped"])
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(b[k]), a[k],
                                          err_msg=k)


def _bumpy(rng, n):
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    bump = (1 + 0.3 * np.sin(5 * v[:, 0]) * np.cos(3 * v[:, 1])
            + 0.2 * np.sin(4 * v[:, 2]))
    return (v * bump[:, None]).astype(np.float32)


def _same_nan(a, b):
    return bool(((a == b) | (a.isnan() & b.isnan())).all())


@pytest.mark.parametrize("scale", [False, True])
def test_batched_dense_extraction_and_join_equal_per_trial(dev, scale):
    """The dense extraction (both forms) and the dense join over T = 8
    trials of G = 2 clouds on the card, each in one call (and a trial at
    a time): every trial equal to its one-base call on the card, bit for
    bit; HEALPix bins and the scale gate included."""
    from super4pcs_tpu_torch.ops import congruent, pairs
    rng = np.random.default_rng(8)
    n, nt = (60 if scale else 400), 8
    pos = torch.as_tensor(np.stack([_bumpy(rng, n) for _ in range(2)]),
                          device=dev)
    nrm = pos / torch.linalg.vector_norm(pos, dim=-1, keepdim=True)
    rgb = (pos.abs() * 200).contiguous()
    g_of = torch.arange(nt, device=dev) // (nt // 2)
    ids = torch.as_tensor(np.stack([rng.choice(n, 4, replace=False)
                                    for _ in range(nt)]), device=dev)
    bases = [c[g_of[:, None], ids] for c in (pos, nrm, rgb)]
    cfg = pairs.PairFilterConfig(
        max_normal_difference=-1.0 if scale else 40.0,
        max_color_distance=-1.0 if scale else 80.0,
        use_distance_filter=not scale)
    off = (torch.as_tensor(rng.integers(0, n, nt), device=dev) if scale
           else None)
    cap = n * (n - 1) if scale else n * 12
    fns = ((pairs.extract_pairs,) if scale else
           (pairs.extract_pairs, pairs.extract_pairs_dense_rowcap))
    tables = None
    for fn in fns:
        for e0, e1 in ((0, 1), (2, 3)):
            got = fn(pos, nrm, rgb, *bases, e0, e1, 0.05, cfg, capacity=cap,
                     row_offset=off)
            chunked = fn(pos, nrm, rgb, *bases, e0, e1, 0.05, cfg,
                         capacity=cap, row_offset=off, trial_chunk=1)
            for t in range(nt):
                g = int(g_of[t])
                one = fn(pos[g], nrm[g], rgb[g], *(b[t] for b in bases),
                         e0, e1, 0.05, cfg, capacity=cap,
                         row_offset=None if off is None else off[t])
                for a, b, c in zip(got, one, chunked):
                    assert torch.equal(a[t], b) and torch.equal(a[t], c[t])
            if fn is pairs.extract_pairs:
                tables = (tables or ()) + got[:2]
    s1 = bases[0][:, 1] - bases[0][:, 0]
    s2 = bases[0][:, 3] - bases[0][:, 2]
    n1 = torch.linalg.vector_norm(s1, dim=-1)
    n2 = torch.linalg.vector_norm(s2, dim=-1)
    cos_a = ((s1 / n1[:, None]) * (s2 / n2[:, None])).sum(-1)
    inv = torch.full((nt,), 0.4, device=dev)
    gate = dict(seg_ratio=n1 / n2, scale_band=0.1) if scale else {}
    for bins in ("cone", "healpix"):
        got = congruent.find_congruent_quads(
            pos, *tables, inv, 1.0 - inv, 0.05, cos_a, 0.3, 4096,
            direction_bins=bins, **gate)
        for t in range(nt):
            g = int(g_of[t])
            gate_t = ({k: (v[t] if torch.is_tensor(v) else v)
                       for k, v in gate.items()})
            one = congruent.find_congruent_quads(
                pos[g], *(x[t] for x in tables), inv[t], 1.0 - inv[t],
                0.05, cos_a[t], 0.3, 4096, direction_bins=bins, **gate_t)
            for a, b in zip(got, one):
                assert torch.equal(a[t], b)
        assert int(got[2].sum()) > 0


@pytest.mark.parametrize("kw", [{}, dict(estimate_scale=True),
                                dict(force_grid_join=True)])
def test_dense_step_trials_equal_one_base_steps_on_the_card(dev, kw):
    """A dense step's trial function over its B = 16 bases equals 16
    one-base calls on the card: transform, cvalid, quads and counts bit
    for bit."""
    from super4pcs_tpu_torch import matcher
    rng = np.random.default_rng(5)
    p = _bumpy(rng, 800)
    ang = 0.7
    R = np.array([[np.cos(ang), -np.sin(ang), 0],
                  [np.sin(ang), np.cos(ang), 0], [0, 0, 1]], np.float32)
    q = (p @ R.T + np.float32([0.1, -0.05, 0.2])).astype(np.float32)
    opts = s4t.Options(delta=0.03, sample_size=500, bases_per_step=16,
                       random_seed=2, **kw).configure_overlap(0.8)
    m = s4t.MatchSuper4PCS(opts, device=dev)
    m._init(s4t.PointCloud(p), s4t.PointCloud(q))
    nq = int(m._d_q_pos.shape[0])
    assert matcher.resolve_pair_engine(opts, nq) == "dense"
    tb, _ = matcher._build_try_bases(m._opts_eff(), nq, m._cone_mode)
    args = m._step_args()
    m._gen.manual_seed(4)
    draws = m._step_fn.draw(m._gen, 1, int(m._d_p_pos.shape[0]))

    def trials(lo, hi):
        rot = tuple(r[:, lo:hi].reshape(-1) for r in draws[3:]) or None
        return tb(tuple(d[:, lo:hi] for d in draws[:3]),
                  m._max_base_diameter, *args[:7], rot)

    full = trials(0, 16)
    for t in range(16):
        one = trials(t, t + 1)
        for k in ("transform", "cvalid", "quads", "counts"):
            assert _same_nan(full[k][t], one[k][0]), (t, k)
    assert bool(full["cvalid"].any())


def test_native_parser_loaded_and_equal_to_numpy(dev, tmp_path,
                                                 monkeypatch):
    """The port's native IO library builds (g++) and loads on the card's
    machine, and its reads of a PLY and an OBJ equal the numpy tier's."""
    from super4pcs_tpu_torch import io as sio
    from super4pcs_tpu_torch.io import native
    assert native.get_lib() is not None
    rng = np.random.default_rng(6)
    pos = _bumpy(rng, 500)
    c = s4t.PointCloud(pos, normal=pos / np.linalg.norm(pos, axis=1,
                                                        keepdims=True),
                       rgb=(np.abs(pos) * 200).astype(np.float32))
    tris = np.array([[0, 1, 2], [3, 4, 5]], np.int32)
    sio.write_ply(str(tmp_path / "c.ply"), c)
    sio.write_obj(str(tmp_path / "m.obj"), c,
                  sio.Mesh(tris=tris, tri_norm=tris))
    reads = []
    for tier in ("native", "numpy"):
        if tier == "numpy":
            monkeypatch.setenv("SUPER4PCS_TPU_NO_NATIVE", "1")
        else:
            assert native.native_parse_ply(str(tmp_path / "c.ply"))
            assert native.native_parse_obj(str(tmp_path / "m.obj"))
        reads.append([sio.read_object(str(tmp_path / f))
                      for f in ("c.ply", "m.obj")])
    for (a, am), (b, bm) in zip(*reads):
        for k in ("pos", "normal", "rgb"):
            x, y = getattr(a, k), getattr(b, k)
            assert (x is None) == (y is None)
            if x is not None:
                np.testing.assert_array_equal(x, y)
        if am is not None:
            np.testing.assert_array_equal(am.tris, bm.tris)


def _launch_counts():
    """The launch counters' values, K1's first."""
    from super4pcs_tpu_torch.utils.graphs import COUNTERS
    first = (k1.lcp_min_d2_within, "launches")
    return [getattr(o, a) for o, a in
            [first] + [c for c in COUNTERS if c != first]]


@pytest.mark.parametrize("engine", ["rowcap", "dense", "allpairs",
                                    "rowcap-xla", "rowcap-similarity"])
def test_graphed_step_equals_the_eager_step(dev, engine):
    """A matcher on the card captures its step (utils/graphs.py); each
    replay equals the same step launched op by op, every output bit for
    bit, and counts the same kernel launches."""
    rng = np.random.default_rng(5)
    n = {"rowcap": 3000, "dense": 400, "allpairs": 300, "rowcap-xla": 3000,
         "rowcap-similarity": 300}[engine]
    p = _bumpy(rng, n)
    q = (p + np.float32([0.1, -0.05, 0.2])).astype(np.float32)
    kw = {"rowcap": dict(pair_engine="rowcap", bases_per_step=4),
          "dense": dict(bases_per_step=8),
          "allpairs": dict(estimate_scale=True, pair_engine="allpairs",
                           bases_per_step=2),
          "rowcap-xla": dict(pair_engine="rowcap", rowcap_kernel="xla",
                             bases_per_step=4),
          "rowcap-similarity": dict(estimate_scale=True,
                                    pair_engine="rowcap", pair_row_cap=64,
                                    bases_per_step=2)}[engine]
    m = s4t.MatchSuper4PCS(s4t.Options(delta=0.02, sample_size=n, **kw),
                           device=dev)
    m._init(s4t.PointCloud(p), s4t.PointCloud(q))
    assert m._graph is not None
    for i in range(3):
        c0 = _launch_counts()
        g = m._run_step(i)
        c1 = _launch_counts()
        e = m._run_step(i, eager=True)
        c2 = _launch_counts()
        assert set(g) == set(e)
        for k in e:
            assert g[k].dtype == e[k].dtype and g[k].shape == e[k].shape
            assert g[k].tobytes() == e[k].tobytes(), k
        assert ([b - a for a, b in zip(c0, c1)]
                == [b - a for a, b in zip(c1, c2)])
    assert c1[0] > c0[0]                  # the verify launched in replays


def _small_search(refine, n=80):
    """tests/test_torch_dispatch.py's ``n``-point search: (options, P,
    Q)."""
    rng = np.random.default_rng(42)
    pos = _bumpy(rng, 150)[:n]
    ang = 0.9
    rot = np.array([[np.cos(ang), -np.sin(ang), 0],
                    [np.sin(ang), np.cos(ang), 0], [0, 0, 1]], np.float32)
    q = (pos @ rot.T + np.float32([0.2, -0.1, 0.3])
         + np.random.default_rng(1).normal(scale=0.03, size=pos.shape)
         ).astype(np.float32)
    opts = s4t.Options(delta=0.05, sample_size=n, max_time_seconds=600,
                       max_quads=512, max_candidates=1024, random_seed=7,
                       bases_per_step=2, search_escalation_stages=0,
                       refine_iterations=refine
                       ).configure_overlap(0.9, terminate_threshold=0.99)
    return opts, s4t.PointCloud(pos), s4t.PointCloud(q)


def _same_search(a, b):
    (ma, ra), (mb, rb) = a, b
    assert ra.n_trials == rb.n_trials and ra.score == rb.score
    np.testing.assert_array_equal(ra.transform, rb.transform)
    np.testing.assert_array_equal(ma._base_ids, mb._base_ids)
    np.testing.assert_array_equal(ma._congruent_ids, mb._congruent_ids)


@pytest.fixture
def fresh(dev):
    """The card's capture context with no kind of warm-up recorded: the
    next registration of each kind warms fully, as the first one of a
    process does (utils/graphs.py)."""
    from super4pcs_tpu_torch.utils import graphs
    ctx = graphs.context(dev)
    ctx.warmed.clear()
    return ctx


@pytest.mark.parametrize("warmed", [False, True])
def test_span_table_on_the_card(dev, fresh, warmed):
    """tests/test_torch_dispatch.py's 80-point search on the card: its
    span table has device seconds on the search's steps and on every
    refine, one capture span (the step's graph), no child's host seconds
    above its parent's, and the device allocations of the call. The
    first registration of its kind in the process warms fully (a warm-up
    step, ``warm_full``); once one has (``warmed``), the next captures
    without one (``warm_reused``)."""
    opts, P, Q = _small_search(8)
    if warmed:
        s4t.MatchSuper4PCS(opts, device=dev).compute_transformation(P, Q)
    m = s4t.MatchSuper4PCS(opts, device=dev)
    res = m.compute_transformation(P, Q)
    table = res.stats["spans"]
    spans = table["spans"]
    assert spans["search/step"]["device_s"] > 0
    assert spans["search/step"]["count"] >= res.n_trials // m._b_eff
    if warmed:
        assert "setup/warm/step" not in spans
        assert table["warm_reused"] == 1 and "warm_full" not in table
    else:
        assert spans["setup/warm/step"]["device_s"] > 0
        assert table["warm_full"] == 1 and "warm_reused" not in table
    refines = [row for path, row in spans.items()
               if path.rpartition("/")[2] == "refine"]
    assert len(refines) >= 2
    assert all(row["device_s"] > 0 for row in refines)
    assert spans["setup/warm/capture"]["count"] == 1
    assert table["device_allocs"] >= 0 and table["index_builds"] >= 1
    for path, row in spans.items():
        prefix = "" if path == "call" else path
        children = [r["host_s"] for p, r in spans.items()
                    if p != "call" and p.rpartition("/")[0] == prefix]
        assert sum(children) <= row["host_s"], path


def _register_on(dev, opts, P, Q):
    m = s4t.MatchSuper4PCS(opts, device=dev)
    return m, m.compute_transformation(P, Q)


def _warmed_alone(table, *stages):
    """A table whose warm-ups all reused the process's: a capture in
    each of ``stages``, and no throw-away step or refine."""
    spans = table["spans"]
    assert table.get("warm_reused", 0) >= 1 and "warm_full" not in table
    for stage in stages:
        assert spans[f"{stage}/capture"]["count"] >= 1, stage
        assert f"{stage}/step" not in spans, stage
        assert f"{stage}/refine" not in spans, stage


def test_a_kind_warms_once_per_process(dev, fresh):
    """Registrations A, then B of another shape, then A again, in one
    process: the first A warms fully; B and the second A capture
    without a warm-up step or refine, and the second A allocates nothing
    on the card and lands the first A's registration bit for bit."""
    opts, P, Q = _small_search(8)
    b_opts, bP, bQ = _small_search(8, n=60)
    a1 = _register_on(dev, opts, P, Q)
    b = _register_on(dev, b_opts, bP, bQ)
    a2 = _register_on(dev, opts, P, Q)
    _same_search(a1, a2)
    first = a1[1].stats["spans"]
    assert first["warm_full"] == 1 and "warm_reused" not in first
    assert "setup/warm/step" in first["spans"]
    assert "setup/warm/refine" in first["spans"]
    for _, res in (b, a2):
        _warmed_alone(res.stats["spans"], "setup/warm")
        assert res.stats["spans"]["warm_reused"] == 1
    assert a2[1].stats["spans"]["device_allocs"] == 0


def test_an_escalation_warms_once_per_process(dev, fresh):
    """A search that escalates, twice: the first registration's set-up
    warms fully and its escalation (a warm-up of the same kind) reuses
    it; the second registration's set-up and escalation both capture
    alone, allocate nothing on the card and land the first's
    registration bit for bit."""
    opts, P, Q = _small_search(8, n=60)
    opts = opts.replace(max_pairs=512, search_escalation_stages=1)
    a1 = _register_on(dev, opts, P, Q)
    a2 = _register_on(dev, opts, P, Q)
    for _, res in (a1, a2):
        assert res.stats["escalated_to"] == 2.0
    _same_search(a1, a2)
    first, second = (r.stats["spans"] for _, r in (a1, a2))
    assert first["warm_full"] == 1 and first["warm_reused"] == 1
    _warmed_alone(second, "setup/warm", "search/escalate")
    assert second["warm_reused"] == 2
    assert second["device_allocs"] == 0


def test_a_batch_warms_once_per_process(dev, fresh):
    """Two register_batch calls of the same two pairs (no straggler
    redemption): the second's set-up runs no warm-up step or refine,
    allocates nothing on the card, and lands the first's registrations
    bit for bit."""
    from super4pcs_tpu_torch.parallel import register_batch
    opts, P, Q = _small_search(8)
    opts = opts.replace(search_escalation_factor=opts.search_delta_factor)
    _, bP, bQ = _small_search(8, n=60)
    pairs = [(P, Q), (bP, bQ)]
    runs = [register_batch(pairs, opts, device=dev) for _ in range(2)]
    for r1, r2 in zip(*runs):
        assert r1.n_trials == r2.n_trials and r1.score == r2.score
        np.testing.assert_array_equal(r1.transform, r2.transform)
    first, second = (r[0].stats["spans"] for r in runs)
    assert first["warm_full"] == 1 and "warm_reused" not in first
    assert second["warm_reused"] == 1 and "warm_full" not in second
    assert not [path for path in second["spans"]
                if path.endswith(("warm/step", "warm/refine"))]
    assert second["device_allocs"] == 0


def test_two_live_matchers_never_share_a_pool(dev):
    """Two matchers whose graphs are alive hold two pools; one that
    lets its graphs go gives its pool back to the next matcher, and the
    other's replays still equal its eager steps."""
    opts, P, Q = _small_search(8)
    a = s4t.MatchSuper4PCS(opts, device=dev)
    a._init(P, Q)
    b = s4t.MatchSuper4PCS(opts, device=dev)
    b._init(P, Q)
    assert a._lease.id != b._lease.id
    pool_a = a._lease.id
    a._release_graphs()
    c = s4t.MatchSuper4PCS(opts, device=dev)
    c._init(P, Q)
    assert c._lease.id == pool_a
    for i in range(3):
        g = b._run_step(i)
        e = b._run_step(i, eager=True)
        for key in e:
            assert g[key].tobytes() == e[key].tobytes(), (i, key)


def test_a_matcher_on_a_card_that_is_not_current(dev):
    """A matcher on the last visible card while cuda:0 is the current
    one: its replayed steps (their host copies behind an event on its
    own card's stream) equal its steps launched op by op, and its search
    (two steps in flight) equals that on cuda:0, bit for bit."""
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        pytest.skip("needs two CUDA cards")
    last = torch.device(f"cuda:{n_cards - 1}")
    torch.cuda.set_device(0)
    opts, P, Q = _small_search(8)
    m = s4t.MatchSuper4PCS(opts.replace(bases_per_step=64), device=last)
    m._init(P, Q)
    assert m._graph is not None
    for i in range(4):
        g = m._run_step(i)
        e = m._run_step(i, eager=True)
        for k in e:
            assert g[k].tobytes() == e[k].tobytes(), (i, k)
    assert torch.cuda.current_device() == 0
    _same_search(_register_on(last, opts, P, Q), _register_on(dev, opts, P, Q))


_LAYOUT_CFGS = {
    "band": dict(),
    "filters": dict(max_normal_difference=40.0, max_color_distance=60.0,
                    max_translation_distance=1.5),
    "angle": dict(max_angle=80.0),
    "no-distance": dict(use_distance_filter=False),
    "no-distance-angle": dict(use_distance_filter=False, max_angle=90.0),
}


def _layout_inputs(rng, g, n, nt):
    """G kd-ordered bumpy clouds with normals (10 missing) and colors (20
    missing), their last 8 points copies of their first (pairs at d2 =
    0), T bases drawn from them (trial t on cloud t // (T // G)),
    per-trial column offsets."""
    pos = np.stack([_bumpy(rng, n) for _ in range(g)])
    pos = np.stack([p[sampling.kd_argsort(p)] for p in pos])
    pos[:, n - 8:] = pos[:, :8]
    nrm = rng.normal(size=pos.shape).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    nrm[:, :10] = 0
    rgb = (np.abs(pos) * 200).astype(np.float32)
    rgb[:, :20] = -1
    g_of = np.arange(nt) // (nt // g)
    ids = np.stack([rng.choice(n, 4, replace=False) for _ in range(nt)])
    clouds = (pos, nrm, rgb)
    bases = tuple(c[g_of[:, None], ids] for c in clouds)
    return clouds, bases, rng.integers(0, n, nt)


def _layout_same(got, ref, angle=None):
    """K2x's outputs against another run's, edge by edge: cols, hit and
    rc bit for bit (outside ``angle``'s rows, (E, T, n_pad) bool, where
    given); returns the hits."""
    hits = 0
    for e, ((c, h, rc), (c0, h0, rc0)) in enumerate(zip(got, ref)):
        hits += int(rc.sum())
        if angle is not None:
            same = (c == c0).all(-1) & (h == h0).all(-1) & (rc == rc0)
            assert bool((same | angle[e]).all())
        else:
            assert torch.equal(c, c0) and torch.equal(h, h0)
            assert torch.equal(rc, rc0)
        assert torch.equal(h, c >= 0)
    return hits


@pytest.mark.parametrize("cfg", list(_LAYOUT_CFGS))
@pytest.mark.parametrize("n,row_cap", [(700, 24), (2500, 64), (40, 7)])
def test_rowcap_layout_kernel_bit_identical_to_plain(dev, cfg, n, row_cap):
    """K2x (both edges of T = 6 trials over G = 2 kd-ordered clouds with
    duplicate points, n not a multiple of the tile, in one launch; and
    edge (2, 3) alone; row caps that are and are not multiples of 4)
    against its plain version, with the rejection on
    and off (bit for bit each other), at drawn offsets and at 0, n - 1
    and a tile boundary: cols, hit and rc bit for bit; with the angle
    filter, outside the rows holding a pair within 1e-6 rad of the gate
    (``acosf`` against ``torch.arccos``), which are counted."""
    rng = np.random.default_rng(n + row_cap)
    clouds, bases, off = _layout_inputs(rng, 2, n, 6)
    args = [torch.as_tensor(a, device=dev) for a in (*clouds, *bases)]
    tcfg = k2x.PairFilterConfig(**_LAYOUT_CFGS[cfg])
    bounds = k2x.reject_bounds(args[0])
    band, angle = k2x.gate_edge_rows(args[0], args[3], 0.1, tcfg)
    tile = (k2x.FILTER_TILE if cfg in ("filters", "angle",
                                       "no-distance-angle") else k2x.TILE)
    hits = 0
    for offs in (off, np.zeros(6), np.full(6, n - 1),
                 np.array([tile, tile - 1, tile + 1, 0, n - 1, tile])):
        offs = torch.as_tensor(offs, device=dev).long()
        ref = k2x.rowcap_layout_plain(*args, 0.1, tcfg, row_cap,
                                      col_offset=offs)
        runs = []
        for reject in (True, False):
            before = k2x.rowcap_layout.launches
            runs.append(k2x.rowcap_layout(*args, 0.1, tcfg, row_cap,
                                          col_offset=offs,
                                          tile_reject=reject,
                                          bounds=bounds if reject
                                          else None))
            assert k2x.rowcap_layout.launches == before + 1
        torch.cuda.synchronize()
        hits += _layout_same(runs[0], ref,
                             angle if tcfg.max_angle > 0 else None)
        _layout_same(runs[0], runs[1])
        one = k2x.rowcap_layout(*args, 0.1, tcfg, row_cap, col_offset=offs,
                                edges=((2, 3),), bounds=bounds)
        torch.cuda.synchronize()
        _layout_same(one, ref[1:], angle[1:] if tcfg.max_angle > 0
                     else None)
    assert hits > 0


def _lattice(n, g):
    """G clouds of n points of the 1/8 lattice (every coordinate, |p|^2,
    dot product and squared distance exact in float32), shuffled, their
    last 16 points copies of their first."""
    rng = np.random.default_rng(n)
    grid = np.stack(np.meshgrid(*[np.arange(-8, 9)] * 3), -1).reshape(-1, 3)
    pos = np.stack([grid[rng.choice(len(grid), n, replace=False)]
                    for _ in range(g)]).astype(np.float32) / 8
    pos[:, n - 16:] = pos[:, :16]
    return pos


@pytest.mark.parametrize("cfg", ["band", "angle"])
def test_rowcap_layout_kernel_at_band_edges(dev, cfg):
    """Lattice clouds whose pair distances fall exactly on both edges of
    each band (d = 0.5 and 0.75 along x, eps = 0.125: lo^2 = 9/64, hi^2 =
    25/64 and 49/64 are lattice squared distances; with the angle filter
    |dist - d| = eps exactly), duplicate points, G = 2, a row cap above
    most rows' hits: K2x with the rejection on and off equals the plain
    version bit for bit."""
    g, n, nt = 2, 1500, 4
    pos = torch.as_tensor(_lattice(n, g), device=dev)
    nrm = torch.zeros_like(pos)
    rgb = torch.full_like(pos, -1.0)
    bp = torch.zeros((nt, 4, 3), device=dev)
    bp[:, 1, 0] = 0.5
    bp[:, 3, 0] = 0.75
    bases = (bp, torch.zeros_like(bp), torch.full_like(bp, -1.0))
    tcfg = k2x.PairFilterConfig(**_LAYOUT_CFGS[cfg])
    offs = torch.tensor([0, n - 1, 512, 700], device=dev)
    ref = k2x.rowcap_layout_plain(pos, nrm, rgb, *bases, 0.125, tcfg, 200,
                                  col_offset=offs)
    _, angle = k2x.gate_edge_rows(pos, bp, 0.125, tcfg)
    runs = [k2x.rowcap_layout(pos, nrm, rgb, *bases, 0.125, tcfg, 200,
                              col_offset=offs, tile_reject=r)
            for r in (True, False)]
    torch.cuda.synchronize()
    assert _layout_same(runs[0], ref,
                        angle if cfg == "angle" else None) > 0
    _layout_same(runs[0], runs[1])


@pytest.mark.parametrize("n,row_cap", [(700, 24), (300, 300)])
def test_rowcap_layout_closed_form_on_the_card(dev, n, row_cap):
    """No band and no filter (similarity mode's rowcap engine): the
    kernel's closed form equals the plain version, one table for both
    edges, at offsets 0, n - 1 and drawn, G = 2."""
    rng = np.random.default_rng(n)
    clouds, bases, off = _layout_inputs(rng, 2, n, 4)
    args = [torch.as_tensor(a, device=dev) for a in (*clouds, *bases)]
    cfg = k2x.PairFilterConfig(use_distance_filter=False)
    offs = torch.as_tensor([0, n - 1, off[2], off[3]], device=dev)
    got = k2x.rowcap_layout(*args, 0.1, cfg, row_cap, col_offset=offs)
    ref = k2x.rowcap_layout_plain(*args, 0.1, cfg, row_cap,
                                  col_offset=offs)
    torch.cuda.synchronize()
    assert got[0][0] is got[1][0]
    assert _layout_same(got, ref) == 2 * 4 * n * (n - 1)


def test_xla_route_registration_on_the_card(dev):
    """The 500-point recipe through ``register`` on the XLA route
    (``pair_engine="rowcap", rowcap_kernel="xla"``): the skill's gates,
    K2x launched, the capture kernel K2 not."""
    rng = np.random.default_rng(11)
    target = _bumpy(rng, 500)
    ang = 1.1
    rot = np.array([[np.cos(ang), -np.sin(ang), 0],
                    [np.sin(ang), np.cos(ang), 0], [0, 0, 1]], np.float32)
    source = (target - np.array([.4, -.2, .7], np.float32)) @ rot
    before = (k2x.rowcap_layout.launches, k2.rowcap_capture.launches)
    res = s4t.register(target, source, overlap=0.9, delta=0.05,
                       sample_size=500, max_time_seconds=30, device=dev,
                       pair_engine="rowcap", rowcap_kernel="xla")
    moved = source @ res.transform[:3, :3].T + res.transform[:3, 3]
    assert res.score > 0.95
    assert np.median(np.linalg.norm(moved - target, axis=1)) < 0.05
    assert k2x.rowcap_layout.launches > before[0]
    assert k2.rowcap_capture.launches == before[1]


# ------------------------------------------------ the refine's neighbour walk

@pytest.fixture(scope="module")
def headline():
    """chip_smoke.py's headline pair as the matcher verifies it: P's
    samples (~75k points) and Q's 8192 in kd order, both centered, and
    a pose near the true one (rotation part, in those frames)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import bench
    import chip_smoke as cs
    dev = torch.device("cuda")
    P, Q = bench.fine_delta_pair()
    opts = cs._headline_options(s4t)
    p, q = cs._samples(s4t, P, Q, opts.delta, opts.sample_size,
                       opts.random_seed, dev)
    return p, q, cs._pose_sampler(dev)(1)[0], opts.delta


#: the refine's trim radius at the cells' search factor and after one and
#: two escalations
WALK_FACTORS = [1.0, 2.0, 4.0]


@pytest.mark.parametrize("sf", WALK_FACTORS)
def test_refine_walk_kernel_bit_identical_to_plain(headline, sf):
    """8192 queries against the headline's P at 2, 4 and 8 delta: the
    kernel is its plain walk bit for bit, with the index built here or
    on the call, and a Q_PAD sentinel row and a NaN transform find
    nothing."""
    p, q, pose, delta = headline
    r = refine.trim_radius(delta, 8, sf)
    index = k1.grid_index(p, r)
    before = k1.nearest_within.launches
    got = k1.nearest_within(pose, q, p, r, index)
    again = k1.nearest_within(pose, q, p, r)
    torch.cuda.synchronize()
    assert k1.nearest_within.launches == before + 2
    want = k1.nearest_within_plain(pose, q, p, r, index)
    assert torch.equal(got, want) and torch.equal(again, want)
    assert 0.5 * q.shape[0] < int(torch.isfinite(got[:, 3]).sum())
    odd = q.clone()
    odd[-3:] = 2.0e17
    nan = pose.clone()
    nan[0, 1] = float("nan")
    for m, qs in ((pose, odd), (nan, q)):
        got = k1.nearest_within(m, qs, p, r, index)
        assert torch.equal(got, k1.nearest_within_plain(m, qs, p, r, index))
    assert torch.isinf(got[:, 3]).all() and not got[:, :3].any()


@pytest.mark.parametrize("sf", WALK_FACTORS)
def test_refine_on_the_card_against_the_brute_force(headline, sf):
    """refine_transform on the card (the walk) against the same loop
    with the brute force of the CPU (ops/refine.py::_nearest): the same
    neighbour on at least 99.9% of the queries the brute force finds
    within the radius, and the refined transforms within 1e-5. Each ICP
    iteration is one launch and one count of ``refine_walks``."""
    from super4pcs_tpu_torch.utils import profiling
    p, q, pose, delta = headline
    r = refine.trim_radius(delta, 8, sf)
    walk = k1.nearest_within(pose, q, p, r)
    tq = q @ pose[:3, :3].T + pose[:3, 3]
    idx, d2 = refine._nearest(tq, p)
    within = d2 <= float(np.float32(r) * np.float32(r))
    same = (walk[:, :3] == p[idx]).all(1) & within
    assert int(same.sum()) >= 0.999 * int(within.sum()) > 0
    before = k1.nearest_within.launches
    with profiling.call(p.device) as table:
        got = refine.refine_transform(pose, q, p, delta, start_factor=sf)
    want = refine._icp(pose, q, refine._radii(delta, 8, sf),
                       refine._brute(q, p))
    torch.cuda.synchronize()
    assert k1.nearest_within.launches == before + 8
    assert table["refine_walks"] == 8
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=1e-5)


def _pool_pair():
    """The first pair of the benchmark's ``scan100k.pair`` pool (its
    traffic file's pool seed) and the configuration's options and pose
    gates."""
    import json
    import os
    import sys
    here = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "benchmark")
    if here not in sys.path:
        sys.path.insert(0, here)
    import generate
    from reference import lcp as ref

    def load(*parts):
        with open(os.path.join(here, *parts)) as f:
            return json.load(f)
    config = load("configs", "scan100k.json")
    traffic = load("traffic", "pair.json")
    call = generate.make_calls(config["data"], dict(traffic, calls=1),
                               traffic["pool_seed"])[0]
    opts = s4t.Options(**config["options"],
                       random_seed=call["random_seed"]).configure_overlap(
        *config["overlap"])
    return call["pairs"][0], opts, config["checks"], ref.pose_errors


def test_register_with_the_walk_against_the_brute_force(dev, monkeypatch):
    """A pool pair of the benchmark's scan100k cell through
    ``api.register``: with the walk, and with the brute force in its
    place (the refine's neighbour step before the walk), both inside
    the pose gates, their LCPs within 1/8192; with the walk, 8
    ``refine_walks`` and 8 launches a refine."""
    pair, opts, checks, pose_errors = _pool_pair()
    calls = []
    real = refine.refine_transform

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    def register():
        return s4t.register(pair["target"], pair["source"], options=opts,
                            device=dev)

    monkeypatch.setattr(refine, "refine_transform", counted)
    before = k1.nearest_within.launches
    walk = register()
    refines = len(calls)
    assert refines >= 1
    assert walk.stats["spans"]["refine_walks"] == 8 * refines
    assert k1.nearest_within.launches - before == 8 * refines
    monkeypatch.setattr(refine, "_walk",
                        lambda q, p, radius, index: refine._brute(q, p))
    brute = register()
    for res in (walk, brute):
        rot, tr = pose_errors(res.transform, pair["truth"])
        assert rot <= checks["rot_diff"] and tr <= checks["tr_err"]
        assert res.score >= opts.terminate_threshold
    assert abs(walk.score - brute.score) <= 1 / 8192
    assert brute.stats["spans"]["refine_walks"] == 0
