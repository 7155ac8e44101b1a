"""The refine's neighbour walk on the CPU: ``kernels/lcp.py``'s
``nearest_within_plain`` (the CUDA kernel's plain version, bit for bit
the kernel on the card) against a dense exact argmin written out here,
and the refine's ICP loop with the walk against the same loop with the
JAX package's brute force (``ops/refine.py::_nearest``)."""

import numpy as np
import pytest
import torch

from super4pcs_tpu_torch.kernels import lcp as k1
from super4pcs_tpu_torch.ops import lcp as tlcp
from super4pcs_tpu_torch.ops import refine
from super4pcs_tpu_torch.parallel.batch import _Q_SENTINEL, _repeat_pad


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float32)


def _cloud(rng, n):
    """The bumped sphere of tests/test_torch_ops.py, centered."""
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    bump = 1 + 0.3 * np.sin(5 * v[:, 0]) * np.cos(3 * v[:, 1])
    pos = v * bump[:, None]
    return (pos - pos.mean(0)).astype(np.float32)


def _pose(ang, shift):
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = [[np.cos(ang), -np.sin(ang), 0],
                 [np.sin(ang), np.cos(ang), 0], [0, 0, 1]]
    m[:3, 3] = shift
    return m


def _queries(rng, p, n, spread):
    """``n`` queries: P's points moved by up to ``spread``, and a third of
    them uniform over P's box (most of those beyond any radius here)."""
    near = p[rng.integers(0, len(p), n - n // 3)] + rng.uniform(
        -spread, spread, (n - n // 3, 3))
    far = rng.uniform(p.min(0), p.max(0), (n // 3, 3))
    return np.concatenate([near, far]).astype(np.float32)


def _dense(m, q, p, radius):
    """Every query's least d^2 over all of P with the kernel's transform
    and d^2 order, ``+inf`` beyond ``radius``, and the (nq, np) d^2."""
    x, y, z = q[:, 0], q[:, 1], q[:, 2]
    t = [((m[k, 0] * x + m[k, 1] * y) + m[k, 2] * z) + m[k, 3]
         for k in range(3)]
    d = [t[k][:, None] - p[None, :, k] for k in range(3)]
    d2 = (d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]
    best = d2.amin(1)
    r2 = float(np.float32(radius) * np.float32(radius))
    return torch.where(best <= r2, best, float("inf")), d2


def _check_against_dense(got, m, q, p, radius):
    best, d2 = _dense(m, q, p, radius)
    within = torch.isfinite(best)
    assert torch.equal(got[:, 3], best)
    assert torch.equal(got[~within, :3], torch.zeros((int((~within).sum()),
                                                      3)))
    # the target is a point of P at the least d^2
    at_best = (d2 == best[:, None]) & within[:, None]
    is_target = (p[None] == got[:, None, :3]).all(-1)
    assert torch.equal((at_best & is_target).any(1), within)
    return int(within.sum())


@pytest.mark.parametrize("n", [500, 5000])
@pytest.mark.parametrize("radius", [0.02, 0.04, 0.08])
def test_plain_walk_equals_the_dense_argmin(n, radius):
    """For every query within the radius the walk's d^2 is the dense
    least d^2 bit for bit and its target a point of P at that d^2;
    beyond it, (0, 0, 0, +inf)."""
    rng = np.random.default_rng(n + int(radius * 100))
    p = _t(_cloud(rng, n))
    q = _t(_queries(rng, p.numpy(), 1200, 2 * radius))
    m = _t(_pose(0.01, [0.003, -0.002, 0.001]))
    got = k1.nearest_within_plain(m, q, p, radius)
    within = _check_against_dense(got, m, q, p, radius)
    assert 0 < within < q.shape[0]
    # the wrapper takes the plain version on the CPU, with or without a
    # prebuilt index
    index = k1.grid_index(p, radius)
    assert torch.equal(k1.nearest_within(m, q, p, radius, index), got)


def test_plain_walk_ties_go_to_the_lower_key_position():
    """Two points equally near a query (exactly, in float32): the one
    first in the index's key order is the target."""
    p = _t([[0.25, 0.0, 0.0], [-0.25, 0.0, 0.0], [0.0, 0.5, 0.0],
            [1.0, 1.0, 1.0]])
    q = _t([[0.0, 0.0, 0.0]])
    m = _t(np.eye(4))
    pts, keys, grid = k1.grid_index(p, 0.3)
    got = k1.nearest_within_plain(m, q, p, 0.3, (pts, keys, grid))
    first = [tuple(r) for r in pts[:, :3].tolist()].index
    want = min(first((0.25, 0.0, 0.0)), first((-0.25, 0.0, 0.0)))
    assert torch.equal(got[0], torch.cat([pts[want, :3],
                                          _t([0.0625])]))


def test_plain_walk_over_repeat_padded_duplicates():
    """register_batch's P repeat-padded to a larger size: the same
    targets and d^2 as the cloud itself (a duplicate is the same
    point)."""
    rng = np.random.default_rng(7)
    p = _cloud(rng, 700)
    q = _t(_queries(rng, p, 900, 0.03))
    m = _t(_pose(-0.02, [0.0, 0.004, -0.003]))
    got = k1.nearest_within_plain(m, q, _t(p), 0.04)
    padded = k1.nearest_within_plain(m, q, _t(_repeat_pad(p, 1900)), 0.04)
    assert torch.equal(padded, got)
    _check_against_dense(padded, m, q, _t(_repeat_pad(p, 1900)), 0.04)


def test_plain_walk_sentinel_rows_and_nan_transform():
    """Q's sentinel rows at 2 Q_PAD and every query under a NaN
    transform find nothing: (0, 0, 0, +inf)."""
    rng = np.random.default_rng(8)
    p = _t(_cloud(rng, 600))
    q = _queries(rng, p.numpy(), 300, 0.01)
    q[-50:] = _Q_SENTINEL
    q = _t(q)
    m = _t(np.eye(4))
    got = k1.nearest_within_plain(m, q, p, 0.02)
    _check_against_dense(got, m, q, p, 0.02)
    assert torch.isinf(got[-50:, 3]).all()
    assert torch.equal(got[-50:, :3], torch.zeros((50, 3)))
    nan = m.clone()
    nan[1, 2] = float("nan")
    got = k1.nearest_within_plain(nan, q, p, 0.02)
    assert torch.isinf(got[:, 3]).all() and not got[:, :3].any()


def test_plain_walk_one_point_and_empty_inputs():
    """P of one point: that point for a query within the radius, nothing
    beyond it; no queries and an empty P give their shapes."""
    p = _t([[0.1, 0.2, 0.3]])
    q = _t([[0.1, 0.2, 0.31], [0.1, 0.2, 0.5]])
    m = _t(np.eye(4))
    got = k1.nearest_within_plain(m, q, p, 0.02)
    _check_against_dense(got, m, q, p, 0.02)
    assert torch.equal(got[0, :3], p[0]) and torch.isinf(got[1, 3])
    assert k1.nearest_within(m, q[:0], p, 0.02).shape == (0, 4)
    empty = k1.nearest_within(m, q, p[:0], 0.02)
    assert torch.isinf(empty[:, 3]).all() and not empty[:, :3].any()


def test_plain_walk_box_outside_the_grid():
    """Queries whose box lies beyond P's grid on any side, and queries
    just past its edge but within the radius of its outer points."""
    rng = np.random.default_rng(9)
    p = _t(_cloud(rng, 800))
    lo, hi = p.min(0).values, p.max(0).values
    far = torch.stack([lo - 1.0, hi + 1.0, torch.stack(
        [lo[0], hi[1] + 0.5, lo[2]])])
    edge = p[p[:, 0].argmax()] + _t([0.015, 0.0, 0.0])
    q = torch.cat([far, edge[None]])
    m = _t(np.eye(4))
    got = k1.nearest_within_plain(m, q, p, 0.02)
    _check_against_dense(got, m, q, p, 0.02)
    assert torch.isinf(got[:3, 3]).all() and torch.isfinite(got[3, 3])


def test_the_index_is_checked_against_p():
    """An index built for another cloud is refused."""
    rng = np.random.default_rng(10)
    p = _t(_cloud(rng, 300))
    index = k1.grid_index(p[:200], 0.02)
    with pytest.raises(ValueError, match="index"):
        k1.nearest_within(_t(np.eye(4)), p[:10], p, 0.02, index)


def test_trim_radius_covers_every_iteration():
    """The walk's radius is the schedule's largest: its square is the
    largest threshold of the loop, at start factors below, at and above
    1, and for one iteration."""
    for delta, iters, sf in [(0.01, 8, 1.0), (0.01, 8, 2.0),
                             (0.01, 8, 4.0), (0.02, 6, 0.5),
                             (0.013, 1, 3.0)]:
        radii = refine._radii(delta, iters, sf)
        r = np.float32(refine.trim_radius(delta, iters, sf))
        assert r * r == (radii ** 2).max()
        assert r == np.float32(2 * delta * max(1.0, sf if iters > 1 else 1))


@pytest.mark.parametrize("estimate_scale", [False, True])
@pytest.mark.parametrize("sf", [1.0, 2.0])
def test_refine_loop_with_the_walk_equals_the_brute_force(sf,
                                                          estimate_scale):
    """The ICP loop on tests/test_torch_ops.py::test_refine_transform's
    data (tests/test_torch_scale.py's with the scale): neighbours from
    the plain walk of P's index at the trim radius, as on the card,
    against the CPU's brute force, which refine_transform takes here;
    the refined transforms within 1e-5. The index of a VerifyIndex, as
    the matcher passes it, gives the same loop."""
    rng = np.random.default_rng(42)
    p = _cloud(rng, 900)
    s = 1.3 if estimate_scale else 1.0
    q = (p[:600] / s
         + rng.normal(scale=0.002, size=(600, 3))).astype(np.float32)
    m = _pose(0.03, [0.01, -0.005, 0.008])
    m[:3, :3] *= 1.27 if estimate_scale else 1.0
    p, q, m = _t(p), _t(q), _t(m)
    radius = refine.trim_radius(0.02, 6, sf)
    walk = refine._icp(m, q, refine._radii(0.02, 6, sf),
                       refine._walk(q, p, radius, None), estimate_scale)
    brute = refine.refine_transform(m, q, p, 0.02, iters=6,
                                    start_factor=sf,
                                    estimate_scale=estimate_scale)
    np.testing.assert_allclose(walk.numpy(), brute.numpy(), atol=1e-5)
    index = tlcp.VerifyIndex(p).get(1, radius).part(0)
    again = refine._icp(m, q, refine._radii(0.02, 6, sf),
                        refine._walk(q, p, radius, index), estimate_scale)
    assert torch.equal(again, walk)
