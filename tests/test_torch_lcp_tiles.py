"""The brute-force K1 of the PyTorch port as a branch-and-bound over a
tiled index of P (``kernels/lcp.py``: ``tile_index``, ``tiled_walk``,
``lcp_min_d2_tiled_plain``), on the CPU: the index's invariants, the
walk bit for bit the brute force's plain version at the boundary cases
(``tests/_tile_cases.py``, which the card's tests share), and both
against the JAX package's Pallas kernels run in interpret mode."""

import functools
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from super4pcs_tpu.kernels import lcp_pallas
from super4pcs_tpu_torch.kernels import lcp as k1

from _tile_cases import NAMES, case, kd_sphere, near_identity, same_bits


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


@pytest.mark.parametrize("n", [1, 31, 32, 33, 1025, 5000])
def test_tile_index_invariants(n):
    """The permutation is one, every point lies in its tile's box and
    every tile's box in its group's, the boxes are tight, and the padded
    tail repeats the last point."""
    rng = np.random.default_rng(n)
    p = _t(kd_sphere(rng, n) if n == 5000 else rng.uniform(-1, 1, (n, 3)))
    idx = k1.tile_index(p)
    n_tiles = -(-n // k1.TILE)
    n_groups = -(-n_tiles // k1.GROUP)
    assert idx.n_points == n
    assert idx.pts.shape == (n_tiles * k1.TILE, 4)
    assert idx.tile_box.shape == (n_tiles, 2, 4)
    assert idx.group_box.shape == (n_groups, 2, 4)
    assert torch.equal(torch.sort(idx.perm).values, torch.arange(n))
    assert torch.equal(idx.pts[:n, :3], p[idx.perm])
    assert bool((idx.pts[:, 3] == 0).all())
    assert bool((idx.pts[n:] == idx.pts[n - 1]).all())
    tiles = idx.pts.view(n_tiles, k1.TILE, 4)
    assert torch.equal(idx.tile_box[:, 0], tiles.amin(1))
    assert torch.equal(idx.tile_box[:, 1], tiles.amax(1))
    group = torch.arange(n_tiles) // k1.GROUP
    assert bool((idx.group_box[group, 0] <= idx.tile_box[:, 0]).all())
    assert bool((idx.group_box[group, 1] >= idx.tile_box[:, 1]).all())
    for g in range(n_groups):
        sl = slice(g * k1.GROUP, (g + 1) * k1.GROUP)
        assert torch.equal(idx.group_box[g, 0], idx.tile_box[sl, 0].amin(0))
        assert torch.equal(idx.group_box[g, 1], idx.tile_box[sl, 1].amax(0))


def test_tile_index_of_an_empty_cloud():
    idx = k1.tile_index(torch.zeros((0, 3)))
    assert idx.n_points == 0 and idx.pts.shape == (0, 4)
    assert idx.tile_box.shape == idx.group_box.shape == (0, 2, 4)


@pytest.mark.parametrize("name", NAMES)
def test_tiled_walk_bit_identical_to_brute_force(name):
    """The walk of the kernel (seeds, coarse and fine box tests, the
    skip rule bound >= running min) returns the brute force's plain
    version bit for bit, NaN where it gives NaN; also with the group
    list cut into parts (the kernel's split over blockIdx.y, one part
    after another, each pruning against the output of the earlier)."""
    tr, q, p = (_t(a) for a in case(name))
    ref = k1.lcp_min_d2_plain(tr, q, p)
    idx = k1.tile_index(p)
    n_groups = idx.group_box.shape[0]
    for parts in sorted({1, 2, max(n_groups, 1)}):
        got = k1.lcp_min_d2_tiled_plain(tr, q, p, idx, parts=parts)
        assert same_bits(got, ref), parts
    if name == "nonfinite":
        assert bool(torch.isnan(ref).any()) and bool(torch.isinf(ref).any())
    if name == "faces":
        assert bool((ref == 0).any())


def test_tiled_walk_prunes_a_kd_ordered_surface():
    """On kd-ordered samples of a surface under near-true poses the walk
    makes a small share of the brute force's pair tests, and counts its
    box tests; without an overlap it still returns the min."""
    rng = np.random.default_rng(3)
    p = _t(kd_sphere(rng, 20000))
    q = _t(kd_sphere(rng, 2048))
    tr = _t(near_identity(rng, 2))
    idx = k1.tile_index(p)
    out, pairs, boxes = k1.tiled_walk(tr, q, idx)
    assert same_bits(out.view(2, -1), k1.lcp_min_d2_plain(tr, q, p))
    m = 2 * 2048
    assert pairs <= 0.2 * m * p.shape[0]
    assert pairs % k1.TILE == 0 and boxes > m
    # a far shift: no group overlaps any warp's box
    far = tr.clone()
    far[:, :3, 3] += 5.0
    out, _, _ = k1.tiled_walk(far, q, idx)
    assert same_bits(out.view(2, -1), k1.lcp_min_d2_plain(far, q, p))


def test_coarse_bound_is_below_every_query_bound():
    """The kernel's coarse test: the bound of a box against a warp's
    query box [a, b] never exceeds the bound of any query in [a, b],
    queries on the faces and corners of [a, b] included."""
    rng = np.random.default_rng(9)
    lo = _t(rng.uniform(-1, 1, (400, 3)))
    hi = lo + _t(rng.uniform(0, 0.5, (400, 3)))
    a = _t(rng.uniform(-1.5, 1.5, (400, 3)))
    b = a + _t(rng.uniform(0, 0.7, (400, 3)))
    w = _t(rng.uniform(0, 1, (400, 16, 3)))
    w[:, :8] = torch.round(w[:, :8])      # corners of [a, b]
    t = torch.minimum(a[:, None] + w * (b - a)[:, None], b[:, None])
    coarse = k1._box_box_bound(lo, hi, a, b)
    fine = k1._box_bound(t, lo[:, None], hi[:, None])
    assert bool((coarse[:, None] <= fine).all())


def test_box_bound_is_below_every_point_of_the_box():
    """The skip rule's bound against the d2 the brute force computes,
    for points on the box's faces and corners and queries just outside
    it, inside it and far from it."""
    rng = np.random.default_rng(4)
    pts = _t(rng.uniform(-1, 1, (64, 32, 3)))
    pts[:, :4] = torch.round(pts[:, :4])           # on a face or corner
    lo, hi = pts.amin(1), pts.amax(1)
    t = _t(rng.uniform(-3, 3, (64, 3)))
    t[:8] = torch.nextafter(hi[:8], torch.full_like(hi[:8], 9.0))
    t[8:16] = (lo[8:16] + hi[8:16]) / 2
    t[16:20] *= 1e17
    bound = k1._box_bound(t, lo, hi)
    d2 = k1._sum_sq(t[:, None] - pts)
    assert bool((bound <= d2.amin(1)).all())
    assert bool((bound[8:16] == 0).all())


def test_wrapper_on_the_cpu_takes_the_plain_version():
    tr, q, p = (_t(a) for a in case("sphere"))
    idx = k1.tile_index(p)
    before = k1.lcp_min_d2.launches
    assert torch.equal(k1.lcp_min_d2(tr, q, p, idx),
                       k1.lcp_min_d2_plain(tr, q, p))
    assert torch.equal(k1.min_sq_dists(q, p, idx),
                       k1.min_sq_dists_plain(q, p))
    assert k1.lcp_min_d2.launches == before
    with pytest.raises(ValueError, match="tile index"):
        k1.lcp_min_d2(tr, q, p[:-1], idx)
    with pytest.raises(ValueError, match="counting build"):
        k1.lcp_min_d2_counts(tr, q, p, idx)


@pytest.mark.parametrize("name", NAMES)
def test_needed_tests_bound_the_walk(name):
    """The tests the queries need (kernels/lcp.py::needed_tests): alone
    at most those of their warps, and those of the kernel's warps at
    most the pair tests the walk makes; a query needs fewer box tests
    than the brute force's pair tests, and a query with a non-finite
    coordinate needs none."""
    tr, q, p = (_t(a) for a in case(name))
    idx = k1.tile_index(p)
    ref = k1.lcp_min_d2_plain(tr, q, p)
    need = k1.needed_tests(tr, q, idx, ref)
    _, pairs, _ = k1.tiled_walk(tr, q, idx)
    assert need["pairs"] <= need["warp_pairs"] <= pairs
    assert need["pairs"] <= need["other_order_pairs"]
    assert need["pairs"] % k1.TILE == 0
    m = tr.shape[0] * q.shape[0]
    assert 0 <= need["boxes"] <= m * max(idx.tile_box.shape[0], 1)
    if name == "nonfinite":
        # candidates 1-3 move every query off the finite range
        keep = [0, 4]
        finite = k1.needed_tests(tr[keep], q, idx, ref[keep])
        assert (finite["pairs"], finite["boxes"]) == (need["pairs"],
                                                      need["boxes"])


def test_needed_tests_of_one_query_by_hand():
    """Two groups of 32 tiles along x, tile k at x = k, and one query
    inside the first group's box, off its axis: it needs the tile that
    holds its min (whose bound is that min), one box test for the far
    group and one for each other tile of its own."""
    x = np.repeat(np.arange(64, dtype=np.float32), 32)
    p = _t(np.stack([x, np.zeros_like(x), np.zeros_like(x)], 1))
    q = _t([[0.4, 0.1, 0.0]])
    idx = k1.tile_index(p)
    assert idx.group_box.shape[0] == 2
    ref = k1.min_sq_dists_plain(q, p)
    need = k1.needed_tests(None, q, idx, ref)
    assert need == dict(pairs=32, boxes=1 + 31, warp_pairs=32,
                        other_order_pairs=32)


@pytest.mark.parametrize("total,n_groups,sms,parts", [
    (524_288, 73, 132, 1),      # the exact stage: 4096 blocks
    (16_384, 519, 132, 3),      # K4a: 128 blocks on 132 SMs
    (64, 196, 132, 196),        # one block: one part a group
    (64, 7, 132, 7),
    (1_048_576, 2000, 132, 2),  # more groups than a part stages
])
def test_tile_parts(total, n_groups, sms, parts):
    """The launcher's split of the group list: two blocks per SM, at most
    MAX_PART_GROUPS groups a part and one part a group."""
    got = k1.tile_parts(total, n_groups, sms)
    assert got == parts
    assert -(-n_groups // got) <= k1.MAX_PART_GROUPS


def _interpret():
    return mock.patch.object(lcp_pallas.pl, "pallas_call", functools.partial(
        lcp_pallas.pl.pallas_call, interpret=True))


@pytest.mark.parametrize("name", ["sphere", "random", "np_33"])
def test_tiled_walk_matches_pallas_kernels_interpreted(name):
    """The walk against candidate_min_sq_dists and min_sq_dists in
    interpret mode. Tolerance 1e-6 absolute: the Pallas kernel applies
    the transform as an 8x8 matrix product whose summation order is
    XLA's, the port as ((r0 x + r1 y) + r2 z) + t (a few ulp of the O(1)
    coordinates); min_sq_dists takes the rows as they are in both."""
    tr, q, p = case(name)
    tr, q = tr[:3], q[:150]
    idx = k1.tile_index(_t(p))
    with _interpret():
        ref = np.asarray(lcp_pallas.candidate_min_sq_dists(
            jnp.asarray(tr), jnp.asarray(q), jnp.asarray(p)))
        ref_m = np.asarray(lcp_pallas.min_sq_dists(jnp.asarray(q),
                                                   jnp.asarray(p)))
    got = k1.lcp_min_d2_tiled_plain(_t(tr), _t(q), _t(p), idx).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    got_m = k1.tiled_walk(None, _t(q), idx)[0].numpy()
    np.testing.assert_allclose(got_m, ref_m, rtol=0, atol=1e-6)
