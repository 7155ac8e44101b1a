"""HEALPix direction bins of the PyTorch port against the JAX package, on
the same numpy inputs: the ring-scheme pixelization
(``ops/healpix.py``), the rasterized alpha-circle and both congruent
joins with ``direction_bins="healpix"``.

Pixel ids are integers made by ``floor`` of float32 expressions, and the
two packages round ``atan2``, ``sin``/``cos`` and fused multiply-adds
(XLA on the CPU contracts them) apart in the last bit. So a direction
within a few ulp of a ring or pixel edge may land in the neighbouring
pixel. The near-edge exclusion, stated once: a row is near an edge when
the JAX package's own pixel changes under a perturbation of its input
by ``_EDGE`` (1e-5, far above float32 rounding, far below a pixel) in
any one coordinate. Ids are compared exactly on every other row, and on
the poles and axes outright (their arithmetic is exact); excluded rows
must stay under 1% of the total.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from super4pcs_tpu.ops import congruent as jc
from super4pcs_tpu.ops import healpix as jh
from super4pcs_tpu_torch.ops import congruent as tc
from super4pcs_tpu_torch.ops import healpix as th

_EDGE = 1e-5
NSIDES = (1, 4, 16)

# the JAX functions compiled as one program each (eager dispatch
# compiles every primitive apart, which is slower here)
_vec2pix = jax.jit(jh.vec2pix_ring, static_argnums=0)
_ang2pix = jax.jit(jh.ang2pix_ring, static_argnums=0)
_pix2vec = jax.jit(jh.pix2vec_ring, static_argnums=0)
_circle = jax.jit(jc.healpix_circle_pixels, static_argnums=(2, 3))
_dense = jax.jit(jc.find_congruent_quads, static_argnames=(
    "distance_threshold", "cone_cos_tolerance", "capacity",
    "direction_bins", "healpix_nside"))
_grid = jax.jit(jc.find_congruent_quads_grid, static_argnames=(
    "distance_threshold", "cone_cos_tolerance", "capacity",
    "cell_candidates", "direction_bins", "healpix_nside"))


def _dirs(rng, n):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


_POLES_AXES = np.array([[0, 0, 1], [0, 0, -1], [1, 0, 0], [-1, 0, 0],
                        [0, 1, 0], [0, -1, 0]], np.float32)


def _near_edge(fn, *cols):
    """Rows whose JAX pixel changes when any one input column moves by
    +-_EDGE (``fn`` maps the columns to pixel ids)."""
    base = np.asarray(fn(*cols))
    near = np.zeros(base.shape, bool)
    for i in range(len(cols)):
        for sgn in (-1.0, 1.0):
            moved = list(cols)
            moved[i] = (cols[i] + sgn * _EDGE).astype(np.float32)
            near |= np.asarray(fn(*moved)) != base
    return near


@pytest.mark.parametrize("nside", NSIDES)
def test_nside2npix(nside):
    assert th.nside2npix(nside) == jh.nside2npix(nside)


@pytest.mark.parametrize("nside", NSIDES)
def test_vec2pix_ring_matches_jax(rng, nside):
    d = _dirs(rng, 20000)
    want = np.asarray(_vec2pix(nside, jnp.asarray(d)))
    got = th.vec2pix_ring(nside, torch.as_tensor(d)).numpy()
    assert got.dtype == np.int32
    near = _near_edge(
        lambda x, y, z: _vec2pix(nside, jnp.stack([x, y, z], -1)),
        d[:, 0], d[:, 1], d[:, 2])
    assert near.mean() < 0.01
    np.testing.assert_array_equal(got[~near], want[~near])
    # every pixel is reached at nside <= 4 (20000 draws), none outside
    assert got.min() >= 0 and got.max() < th.nside2npix(nside)
    if nside <= 4:
        assert len(np.unique(got)) == th.nside2npix(nside)
    np.testing.assert_array_equal(
        th.vec2pix_ring(nside, torch.as_tensor(_POLES_AXES)).numpy(),
        np.asarray(_vec2pix(nside, jnp.asarray(_POLES_AXES))))


@pytest.mark.parametrize("nside", NSIDES)
def test_ang2pix_ring_matches_jax(rng, nside):
    """z over [-1, 1] (both caps and the belt) and phi over several
    turns, negative too (the Python-style mod)."""
    z = rng.uniform(-1, 1, 20000).astype(np.float32)
    phi = rng.uniform(-3 * np.pi, 3 * np.pi, 20000).astype(np.float32)
    z[:4] = [1.0, -1.0, 0.0, 2.0 / 3.0]
    phi[:4] = [0.0, 0.0, 0.0, np.pi / 2]
    want = np.asarray(_ang2pix(nside, jnp.asarray(z), jnp.asarray(phi)))
    got = th.ang2pix_ring(nside, torch.as_tensor(z),
                          torch.as_tensor(phi)).numpy()
    near = _near_edge(lambda a, b: _ang2pix(nside, a, b), z, phi)
    near[:4] = False                       # exact inputs: compared too
    assert near.mean() < 0.01
    np.testing.assert_array_equal(got[~near], want[~near])


@pytest.mark.parametrize("nside", NSIDES)
def test_pix2vec_ring_matches_jax(nside):
    """Every pixel's centre within 1e-6 (sin/cos and a division by a
    host scalar round apart in the last bit), and the round trip
    vec2pix(pix2vec(p)) == p in both packages."""
    pix = np.arange(th.nside2npix(nside), dtype=np.int32)
    want = np.asarray(_pix2vec(nside, jnp.asarray(pix)))
    got = th.pix2vec_ring(nside, torch.as_tensor(pix)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(
        th.vec2pix_ring(nside, torch.as_tensor(got)).numpy(), pix)


@pytest.mark.parametrize("cos_alpha,samples", [(0.3, 32), (-0.85, 48),
                                               (1.0, 32)])
def test_circle_pixels_match_jax(rng, cos_alpha, samples):
    """The rasterized alpha-circle, near-edge samples excluded (the
    circle's points are perturbed through the query direction)."""
    d = _dirs(rng, 500)
    want = np.asarray(_circle(jnp.asarray(d), cos_alpha, 4, samples))
    got = tc.healpix_circle_pixels(torch.as_tensor(d), cos_alpha, 4,
                                   samples).numpy()
    assert got.shape == want.shape == (500, samples)
    near = _near_edge(
        lambda x, y, z: _circle(
            jnp.stack([x, y, z], -1), cos_alpha, 4, samples),
        d[:, 0], d[:, 1], d[:, 2])
    assert near.mean() < 0.01
    np.testing.assert_array_equal(got[~near], want[~near])


def _pairs(rng, n_pts, k):
    a = rng.integers(0, n_pts, k)
    b = (a + rng.integers(1, n_pts, k)) % n_pts
    return np.stack([a, b], 1).astype(np.int32)


@pytest.mark.parametrize("thr,cos_alpha", [(0.15, 0.25), (0.3, -0.4)])
def test_healpix_joins_match_jax(rng, thr, cos_alpha):
    """The dense and the grid join with HEALPix bins on equal inputs
    (the JAX package's own grid == dense fixture): equal quads, valid
    masks and counts, in both packages and across the two joins."""
    pos = rng.uniform(-1, 1, size=(120, 3)).astype(np.float32)
    p1, p2 = _pairs(rng, 120, 300), _pairs(rng, 120, 300)
    kw = dict(direction_bins="healpix", healpix_nside=4)
    jargs = (jnp.asarray(pos), jnp.asarray(p1), jnp.ones(300, bool),
             jnp.asarray(p2), jnp.ones(300, bool), 0.42, 0.58)
    jkw = dict(distance_threshold=thr, base_cos_alpha=cos_alpha,
               cone_cos_tolerance=0.3, capacity=16384, **kw)
    targs = (torch.as_tensor(pos), torch.as_tensor(p1).long(),
             torch.ones(300, dtype=torch.bool), torch.as_tensor(p2).long(),
             torch.ones(300, dtype=torch.bool), torch.tensor(0.42),
             torch.tensor(0.58), thr, torch.tensor(cos_alpha), 0.3)
    jd = _dense(*jargs, **jkw)
    td = tc.find_congruent_quads(*targs, capacity=16384, **kw)
    jg = _grid(*jargs, cell_candidates=64, **jkw)
    tg = tc.find_congruent_quads_grid(*targs, capacity=16384,
                                      cell_candidates=64, **kw)
    for j, t in ((jd, td), (jg, tg)):
        np.testing.assert_array_equal(t[0].numpy(), np.asarray(j[0]))
        np.testing.assert_array_equal(t[1].numpy(), np.asarray(j[1]))
        assert int(t[2]) == int(j[2])
    assert [int(x) for x in tg[3:]] == [int(x) for x in jg[3:]]
    dense = {tuple(q) for q, v in zip(td[0].tolist(), td[1].tolist()) if v}
    grid = {tuple(q) for q, v in zip(tg[0].tolist(), tg[1].tolist()) if v}
    assert grid == dense and len(dense) > 0
    # the bins filter: fewer quads than the distance test alone
    none = tc.find_congruent_quads(*targs[:-1], -1.0, capacity=16384)
    assert int(td[2]) < int(none[2])


def test_healpix_registration_on_cpu():
    """A registration with HEALPix bins through the port's matcher (the
    JAX package's tests/test_matcher.py:539-556 configuration, grid
    join) recovers a known pose within the reference's gates."""
    import super4pcs_tpu_torch as s4t
    rng = np.random.default_rng(42)
    pos = _dirs(rng, 250)
    pos *= (1 + 0.3 * np.sin(5 * pos[:, :1]) * np.cos(3 * pos[:, 1:2])
            + 0.2 * np.sin(4 * pos[:, 2:]))
    ang = 0.7
    rot = np.array([[np.cos(ang), -np.sin(ang), 0],
                    [np.sin(ang), np.cos(ang), 0], [0, 0, 1]], np.float32)
    shift = np.float32([0.1, 0.05, -0.2])
    gt = np.eye(4)
    gt[:3, :3], gt[:3, 3] = rot, shift
    opts = s4t.Options(delta=0.05, sample_size=250, max_time_seconds=600,
                       bases_per_step=8, max_quads=2048, max_candidates=4096,
                       direction_bins="healpix", healpix_nside=4,
                       random_seed=7, force_grid_join=True
                       ).configure_overlap(0.9)
    res = s4t.MatchSuper4PCS(opts, device="cpu").compute_transformation(
        s4t.PointCloud(pos), s4t.PointCloud((pos - shift) @ rot))
    assert res.improved and res.score > 0.8
    rot_diff, tr_diff = s4t.reference_pose_diff(res.transform, gt)
    assert rot_diff <= 0.2 and tr_diff <= 0.1
