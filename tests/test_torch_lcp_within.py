"""The grid-pruned verify of the PyTorch port (``lcp_min_d2_within``)
on the CPU: its plain walk of the cell index against the brute-force
contract ``where(lcp_min_d2_plain <= eps2, ., inf)`` bit for bit, and
its hit masks against the JAX package's Pallas kernel in interpret
mode."""

import functools
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from super4pcs_tpu.kernels import lcp_pallas
from super4pcs_tpu_torch.kernels import lcp as k1

from _within_cases import NAMES, case, near_cloud, transforms


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a, np.float32))


def _contract(tr, q, p, eps):
    ref = k1.lcp_min_d2_plain(tr, q, p)
    eps2 = float(np.float32(eps) * np.float32(eps))
    return torch.where(ref <= eps2, ref, float("inf"))


@pytest.mark.parametrize("name", NAMES)
def test_within_plain_equals_brute_force_contract(name):
    tr, q, p, eps = (_t(a) if isinstance(a, np.ndarray) else a
                     for a in case(name))
    got = k1.lcp_min_d2_within_plain(tr, q, p, eps)
    want = _contract(tr, q, p, eps)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert torch.equal(got, want)
    # the wrapper on the CPU is the plain walk
    assert torch.equal(k1.lcp_min_d2_within(tr, q, p, eps), got)
    hits = int(torch.isfinite(got).sum())
    if name in ("random", "at_eps", "at_eps_inexact", "eps_above_extent"):
        assert hits > 0
    if name == "at_eps":
        assert hits == got.numel()          # d^2 == eps^2 counts
    if name == "q_pad":
        assert not torch.isfinite(got[:, ::5]).any()
    if name == "nan_transform":
        assert not torch.isfinite(got[1:3]).any()
    if name == "empty_p":
        assert not torch.isfinite(got).any()


@pytest.mark.parametrize("stage", ["coarse", "mid"])
def test_within_plain_on_the_strided_stage_views(stage):
    """The coarse and mid stages pass strided views of Q and P
    (ops/lcp.py lcp_scores_two_stage); the index is built from them as
    they are."""
    rng = np.random.default_rng(7)
    p, q = near_cloud(rng, 6000, 2500, 0.005)
    pt, qt = _t(p), _t(q)
    if stage == "coarse":
        qs, ps, c = qt[::40], pt[::3], 300
    else:
        qs, ps, c = qt[::5], pt[::2], 40
    assert not qs.is_contiguous() and not ps.is_contiguous()
    tr = _t(transforms(rng, c, max_shift=0.02))
    got = k1.lcp_min_d2_within_plain(tr, qs, ps, 0.04)
    assert torch.equal(got, _contract(tr, qs, ps, 0.04))
    assert int(torch.isfinite(got).sum()) > 0


def _near_threshold(tr, q, p, eps, tol=1e-6):
    """(C, nq) bool: float64 min d^2 within ``tol`` of eps^2, where
    float32 rounding may flip the hit."""
    tq = (np.einsum('cij,nj->cni', tr[:, :3, :3].astype(np.float64), q)
          + tr[:, None, :3, 3])
    d2 = ((tq[:, :, None, :] - p[None, None]) ** 2).sum(-1).min(-1)
    return np.abs(d2 - eps * eps) <= tol


def test_within_hits_match_pallas_kernel_interpreted():
    """Hit masks of the pruned verify against candidate_min_sq_dists (the
    TPU kernel, interpret mode) thresholded at eps^2, except for queries
    whose d^2 lies within 1e-6 of eps^2."""
    rng = np.random.default_rng(11)
    p, q = near_cloud(rng, 900, 300, 0.02)
    tr = transforms(rng, 9)
    eps = 0.03
    with mock.patch.object(lcp_pallas.pl, "pallas_call",
                           functools.partial(lcp_pallas.pl.pallas_call,
                                             interpret=True)):
        ref = np.asarray(lcp_pallas.candidate_min_sq_dists(
            jnp.asarray(tr), jnp.asarray(q), jnp.asarray(p)))
    eps2 = np.float32(eps) * np.float32(eps)
    want = ref <= eps2
    got = np.isfinite(k1.lcp_min_d2_within(_t(tr), _t(q), _t(p),
                                           eps).numpy())
    differ = got != want
    assert not (differ & ~_near_threshold(tr, q, p, eps)).any()
    assert 0 < want.sum() < want.size


def test_within_wrapper_runs_plain_on_cpu_and_refuses_other_devices():
    """On the CPU the wrapper is the plain walk and counts no launch;
    another device raises, and so does a wrong shape: nothing falls
    back."""
    tr, q, p, eps = (_t(a) if isinstance(a, np.ndarray) else a
                     for a in case("random"))
    before = k1.lcp_min_d2_within.launches
    got = k1.lcp_min_d2_within(tr, q, p, eps)
    assert torch.equal(got, k1.lcp_min_d2_within_plain(tr, q, p, eps))
    assert k1.lcp_min_d2_within.launches == before
    meta = torch.zeros((8, 3), device="meta")
    with pytest.raises(ValueError):
        k1.lcp_min_d2_within(torch.zeros((1, 4, 4), device="meta"), meta,
                             meta, eps)
    with pytest.raises(ValueError):
        k1.lcp_min_d2_within(tr, q[:, :2], p, eps)


def test_walk_on_a_large_sparse_grid_meets_the_contract():
    """P spread over 1000 cells per axis, most of them empty: the plain
    walk meets the brute-force contract and finds hits."""
    rng = np.random.default_rng(3)
    p = _t(rng.uniform(-50, 50, (2000, 3)))
    q = p[::10] + _t(rng.normal(scale=0.03, size=(200, 3)))
    tr = _t(np.tile(np.eye(4, dtype=np.float32), (3, 1, 1)))
    tr[1, :3, 3] = 0.02
    tr[2, :3, 3] = 5.0
    eps = 0.05
    grid = k1.grid_index(p, eps)[2]
    assert int(grid[4] * grid[5] * grid[6]) > 1 << 20
    got = k1.lcp_min_d2_within_plain(tr, q, p, eps)
    assert torch.equal(got, _contract(tr, q, p, eps))
    assert bool(torch.isfinite(got[0]).any())
