"""K1 (LCP min-distance) of the PyTorch port against the JAX package:
the kernel's plain version against the Pallas kernel run in interpret
mode and against the XLA oracle ``ops.lcp.lcp_scores``, then the
two-stage verify with live masks."""

import functools
from unittest import mock

import jax.numpy as jnp
import numpy as np
import torch

from super4pcs_tpu.kernels import lcp_pallas
from super4pcs_tpu.ops import lcp as jax_lcp
from super4pcs_tpu_torch.kernels import lcp as k1
from super4pcs_tpu_torch.ops import lcp as torch_lcp


def _transforms(rng, c, max_shift=0.3):
    mats = []
    for _ in range(c):
        qm, r = np.linalg.qr(rng.normal(size=(3, 3)))
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = qm * np.sign(np.diag(r))
        m[:3, 3] = rng.uniform(-max_shift, max_shift, 3)
        mats.append(m)
    return np.stack(mats)


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def test_plain_matches_pallas_kernel_interpreted(rng):
    """d^2 of the plain version against candidate_min_sq_dists in
    interpret mode. Tolerance 1e-6 absolute: the Pallas kernel applies
    the transform as an 8x8 matrix product whose summation order is
    XLA's, the port as ((r0 x + r1 y) + r2 z) + t — a few ulp of the
    O(1) coordinates."""
    p = rng.uniform(-1, 1, (900, 3)).astype(np.float32)
    for nq in (150, 600):                 # one and two query tiles
        q = rng.uniform(-1, 1, (nq, 3)).astype(np.float32)
        tr = _transforms(rng, 11)
        with mock.patch.object(lcp_pallas.pl, "pallas_call",
                               functools.partial(
                                   lcp_pallas.pl.pallas_call,
                                   interpret=True)):
            ref = np.asarray(lcp_pallas.candidate_min_sq_dists(
                jnp.asarray(tr), jnp.asarray(q), jnp.asarray(p)))
        got = k1.lcp_min_d2_plain(_t(tr), _t(q), _t(p)).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_plain_matches_float64_brute_force(rng):
    p = rng.uniform(-1, 1, (3000, 3)).astype(np.float32)
    q = rng.uniform(-1, 1, (40, 3)).astype(np.float32)
    tr = _transforms(rng, 5)
    tq = (np.einsum('cij,nj->cni', tr[:, :3, :3].astype(np.float64), q)
          + tr[:, None, :3, 3])
    ref = ((tq[:, :, None, :] - p[None, None]) ** 2).sum(-1).min(-1)
    got = k1.lcp_min_d2(_t(tr), _t(q), _t(p)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def _near_threshold(tr, q, p, eps, tol=1e-6):
    """Per candidate: queries whose float64 min d^2 lies within ``tol``
    of eps^2 (where float32 rounding may flip the hit)."""
    tq = (np.einsum('cij,nj->cni', tr[:, :3, :3].astype(np.float64), q)
          + tr[:, None, :3, 3])
    d2 = ((tq[:, :, None, :] - p[None, None]) ** 2).sum(-1).min(-1)
    return (np.abs(d2 - eps * eps) <= tol).sum(-1)


def test_lcp_scores_match_jax_oracle(rng):
    """LCP fractions equal ops.lcp.lcp_scores (the XLA oracle) except
    for queries whose d^2 lies within rounding of eps^2."""
    p = rng.uniform(-1, 1, (1200, 3)).astype(np.float32)
    q = (p[:300] + rng.normal(scale=0.006, size=(300, 3))).astype(
        np.float32)
    tr = _transforms(rng, 20, max_shift=0.05)
    tr[:5] = np.eye(4)                        # a few high-LCP candidates
    tr[:5, :3, 3] = rng.uniform(-0.01, 0.01, (5, 3))
    eps = 0.02
    ref = np.asarray(jax_lcp.lcp_scores(jnp.asarray(tr), jnp.asarray(q),
                                        jnp.asarray(p), eps))
    got = torch_lcp.lcp_scores(_t(tr), _t(q), _t(p), eps).numpy()
    slack = _near_threshold(tr, q, p, eps)
    assert np.all(np.abs(got - ref) * len(q) <= slack + 1e-3)
    assert ref.max() > 0.5                    # the test sees real hits
    single = torch_lcp.lcp_score_single(_t(tr[0]), _t(q), _t(p), eps)
    assert float(single) == got[0]


def test_masked_lcp_mean_q_pad_denominator():
    q = np.zeros((6, 3), np.float32)
    q[4:, 0] = 2.0e17                         # Q_PAD rows
    hits = np.array([[1, 1, 0, 0, 1, 1]], bool)
    ref = np.asarray(jax_lcp._masked_lcp_mean(jnp.asarray(hits),
                                              jnp.asarray(q)))
    got = torch_lcp._masked_lcp_mean(torch.as_tensor(hits), _t(q)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert got[0] == 0.5


def test_two_stage_selects_what_jax_selects(rng):
    """lcp_scores_two_stage with a live mask (and the mid stage, at
    nq > 1024): the same selected indices, in the same order, and the
    same exact scores. Candidates are translations of a shared cloud by
    distinct offsets, so their LCPs are well separated; dead slots and
    equal scores tie, broken toward the lower index by both."""
    p = rng.uniform(0, 1, (1500, 3)).astype(np.float32)
    q = p[:1100].copy()
    c = 40
    tr = np.tile(np.eye(4, dtype=np.float32), (c, 1, 1))
    shifts = rng.permutation(c) * 0.0013
    tr[:, 0, 3] = shifts
    live = np.ones(c, bool)
    live[::7] = False
    eps = 0.02
    ref_s, ref_i = jax_lcp.lcp_scores_two_stage(
        jnp.asarray(tr), jnp.asarray(q), jnp.asarray(p), eps,
        coarse_q=64, coarse_p=512, top_k=12, live=jnp.asarray(live))
    got_s, got_i = torch_lcp.lcp_scores_two_stage(
        _t(tr), _t(q), _t(p), eps, coarse_q=64, coarse_p=512, top_k=12,
        live=torch.as_tensor(live))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(ref_s), rtol=0,
                               atol=1.0 / len(q))
    # no candidate of the short path (c <= top_k) is dropped either
    s, i = torch_lcp.lcp_scores_two_stage(_t(tr[:5]), _t(q), _t(p), eps,
                                          top_k=12)
    assert i.tolist() == list(range(5))


def _interpreted():
    return mock.patch.object(lcp_pallas.pl, "pallas_call",
                             functools.partial(lcp_pallas.pl.pallas_call,
                                               interpret=True))


def test_lcp_min_d2_matches_streamed_kernel_interpreted(rng):
    """K3: the streamed-P TPU kernel (candidate_min_sq_dists_streamed, in
    interpret mode) has no separate counterpart: lcp_min_d2 streams P at
    any Np. Np spans three P tiles (1024). Tolerance 1e-6 absolute, as
    for K1 (the Pallas kernel applies the transform as a matrix
    product)."""
    p = rng.uniform(-1, 1, (2500, 3)).astype(np.float32)
    q = rng.uniform(-1, 1, (200, 3)).astype(np.float32)
    tr = _transforms(rng, 6)
    with _interpreted():
        ref = np.asarray(lcp_pallas.candidate_min_sq_dists_streamed(
            jnp.asarray(tr), jnp.asarray(q), jnp.asarray(p)))
    got = k1.lcp_min_d2(_t(tr), _t(q), _t(p)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_min_sq_dists_matches_resident_and_streamed_kernels(rng):
    """K4a and K4b: min_sq_dists (K1 with one identity transform on the
    card, its plain version here) against min_sq_dists and
    min_sq_dists_streamed in interpret mode, Np above one P tile.
    Tolerance 1e-6 absolute (XLA may contract the squares' sum into an
    FMA); the identity path equals the direct plain version bit for
    bit."""
    p = rng.uniform(-1, 1, (2100, 3)).astype(np.float32)
    tq = rng.uniform(-1, 1, (700, 3)).astype(np.float32)
    with _interpreted():
        ref_a = np.asarray(lcp_pallas.min_sq_dists(jnp.asarray(tq),
                                                   jnp.asarray(p)))
        ref_b = np.asarray(lcp_pallas.min_sq_dists_streamed(
            jnp.asarray(tq), jnp.asarray(p)))
    got = k1.min_sq_dists(_t(tq), _t(p))
    assert got.shape == (700,) and got.dtype == torch.float32
    for ref in (ref_a, ref_b):
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)
    eye = torch.eye(4)[None]
    assert torch.equal(k1.lcp_min_d2_plain(eye, _t(tq), _t(p))[0], got)
    assert torch.equal(k1.min_sq_dists_plain(_t(tq), _t(p)), got)
