"""Faults planted under a run, to show that its check catches them.

Each is a context manager that breaks the port's timed path from the
benchmark's side and puts it back. The tests (``tests/``) and the chip
readings (``control.py``) run a cell under each and expect ``correct``
to come out false.

- ``state_unchanged``: a search step that leaves the best-so-far as it
  was (the single-pair search loop runs no step; a batch step adopts
  nothing): every pair comes back at the identity.
- ``half_the_samples``: the verify's mean taken over the first half of
  the source samples only, the rest left out.
- ``half_the_pairs``: a batch call that leaves out the second half of
  each device's pairs (on one device, of the call's): no step, refine
  or straggler redemption adopts anything for them, so they come back
  at their starting state. Over several cards every process leaves out
  the same pairs.
- ``exchange_left_out``: over several cards, each process keeps only
  its own shard's step and refine results and takes the other shards'
  pairs as unimproved (on one device it changes nothing).
- ``answer_altered``: each answer's transform moved by 0.5 in x where
  it is produced (the single-pair matcher's recomposed transform; a
  batch step's candidates), its score left as it was.
"""

from __future__ import annotations

import contextlib

import numpy as np


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


@contextlib.contextmanager
def state_unchanged():
    from super4pcs_tpu_torch import matcher
    from super4pcs_tpu_torch.parallel import batch
    run_step = batch.BatchRun.run_step

    def step(self, step_idx):
        out = run_step(self, step_idx)
        if step_idx >= 0:
            out["lcp"] = np.full_like(out["lcp"], -1.0)
        return out

    with _patched(matcher.MatchSuper4PCS, "_perform_steps",
                  lambda self, visitor, **kw: None), \
            _patched(batch.BatchRun, "run_step", step):
        yield


@contextlib.contextmanager
def half_the_samples():
    import torch
    from super4pcs_tpu_torch.ops import lcp

    def mean(hits, q_pos):
        half = q_pos.shape[-2] // 2
        qm = lcp.q_valid_mask(q_pos)[..., :half]
        denom = torch.clamp(qm.sum(dim=-1, dtype=torch.float32), min=1.0)
        if q_pos.ndim == 3:
            qm, denom = qm[:, None, :], denom[:, None]
        return (hits[..., :half] & qm).sum(dim=-1,
                                            dtype=torch.float32) / denom

    with _patched(lcp, "_masked_lcp_mean", mean):
        yield


@contextlib.contextmanager
def answer_altered():
    from super4pcs_tpu_torch import matcher
    from super4pcs_tpu_torch.parallel import batch
    recompose = matcher.MatchSuper4PCS._global_transform
    run_step = batch.BatchRun.run_step

    def moved(self):
        out = recompose(self)
        out[0, 3] += 0.5
        return out

    def step(self, step_idx):
        out = run_step(self, step_idx)
        out["transform"] = out["transform"].copy()
        out["transform"][..., 0, 3] += 0.5
        return out

    with _patched(matcher.MatchSuper4PCS, "_global_transform", moved), \
            _patched(batch.BatchRun, "run_step", step):
        yield


def _second_halves(run) -> np.ndarray:
    """(G,) bool: the second half of each device's pairs of the batch
    ``run``, over every device of its mesh."""
    out = np.zeros(run.g, bool)
    for i in range(run.mesh.size):
        lo, hi = run.mesh.bounds(run.g, i)
        out[lo + (hi - lo) // 2:hi] = True
    return out


def _others(run) -> np.ndarray:
    """(G,) bool: the pairs of the batch ``run`` that other processes'
    shards hold."""
    out = np.ones(run.g, bool)
    for i in run.mesh.local_shards():
        lo, hi = run.mesh.bounds(run.g, i)
        out[lo:hi] = False
    return out


@contextlib.contextmanager
def half_the_pairs():
    from super4pcs_tpu_torch.parallel import batch
    init = batch.BatchRun.__init__
    run_step = batch.BatchRun.run_step
    refine_pairs = batch.BatchRun.refine_pairs

    def start(self, *a, **kw):
        init(self, *a, **kw)
        # no straggler redemption either
        self.opts = self.opts.replace(search_escalation_factor=0.0)

    def step(self, step_idx):
        out = run_step(self, step_idx)
        if step_idx >= 0:
            out["lcp"] = out["lcp"].copy()
            out["lcp"][_second_halves(self)] = -1.0
        return out

    def refine(self, src):
        refined, scores = refine_pairs(self, src)
        scores = np.array(scores, copy=True)
        scores[_second_halves(self)] = -np.inf
        return refined, scores

    with _patched(batch.BatchRun, "__init__", start), \
            _patched(batch.BatchRun, "run_step", step), \
            _patched(batch.BatchRun, "refine_pairs", refine):
        yield


@contextlib.contextmanager
def exchange_left_out():
    from super4pcs_tpu_torch.parallel import batch
    run_step = batch.BatchRun.run_step
    refine_pairs = batch.BatchRun.refine_pairs

    def step(self, step_idx):
        out = run_step(self, step_idx)
        if step_idx >= 0:
            out["lcp"] = out["lcp"].copy()
            out["lcp"][_others(self)] = -1.0
        return out

    def refine(self, src):
        refined, scores = refine_pairs(self, src)
        scores = np.array(scores, copy=True)
        scores[_others(self)] = -np.inf
        return refined, scores

    with _patched(batch.BatchRun, "run_step", step), \
            _patched(batch.BatchRun, "refine_pairs", refine):
        yield


FAULTS = {"state_unchanged": state_unchanged,
          "half_the_samples": half_the_samples,
          "half_the_pairs": half_the_pairs,
          "answer_altered": answer_altered,
          "exchange_left_out": exchange_left_out}
