"""The per-device capture context of ``utils/graphs.py`` on the CPU,
with a fake stream and a fake pool: a pool lent to one holder at a
time and given back on release and on collection, one capture stream; the
kinds of warm-up the record tells apart (``matcher.warm_kind``); and
the verify indexes a warm-up that runs no eager step builds
(``step.index_keys``) against those an eager step reads. The captures
themselves are held on the card in tests/test_torch_cuda.py."""

import gc
import weakref

import numpy as np
import pytest
import torch

import super4pcs_tpu_torch as s4t
from super4pcs_tpu_torch import matcher as tmatcher
from super4pcs_tpu_torch.ops import lcp
from super4pcs_tpu_torch.utils import graphs

from _torch_threads import one_torch_thread_per_worker  # noqa: F401


class _Fakes:
    """Counts the streams and pools a context makes and its waits."""

    def __init__(self):
        self.streams = self.pools = self.syncs = 0

    def stream(self):
        self.streams += 1
        return ("stream", self.streams)

    def pool(self):
        self.pools += 1
        return ("pool", self.pools)

    def sync(self):
        self.syncs += 1

    def context(self):
        return graphs.CaptureContext("fake", new_stream=self.stream,
                                     new_pool=self.pool, sync=self.sync)


class _Graph:
    """A captured graph, as a lease sees it."""


class _Holder:
    """A registration holding its lease."""

    def __init__(self, ctx):
        self.lease = ctx.lease()


def test_one_capture_stream_a_device():
    fakes = _Fakes()
    ctx = fakes.context()
    assert ctx.stream is ctx.stream
    assert fakes.streams == 1


def test_a_pool_comes_back_on_release_and_is_recycled():
    fakes = _Fakes()
    ctx = fakes.context()
    lease = ctx.lease()
    first = lease.id
    assert fakes.pools == 1 and fakes.syncs == 0
    del lease
    again = ctx.lease()
    # the pool given back, not a new one; the device waited for its
    # last holder's replays first
    assert again.id is first
    assert fakes.pools == 1 and fakes.syncs == 1


def test_a_pool_comes_back_when_its_holder_is_collected():
    fakes = _Fakes()
    ctx = fakes.context()
    holder = _Holder(ctx)
    first = holder.lease.id
    holder.cycle = holder               # only the collector frees it
    del holder
    assert ctx.lease().id != first
    gc.collect()
    assert ctx.lease().id == first


def test_a_pool_is_never_lent_to_a_second_live_holder():
    fakes = _Fakes()
    ctx = fakes.context()
    a, b = _Holder(ctx), _Holder(ctx)
    assert a.lease.id != b.lease.id
    # a graph captured into a's pool outlives a's own hold on it
    graph = _Graph()
    graph.pool = a.lease
    pool_a = a.lease.id
    a.lease = None
    c = _Holder(ctx)
    assert c.lease.id not in (pool_a, b.lease.id)
    del graph
    d = _Holder(ctx)
    assert d.lease.id == pool_a
    assert fakes.pools == 3
    assert len({h.lease.id for h in (b, c, d)}) == 3


def test_a_pool_keeps_its_last_graph_until_the_next_capture():
    """The last graph captured into a pool stays alive with it on the
    free list, which keeps the pool live, and goes once the next holder
    keeps its own."""
    ctx = _Fakes().context()
    lease = ctx.lease()
    old = _Graph()
    gone = weakref.ref(old)
    lease.keep(old)
    del old, lease
    assert gone() is not None
    again = ctx.lease()
    assert gone() is not None
    again.keep(_Graph())
    assert gone() is None


def test_the_warmed_record_is_the_contexts_own():
    fakes = _Fakes()
    one, two = fakes.context(), fakes.context()
    kind = tmatcher.warm_kind(s4t.Options(), "rowcap", refine=True)
    one.warmed.add(kind)
    assert kind in one.warmed and kind not in two.warmed


def _kind(engine="rowcap", refine=True, batch=False, **kw):
    return tmatcher.warm_kind(s4t.Options(**kw), engine, refine=refine,
                              batch=batch)


@pytest.mark.parametrize("other", [
    dict(engine="dense"), dict(engine="banded"),
    dict(rowcap_kernel="xla"),                      # K2x, not K2
    dict(max_normal_difference=20.0), dict(max_color_distance=60.0),
    dict(max_translation_distance=1.0), dict(max_angle=80.0),
    dict(estimate_scale=True), dict(refine=False), dict(batch=True)])
def test_the_warm_kind_separates(other):
    assert _kind(**other) != _kind()


def test_the_warm_kind_ignores_what_no_kernel_depends_on():
    assert _kind(delta=0.02, sample_size=2000, random_seed=3,
                 max_time_seconds=5) == _kind()


def test_the_capture_routes():
    assert _kind()[2] == "K2"
    assert _kind(rowcap_kernel="xla")[2] == "K2x"
    assert _kind(engine="rowcap", estimate_scale=True)[2] == "K2x"
    assert _kind(engine="dense")[2] is None


def _bumpy(rng, n):
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    bump = (1.0 + 0.3 * np.sin(5 * v[:, 0]) * np.cos(3 * v[:, 1])
            + 0.2 * np.sin(4 * v[:, 2]))
    return (v * bump[:, None]).astype(np.float32)


def _keys(keys):
    return {(int(s), float(np.float32(e))) for s, e in keys}


@pytest.mark.parametrize("c,nq,np_,top_k", [
    (8, 300, 900, 16),                 # every candidate exact
    (40, 300, 900, 16),                # coarse, then exact
    (40, 1100, 900, 16),               # coarse, mid, exact
    (40, 1100, 20000, 16)])
def test_two_stage_strides_are_the_indexes_the_verify_reads(c, nq, np_,
                                                             top_k):
    rng = np.random.default_rng(3)
    p = torch.as_tensor(_bumpy(rng, np_))
    q = torch.as_tensor(_bumpy(rng, nq))
    t = torch.eye(4).repeat(c, 1, 1)
    t[:, :3, 3] = torch.as_tensor(rng.normal(scale=0.01, size=(c, 3)),
                                  dtype=torch.float32)
    index = lcp.VerifyIndex(p)
    lcp.lcp_scores_two_stage(t, q, p, 0.05, coarse_p=512, top_k=top_k,
                             index=index)
    want = lcp.two_stage_strides(c, nq, np_, coarse_p=512, top_k=top_k)
    assert set(index._cache) == _keys((s, 0.05) for s in want)
    assert len(want) == {8: 1}.get(c, 3 if nq > 1024 else 2)


@pytest.mark.parametrize("kw", [
    dict(),                                         # one stage, delta
    dict(verify_top_k=64, coarse_p=16),             # coarse, then exact
    dict(search_delta_factor=1.5),                  # rank radius apart
    dict(verify_top_k=0, search_delta_factor=1.5),
    dict(verify_top_k=64, coarse_p=16, search_delta_factor=1.5)])
def test_index_keys_are_the_indexes_an_eager_step_reads(kw):
    """A matcher's step builds no index a warm-up that runs no eager
    step has not built from ``step.index_keys``: each eager step on a
    fresh index reads those and no other."""
    rng = np.random.default_rng(42)
    pos = _bumpy(rng, 150)[:80]
    q = (pos + np.float32([0.1, -0.05, 0.2])).astype(np.float32)
    opts = s4t.Options(delta=0.05, sample_size=80, max_quads=512,
                       max_candidates=1024, bases_per_step=2,
                       random_seed=7, **kw)
    m = s4t.MatchSuper4PCS(opts, device="cpu")
    m._init(s4t.PointCloud(pos), s4t.PointCloud(q))
    np_ = int(m._d_p_pos.shape[0])
    want = _keys(m._step_fn.index_keys(np_))
    for i in range(2):
        m._p_index = lcp.VerifyIndex(m._d_p_pos)
        m._run_step(i)
        assert set(m._p_index._cache) == want, i


def test_index_keys_are_the_indexes_a_batch_step_reads():
    """The same for ``register_batch``'s step over two pairs of other
    sizes (P padded to the larger)."""
    from super4pcs_tpu_torch.parallel.batch import BatchRun
    rng = np.random.default_rng(42)
    pairs = []
    for n in (80, 60):
        pos = _bumpy(rng, 150)[:n]
        pairs.append((s4t.PointCloud(pos),
                      s4t.PointCloud(pos + np.float32([0.1, 0.0, 0.2]))))
    opts = s4t.Options(delta=0.05, sample_size=80, max_quads=512,
                       max_candidates=1024, bases_per_step=2,
                       random_seed=7, verify_top_k=64, coarse_p=16,
                       search_delta_factor=1.5)
    run = BatchRun(pairs, opts, device="cpu")
    sh = run.shards[0]
    want = _keys(sh.step.index_keys(run.np_max))
    sh.p_index = lcp.VerifyIndex(sh.arrays[0])
    run.run_step(0)
    assert set(sh.p_index._cache) == want
    assert len(want) == 3
