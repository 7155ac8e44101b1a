"""CUDA graphs of the matcher's device step.

On the card one step is ~800-1000 launches (torch ops and the two
hand-written kernels), and one host thread issuing them takes longer
than the card takes to run them at most of the port's sizes (PERF.md,
section 5). The port captures the step once per run, as ``step.run``
runs it, and its one anytime loop replays the capture: one launch a
step, with the step's inputs and outputs at fixed addresses. (The JAX
package answers the same overhead with its fused K-step dispatch,
which the port does not have.)

:class:`StepGraph` holds one captured call. The kernel wrappers count
their launches in plain Python integers, registered here by their
modules (:func:`launch_counter`), which a replay does not touch: the
capture records what it added to each (:class:`LaunchRecord`) and every
replay adds it again, so a count keeps meaning the kernel launches that
ran. :class:`HostCopies` brings a replay's outputs to the host behind
an event, so that the host can enqueue the next step first.

Warm once per process, not once per call. A graph is still captured
once per registration: P's sample size, the diameter and P's verify
index are baked into it, and they change from pair to pair. What the
capture needs around it lives in the device's :class:`CaptureContext`
(:func:`context`) for the whole process: one capture stream, whose
cached blocks and library workspaces every later capture finds; a
free list of graph memory pools, each lent to one registration at a
time (:class:`PoolLease`) and kept live between registrations, so that
a capture after the first ones finds its blocks cached and the call's
end frees none; and the record of the
step kinds already warmed there (``CaptureContext.warmed``, keyed by
``matcher.warm_kind``). The first registration of a kind in the process
still pays the whole warm-up: an eager step and an eager run on the
capture stream before the capture (the CUDA libraries' first calls,
their handles and workspaces, the kernels' first loads), a replay and
a refine, all thrown away, besides the capture itself and the pool's
first ``cudaMalloc``s. A later one of that kind captures alone.
"""

from __future__ import annotations

import os
import re
import threading
import weakref

import torch

#: (object, attribute) of every launch counter; the kernel modules
#: register theirs (:func:`launch_counter`)
COUNTERS = []


def launch_counter(obj, *attrs):
    """Register the integer attributes ``attrs`` of ``obj`` as launch
    counters, which :class:`LaunchRecord` keeps true across replays."""
    COUNTERS.extend((obj, a) for a in attrs)


class LaunchRecord:
    """The launch counts a block adds (``with LaunchRecord() as rec:``),
    taken back when the block ends: a capture records its kernels but
    runs none. :meth:`replay` adds them once more, for each run of what
    the block recorded. ``increments`` follows ``counters``, the
    registered counters at the block's start."""

    def __enter__(self):
        self.counters = list(COUNTERS)
        self._before = [getattr(o, a) for o, a in self.counters]
        return self

    def __exit__(self, *exc):
        self.increments = [getattr(o, a) - b for (o, a), b
                           in zip(self.counters, self._before)]
        for (o, a), b in zip(self.counters, self._before):
            setattr(o, a, b)
        return False

    def replay(self):
        for (o, a), inc in zip(self.counters, self.increments):
            setattr(o, a, getattr(o, a) + inc)


class StepGraph:
    """``fn(*inputs)`` captured into a CUDA graph; a call replays it.

    ``inputs``: tensors on ``device``. The graph reads copies of them
    (``self.inputs``), and a call copies its arguments into those first.
    ``fn`` returns a tensor, or a tuple or dict of tensors: ``outputs``,
    which every replay overwrites in place. ``pool``: the
    :class:`PoolLease` of the memory pool the run leases; the graph
    holds it, so the pool goes back to the free list only once no graph
    captured into it is left. A call enqueues on ``device``'s current stream, whichever
    card is current.

    The capture runs on ``device``'s capture stream (:func:`context`).
    With ``prerun`` ``fn`` first runs once eagerly on that stream
    (library handles and workspaces are made per stream, and a kernel
    is loaded at its first launch): the first capture of a kind of step
    in the process needs it, a later one does not. A capture that fails
    raises: nothing falls back to eager launches. ``fn`` must not read
    device values on the host or copy host memory to the device
    (tests/test_torch_dispatch.py holds the matcher's step to that on
    the CPU).
    """

    def __init__(self, fn, inputs, *, device, pool=None, prerun=True):
        self.device = device = torch.device(device)
        self.pool = pool
        self.inputs = tuple(t.clone() for t in inputs)
        ctx = context(device)
        stream = ctx.stream
        current = torch.cuda.current_stream(device)
        with ctx.capture_lock:
            stream.wait_stream(current)
            if prerun:
                with torch.cuda.stream(stream):
                    fn(*self.inputs)
            # the captured graph is kept beside its executable (host
            # memory) for kernel_nodes
            self.graph = torch.cuda.CUDAGraph(keep_graph=True)
            # capture_begin itself, not torch.cuda.graph, whose entry
            # empties the allocator's cache: the blocks the next calls
            # would find cached
            with LaunchRecord() as self.launches, torch.cuda.stream(stream):
                self.graph.capture_begin(
                    pool=None if pool is None else pool.id)
                try:
                    self.outputs = fn(*self.inputs)
                finally:
                    self.graph.capture_end()
            self.graph.instantiate()
            current.wait_stream(stream)
        if pool is not None:
            pool.keep(self.graph)

    def __call__(self, *inputs):
        with torch.cuda.device(self.device):
            for dst, src in zip(self.inputs, inputs):
                dst.copy_(src)
            self.graph.replay()
        self.launches.replay()
        return self.outputs

    def kernel_nodes(self, path: str) -> list:
        """The label of every kernel node of the graph (each names its
        kernel), from CUDA's DOT dump written to ``path`` and removed."""
        self.graph.debug_dump(path)
        try:
            with open(path) as fh:
                text = fh.read()
        finally:
            os.remove(path)
        heads = list(re.finditer(r'"\w+_node_\d+"\s*\[', text))
        blocks = [text[h.end():(heads[j + 1].start() if j + 1 < len(heads)
                                else len(text))]
                  for j, h in enumerate(heads)]
        return [b for b in blocks if "KERNEL" in b]


class HostCopies:
    """Two pinned host copies of a dict of tensors on ``device``: the
    card fills one (:meth:`put`, behind an event on ``device``'s current
    stream) while the host reads the other (:meth:`get`). A handle must
    be read before the copy after next is put."""

    def __init__(self, like: dict, device):
        self.device = torch.device(device)
        self._slots = [({k: torch.empty(v.shape, dtype=v.dtype,
                                        pin_memory=True)
                         for k, v in like.items()}, torch.cuda.Event())
                       for _ in range(2)]
        self._next = 0

    def put(self, src: dict):
        host, event = self._slots[self._next]
        self._next ^= 1
        with torch.cuda.device(self.device):
            for k, v in src.items():
                host[k].copy_(v, non_blocking=True)
            event.record(torch.cuda.current_stream(self.device))
        return host, event

    @staticmethod
    def get(handle) -> dict:
        """The copies of ``handle`` (numpy), once they have landed."""
        host, event = handle
        event.synchronize()
        return {k: v.numpy().copy() for k, v in host.items()}


class PoolLease:
    """A graph memory pool (``id``, the token a capture takes) lent by a
    :class:`CaptureContext`. Whoever captures into it holds the lease:
    the registration while it captures, and each graph captured
    (``StepGraph.pool``). The pool goes back to the context's free list
    when the last holder lets the lease go, by release or by collection,
    and never while a graph captured into it is alive."""

    __slots__ = ("id", "_kept", "__weakref__")

    def __init__(self, pool_id, kept: list):
        self.id = pool_id
        self._kept = kept

    def keep(self, graph):
        """Keep ``graph``, the last one captured into the pool, until
        the next capture into it has begun. A pool all of whose graphs
        are gone is no longer live: PyTorch would free its blocks and
        refuse its id to a new capture. A kept graph that nothing
        replays holds none of the pool's blocks."""
        self._kept[:] = [graph]


class CaptureContext:
    """What the graphs captured on ``device`` share for the whole
    process (see the module docstring): the capture stream
    (``stream``, made at its first use), the free list of graph memory
    pools (:meth:`lease`), the lock of the stream's captures
    (``capture_lock``), and ``warmed``, the kinds of step already warmed
    on this device (``matcher.warm_kind``).

    ``new_stream``, ``new_pool`` and ``sync`` make a stream, make a pool
    id and wait for the device: by default a ``torch.cuda.Stream``,
    ``torch.cuda.graph_pool_handle()`` and ``torch.cuda.synchronize`` on
    ``device``."""

    def __init__(self, device, new_stream=None, new_pool=None, sync=None):
        self._new_stream = new_stream or (lambda: torch.cuda.Stream(device))
        self._new_pool = new_pool or torch.cuda.graph_pool_handle
        self._sync = sync or (lambda: torch.cuda.synchronize(device))
        self._stream = None
        #: (pool id, its kept graph) of each pool given back
        self._free = []
        self._lock = threading.Lock()
        self.capture_lock = threading.Lock()
        self.warmed = set()

    @property
    def stream(self):
        with self._lock:
            if self._stream is None:
                self._stream = self._new_stream()
            return self._stream

    def lease(self) -> PoolLease:
        """A pool for one registration's graphs: the one given back
        last, else a new one."""
        with self._lock:
            entry = self._free.pop() if self._free else None
        if entry is None:
            entry = (self._new_pool(), [])
        else:
            # its last holder's replays may still run: they end before
            # a capture reuses their blocks
            self._sync()
        lease = PoolLease(*entry)
        weakref.finalize(lease, self._give_back, entry).atexit = False
        return lease

    def _give_back(self, entry):
        with self._lock:
            self._free.append(entry)


#: the capture context of each device of this process
_CONTEXTS = {}
_CONTEXTS_LOCK = threading.Lock()


def context(device) -> CaptureContext:
    """The capture context of CUDA ``device`` (the current card when it
    has no index), made at its first use and kept for the process."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    with _CONTEXTS_LOCK:
        ctx = _CONTEXTS.get(device)
        if ctx is None:
            ctx = _CONTEXTS[device] = CaptureContext(device)
    return ctx
