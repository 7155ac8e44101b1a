"""Tracing and phase timing.

PyTorch counterpart of ``super4pcs_tpu.utils.profiling``. The
reference's opt-in ``ENABLE_TIMING`` accumulates three phase timers and
dumps a table (ref:src/super4pcs/algorithms/match4pcsBase.hpp:77-83,
utils/timer.h). Here:

- every registration's span table, in ``RegistrationResult.stats
  ["spans"]``: :func:`call` opens it around the registration and
  :func:`span` around each stage, under its path
  ("setup/warm/capture"). It keeps, per path, the count of its spans,
  their host seconds and, for the spans given a CUDA device, their
  device seconds (two events on the stream, read when the table
  closes), and the call's counters (:func:`count`, and on the card the
  device allocations it made). While a ``torch.profiler`` is active each
  span is also a ``record_function`` range named ``s4p.<path with
  dots>``, on the clock of the device's operations; with none active no
  span calls into the profiler. :func:`recent` gives the tables of the
  last registrations that returned in this process, for a monitor that
  does not hold their results;
- coarse wall-clock phases in ``RegistrationResult.stats``
  (``compile_seconds`` / ``search_seconds``), read from their spans'
  clocks;
- op-level device timelines from ``torch.profiler``, captured with
  :func:`trace` and viewable in Perfetto or TensorBoard;
- the phases of one step (``Options.phase_timing``), marked with
  :class:`PhaseMarks`: on the card CUDA events on the stream, on the
  CPU the wall clock. The JAX package times prefixes of its fused step
  program instead; PyTorch runs the phases as separate launches, so
  marks between them time each phase of one step directly.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import itertools
import time

import torch

#: the span table of the registration running in this context
_TABLE = contextvars.ContextVar("super4pcs_span_table", default=None)
#: registrations' ids, process-wide
_CALL_IDS = itertools.count(1)
#: how many of the last registrations' tables :func:`recent` keeps
RECENT_TABLES = 1024
_RECENT = collections.deque(maxlen=RECENT_TABLES)


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace (the host and, when a card is
    visible, the device) around a code block; it is written to
    ``log_dir`` as a ``*.pt.trace.json`` that Perfetto and TensorBoard
    read.

    Example::

        with profiling.trace("/tmp/s4p-trace"):
            matcher.compute_transformation(P, Q)
    """
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


def _event(device=None):
    """A timing event recorded on ``device``'s current stream."""
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


def _device_allocs(device) -> int:
    return torch.cuda.memory_stats(device).get("num_device_alloc", 0)


class SpanTable:
    """The spans of one registration. ``stats`` is its stored form:
    ``call`` (the registration's process-wide id), ``pairs`` (the pairs
    it registers), ``spans`` ({path:
    {"count", "host_s", "device_s"}}, the root "call" first, the others
    in the order they first opened; ``device_s`` None for a path with no
    device span), the counters added with :func:`count` (``index_builds``,
    ``refine_walks``, the refine's neighbour walks, and
    ``join_kernel_steps``, the steps whose join ran the join kernel, from
    0), and on
    the card ``device_allocs`` (the ``num_device_alloc`` of
    ``torch.cuda.memory_stats`` the call added)."""

    def __init__(self, device, pairs: int):
        self.device = device
        self.stats = {"call": next(_CALL_IDS), "pairs": pairs,
                      "spans": {"call": _row()}, "index_builds": 0,
                      "refine_walks": 0, "join_kernel_steps": 0}
        #: the open spans' paths, innermost last ("" the root's)
        self._open = [""]
        #: (row, start event, end event) of the device spans
        self._events = []
        self._allocs = (_device_allocs(device) if device.type == "cuda"
                        else None)

    def enter(self, name: str) -> str:
        top = self._open[-1]
        path = f"{top}/{name}" if top else name
        self._open.append(path)
        if path not in self.stats["spans"]:
            self.stats["spans"][path] = _row()
        return path

    def leave(self, path: str, seconds: float, events=None):
        self._open.pop()
        row = self.stats["spans"][path]
        row["count"] += 1
        row["host_s"] += seconds
        if events is not None:
            self._events.append((row, *events))

    def close(self, seconds: float):
        """The root's ``seconds``, then each device span's seconds (an
        end event not reached yet, as a step abandoned in flight, is
        waited for) and the allocations."""
        root = self.stats["spans"]["call"]
        root["count"] += 1
        root["host_s"] += seconds
        for row, start, end in self._events:
            end.synchronize()
            row["device_s"] = ((row["device_s"] or 0.0)
                               + start.elapsed_time(end) / 1e3)
        self._events = []
        if self._allocs is not None:
            self.stats["device_allocs"] = (_device_allocs(self.device)
                                           - self._allocs)


def _row() -> dict:
    return {"count": 0, "host_s": 0.0, "device_s": None}


def _profiler_range(path: str):
    """The profiler range of a span at ``path``, entered; None when no
    profiler is active."""
    if not torch.autograd.profiler._is_profiler_enabled:
        return None
    rng = torch.autograd.profiler.record_function(
        "s4p." + path.replace("/", "."))
    rng.__enter__()
    return rng


class span:
    """A stage of the registration running in this context, under the
    span open around it: ``with span("warm"):``. ``seconds`` holds its
    host seconds once it has closed, also outside any registration,
    where it records nothing. ``device``: a CUDA device whose current
    stream runs the stage's launches; the span then records an event on
    it at each end (not while that stream is being captured into a
    graph), and its table reads their elapsed time when it closes."""

    __slots__ = ("name", "device", "seconds", "_t0", "_table", "_path",
                 "_range", "_start")

    def __init__(self, name: str, device=None):
        self.name, self.device = name, device
        self.seconds = 0.0

    def __enter__(self):
        table = self._table = _TABLE.get()
        self._range = self._start = None
        if table is not None:
            self._path = table.enter(self.name)
            self._range = _profiler_range(self._path)
            dev = self.device
            if (dev is not None and torch.device(dev).type == "cuda"
                    and not torch.cuda.is_current_stream_capturing()):
                self._start = _event(dev)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        table = self._table
        events = (None if self._start is None
                  else (self._start, _event(self.device)))
        self.seconds = time.perf_counter() - self._t0
        if table is not None:
            table.leave(self._path, self.seconds, events)
            if self._range is not None:
                self._range.__exit__(None, None, None)
        return False


@contextlib.contextmanager
def call(device, pairs: int = 1):
    """The span of one registration of ``pairs`` pairs on ``device``;
    yields the stored form of its table (:class:`SpanTable`), which is
    complete once the outermost registration has returned, and then
    joins :func:`recent`. Outside any registration it opens a new table,
    the root "call"; inside another one (a batch's straggler, a half of
    a hierarchical similarity run) it is a span "call" under the span
    open there, in that table."""
    table = _TABLE.get()
    if table is not None:
        with span("call"):
            yield table.stats
        return
    table = SpanTable(torch.device(device), pairs)
    token = _TABLE.set(table)
    rng = _profiler_range("call")
    t0 = time.perf_counter()
    returned = False
    try:
        yield table.stats
        returned = True
    finally:
        seconds = time.perf_counter() - t0
        _TABLE.reset(token)
        table.close(seconds)
        if rng is not None:
            rng.__exit__(None, None, None)
        if returned:
            _RECENT.append(table.stats)


def recent(n: int) -> list:
    """The stored tables of the last ``n`` outermost registrations that
    returned in this process (a registration that raised leaves none),
    oldest first; at most :data:`RECENT_TABLES`."""
    return list(_RECENT)[-n:] if n > 0 else []


def count(name: str, n: int):
    """Add ``n`` to the counter ``name`` of the registration running in
    this context (nothing outside one)."""
    table = _TABLE.get()
    if table is not None:
        table.stats[name] = table.stats.get(name, 0) + n


class PhaseMarks:
    """Marks between the phases of one step on ``device``:
    ``mark(name)`` ends the running phase and starts ``name`` (a name
    may recur: its spans add up), ``stop()`` ends the last one. On a
    CUDA device a mark records an event on the current stream, so a
    phase's span is the device's time between the marks, idle gaps
    included; on the CPU a mark reads the wall clock (torch's CPU ops
    are synchronous)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self._marks = []

    def _now(self):
        return _event(self.device) if self.cuda else time.perf_counter()

    def mark(self, name: str):
        self._marks.append((name, self._now()))

    def stop(self):
        self.mark(None)

    def seconds(self) -> dict:
        """{phase: seconds} of the marked spans (synchronizes with the
        last event on the card)."""
        out = {}
        if self.cuda and self._marks:
            self._marks[-1][1].synchronize()
        for (name, a), (_, b) in zip(self._marks, self._marks[1:]):
            dt = (a.elapsed_time(b) / 1e3 if self.cuda else b - a)
            out[name] = out.get(name, 0.0) + dt
        return out
