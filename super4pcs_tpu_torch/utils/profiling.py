"""Tracing and phase timing.

PyTorch counterpart of ``super4pcs_tpu.utils.profiling``. The
reference's opt-in ``ENABLE_TIMING`` accumulates three phase timers and
dumps a table (ref:src/super4pcs/algorithms/match4pcsBase.hpp:77-83,
utils/timer.h). Here:

- coarse wall-clock phases in ``RegistrationResult.stats``
  (``compile_seconds`` / ``search_seconds``);
- op-level device timelines from ``torch.profiler``, captured with
  :func:`trace` and viewable in Perfetto or TensorBoard;
- the phases of one step (``Options.phase_timing``), marked with
  :class:`PhaseMarks`: on the card CUDA events on the stream, on the
  CPU the wall clock. The JAX package times prefixes of its fused step
  program instead; PyTorch runs the phases as separate launches, so
  marks between them time each phase of one step directly.
"""

from __future__ import annotations

import contextlib
import time

import torch

from .timer import PhaseTimers


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


@contextlib.contextmanager
def timed_phase(timers: PhaseTimers, name: str, sync=None):
    """Accumulate a wall-clock phase; ``sync`` (a tensor or a device)
    names the CUDA device to synchronize before the clock stops, so that
    asynchronous device work is counted in the phase."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if sync is not None:
            dev = sync.device if torch.is_tensor(sync) else torch.device(sync)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        timers.add(name, time.perf_counter() - t0)


class PhaseMarks:
    """Marks between the phases of one step on ``device``:
    ``mark(name)`` ends the running phase and starts ``name`` (a name
    may recur: its spans add up), ``stop()`` ends the last one. On a
    CUDA device a mark records an event on the current stream, so a
    phase's span is the device's time between the marks, idle gaps
    included; on the CPU a mark reads the wall clock (torch's CPU ops
    are synchronous)."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self._marks = []

    def _now(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

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
