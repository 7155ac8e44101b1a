"""What a traced run (``--trace 1``) watches, from the benchmark's side.

:class:`Watch` puts proxies in place of a few of the port's functions,
in every module of the port that binds them, and takes them out again:

- the refine (``ops.refine.refine_transform``): each call timed by the
  host clock between two ``torch.cuda.synchronize()``, inside a
  ``record_function("refine")`` range;
- the sampling (``ops.sampling.sample_for_matching``): a
  ``record_function("sampling")`` range;
- each roofline kernel's launching function (``roofline/<kernel>.py``
  ``SPY``): while a stretch is recorded, the (bytes, operations) of
  every call, apart for calls made while a CUDA graph is captured (they
  run again at every replay);
- over several cards (``exchange``), the port's collectives
  (``torch.distributed``'s :data:`EXCHANGE`, which the port looks up on
  ``torch.distributed`` at each call): each call timed by the host
  clock, waits for the other processes included, inside a
  ``record_function("exchange")`` range. The harness's own collectives
  call ``torch.distributed.distributed_c10d``'s functions, which stay
  unwatched.

A proxy forwards attribute reads and writes to the function it wraps,
so the port's launch counters on it keep working.

:class:`Stretch` runs ``torch.profiler`` over part of the window and
reduces its trace to kernel time by name, the device's busy time (the
union of its operations' intervals), the longest idle gaps labelled by
the innermost host range open at their middle (else "after" the last
one that ended before it), and each roofline kernel's least time per
launch against its device time per launch.
"""

from __future__ import annotations

import sys
import time

import torch

import roofline


class _Proxy:
    def __init__(self, fn, on_call):
        object.__setattr__(self, "_fn", fn)
        object.__setattr__(self, "_on_call", on_call)

    def __call__(self, *args, **kwargs):
        return self._on_call(self._fn, args, kwargs)

    def __getattr__(self, name):
        return getattr(self._fn, name)

    def __setattr__(self, name, value):
        setattr(self._fn, name, value)


#: the ``torch.distributed`` functions of the port's collectives: each
#: step's per-pair results and process 0's clock
EXCHANGE = ("all_gather_object", "broadcast")


def _port_modules():
    return [m for name, m in list(sys.modules.items())
            if m is not None and (name == "super4pcs_tpu_torch"
                                  or name.startswith("super4pcs_tpu_torch."))]


class _KernelWork:
    def __init__(self, name):
        mod = roofline.load(name)
        self.name, self.mod = name, mod
        self.fn = getattr(sys.modules[mod.SPY[0]], mod.SPY[1])
        self.recording = False
        self.eager, self.captured = [], []
        self.calls = 0
        self.start_count = 0

    def counter(self):
        return getattr(self.fn, self.mod.COUNTER, None)

    def on_call(self, fn, args, kwargs):
        out = fn(*args, **kwargs)
        if self.recording and isinstance(out, (torch.Tensor, tuple)):
            first = out if isinstance(out, torch.Tensor) else out[0]
            if first.device.type == "cuda":
                least = roofline.least_seconds(
                    *self.mod.work(args, kwargs, out))
                (self.captured if torch.cuda.is_current_stream_capturing()
                 else self.eager).append(least)
        return out

    def start(self):
        self.eager, self.captured = [], []
        self.start_count = self.counter() or 0
        self.recording = True

    def stop(self) -> dict:
        """Least seconds summed over the stretch's launches, and the
        launches: those the program's counter counts (replays included),
        each replayed one at the mean of the captured calls."""
        self.recording = False
        launches = (self.counter() or 0) - self.start_count
        least = sum(self.eager)
        replayed = launches - len(self.eager)
        if replayed > 0 and self.captured:
            least += replayed * sum(self.captured) / len(self.captured)
        elif replayed > 0:
            launches = len(self.eager)
        return dict(least_s=least, launches=launches)


class Watch:
    """The traced run's proxies (see the module doc)."""

    def __init__(self, kernels=(), exchange: bool = False):
        from super4pcs_tpu_torch.ops import refine, sampling
        self.refine_s = []
        self.exchange = exchange
        self.exchange_s = []
        self.kernels = {k: _KernelWork(k) for k in kernels}
        self._targets = [
            (refine.refine_transform, self._timed_refine),
            (sampling.sample_for_matching, self._ranged("sampling"))]
        self._targets += [(w.fn, w.on_call) for w in self.kernels.values()]
        self._names = []
        if exchange:
            import torch.distributed as dist
            self._names = [(dist, name) for name in EXCHANGE]
        self._undo = []

    def _timed_refine(self, fn, args, kwargs):
        sync = args[1].device.type == "cuda"
        with torch.profiler.record_function("refine"):
            if sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            if sync:
                torch.cuda.synchronize()
            self.refine_s.append(time.perf_counter() - t0)
        return out

    def _timed_exchange(self, fn, args, kwargs):
        with torch.profiler.record_function("exchange"):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.exchange_s.append(time.perf_counter() - t0)

    @staticmethod
    def _ranged(label):
        def on_call(fn, args, kwargs):
            with torch.profiler.record_function(label):
                return fn(*args, **kwargs)
        return on_call

    def __enter__(self):
        for fn, on_call in self._targets:
            proxy = _Proxy(fn, on_call)
            for mod in _port_modules():
                for attr, value in list(vars(mod).items()):
                    if value is fn:
                        setattr(mod, attr, proxy)
                        self._undo.append((mod, attr, fn))
        for mod, attr in self._names:
            fn = getattr(mod, attr)
            setattr(mod, attr, _Proxy(fn, self._timed_exchange))
            self._undo.append((mod, attr, fn))
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in reversed(self._undo):
            setattr(mod, attr, fn)
        self._undo = []
        return False


class Stretch:
    """``torch.profiler`` over part of the window (``start``/``stop``);
    ``stop`` returns the reduced trace (see the module doc)."""

    def __init__(self, watch: Watch):
        self.watch = watch
        self.prof = None

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        for w in self.watch.kernels.values():
            w.start()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self) -> "Stretch":
        """Ends the stretch; :meth:`reduce` reads it."""
        torch.cuda.synchronize()
        self.window = time.perf_counter() - self.t0
        self.prof.stop()
        self.work = {k: w.stop() for k, w in self.watch.kernels.items()}
        self.stop_s = time.perf_counter() - self.t0 - self.window
        return self

    def reduce(self) -> dict:
        out = reduce_events(self.prof.events(), self.window)
        out["work"] = self.work
        self.prof = None
        return out


def _merged(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def reduce_events(events, window_s: float, gaps: int = 10) -> dict:
    """Kernel seconds and launches by name, busy seconds (the union of
    the device's operation intervals), and the ``gaps`` longest idle
    gaps between them, each named by the innermost host range open at
    its middle (else "after" the last one that ended before it), from a
    profiler's ``events()``."""
    cuda = torch.autograd.DeviceType.CUDA
    by_name, dev, host = {}, [], []
    for e in events:
        tr = e.time_range
        if e.device_type == cuda:
            if getattr(e, "is_user_annotation", False):
                continue
            dev.append((tr.start, tr.end))
            s, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (s + (tr.end - tr.start) * 1e-6, n + 1)
        else:
            host.append((tr.start, tr.end, e.name))
    merged = _merged(dev)
    busy = sum(e - s for s, e in merged) * 1e-6
    holes = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1],
                     merged[i + 1][0]) for i in range(len(merged) - 1)),
                   reverse=True)[:gaps]
    named = []
    for length, s, e in holes:
        mid = 0.5 * (s + e)
        around = [h for h in host if h[0] <= mid <= h[1]]
        if around:
            label = min(around, key=lambda h: h[1] - h[0])[2]
        else:
            before = [h for h in host if h[1] <= mid]
            label = ("after " + max(before, key=lambda h: h[1])[2]
                     if before else "before any host range")
        named.append([label, length * 1e-6])
    return dict(kernels={k: list(v) for k, v in by_name.items()},
                busy_s=busy, window_s=window_s, idle_gaps=named)


def roofline_share(trace: dict, kernel: str):
    """Percent of its roofline that kernel ``kernel`` ran at in the
    stretch: its least time per launch over its device time per launch
    (the profiler's records of its first kernel name count launches:
    the trace may drop a record now and then), or None when the stretch
    launched or recorded none."""
    if not trace or kernel not in trace.get("work", {}):
        return None
    mod = roofline.load(kernel)
    work = trace["work"][kernel]
    device_s = records = 0
    for name, (secs, n) in trace["kernels"].items():
        if any(k in name for k in mod.KERNELS):
            device_s += secs
        if mod.KERNELS[0] in name:
            records += n
    if work["launches"] <= 0 or records <= 0 or device_s <= 0:
        return None
    return 100.0 * (work["least_s"] / work["launches"]) / (
        device_s / records)
