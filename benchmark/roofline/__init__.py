"""Roofline arithmetic of the port's kernels, one module a kernel.

Each module names the function whose calls launch its kernel (``SPY``:
module and attribute; every module binding of that function is
watched), the program's launch counter on it (``COUNTER``), the kernel
names it times in the profiler's trace (``KERNELS``: substrings; the
first is counted once a launch), and ``work(args, kwargs, out)``: the
(bytes, float operations) one launch needs, from the call's shapes.
Bytes count each input read once and each output written once;
operations count only what the results the kernel emits need, never
the all-pairs tests a pruning kernel skips, so no implementation can
read above 100%.

The least time of a launch is the larger of its bytes over the card's
memory bandwidth and its operations over its float32 rate (``PEAKS``).
"""

from __future__ import annotations

import importlib
import subprocess

#: NVIDIA H100 SXM, NVIDIA's data sheet (dense, at the 700 W power
#: limit): float32 outside the tensor cores (every kernel of the port;
#: TF32 is off) and HBM3
PEAKS = dict(name="NVIDIA H100 80GB HBM3 (SXM data sheet, 700 W)",
             f32_flops=67.0e12, hbm_bytes_per_s=3.35e12)


def load(name: str):
    """The roofline module of kernel ``name`` (``roofline/<name>.py``)."""
    return importlib.import_module(f"roofline.{name}")


def least_seconds(nbytes: float, flops: float, peaks: dict = PEAKS) -> float:
    """The least time a launch of ``nbytes`` and ``flops`` can take."""
    return max(nbytes / peaks["hbm_bytes_per_s"], flops / peaks["f32_flops"])


def power_limit_w(index: int = 0):
    """Card ``index``'s power limit in watts (``nvidia-smi``), or None
    where it cannot be read: a card set below 700 W runs slower than
    the data sheet's peaks assume."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", str(index), "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30)
        return float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None
