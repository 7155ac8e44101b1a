"""Named phase timers (ref:src/super4pcs/utils/timer.h:56-80).

The analog of the reference's TEST_GLOBAL_TIMINGS phase breakdown
(totalTime / verifyTime / kdTreeTime, ref:match4pcsBase.h:176-184):
the step's phases (``Options.phase_timing``) add up here; a
registration's own stages are its span table (``utils/profiling.py``).
"""

from __future__ import annotations


class PhaseTimers:
    """Named phase accumulator, mirroring the reference timing table
    (ref:match4pcsBase.hpp:77-83)."""

    def __init__(self):
        self.phases: dict[str, float] = {}

    def add(self, name: str, seconds: float):
        self.phases[name] = self.phases.get(name, 0.0) + seconds

    def table(self) -> str:
        lines = ["----------- Timings (msec) -------------"]
        for name, sec in self.phases.items():
            lines.append(f" {name:<24}: {sec * 1e3:.3f}")
        lines.append("----------------------------------------")
        return "\n".join(lines)
