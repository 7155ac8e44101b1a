from .logger import Logger, LogLevel
from .timer import Timer, PhaseTimers
from . import profiling

__all__ = ["Logger", "LogLevel", "Timer", "PhaseTimers", "profiling"]
