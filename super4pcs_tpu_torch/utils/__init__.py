from .logger import Logger, LogLevel
from .timer import PhaseTimers
from . import profiling

__all__ = ["Logger", "LogLevel", "PhaseTimers", "profiling"]
