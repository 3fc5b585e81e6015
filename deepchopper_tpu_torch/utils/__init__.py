"""Host utilities: rank-aware logging and warning filters."""

from .pylogger import RankedLogger, suppress_warnings

__all__ = ["RankedLogger", "suppress_warnings"]
