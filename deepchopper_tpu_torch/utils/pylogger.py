"""Rank-aware logging and curated third-party warning filters.

Port of `deepchopper_tpu/utils/pylogger.py` (the reference's RankedLogger,
deepchopper/utils/pylogger.py:12-57, and its curated warning list,
deepchopper/utils/suppress_warnings.py:44-97). The rank comes from
`torch.distributed` when a group is up, else 0; the filters target the
noise of PyTorch and its distributed plane.
"""

from __future__ import annotations

import logging
import warnings

import torch.distributed as dist


class RankedLogger(logging.LoggerAdapter):
    """Prefixes messages with the rank; `rank_zero_only=True` drops messages
    on the other ranks (a multi-rank run logs once)."""

    def __init__(self, name: str = __name__, rank_zero_only: bool = False):
        super().__init__(logging.getLogger(name), {})
        self.rank_zero_only = rank_zero_only

    @staticmethod
    def _rank() -> int:
        return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0

    def log(self, level: int, msg, *args, **kwargs) -> None:
        if not self.isEnabledFor(level):
            return
        rank = self._rank()
        if self.rank_zero_only and rank != 0:
            return
        super().log(level, f"[rank {rank}] {msg}", *args, **kwargs)


_SUPPRESSED: list[tuple[type[Warning], str]] = [
    (UserWarning, r".*TypedStorage is deprecated.*"),
    (UserWarning, r".*is_sparse.*deprecated.*"),
    (UserWarning, r".*barrier\(\).*using the device under current context.*"),
    (UserWarning, r".*No device id is provided via `init_process_group` or `barrier `.*"),
    (FutureWarning, r".*torch\.cuda\.amp.*deprecated.*"),
    (FutureWarning, r".*`torch\.distributed\._.*` is deprecated.*"),
]


_SAVED_FILTERS: list | None = None


def suppress_warnings(verbose: bool = False) -> None:
    """Install the curated warning filters; `verbose=True` removes them again
    (reference contract: deepchopper/cli.py:92-94 --verbose).

    Only these filters are added and removed, never `warnings.resetwarnings()`,
    which would wipe the user's -W / PYTHONWARNINGS configuration too."""
    global _SAVED_FILTERS
    if verbose:
        if _SAVED_FILTERS is not None:
            warnings.filters[:] = _SAVED_FILTERS
            _SAVED_FILTERS = None
        return
    if _SAVED_FILTERS is None:
        _SAVED_FILTERS = list(warnings.filters)
    for category, pattern in _SUPPRESSED:
        warnings.filterwarnings("ignore", message=pattern, category=category)
