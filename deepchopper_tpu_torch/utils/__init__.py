"""Host utilities: rank-aware logging, warning filters, record-length
summaries, target highlighting."""

from .pylogger import RankedLogger, suppress_warnings
from .stat import summary_bam_record_len, summary_fx_record_len, summary_record_len
from .vis import highlight_targets

__all__ = [
    "RankedLogger",
    "highlight_targets",
    "summary_bam_record_len",
    "summary_fx_record_len",
    "summary_record_len",
    "suppress_warnings",
]
