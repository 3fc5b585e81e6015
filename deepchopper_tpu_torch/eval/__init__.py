"""Evaluation: prediction statistics, the BAM overlap strategy, BLAT.

Copy of `deepchopper_tpu/eval/__init__.py`.
"""

from .blat import MIN_SEQ_SIZE, PslAlignment, blat, parse_psl, parse_psl_by_qname
from .stat import StatResult, collect_statistics_for_predicts
from .strategy import (
    OverlapOptions,
    collect_overlap_results_for_predict,
    collect_overlap_results_for_predicts,
    has_overlap,
)

__all__ = [
    "MIN_SEQ_SIZE",
    "OverlapOptions",
    "PslAlignment",
    "StatResult",
    "blat",
    "collect_overlap_results_for_predict",
    "collect_overlap_results_for_predicts",
    "collect_statistics_for_predicts",
    "has_overlap",
    "parse_psl",
    "parse_psl_by_qname",
]
