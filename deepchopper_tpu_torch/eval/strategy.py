"""BAM overlap evaluation strategy.

Copy of `deepchopper_tpu/eval/strategy.py`: classify each predicted adapter
interval against the aligned read's softclips into terminal/internal x
softclip/no-softclip x BLAT-outcome categories, and drive a whole run over
(BAM, prediction shards) that writes `stats_pd{N}_bt{M}.json` and
`overlap_results_spd{S}_pd{N}.json`.
"""

from __future__ import annotations

import dataclasses
import json
import logging
from pathlib import Path
from typing import TYPE_CHECKING

from .. import default
from .blat import MIN_SEQ_SIZE, blat
from .stat import StatResult, collect_statistics_for_predicts

if TYPE_CHECKING:  # pragma: no cover
    from ..io.bam import BamRecord
    from ..io.predicts import Predict

log = logging.getLogger(__name__)

OverlapResults = dict[str, list[str]]


@dataclasses.dataclass
class OverlapOptions:
    """Reference: src/smooth/strategy.rs:24-38 (defaults from src/bin/eval.rs)."""

    internal_threshold: float = 0.9
    overlap_threshold: float = 0.5
    blat_threshold: float = 0.9
    min_mapping_quality: int = 0
    smooth_window_size: int = default.SMOOTH_WINDOW_SIZE
    min_interval_size: int = default.MIN_INTERVAL_SIZE
    approved_interval_number: int = default.APPROVED_INTERVAL_NUMBER
    max_process_intervals: int = 4
    ploya_threshold: int = 3
    hg38_2bit: str | None = None
    blat_cli: str | None = None
    threads: int = 2


def has_overlap(
    interval1: tuple[int, int], interval2: tuple[int, int], overlap_threshold: float
) -> bool:
    """Overlap ratio relative to interval2's length > threshold
    (reference: src/smooth/strategy.rs:40-70)."""
    start1, end1 = interval1
    start2, end2 = interval2
    length2 = end2 - start2
    overlap = max(0, min(end1, end2) - max(start1, start2))
    if length2 == 0:
        return False
    return overlap / length2 > overlap_threshold


def _push(results: OverlapResults, key: str, rid: str) -> None:
    results.setdefault(key, []).append(rid)


def _try_blat(
    results: OverlapResults,
    prefix: str,
    predict_seq: str,
    rid: str,
    options: OverlapOptions,
) -> None:
    """Shared nosc BLAT check (reference: strategy.rs:115-143, :192-216)."""
    if len(predict_seq) < MIN_SEQ_SIZE:
        _push(results, f"{prefix}_cannot_blat", rid)
        return
    if not options.blat_cli or not options.hg38_2bit:
        _push(results, f"{prefix}_blat_fail", rid)
        return
    try:
        alignments = blat(predict_seq, options.blat_cli, options.hg38_2bit)
    except Exception:
        _push(results, f"{prefix}_blat_fail", rid)
        return
    if not alignments or alignments[0].identity < options.blat_threshold:
        _push(results, f"{prefix}_noblat", rid)


def process_no_interval(
    results: OverlapResults, bam_record: "BamRecord", options: OverlapOptions
) -> None:
    """Reads with softclips but no predicted chop
    (reference: src/smooth/strategy.rs:72-87)."""
    if (
        bam_record.left_softclip > options.min_interval_size
        or bam_record.right_softclip > options.min_interval_size
    ):
        _push(results, "sc_without_chop", bam_record.qname)


def process_one_interval(
    results: OverlapResults,
    predict_start: int,
    predict_end: int,
    predict: "Predict",
    bam_record: "BamRecord",
    options: OverlapOptions,
) -> None:
    """Classify one predicted interval (reference: strategy.rs:89-218)."""
    predict_seq = predict.seq[predict_start:predict_end]
    whole = len(predict.seq)

    if whole and predict_end / whole > options.internal_threshold:
        # Terminal adapter: compare against the right softclip.
        if has_overlap(
            (whole - bam_record.right_softclip, whole),
            (predict_start, predict_end),
            options.overlap_threshold,
        ):
            _push(results, "terminal_chop_sc", predict.id)
        else:
            _push(results, "terminal_chop_nosc", predict.id)
            _try_blat(results, "terminal_chop_nosc", predict_seq, predict.id, options)
    else:
        # Internal adapter: either softclip may explain it.
        if bam_record.left_softclip > 0 and has_overlap(
            (0, bam_record.left_softclip),
            (predict_start, predict_end),
            options.overlap_threshold,
        ):
            _push(results, "internal_chop_sc", predict.id)
            if bam_record.sa_tag is not None:
                _push(results, "internal_chop_sc_sa", predict.id)
            return
        if bam_record.right_softclip > 0 and has_overlap(
            (whole - bam_record.right_softclip, whole),
            (predict_start, predict_end),
            options.overlap_threshold,
        ):
            _push(results, "internal_chop_sc", predict.id)
            if bam_record.sa_tag is not None:
                _push(results, "internal_chop_sc_sa", predict.id)
            return
        _push(results, "internal_chop_nosc", predict.id)
        _try_blat(results, "internal_chop_nosc", predict_seq, predict.id, options)


def collect_overlap_results_for_predict(
    stats: StatResult,
    predict: "Predict",
    bam_record: "BamRecord",
    options: OverlapOptions,
) -> OverlapResults:
    """Classify one read (reference: src/smooth/strategy.rs:220-290)."""
    results: OverlapResults = {}
    if not bam_record.is_mapped:
        _push(results, "unmapped_read", predict.id)
        return results
    if bam_record.is_secondary or bam_record.is_supplementary:
        _push(results, "secondary_or_supp_read", predict.id)
        return results
    if bam_record.mapping_quality < options.min_mapping_quality:
        _push(results, "low_mp_read", predict.id)
        return results

    intervals = stats.smooth_intervals.get(predict.id, [])
    if len(intervals) == 0:
        process_no_interval(results, bam_record, options)
    elif len(intervals) <= options.max_process_intervals:
        for start, end in intervals:
            process_one_interval(results, start, end, predict, bam_record, options)
    else:
        _push(results, "no_process", predict.id)
    return results


def collect_overlap_results_for_predicts(
    bam_file: str | Path,
    prediction_path: str | Path,
    options: OverlapOptions | None = None,
    max_batch_size: int | None = None,
    output_dir: str | Path = ".",
) -> OverlapResults:
    """Full evaluation run (reference: src/smooth/strategy.rs:292-374):
    read BAM + prediction shards, aggregate stats, classify every predict,
    write `stats_*.json` and `overlap_results_*.json`."""
    from ..io.bam import read_bam_records_parallel
    from ..io.predicts import load_predicts_from_batch_pts

    options = options or OverlapOptions()
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)

    bam_records = read_bam_records_parallel(bam_file, threads=options.threads)
    log.info("collected %d bam records", len(bam_records))

    all_predicts = load_predicts_from_batch_pts(
        prediction_path, default.IGNORE_LABEL, max_batch_size
    )
    n_predicts = len(all_predicts)
    log.info("collected %d predicts", n_predicts)

    stats = collect_statistics_for_predicts(
        all_predicts.values(),
        options.smooth_window_size,
        options.min_interval_size,
        options.approved_interval_number,
        options.internal_threshold,
        options.ploya_threshold,
        threads=options.threads,
    )
    stats_file = output_dir / f"stats_pd{n_predicts}_bt{max_batch_size or 0}.json"
    stats_file.write_text(stats.to_json())
    log.info("stats saved to %s", stats_file)

    merged: OverlapResults = {}
    for rid, predict in all_predicts.items():
        bam_record = bam_records.get(rid)
        if bam_record is None:
            _push(merged, "missing_bam_record", rid)
            continue
        for key, vals in collect_overlap_results_for_predict(
            stats, predict, bam_record, options
        ).items():
            merged.setdefault(key, []).extend(vals)

    n_smooth = len(stats.smooth_predicts_with_chop)
    overlap_file = output_dir / f"overlap_results_spd{n_smooth}_pd{n_predicts}.json"
    overlap_file.write_text(json.dumps(merged))
    log.info("overlap results saved to %s", overlap_file)
    return merged
