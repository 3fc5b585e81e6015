"""Prediction statistics aggregation.

Copy of `deepchopper_tpu/eval/stat.py`: `StatResult` and
`collect_statistics_for_predicts`, the per-predict raw and smoothed interval
collection, truncation counting, polyA-adjacent single-interval detection
and relative-position histogram, merged map-reduce style over a thread pool.
"""

from __future__ import annotations

import dataclasses
import json
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import TYPE_CHECKING

from .. import default

if TYPE_CHECKING:  # pragma: no cover
    from ..io.predicts import Predict

# First 5 bp upstream of a single smoothed interval are checked for >=3 'A's
# (reference: src/smooth/stat.rs:16, :281-291).
FLANK_SIZE_COUNT_PLOYA = 5


@dataclasses.dataclass
class StatResult:
    """Aggregate over predictions (reference: src/smooth/stat.rs:18-41)."""

    predicts_with_chop: list[str] = dataclasses.field(default_factory=list)
    smooth_predicts_with_chop: list[str] = dataclasses.field(default_factory=list)
    smooth_internal_predicts: list[str] = dataclasses.field(default_factory=list)
    smooth_intervals: dict[str, list[tuple[int, int]]] = dataclasses.field(default_factory=dict)
    original_intervals: dict[str, list[tuple[int, int]]] = dataclasses.field(default_factory=dict)
    total_truncated: int = 0
    smooth_only_one: list[str] = dataclasses.field(default_factory=list)
    smooth_only_one_with_ploya: list[str] = dataclasses.field(default_factory=list)
    total_predicts: int = 0
    smooth_intervals_relative_pos: list[float] = dataclasses.field(default_factory=list)

    # -- queries (reference: src/smooth/stat.rs:82-131) --------------------

    def selected_predict_by_intervals(self, interval_number: int) -> list[str]:
        return [
            rid
            for rid in self.smooth_predicts_with_chop
            if len(self.smooth_intervals[rid]) >= interval_number
        ]

    def length_predicts_with_chop(self) -> list[int]:
        return [
            e - s for rid in self.predicts_with_chop for (s, e) in self.original_intervals[rid]
        ]

    def number_predicts_with_chop(self) -> list[int]:
        return [len(self.original_intervals[rid]) for rid in self.predicts_with_chop]

    def length_smooth_predicts_with_chop(self) -> list[int]:
        return [
            e - s for rid in self.smooth_predicts_with_chop for (s, e) in self.smooth_intervals[rid]
        ]

    def number_smooth_predicts_with_chop(self) -> list[int]:
        return [len(self.smooth_intervals[rid]) for rid in self.smooth_predicts_with_chop]

    # -- merge / io --------------------------------------------------------

    def merge(self, other: "StatResult") -> None:
        """In-place merge (reference: src/smooth/stat.rs:180-199)."""
        self.predicts_with_chop.extend(other.predicts_with_chop)
        self.smooth_predicts_with_chop.extend(other.smooth_predicts_with_chop)
        self.smooth_internal_predicts.extend(other.smooth_internal_predicts)
        self.smooth_intervals.update(other.smooth_intervals)
        self.original_intervals.update(other.original_intervals)
        self.total_truncated += other.total_truncated
        self.smooth_only_one.extend(other.smooth_only_one)
        self.smooth_only_one_with_ploya.extend(other.smooth_only_one_with_ploya)
        self.total_predicts += other.total_predicts
        self.smooth_intervals_relative_pos.extend(other.smooth_intervals_relative_pos)

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["smooth_intervals"] = {k: [list(t) for t in v] for k, v in self.smooth_intervals.items()}
        d["original_intervals"] = {
            k: [list(t) for t in v] for k, v in self.original_intervals.items()
        }
        return json.dumps(d)

    @classmethod
    def from_json(cls, json_path: str | Path) -> "StatResult":
        data = json.loads(Path(json_path).read_text())
        data["smooth_intervals"] = {
            k: [tuple(t) for t in v] for k, v in data.get("smooth_intervals", {}).items()
        }
        data["original_intervals"] = {
            k: [tuple(t) for t in v] for k, v in data.get("original_intervals", {}).items()
        }
        return cls(**data)

    def __repr__(self) -> str:
        return (
            f"StatResult(total_predicts: {self.total_predicts}, "
            f"predicts_with_chop: {len(self.predicts_with_chop)}, "
            f"smooth_predicts_with_chop: {len(self.smooth_predicts_with_chop)}, "
            f"smooth_internal_predicts: {len(self.smooth_internal_predicts)}, "
            f"total_truncated: {self.total_truncated}, "
            f"smooth_only_one: {len(self.smooth_only_one)}, "
            f"smooth_ploya_only_one: {len(self.smooth_only_one_with_ploya)})"
        )


def _stat_one(
    predict: "Predict",
    smooth_window_size: int,
    min_interval_size: int,
    approved_interval_number: int,
    internal_threshold: float,
    ploya_threshold: int,
) -> StatResult | None:
    """Per-predict statistics (reference: src/smooth/stat.rs:241-305)."""
    if len(predict.seq) < default.MIN_READ_LEN:
        return None
    result = StatResult()
    result.total_predicts = 1
    if predict.is_truncated:
        result.total_truncated = 1

    raw_regions = [(int(s), int(e)) for (s, e) in predict.prediction_region()]
    if raw_regions:
        result.predicts_with_chop.append(predict.id)
        result.original_intervals[predict.id] = raw_regions

    smooth_regions = [
        (int(s), int(e))
        for (s, e) in predict.smooth_and_select_intervals(
            smooth_window_size, min_interval_size, approved_interval_number
        )
    ]
    if smooth_regions:
        result.smooth_predicts_with_chop.append(predict.id)
        result.smooth_intervals[predict.id] = smooth_regions
        if len(smooth_regions) == 1:
            result.smooth_only_one.append(predict.id)
            s0 = smooth_regions[0][0]
            flank = predict.seq[max(s0 - FLANK_SIZE_COUNT_PLOYA, 0) : s0]
            if flank.count("A") >= ploya_threshold:
                result.smooth_only_one_with_ploya.append(predict.id)
        seq_len = len(predict.seq)
        for _s, e in smooth_regions:
            rel = e / seq_len
            result.smooth_intervals_relative_pos.append(rel)
            if rel < internal_threshold:
                result.smooth_internal_predicts.append(predict.id)
    return result


def collect_statistics_for_predicts(
    predicts,
    smooth_window_size: int = default.SMOOTH_WINDOW_SIZE,
    min_interval_size: int = default.MIN_INTERVAL_SIZE,
    approved_interval_number: int = default.APPROVED_INTERVAL_NUMBER,
    internal_threshold: float = 0.9,
    ploya_threshold: int = 3,
    threads: int | None = None,
) -> StatResult:
    """Map-reduce statistics over predictions
    (reference: src/smooth/stat.rs:222-308)."""
    predicts = list(predicts)
    agg = StatResult()

    def work(p):
        return _stat_one(
            p,
            smooth_window_size,
            min_interval_size,
            approved_interval_number,
            internal_threshold,
            ploya_threshold,
        )

    if threads and threads > 1 and len(predicts) > 64:
        with ThreadPoolExecutor(max_workers=threads) as pool:
            results = pool.map(work, predicts)
    else:
        results = map(work, predicts)
    for r in results:
        if r is not None:
            agg.merge(r)
    return agg
