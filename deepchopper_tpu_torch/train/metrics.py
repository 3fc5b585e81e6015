"""Binary classification metrics with ignore-index masking.

Port of `deepchopper_tpu/train/metrics.py`: additive (tp, fp, fn, tn) counts
per batch, summed on the host across batches. Over several ranks a batch's
counts are first summed across the ranks on the device (`binary_stats_arrays`
is an int64 tensor, `train.step` all-reduces it), so every rank holds the
global batch's.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import default


@dataclasses.dataclass
class BinaryStats:
    tp: int = 0
    fp: int = 0
    fn: int = 0
    tn: int = 0

    def __add__(self, other: BinaryStats) -> BinaryStats:
        return BinaryStats(self.tp + other.tp, self.fp + other.fp, self.fn + other.fn, self.tn + other.tn)

    @property
    def precision(self) -> float:
        d = self.tp + self.fp
        return self.tp / d if d else 0.0

    @property
    def recall(self) -> float:
        d = self.tp + self.fn
        return self.tp / d if d else 0.0

    @property
    def f1(self) -> float:
        p, r = self.precision, self.recall
        return 2 * p * r / (p + r) if (p + r) else 0.0

    @property
    def accuracy(self) -> float:
        total = self.tp + self.fp + self.fn + self.tn
        return (self.tp + self.tn) / total if total else 0.0


def binary_stats_arrays(
    preds: torch.Tensor, labels: torch.Tensor, ignore_index: int = default.IGNORE_LABEL
) -> torch.Tensor:
    """(tp, fp, fn, tn) as a length-4 int64 tensor on the inputs' device."""
    mask = labels != ignore_index
    pred_pos = (preds == 1) & mask
    lab_pos = (labels == 1) & mask
    tp = (pred_pos & lab_pos).sum()
    fp = (pred_pos & ~lab_pos).sum()
    fn = (~pred_pos & lab_pos).sum()
    tn = (~pred_pos & ~lab_pos & mask).sum()
    return torch.stack([tp, fp, fn, tn])


def stats_from_array(arr) -> BinaryStats:
    tp, fp, fn, tn = (int(x) for x in arr)
    return BinaryStats(tp, fp, fn, tn)
