"""Label ops: target parsing and vectorization, region extraction, smoothing.

Copy of `deepchopper_tpu/ops/labels.py`. Reference behaviours that
look like quirks are load-bearing for chop output parity and are kept:

* `parse_target_from_id` degrades to [(0, 0)] on malformed ids instead of
  raising, as the reference tokenizer does;
* `get_label_region` uses `start == 0` as its "no open region" sentinel, so a
  1-run touching index 0 only opens at index 1;
* `majority_voting` forces the window odd, shifts it left at the tail so it
  stays full-size, and keeps the original label on a two-way tie.
"""

from __future__ import annotations

import re

import numpy as np

from .. import default, native
from ..errors import TargetRegionInvalid

_TARGET_PART = re.compile(rb"^(\d+):(\d+)$")


def parse_target_from_id(src: str | bytes) -> list[tuple[int, int]]:
    """Parse `...|start:end-start2:end2` adapter annotations from a read id.

    * empty input -> []
    * no '|' in the id -> [(0, 0)]
    * otherwise the last '|'-separated field is split on '-' into
      `start:end` pairs; ANY parse failure degrades to [(0, 0)].
    """
    if isinstance(src, str):
        src = src.encode("ascii", errors="replace")
    if not src:
        return []
    if b"|" not in src:
        return [(0, 0)]
    number_part = src.rsplit(b"|", 1)[-1]
    result: list[tuple[int, int]] = []
    for part in number_part.split(b"-"):
        m = _TARGET_PART.match(part)
        if m is None:
            return [(0, 0)]
        result.append((int(m.group(1)), int(m.group(2))))
    return result


def vectorize_target(start: int, end: int, length: int) -> np.ndarray:
    """[start, end) -> binary label vector."""
    if start > end or end > length:
        raise TargetRegionInvalid(f"invalid target region {start}:{end} for length {length}")
    out = np.zeros(length, dtype=np.int64)
    out[start:end] = 1
    return out


def vectorize_targets(targets, length: int) -> np.ndarray:
    """Flat [s1, e1, s2, e2, ...] or [(s,e), ...] -> binary label vector."""
    flat = np.asarray(targets, dtype=np.int64).reshape(-1)
    if flat.size == 0:
        return np.zeros(length, dtype=np.int64)
    if flat.size % 2 != 0:
        raise TargetRegionInvalid("targets must contain an even number of values")
    out = np.zeros(length, dtype=np.int64)
    for start, end in flat.reshape(-1, 2):
        if start > end or end > length:
            raise TargetRegionInvalid(f"invalid target region {start}:{end} for length {length}")
        out[start:end] = 1
    return out


def get_label_region(labels) -> list[tuple[int, int]]:
    """1-runs -> [start, end) ranges, with the index-0 sentinel: a run that
    starts at index 0 opens at index 1 (`[1, 0, ...]` yields no region,
    `[1, 1, 0]` yields (1, 2))."""
    labels = np.asarray(labels)
    n = labels.shape[0]
    if n == 0:
        return []
    ones = labels == 1
    if not ones.any():
        return []
    diff = np.diff(ones.astype(np.int8))
    starts = list(np.nonzero(diff == 1)[0] + 1)
    ends_excl = list(np.nonzero(diff == -1)[0] + 1)
    if ones[0]:
        starts.insert(0, 0)
    if ones[-1]:
        ends_excl.append(n)
    regions: list[tuple[int, int]] = []
    for s, e in zip(starts, ends_excl):
        if s == 0:
            if e <= 1:
                continue
            s = 1
        regions.append((int(s), int(e)))
    return regions


def _window_bounds(idx: np.ndarray, lengths, window_size: int) -> tuple[np.ndarray, np.ndarray]:
    """[start, end) of each position's vote window: odd width, clipped to the
    row, shifted left at the tail to stay full-size."""
    w = int(window_size)
    if w % 2 == 0:
        w += 1
    half = w // 2
    start = np.maximum(idx - half, 0)
    end = np.minimum(idx + half + 1, lengths)
    shift = (end == lengths) & ((end - start) < w)
    return np.where(shift, np.maximum(end - w, 0), start), end


def majority_voting(labels, window_size: int) -> np.ndarray:
    """Sliding-window majority vote over binary labels; a 0/1 count tie keeps
    the original label."""
    labels = np.asarray(labels)
    n = labels.shape[0]
    if n == 0:
        return labels.copy()
    start, end = _window_bounds(np.arange(n, dtype=np.int64), n, window_size)
    csum = np.concatenate(([0], np.cumsum((labels == 1).astype(np.int64))))
    twice = 2 * (csum[end] - csum[start])
    size = end - start
    out = np.where(twice > size, 1, np.where(twice < size, 0, labels))
    return out.astype(labels.dtype, copy=False)


def majority_voting_batch(labels: np.ndarray, lengths: np.ndarray, window_size: int) -> np.ndarray:
    """Batched majority vote over a padded (B, L) label matrix: row i is
    smoothed over its own `lengths[i]` prefix, padding passes through. Runs in
    the native library when it is available and the labels are int8,
    otherwise in NumPy (one cumsum over the batch)."""
    labels = np.asarray(labels)
    if labels.dtype == np.int8 and native.available():
        return native.majority_vote_batch(labels, lengths, window_size)
    b, maxlen = labels.shape
    lengths = np.asarray(lengths, dtype=np.int64).reshape(b, 1)
    idx = np.arange(maxlen, dtype=np.int64)[None, :]
    start, end = _window_bounds(idx, lengths, window_size)
    csum = np.concatenate([np.zeros((b, 1), np.int64), np.cumsum((labels == 1).astype(np.int64), axis=1)], axis=1)
    twice = 2 * (np.take_along_axis(csum, end, axis=1) - np.take_along_axis(csum, start, axis=1))
    size = end - start
    out = np.where(twice > size, 1, np.where(twice < size, 0, labels))
    return np.where(idx < lengths, out, labels).astype(labels.dtype, copy=False)


def smooth_label_region(
    labels,
    smooth_window_size: int = default.SMOOTH_WINDOW_SIZE,
    min_interval_size: int = default.MIN_INTERVAL_SIZE,
    approved_interval_number: int = default.APPROVED_INTERVAL_NUMBER,
) -> list[tuple[int, int]]:
    """majority_voting -> get_label_region -> min-size filter -> count gate:
    [] when more than `approved_interval_number` intervals survive."""
    regions = get_label_region(majority_voting(labels, smooth_window_size))
    results = [(s, e) for (s, e) in regions if e - s >= min_interval_size]
    if len(results) > approved_interval_number:
        return []
    return results


def summary_predict(
    predictions,
    labels,
    ignore_label: int = default.IGNORE_LABEL,
) -> tuple[list[np.ndarray], list[np.ndarray]]:
    """Drop the positions whose label equals `ignore_label`, row by row."""
    preds_out: list[np.ndarray] = []
    labels_out: list[np.ndarray] = []
    for pred, lab in zip(predictions, labels):
        pred, lab = np.asarray(pred), np.asarray(lab)
        keep = lab != ignore_label
        preds_out.append(pred[keep])
        labels_out.append(lab[keep])
    return preds_out, labels_out
