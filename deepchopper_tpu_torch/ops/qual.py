"""Quality-score encoding ops.

Copy of `deepchopper_tpu/ops/qual.py`.
"""

from __future__ import annotations

import numpy as np

from .. import default
from .sequence import seq_to_bytes


def encode_qual(qual: str | bytes, qual_offset: int = default.QUAL_OFFSET) -> np.ndarray:
    """Phred+offset ASCII quality string -> int32 scores."""
    return (seq_to_bytes(qual).astype(np.int32)) - int(qual_offset)


def encode_qual_kmer(
    qual: str | bytes,
    kmer_size: int,
    qual_offset: int = default.QUAL_OFFSET,
) -> tuple[np.ndarray, np.ndarray]:
    """Per-base scores plus the integer mean score of each overlapping k-mer.

    The reference sums a window into a u8 and floor-divides; phred scores are
    <= 93, so a sum of k <= 3 values fits, and the wrap is kept for larger k.
    """
    scores = encode_qual(qual, qual_offset)
    k = int(kmer_size)
    if k <= 0 or scores.size < k:
        return scores, np.zeros(0, dtype=np.int32)
    windows = np.lib.stride_tricks.sliding_window_view(scores, k)
    sums = windows.sum(axis=1).astype(np.int64) % 256
    return scores, (sums // k).astype(np.int32)


def splite_qual_by_offsets(target: list[int] | np.ndarray, offsets) -> list[int]:
    """Integer mean quality per token span; 0 for an empty (special-token)
    span. The misspelled name is the reference's."""
    target = np.asarray(target, dtype=np.int64)
    return [0 if start == end else int(target[start:end].sum() // (end - start)) for start, end in offsets]


def normalize_quals(quals: np.ndarray, axis: int = -1, eps: float = 1e-12) -> np.ndarray:
    """L2-normalize quality vectors, matching torch.nn.functional.normalize.

    Zero padding does not change the L2 norm, so normalizing a padded batch
    row equals normalizing the read.
    """
    quals = np.asarray(quals, dtype=np.float32)
    norm = np.sqrt(np.sum(quals * quals, axis=axis, keepdims=True))
    return quals / np.maximum(norm, eps)
