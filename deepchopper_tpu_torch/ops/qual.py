"""Quality-score encoding ops.

Trimmed copy of `deepchopper_tpu/ops/qual.py`.
"""

from __future__ import annotations

import numpy as np

from .. import default
from .sequence import seq_to_bytes


def encode_qual(qual: str | bytes, qual_offset: int = default.QUAL_OFFSET) -> np.ndarray:
    """Phred+offset ASCII quality string -> int32 scores."""
    return (seq_to_bytes(qual).astype(np.int32)) - int(qual_offset)


def normalize_quals(quals: np.ndarray, axis: int = -1, eps: float = 1e-12) -> np.ndarray:
    """L2-normalize quality vectors, matching torch.nn.functional.normalize.

    Zero padding does not change the L2 norm, so normalizing a padded batch
    row equals normalizing the read.
    """
    quals = np.asarray(quals, dtype=np.float32)
    norm = np.sqrt(np.sum(quals * quals, axis=axis, keepdims=True))
    return quals / np.maximum(norm, eps)
