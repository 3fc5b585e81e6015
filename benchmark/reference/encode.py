"""The model's input for one raw read, worked out from the FASTQ contract:
one token a base (A C G T N -> 7 8 9 10 11), then SEP (1), then PAD (4) up
to the width; the phred scores (byte - 33) with 0 at SEP and the pads,
divided by their L2 norm; and, for a labelled read, 1 inside its adapter
span, 0 elsewhere, -100 at SEP and the pads. A read of max_length bases or
more keeps its first max_length - 1."""

from __future__ import annotations

import numpy as np

SEP, PAD, IGNORE = 1, 4, -100
_LUT = np.full(256, 11, np.int64)
for _base, _tok in zip(b"ACGTN", (7, 8, 9, 10, 11)):
    _LUT[_base] = _tok
    _LUT[ord(chr(_base).lower())] = _tok


def encode(seq: bytes, qual: bytes, width: int, max_length: int,
           span: tuple[int, int] | None = None) -> tuple[np.ndarray, np.ndarray, np.ndarray]:  # fmt: skip
    """(ids int64, quals float32, labels int64), each (width,)."""
    n = min(len(seq), max_length - 1)
    if n + 1 > width:
        raise ValueError(f"a read of {n} tokens + SEP does not fit width {width}")
    ids = np.full(width, PAD, np.int64)
    ids[:n] = _LUT[np.frombuffer(seq[:n], np.uint8)]
    ids[n] = SEP
    q = np.zeros(width, np.float64)
    q[:n] = np.frombuffer(qual[:n], np.uint8).astype(np.float64) - 33.0
    q /= max(np.sqrt((q * q).sum()), 1e-12)
    labels = np.full(width, IGNORE, np.int64)
    labels[:n] = 0
    if span is not None:
        s, e = span
        if len(seq) < max_length or e + 2 <= max_length:
            labels[s:e] = 1
    return ids, q.astype(np.float32), labels
