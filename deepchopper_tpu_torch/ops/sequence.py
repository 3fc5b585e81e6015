"""Base-sequence ops: normalization and tokenization lookup tables.

Trimmed copy of `deepchopper_tpu/ops/sequence.py`: tokenization is a uint8
table gather over the raw read bytes.
"""

from __future__ import annotations

import numpy as np

from .. import default


def _build_normalize_lut() -> np.ndarray:
    """ASCII -> normalized-base LUT: uppercase, U->T, everything else N."""
    lut = np.full(256, ord("N"), dtype=np.uint8)
    for ch in "ACGT":
        lut[ord(ch)] = ord(ch)
        lut[ord(ch.lower())] = ord(ch)
    for ch in ("U", "u"):
        lut[ord(ch)] = ord("T")
    return lut


_NORM_LUT = _build_normalize_lut()


def _build_token_lut() -> np.ndarray:
    """ASCII -> token-id LUT (A=7 C=8 G=9 T=10 N=11, unknown -> UNK)."""
    lut = np.full(256, default.TOKEN_UNK, dtype=np.int32)
    mapping = {
        "A": default.TOKEN_A,
        "C": default.TOKEN_C,
        "G": default.TOKEN_G,
        "T": default.TOKEN_T,
        "N": default.TOKEN_N,
    }
    for ch, tok in mapping.items():
        lut[ord(ch)] = tok
        lut[ord(ch.lower())] = tok
    lut[ord("U")] = default.TOKEN_T
    lut[ord("u")] = default.TOKEN_T
    return lut


_TOKEN_LUT = _build_token_lut()


def seq_to_bytes(seq: str | bytes | np.ndarray) -> np.ndarray:
    """Coerce a sequence to a uint8 byte array (zero-copy for bytes)."""
    if isinstance(seq, np.ndarray):
        return seq.astype(np.uint8, copy=False)
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    return np.frombuffer(seq, dtype=np.uint8)


def normalize_seq_bytes(seq: np.ndarray) -> np.ndarray:
    """Uppercase and map non-ACGT characters to N (U/u -> T) over uint8 bytes."""
    return _NORM_LUT[seq]


def tokenize_bases(seq: str | bytes | np.ndarray) -> np.ndarray:
    """Base characters -> token ids (int32), one id per base, no special tokens."""
    return _TOKEN_LUT[seq_to_bytes(seq)]
