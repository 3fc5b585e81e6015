"""Base-sequence ops: normalization, tokenization lookup tables, complement.

Copy of `deepchopper_tpu/ops/sequence.py`: tokenization is a uint8 table
gather over the raw read bytes, detokenization its inverse.
"""

from __future__ import annotations

import numpy as np

from .. import default


def _build_normalize_lut(iupac: bool) -> np.ndarray:
    """ASCII -> normalized-base LUT: uppercase, U->T, everything else N (the
    IUPAC ambiguity codes kept, uppercased, when `iupac`)."""
    lut = np.full(256, ord("N"), dtype=np.uint8)
    for ch in "ACGT":
        lut[ord(ch)] = ord(ch)
        lut[ord(ch.lower())] = ord(ch)
    for ch in ("U", "u"):
        lut[ord(ch)] = ord("T")
    if iupac:
        for ch in "BDHKMRSVWY":
            lut[ord(ch)] = ord(ch)
            lut[ord(ch.lower())] = ord(ch)
    return lut


_NORM_LUT = _build_normalize_lut(iupac=False)
_NORM_LUT_IUPAC = _build_normalize_lut(iupac=True)


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


def _build_detoken_lut() -> np.ndarray:
    """token-id -> ASCII base LUT; ids outside 7..11 decode to 'N'."""
    lut = np.full(256, ord("N"), dtype=np.uint8)
    lut[default.TOKEN_A] = ord("A")
    lut[default.TOKEN_C] = ord("C")
    lut[default.TOKEN_G] = ord("G")
    lut[default.TOKEN_T] = ord("T")
    lut[default.TOKEN_N] = ord("N")
    return lut


_DETOKEN_LUT = _build_detoken_lut()


def _build_revcomp_lut() -> np.ndarray:
    lut = np.arange(256, dtype=np.uint8)
    pairs = {"A": "T", "T": "A", "C": "G", "G": "C", "a": "t", "t": "a", "c": "g", "g": "c"}
    for src, dst in pairs.items():
        lut[ord(src)] = ord(dst)
    return lut


_REVCOMP_LUT = _build_revcomp_lut()


def seq_to_bytes(seq: str | bytes | np.ndarray) -> np.ndarray:
    """Coerce a sequence to a uint8 byte array (zero-copy for bytes)."""
    if isinstance(seq, np.ndarray):
        return seq.astype(np.uint8, copy=False)
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    return np.frombuffer(seq, dtype=np.uint8)


def normalize_seq_bytes(seq: np.ndarray, iupac: bool = False) -> np.ndarray:
    """Uppercase and map non-ACGT characters to N (U/u -> T) over uint8 bytes."""
    return (_NORM_LUT_IUPAC if iupac else _NORM_LUT)[seq]


def normalize_seq(seq: str | bytes, iupac: bool = False) -> str:
    """Uppercase and map non-ACGT(N) characters to N; U/u map to T."""
    return normalize_seq_bytes(seq_to_bytes(seq), iupac).tobytes().decode("ascii")


def reverse_complement(seq: str) -> str:
    """Reverse complement; bytes other than ACGT/acgt are kept as they are."""
    return _REVCOMP_LUT[seq_to_bytes(seq)][::-1].tobytes().decode("ascii")


def tokenize_bases(seq: str | bytes | np.ndarray) -> np.ndarray:
    """Base characters -> token ids (int32), one id per base, no special tokens."""
    return _TOKEN_LUT[seq_to_bytes(seq)]


def detokenize_bases(ids: np.ndarray) -> str:
    """Token ids -> base string; ids outside 7..11 (negative ones too) decode
    to 'N'."""
    clipped = np.clip(np.asarray(ids), 0, 255).astype(np.int64)
    return _DETOKEN_LUT[clipped].tobytes().decode("ascii")


def id_list2seq(id_list) -> str:
    """The reference's name for `detokenize_bases`."""
    return detokenize_bases(np.asarray(id_list))


def ascii_list2str(ascii_list) -> str:
    """Packed ascii codes -> str."""
    arr = np.asarray(ascii_list, dtype=np.int64)
    return arr.astype(np.uint8).tobytes().decode("ascii", errors="replace")
