"""Error types raised by the host-side encode and chop paths.

Copy of `deepchopper_tpu/errors.py`.
"""

from __future__ import annotations


class EncodingError(ValueError):
    """Base error for encode pipeline failures."""


class TargetRegionInvalid(EncodingError):
    """Target region is out of bounds or inverted."""


class SeqShorterThanKmer(EncodingError):
    """Sequence shorter than the requested k-mer size."""


class InvalidInterval(EncodingError):
    """Interval does not fit inside the sequence."""


class InvalidKmerId(EncodingError):
    """Unknown k-mer id during decoding."""


class QualSeqLengthMismatch(EncodingError):
    """Sequence and quality lengths differ."""
