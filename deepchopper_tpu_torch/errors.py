"""Error types raised by the host-side encode and chop paths.

Trimmed copy of `deepchopper_tpu/errors.py`.
"""

from __future__ import annotations


class EncodingError(ValueError):
    """Base error for encode pipeline failures."""


class TargetRegionInvalid(EncodingError):
    """Target region is out of bounds or inverted."""


class InvalidInterval(EncodingError):
    """Interval does not fit inside the sequence."""


class QualSeqLengthMismatch(EncodingError):
    """Sequence and quality lengths differ."""
