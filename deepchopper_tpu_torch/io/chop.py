"""FASTQ record type.

Trimmed copy of `deepchopper_tpu/io/chop.py`: the record the reader yields.
The chop kernel itself belongs to a later slice of the port.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True, slots=True)
class FastqRecord:
    """A FASTQ record: raw id line (without '@'), sequence, quality bytes."""

    id: str
    seq: bytes
    qual: bytes

    @property
    def name(self) -> str:
        """Read name: id line up to the first whitespace."""
        return self.id.split(None, 1)[0] if self.id else self.id
