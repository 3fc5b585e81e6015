"""Chop kernel: interval complement math and FASTQ record splitting.

Copy of `deepchopper_tpu/io/chop.py`. This is the byte-parity-critical stage;
reference quirks are reproduced on purpose:

* `generate_unmaped_intervals` emits the trailing keep-interval as
  `[current_start, total_length - 1)`: the final base is dropped whenever
  sequence remains after the last adapter interval;
* passthrough rules and the Terminal/Internal decision use the keep count
  before the min-length filter;
* kept-part ids are annotated `<id>|<start>:<end>` plus `|T`/`|I`.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum

from ..errors import InvalidInterval, QualSeqLengthMismatch


class ChopType(str, Enum):
    """Which chop classes to emit."""

    TERMINAL = "terminal"
    INTERNAL = "internal"
    ALL = "all"

    @classmethod
    def parse(cls, value: "str | ChopType") -> "ChopType":
        if isinstance(value, ChopType):
            return value
        try:
            return cls(value.lower())
        except ValueError as exc:
            raise ValueError(f"Invalid chop type: {value!r}") from exc


@dataclass(frozen=True, slots=True)
class FastqRecord:
    """A FASTQ record: raw id line (without '@'), sequence, quality bytes."""

    id: str
    seq: bytes
    qual: bytes

    def to_bytes(self) -> bytes:
        return b"@" + self.id.encode("ascii") + b"\n" + self.seq + b"\n+\n" + self.qual + b"\n"

    @property
    def name(self) -> str:
        """Read name: id line up to the first whitespace."""
        return self.id.split(None, 1)[0] if self.id else self.id


def generate_unmaped_intervals(
    intervals: list[tuple[int, int]], total_length: int
) -> list[tuple[int, int]]:
    """Complement of sorted, non-overlapping adapter intervals.

    Includes the deliberate `total_length - 1` end trim.
    """
    if not intervals:
        return [(0, total_length)]
    result: list[tuple[int, int]] = []
    current_start = 0
    for start, end in intervals:
        if current_start < start:
            result.append((current_start, start))
        current_start = end
    if current_start < total_length - 1:
        result.append((current_start, total_length - 1))
    return result


def remove_intervals_and_keep_left(
    seq: bytes | str, intervals: list[tuple[int, int]]
) -> tuple[list[bytes], list[tuple[int, int]]]:
    """Remove adapter intervals (sorted by start first); return the kept
    segments and their coordinates. An interval starting past the end raises."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    ordered = sorted(intervals, key=lambda r: r[0])
    selected = generate_unmaped_intervals(ordered, len(seq))
    out: list[bytes] = []
    for start, end in selected:
        if start >= len(seq):
            raise InvalidInterval(f"interval ({start}, {end}) outside sequence of length {len(seq)}")
        out.append(seq[start:end])
    return out, selected


def _split_parts(
    seq: bytes,
    record_id: str,
    qual: bytes,
    intervals: list[tuple[int, int]],
    min_retain_interval_length: int | None,
) -> tuple[int, list[str], list[bytes], list[bytes]]:
    """Shared remove-and-annotate core."""
    seqs, selected = remove_intervals_and_keep_left(seq, intervals)
    quals, _ = remove_intervals_and_keep_left(qual, intervals)
    if len(seqs) != len(quals):
        raise QualSeqLengthMismatch(f"{record_id}: {len(seqs)} seq parts vs {len(quals)} qual parts")
    for s, q in zip(seqs, quals):
        if len(s) != len(q):
            raise QualSeqLengthMismatch(
                f"{record_id}: seq part length {len(s)} != qual part length {len(q)}"
            )
    ids = [f"{record_id}|{start}:{end}" for start, end in selected]
    count_before_filter = len(seqs)
    if min_retain_interval_length is not None:
        kept = [
            (i, s, q)
            for i, s, q in zip(ids, seqs, quals)
            if len(s) >= min_retain_interval_length
        ]
        ids = [i for i, _, _ in kept]
        seqs = [s for _, s, _ in kept]
        quals = [q for _, _, q in kept]
    return count_before_filter, ids, seqs, quals


def split_records_by_intervals(
    seq: bytes | str,
    record_id: str,
    qual: bytes,
    intervals: list[tuple[int, int]],
) -> list[FastqRecord]:
    """Emit the adapter segments themselves (the `--ocq` path)."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    return [
        FastqRecord(f"{record_id}|{start}:{end}", seq[start:end], qual[start:end])
        for start, end in intervals
    ]


def split_records_by_remove_interval(
    seq: bytes | str,
    record_id: str,
    qual: bytes,
    intervals: list[tuple[int, int]],
    min_chop_read_length: int,
    id_annotation: bool = True,
) -> list[FastqRecord]:
    """Remove adapters and always emit the kept parts (no passthrough rules).

    The record-splitting variant `io.parquet.write_predicts` uses: parts are
    annotated `|T` (one part before filtering) or `|I` (several) when
    `id_annotation`, and the record is never re-emitted whole.
    """
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    count_before, ids, seqs, quals = _split_parts(seq, record_id, qual, intervals, min_chop_read_length)
    suffix = "T" if count_before == 1 else "I"
    return [
        FastqRecord(f"{rid}|{suffix}" if id_annotation else rid, rseq, rqual)
        for rid, rseq, rqual in zip(ids, seqs, quals)
    ]


def split_records_by_remove_intervals(
    seq: bytes | str,
    record_id: str,
    qual: bytes,
    intervals: list[tuple[int, int]],
    min_chop_read_length: int,
    id_annotation: bool = True,
    chop_type: ChopType = ChopType.ALL,
) -> list[FastqRecord]:
    """Remove adapters and emit the kept parts, or pass the record through.

    Passthrough (emit the original record unchanged) when:
    * the requested chop_type does not match the record's Terminal/Internal
      class (1 keep-part before filtering => Terminal, else Internal); or
    * the first kept part spans the whole sequence.
    """
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    count_before, ids, seqs, quals = _split_parts(
        seq, record_id, qual, intervals, min_chop_read_length
    )
    current_is_terminal = count_before == 1
    if (
        (chop_type == ChopType.TERMINAL and not current_is_terminal)
        or (chop_type == ChopType.INTERNAL and current_is_terminal)
        or (seqs and len(seqs[0]) == len(seq))
    ):
        return [FastqRecord(record_id, seq, qual)]
    suffix = "T" if current_is_terminal else "I"
    out: list[FastqRecord] = []
    for rid, rseq, rqual in zip(ids, seqs, quals):
        out.append(FastqRecord(f"{rid}|{suffix}" if id_annotation else rid, rseq, rqual))
    return out
