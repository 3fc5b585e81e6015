"""FASTQ -> encoded-read stream -> bucketed batches.

Copy of `deepchopper_tpu/data/fastq_module.py`.
"""

from __future__ import annotations

from collections.abc import Iterator
from pathlib import Path

from ..io.fastq import StreamingFastqReader
from ..ops.labels import parse_target_from_id
from ..ops.qual import encode_qual
from ..ops.sequence import normalize_seq_bytes, seq_to_bytes
from .bucketing import Batch, EncodedRead, bucketed_batches, encode_read


def parse_fastq_file(file_path: str | Path, has_targets: bool = True) -> Iterator[dict]:
    """Yield {id, seq, qual, target} dicts per read."""
    count = 0
    for rec in StreamingFastqReader(file_path):
        if not rec.id or not rec.seq or not rec.qual:
            raise ValueError(f"Incomplete FASTQ record at position {count} in {file_path}")
        if len(rec.seq) != len(rec.qual):
            raise ValueError(
                f"Sequence/quality length mismatch in record {rec.name!r}: "
                f"seq={len(rec.seq)}, qual={len(rec.qual)}"
            )
        target: list[tuple[int, int]] = [(0, 0)]
        if has_targets:
            target = parse_target_from_id(rec.name)
        seq = normalize_seq_bytes(seq_to_bytes(rec.seq)).tobytes().decode("ascii")
        yield {
            "id": rec.name,
            "seq": seq,
            "qual": encode_qual(rec.qual),
            "target": target,
        }
        count += 1
    if count == 0:
        raise ValueError(f"No valid records found in {file_path}")


def iter_encoded_reads(
    file_path: str | Path,
    max_length: int = 32768,
    has_targets: bool = True,
    max_samples: int | None = None,
    shard: tuple[int, int] | None = None,
) -> Iterator[EncodedRead]:
    """Stream tokenizer-contract encoded reads from a FASTQ file.

    `shard=(rank, count)` keeps the reads whose index % count == rank: each
    rank of a data-parallel predict reads its interleaved slice.
    `max_samples` counts reads globally, before the shard is taken, so a
    sharded run covers the reads a one-rank run does."""
    rank, count = shard or (0, 1)
    for i, rec in enumerate(parse_fastq_file(file_path, has_targets)):
        if max_samples is not None and i >= max_samples:
            return
        if count > 1 and i % count != rank:
            continue
        yield encode_read(rec["id"], rec["seq"], rec["qual"], rec["target"], max_length)


def iter_batches(
    file_path: str | Path,
    max_length: int = 32768,
    tokens_per_batch: int = 1 << 17,
    buckets: list[int] | None = None,
    has_targets: bool = True,
    max_samples: int | None = None,
    max_batch: int = 512,
    shard: tuple[int, int] | None = None,
) -> Iterator[Batch]:
    """FASTQ -> fixed-shape batches, streaming (`shard` as in
    `iter_encoded_reads`)."""
    yield from bucketed_batches(
        iter_encoded_reads(file_path, max_length, has_targets, max_samples, shard),
        buckets=buckets,
        tokens_per_batch=tokens_per_batch,
        max_batch=max_batch,
    )
