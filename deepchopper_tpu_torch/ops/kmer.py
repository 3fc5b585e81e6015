"""K-mer math: vocabularies, k-mer <-> sequence, target regions in k-mer space.

Copy of `deepchopper_tpu/ops/kmer.py`. The predict path is base-level (a k=1
gather in `ops.sequence`); these serve dataset tooling (`data.tensor_encoder`).
"""

from __future__ import annotations

from itertools import product

import numpy as np

from ..errors import InvalidKmerId, SeqShorterThanKmer, TargetRegionInvalid


def seq_to_kmers(seq: str, k: int, overlap: bool = True) -> list[str]:
    """Overlapping windows or non-overlapping chunks (reference: src/kmer.rs:144-150).

    Note the chunked path keeps a trailing short chunk, matching Rust's
    `chunks` semantics.
    """
    if overlap:
        return [seq[i : i + k] for i in range(max(len(seq) - k + 1, 0))]
    return [seq[i : i + k] for i in range(0, len(seq), k)]


def kmers_to_seq(kmers: list[str]) -> str:
    """Reconstruct a sequence from overlapping k-mers (reference: src/kmer.rs:152-172)."""
    if not kmers:
        return ""
    parts = [kmers[0]]
    for kmer in kmers[1:]:
        if not kmer:
            raise InvalidKmerId("empty k-mer")
        parts.append(kmer[-1])
    return "".join(parts)


def seq_to_kmers_and_offset(
    seq: str, kmer_size: int, overlap: bool = True
) -> list[tuple[str, tuple[int, int]]]:
    """K-mers plus their [start, end) offsets (reference: src/kmer.rs:175-211).

    Unlike `seq_to_kmers`, the non-overlapping path DROPS a trailing short
    chunk, matching the reference.
    """
    if kmer_size == 0 or kmer_size > len(seq):
        raise SeqShorterThanKmer(f"kmer_size {kmer_size} invalid for sequence of length {len(seq)}")
    if overlap:
        return [
            (seq[i : i + kmer_size], (i, i + kmer_size))
            for i in range(len(seq) - kmer_size + 1)
        ]
    return [
        (seq[i : i + kmer_size], (i, i + kmer_size))
        for i in range(0, len(seq) - kmer_size + 1, kmer_size)
        if len(seq[i : i + kmer_size]) == kmer_size
    ]


def generate_kmers(bases: str, k: int) -> list[str]:
    """Cartesian-product k-mer vocabulary (reference: src/kmer.rs:213-228)."""
    return ["".join(combo) for combo in product(bases, repeat=k)]


def generate_kmers_table(bases: str, k: int) -> dict[str, int]:
    """K-mer -> id table (reference: src/kmer.rs:213-219)."""
    return {kmer: i for i, kmer in enumerate(generate_kmers(bases, k))}


def kmerids_to_seq(kmer_ids, id2kmer_table: dict[int, str]) -> str:
    """Ids -> overlapping k-mers -> sequence (reference: src/kmer.rs:79-91)."""
    try:
        kmers = [id2kmer_table[int(i)] for i in np.asarray(kmer_ids).reshape(-1)]
    except KeyError as exc:
        raise InvalidKmerId(str(exc)) from exc
    return kmers_to_seq(kmers)


def to_kmer_target_region(
    original_target: tuple[int, int], k: int, seq_len: int | None = None
) -> tuple[int, int]:
    """Base-space [start, end) -> k-mer-space region (reference: src/kmer.rs:106-142)."""
    start, end = original_target
    if start >= end or k == 0:
        raise TargetRegionInvalid(f"invalid region {start}:{end} with k={k}")
    if seq_len is not None and end > seq_len:
        raise TargetRegionInvalid(f"region end {end} exceeds seq_len {seq_len}")
    num_kmers = end - start - k + 1 if end - start >= k else 0
    new_end = start + num_kmers if num_kmers > 0 else end
    return (start, new_end)


def to_original_targtet_region(kmer_target: tuple[int, int], k: int) -> tuple[int, int]:
    """Inverse of `to_kmer_target_region`; keeps the reference's misspelled name
    for API compatibility (reference: src/kmer.rs:93-104)."""
    start, end = kmer_target
    return (start, end + k - 1 if end > start else end)


# API-compatible correctly-spelled alias.
to_original_target_region = to_original_targtet_region
