"""Dense whole-file tensor encoding: `TensorEncoder`, `FqEncoderOption`,
`RecordData`.

Copy of `deepchopper_tpu/data/tensor_encoder.py`. A FASTQ file becomes

  inputs  (N, 2, W)  — row 0: overlapping k-mer ids, row 1: per-k-mer integer
                       mean quality; both padded with -1 to W
  targets (N, T, W)  — 0/1 fill of each k-mer-space target region when
                       ``vectorized_target`` (else (N, T, 2) start/end pairs)
  quals   (N, L)     — per-base Phred-offset scores padded with -1 to L

where W = max_seq_len - k + 1 and T = number of target regions parsed from the
read id. The encoder grows ``tensor_max_width`` / ``tensor_max_seq_len``
while it scans a file. Each record is a handful of NumPy vector ops: an ASCII
LUT normalization, a base-|bases| positional sliding-window evaluation for
the k-mer ids (a k-mer's id is its index in the cartesian-product
vocabulary), and a sliding-window integer mean for the k-mer quality.
"""

from __future__ import annotations

import logging
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from pathlib import Path
from typing import Sequence

import numpy as np

from .. import default
from ..errors import EncodingError, SeqShorterThanKmer
from ..io.fastq import StreamingFastqReader
from ..ops.kmer import generate_kmers_table, to_kmer_target_region
from ..ops.qual import encode_qual_kmer
from ..ops.sequence import normalize_seq_bytes, seq_to_bytes
from ..ops.labels import parse_target_from_id

logger = logging.getLogger(__name__)


@dataclass
class RecordData:
    """One FASTQ record's raw fields (reference: src/fq_encode/record.rs:3-14)."""

    id: bytes
    seq: bytes
    qual: bytes

    @classmethod
    def new(cls, id: str | bytes, seq: str | bytes, qual: str | bytes) -> "RecordData":
        def b(x: str | bytes) -> bytes:
            return x.encode("ascii") if isinstance(x, str) else bytes(x)

        return cls(b(id), b(seq), b(qual))


@dataclass
class FqEncoderOption:
    """Encoder options (reference: src/fq_encode/option.rs:8-52)."""

    kmer_size: int = default.KMER_SIZE
    qual_offset: int = default.QUAL_OFFSET
    bases: str = default.BASES
    vectorized_target: bool = default.VECTORIZED_TARGET
    threads: int = 2


def _base_index_lut(bases: str) -> np.ndarray:
    """ASCII byte -> index within ``bases`` (-1 for bytes outside the alphabet)."""
    lut = np.full(256, -1, dtype=np.int64)
    for i, ch in enumerate(bases):
        lut[ord(ch)] = i
    return lut


@dataclass
class TensorEncoder:
    """Whole-file dense tensor encoder (reference: src/fq_encode/tensor_encoder.rs:27-125).

    ``tensor_max_width`` / ``tensor_max_seq_len`` grow as files are scanned, so
    encoding a second, longer file widens subsequent outputs — mirroring the
    reference's stateful behavior.
    """

    option: FqEncoderOption = field(default_factory=FqEncoderOption)
    tensor_max_width: int = 0
    tensor_max_seq_len: int = 0

    def __post_init__(self) -> None:
        self.kmer2id_table = generate_kmers_table(self.option.bases, self.option.kmer_size)
        self.id2kmer_table = {v: k for k, v in self.kmer2id_table.items()}
        self._base_lut = _base_index_lut(self.option.bases)

    # -- scanning ---------------------------------------------------------

    def fetch_records(self, path: str | Path) -> list[RecordData]:
        """Read + normalize records, growing max width/len
        (reference: src/fq_encode/tensor_encoder.rs:127-175)."""
        k = self.option.kmer_size
        records: list[RecordData] = []
        try:
            for rec in StreamingFastqReader(path):
                seq = rec.seq
                if len(seq) < k:
                    continue
                if len(seq) != len(rec.qual):
                    raise EncodingError(f"record: id {rec.id} seq_len != qual_len")
                self.tensor_max_seq_len = max(self.tensor_max_seq_len, len(seq))
                records.append(RecordData(rec.id.encode("ascii"), seq, rec.qual))
        except ValueError as exc:
            # The native FASTQ scanner rejects malformed files (e.g. seq/qual
            # length mismatch) with ValueError; surface it uniformly.
            raise EncodingError(str(exc)) from exc

        if self.tensor_max_seq_len < k:
            raise SeqShorterThanKmer(
                f"max seq len {self.tensor_max_seq_len} shorter than k={k}"
            )
        self.tensor_max_width = max(
            self.tensor_max_width, self.tensor_max_seq_len - k + 1
        )
        logger.info(
            "fetched %d records (max_seq_len=%d max_width=%d)",
            len(records), self.tensor_max_seq_len, self.tensor_max_width,
        )
        return records

    # -- per-record kernels ------------------------------------------------

    def kmer_ids(self, seq: bytes | np.ndarray) -> np.ndarray:
        """Overlapping k-mer ids via positional base-|bases| encoding.

        Equals lookup in the cartesian-product table
        (reference: src/kmer.rs:213-228 ordering).
        """
        k = self.option.kmer_size
        norm = normalize_seq_bytes(seq_to_bytes(seq))
        idx = self._base_lut[norm]
        if np.any(idx < 0):
            raise EncodingError("invalid kmer: base outside alphabet")
        if idx.size < k:
            raise SeqShorterThanKmer(f"sequence shorter than k={k}")
        windows = np.lib.stride_tricks.sliding_window_view(idx, k)
        powers = len(self.option.bases) ** np.arange(k - 1, -1, -1, dtype=np.int64)
        return (windows @ powers).astype(np.int32)

    def encode_target(self, id: bytes) -> np.ndarray:
        """Target regions from the read id, mapped to k-mer space
        (reference: src/fq_encode/tensor_encoder.rs:177-219)."""
        k = self.option.kmer_size
        regions = parse_target_from_id(id.decode("ascii", "replace"))
        kmer_regions = [
            to_kmer_target_region((int(s), int(e)), k) if e > s else (int(s), int(e))
            for s, e in regions
        ]
        if self.option.vectorized_target:
            out = np.zeros((1, len(kmer_regions), self.tensor_max_width), dtype=np.int32)
            for row, (s, e) in enumerate(kmer_regions):
                if s < e and e <= self.tensor_max_width:
                    out[0, row, s:e] = 1
            return out
        out = np.zeros((1, len(kmer_regions), 2), dtype=np.int32)
        for row, (s, e) in enumerate(kmer_regions):
            out[0, row] = (s, e)
        return out

    def encode_record(
        self, id: bytes, seq: bytes, qual: bytes
    ) -> tuple[tuple[np.ndarray, np.ndarray], np.ndarray]:
        """One record -> ((1,2,W) input, (1,T,W|2) target), (1,L) qual
        (reference: src/fq_encode/tensor_encoder.rs:221-283)."""
        k, W, L = self.option.kmer_size, self.tensor_max_width, self.tensor_max_seq_len
        width = max(len(seq) - k, 0) + 1
        if width > W:
            raise EncodingError(f"invalid current_width: {width} > max_width: {W}")

        ids = self.kmer_ids(seq)
        scores, kmer_scores = encode_qual_kmer(qual, k, self.option.qual_offset)

        inp = np.full((1, 2, W), -1, dtype=np.int32)
        inp[0, 0, : ids.size] = ids
        inp[0, 1, : kmer_scores.size] = kmer_scores

        qual_row = np.full((1, L), -1, dtype=np.int32)
        qual_row[0, : scores.size] = scores

        return (inp, self.encode_target(id)), qual_row

    # -- whole-file API -----------------------------------------------------

    def encode(
        self, path: str | Path
    ) -> tuple[tuple[np.ndarray, np.ndarray], np.ndarray]:
        """Encode one FASTQ -> ((N,2,W), (N,T,W|2)), (N,L)
        (reference: src/fq_encode/tensor_encoder.rs:285-331).

        Per-record encode errors drop the record, matching the reference's
        ``filter_map(.ok())``.
        """
        records = self.fetch_records(path)
        inputs, targets, quals = [], [], []
        for rec in records:
            try:
                (inp, tgt), qual_row = self.encode_record(rec.id, rec.seq, rec.qual)
            except EncodingError as exc:  # pragma: no cover - defensive drop
                logger.warning("encode fq read id %s error: %s", rec.id, exc)
                continue
            inputs.append(inp)
            targets.append(tgt)
            quals.append(qual_row)
        if not inputs:
            raise EncodingError(f"no encodable records in {path}")
        return (
            (np.concatenate(inputs, axis=0), np.concatenate(targets, axis=0)),
            np.concatenate(quals, axis=0),
        )

    def encode_multiple(
        self, paths: Sequence[str | Path], parallel: bool = False
    ) -> tuple[tuple[np.ndarray, np.ndarray], np.ndarray]:
        """Encode several FASTQs and concatenate along N
        (reference: src/fq_encode/tensor_encoder.rs:333-367).

        Each path gets an independent clone of this encoder (so per-file width
        growth matches the reference's ``self.clone()`` semantics); widths are
        then unified by re-padding to the global maximum before concatenation.
        """
        def work(p: str | Path):
            enc = TensorEncoder(
                option=self.option,
                tensor_max_width=self.tensor_max_width,
                tensor_max_seq_len=self.tensor_max_seq_len,
            )
            return enc.encode(p)

        if parallel and len(paths) > 1:
            with ThreadPoolExecutor(max_workers=max(self.option.threads, 1)) as pool:
                results = list(pool.map(work, paths))
        else:
            results = [work(p) for p in paths]

        W = max(r[0][0].shape[2] for r in results)
        L = max(r[1].shape[1] for r in results)
        T_vec = self.option.vectorized_target

        def pad3(a: np.ndarray, last: int, fill: int) -> np.ndarray:
            if a.shape[-1] == last:
                return a
            out = np.full(a.shape[:-1] + (last,), fill, dtype=a.dtype)
            out[..., : a.shape[-1]] = a
            return out

        inputs = np.concatenate([pad3(r[0][0], W, -1) for r in results], axis=0)
        targets = np.concatenate(
            [pad3(r[0][1], W, 0) if T_vec else r[0][1] for r in results], axis=0
        )
        quals = np.concatenate([pad3(r[1], L, -1) for r in results], axis=0)
        self.tensor_max_width = max(self.tensor_max_width, W)
        self.tensor_max_seq_len = max(self.tensor_max_seq_len, L)
        return (inputs, targets), quals


def encode_fq_path_to_tensor(
    path: str | Path,
    kmer_size: int = default.KMER_SIZE,
    bases: str = default.BASES,
    qual_offset: int = default.QUAL_OFFSET,
    vectorized_target: bool = default.VECTORIZED_TARGET,
    max_width: int = 0,
    max_seq_len: int = 0,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, dict[str, int]]:
    """One-shot helper returning (input, target, qual, kmer2id_table).

    API parity with the reference's ``encode_fq_path_to_tensor``
    (reference: src/python.rs:288-340).
    """
    enc = TensorEncoder(
        option=FqEncoderOption(
            kmer_size=kmer_size,
            qual_offset=qual_offset,
            bases=bases,
            vectorized_target=vectorized_target,
        ),
        tensor_max_width=max_width,
        tensor_max_seq_len=max_seq_len,
    )
    (inputs, targets), quals = enc.encode(path)
    return inputs, targets, quals, dict(enc.kmer2id_table)


def encode_fq_paths_to_tensor(
    paths: Sequence[str | Path],
    kmer_size: int = default.KMER_SIZE,
    bases: str = default.BASES,
    qual_offset: int = default.QUAL_OFFSET,
    vectorized_target: bool = default.VECTORIZED_TARGET,
    parallel: bool = True,
    max_width: int = 0,
    max_seq_len: int = 0,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, dict[str, int]]:
    """Multi-file variant (reference: src/python.rs:342-402)."""
    enc = TensorEncoder(
        option=FqEncoderOption(
            kmer_size=kmer_size,
            qual_offset=qual_offset,
            bases=bases,
            vectorized_target=vectorized_target,
        ),
        tensor_max_width=max_width,
        tensor_max_seq_len=max_seq_len,
    )
    (inputs, targets), quals = enc.encode_multiple(paths, parallel=parallel)
    return inputs, targets, quals, dict(enc.kmer2id_table)
