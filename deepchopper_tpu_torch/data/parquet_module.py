"""Train/val/test batch provider over FASTQ sources.

Port of `deepchopper_tpu/data/parquet_module.py` for FASTQ sources: explicit
files per split, or a seeded 80/10/10 ratio split of one file, an
epoch-seeded buffered shuffle of the training reads, and the bucketed
fixed-shape batcher. A ratio split filters the source stream by row index
(`_iter_encoded` of the JAX module); the JAX package's per-split parquet
cache gives the same reads in the same order, and is not ported. Parquet
sources need pyarrow and are not ported yet: they raise.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Iterator
from pathlib import Path

import numpy as np

from .bucketing import Batch, EncodedRead, bucketed_batches
from .fastq_module import iter_encoded_reads, parse_fastq_file

_FASTQ_SUFFIXES = (".fq", ".fastq", ".fq.gz", ".fastq.gz", ".fq.bgz", ".fastq.bgz")


def _fastq_path(path: str | Path) -> Path:
    p = Path(path)
    if not p.name.lower().endswith(_FASTQ_SUFFIXES):
        raise NotImplementedError(
            f"{p}: only FASTQ sources ({', '.join(_FASTQ_SUFFIXES)}) are ported; parquet sources "
            "need pyarrow and are queued in ROADMAP.md (queue 1, item 7)"
        )
    return p


def count_rows(path: str | Path) -> int:
    return sum(1 for _ in parse_fastq_file(_fastq_path(path)))


@dataclasses.dataclass
class SplitSpec:
    """Row-index split of one dataset (reference: hg_data.py ratio splits)."""

    train: np.ndarray
    val: np.ndarray
    test: np.ndarray


def ratio_split(n: int, train: float = 0.8, val: float = 0.1, seed: int = 0) -> SplitSpec:
    rng = np.random.default_rng(seed)
    order = rng.permutation(n)
    n_train = int(n * train)
    n_val = int(n * val)
    return SplitSpec(
        train=order[:n_train],
        val=order[n_train : n_train + n_val],
        test=order[n_train + n_val :],
    )


class DataModule:
    """Train/val/test/predict encoded-batch provider (the JAX DataModule's
    contract, FASTQ sources only)."""

    def __init__(
        self,
        train_data_path: str | None = None,
        val_data_path: str | None = None,
        test_data_path: str | None = None,
        predict_data_path: str | None = None,
        split_train: float = 0.8,
        split_val: float = 0.1,
        max_length: int = 32768,
        tokens_per_batch: int = 1 << 17,
        max_batch: int = 512,
        buckets: list[int] | None = None,
        shuffle_buffer: int = 4096,
        seed: int = 0,
    ):
        self.train_data_path = train_data_path
        self.val_data_path = val_data_path
        self.test_data_path = test_data_path
        self.predict_data_path = predict_data_path
        self.split_train = split_train
        self.split_val = split_val
        self.max_length = max_length
        self.tokens_per_batch = tokens_per_batch
        self.max_batch = max_batch
        self.buckets = buckets
        self.shuffle_buffer = shuffle_buffer
        self.seed = seed
        self._split: SplitSpec | None = None

    # -- split management --------------------------------------------------

    def _needs_ratio_split(self) -> bool:
        return self.train_data_path is not None and self.val_data_path is None

    def _get_split(self) -> SplitSpec:
        if self._split is None:
            n = count_rows(self.train_data_path)
            self._split = ratio_split(n, self.split_train, self.split_val, self.seed)
        return self._split

    def _iter_encoded(self, path: str, indices: np.ndarray | None) -> Iterator[EncodedRead]:
        reads = iter_encoded_reads(_fastq_path(path), self.max_length)
        if indices is None:
            yield from reads
            return
        allowed = set(int(i) for i in indices)
        for i, r in enumerate(reads):
            if i in allowed:
                yield r

    def _split_iter(self, which: str) -> Iterator[EncodedRead]:
        if self._needs_ratio_split():
            yield from self._iter_encoded(self.train_data_path, getattr(self._get_split(), which))
            return
        path = getattr(self, f"{which}_data_path")
        if path is None:
            raise ValueError(f"no {which} data path configured")
        yield from self._iter_encoded(path, None)

    # -- shuffling ---------------------------------------------------------

    def _shuffled(self, reads: Iterator[EncodedRead], epoch: int) -> Iterator[EncodedRead]:
        """Buffered streaming shuffle (epoch-seeded)."""
        if self.shuffle_buffer <= 1:
            yield from reads
            return
        rng = np.random.default_rng((self.seed, epoch))
        buf: list[EncodedRead] = []
        for r in reads:
            buf.append(r)
            if len(buf) >= self.shuffle_buffer:
                idx = rng.integers(len(buf))
                buf[idx], buf[-1] = buf[-1], buf[idx]
                yield buf.pop()
        rng.shuffle(buf)  # type: ignore[arg-type]
        yield from buf

    # -- batch iterators ---------------------------------------------------

    def _batches(self, reads: Iterator[EncodedRead]) -> Iterator[Batch]:
        yield from bucketed_batches(
            reads,
            buckets=self.buckets,
            tokens_per_batch=self.tokens_per_batch,
            max_batch=self.max_batch,
        )

    def train_batches(self, epoch: int = 0) -> Iterator[Batch]:
        yield from self._batches(self._shuffled(self._split_iter("train"), epoch))

    def val_batches(self) -> Iterator[Batch]:
        yield from self._batches(self._split_iter("val"))

    def test_batches(self) -> Iterator[Batch]:
        yield from self._batches(self._split_iter("test"))

    def predict_batches(self) -> Iterator[Batch]:
        if self.predict_data_path is None:
            raise ValueError("no predict data path configured")
        yield from self._batches(
            iter_encoded_reads(_fastq_path(self.predict_data_path), self.max_length, has_targets=False)
        )
