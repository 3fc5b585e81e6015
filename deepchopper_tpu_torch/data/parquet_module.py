"""Train/val/test/predict batch provider over parquet and FASTQ sources.

Copy of `deepchopper_tpu/data/parquet_module.py`. It reads the encoder's
parquet schema {id: utf8, seq: utf8, qual: list<int32>, target: list<int32>}
(`io/parquet.py`), one file or a directory of chunk files, and FASTQ files
wherever parquet is accepted (dispatch on the suffix). Splits are explicit
files per split, or a seeded 80/10/10 ratio split of one source; training
reads go through an epoch-seeded buffered shuffle into the bucketed
fixed-shape batcher.

A ratio split writes each split once into a hidden cache beside the source,
`.<name>.splits_s<seed>_t<train>_v<val>_<size>_<mtime ms>/{train,val,test}.parquet`
(a temporary directory renamed into place; regenerating the source changes
the tag), so an epoch reads only its own split. The one difference from the
JAX module: where pyarrow cannot be imported, or the cache cannot be written,
the split filters the source stream by row index instead, for FASTQ sources
too (the JAX module needs pyarrow for any ratio split). Both routes yield the
same reads in the same order. A parquet source needs pyarrow and raises an
ImportError that names it where pyarrow is absent.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
from collections.abc import Iterator
from pathlib import Path

import numpy as np

from ..io.parquet import require_pyarrow
from ..utils.trace import span
from .bucketing import Batch, EncodedRead, bucketed_batches, default_buckets, encode_read

_FASTQ_SUFFIXES = (".fq", ".fastq", ".fq.gz", ".fastq.gz", ".fq.bgz", ".fastq.bgz")
_SPLITS = ("train", "val", "test")


def _is_fastq(path: Path) -> bool:
    return path.name.lower().endswith(_FASTQ_SUFFIXES)


def _parquet_files(path: Path) -> list[Path]:
    if path.is_dir():
        files = sorted(path.rglob("*.parquet"))
        if not files:
            raise FileNotFoundError(f"no .parquet files under {path}")
        return files
    return [path]


def iter_parquet_rows(path: str | Path, columns: list[str] | None = None) -> Iterator[dict]:
    """Stream rows {id, seq, qual, target} from a parquet file or chunk dir."""
    _, pq = require_pyarrow()
    for f in _parquet_files(Path(path)):
        for rb in pq.ParquetFile(f).iter_batches(columns=columns):
            cols = {name: rb.column(i) for i, name in enumerate(rb.schema.names)}
            n = rb.num_rows
            ids = cols["id"].to_pylist()
            seqs = cols["seq"].to_pylist()
            quals = cols["qual"].to_pylist()
            targets = cols["target"].to_pylist() if "target" in cols else [None] * n
            for i in range(n):
                yield {"id": ids[i], "seq": seqs[i], "qual": quals[i], "target": targets[i]}


def _pairs(flat: list[int] | None) -> list[tuple[int, int]]:
    if not flat:
        return [(0, 0)]
    return [(flat[i], flat[i + 1]) for i in range(0, len(flat) - 1, 2)]


def iter_encoded_from_any(
    path: str | Path,
    max_length: int = 32768,
    has_targets: bool = True,
    max_samples: int | None = None,
) -> Iterator[EncodedRead]:
    """Encoded-read stream from a FASTQ or parquet source (suffix dispatch)."""
    p = Path(path)
    if _is_fastq(p):
        from .fastq_module import iter_encoded_reads

        yield from iter_encoded_reads(p, max_length, has_targets, max_samples)
        return
    for i, row in enumerate(iter_parquet_rows(p)):
        if max_samples is not None and i >= max_samples:
            return
        targets = _pairs(row["target"]) if has_targets else None
        yield encode_read(row["id"], row["seq"], np.asarray(row["qual"], np.int32), targets, max_length)


def count_rows(path: str | Path) -> int:
    p = Path(path)
    if _is_fastq(p):
        from .fastq_module import parse_fastq_file

        return sum(1 for _ in parse_fastq_file(p))
    _, pq = require_pyarrow()
    return sum(pq.ParquetFile(f).metadata.num_rows for f in _parquet_files(p))


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
    contract)."""

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

    def _split_cache_paths(self) -> dict[str, Path]:
        """The split files, in a directory tagged with the seed, the ratios and
        the source's size and mtime, so a regenerated source misses the cache."""
        base = Path(self.train_data_path)
        try:
            st = base.stat()
            src = f"_{st.st_size}_{st.st_mtime_ns // 1_000_000}"
        except OSError:
            src = ""
        tag = f"splits_s{self.seed}_t{self.split_train:g}_v{self.split_val:g}{src}"
        d = base.parent / f".{base.name}.{tag}"
        return {w: d / f"{w}.parquet" for w in _SPLITS}

    def _materialize_splits(self) -> dict[str, Path] | None:
        """Write the per-split parquet files in one pass over the source, or
        return the cache's if it is whole. None where pyarrow cannot be
        imported or the files cannot be written: the split then filters the
        source stream."""
        try:
            pa, pq = require_pyarrow()
        except ImportError:  # a cache written elsewhere is no use without it
            return None
        paths = self._split_cache_paths()
        cache_dir = paths["train"].parent
        if cache_dir.is_dir() and all(p.exists() for p in paths.values()):
            return paths
        split = self._get_split()
        n = sum(len(getattr(split, w)) for w in _SPLITS)
        member = np.empty(n, np.int8)
        for si, w in enumerate(_SPLITS):
            member[getattr(split, w)] = si
        # Written into a temporary directory renamed into place: a crash
        # mid-write never leaves a partial cache that a later run would trust.
        tmp_dir = cache_dir.with_name(cache_dir.name + f".tmp{os.getpid()}")
        try:
            from ..io.parquet import _arrow_schema

            tmp_dir.mkdir(parents=True, exist_ok=True)
            schema = _arrow_schema()
            writers = {}
            buffers: dict[str, list[dict]] = {w: [] for w in paths}

            def flush(w: str) -> None:
                if not buffers[w]:
                    return
                if w not in writers:
                    writers[w] = pq.ParquetWriter(tmp_dir / paths[w].name, schema)
                writers[w].write_table(pa.Table.from_pylist(buffers[w], schema=schema))
                buffers[w] = []

            for i, row in enumerate(self._iter_source_rows()):
                w = _SPLITS[member[i]]
                buffers[w].append(row)
                if len(buffers[w]) >= 10_000:
                    flush(w)
            for w in paths:
                flush(w)
                if w not in writers:  # an empty split still needs a valid file
                    writers[w] = pq.ParquetWriter(tmp_dir / paths[w].name, schema)
                writers[w].close()
            try:
                os.replace(tmp_dir, cache_dir)
            except OSError:
                # Another process (a rank of the same run) renamed its whole
                # cache into place first: keep it, it holds the same rows.
                if not all(p.exists() for p in paths.values()):
                    raise
                shutil.rmtree(tmp_dir, ignore_errors=True)
            return paths
        except Exception:  # noqa: BLE001 - fall back to in-stream filtering
            shutil.rmtree(tmp_dir, ignore_errors=True)
            return None

    def _iter_source_rows(self) -> Iterator[dict]:
        """{id, seq, qual, target} rows of the ratio-split source."""
        p = Path(self.train_data_path)
        if _is_fastq(p):
            from .fastq_module import parse_fastq_file

            for rec in parse_fastq_file(p):
                yield {
                    "id": rec["id"],
                    "seq": rec["seq"],
                    "qual": np.asarray(rec["qual"]).tolist(),
                    "target": [v for se in rec["target"] for v in se],
                }
            return
        yield from iter_parquet_rows(p)

    def _iter_encoded(self, path: str, indices: np.ndarray | None) -> Iterator[EncodedRead]:
        if indices is None:
            yield from iter_encoded_from_any(path, self.max_length)
            return
        allowed = set(int(i) for i in indices)
        for i, r in enumerate(iter_encoded_from_any(path, self.max_length)):
            if i in allowed:
                yield r

    def _split_iter(self, which: str) -> Iterator[EncodedRead]:
        if self._needs_ratio_split():
            paths = self._materialize_splits()
            if paths is not None:
                yield from iter_encoded_from_any(paths[which], self.max_length)
                return
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
        """Bucketed batches on the ladder, with max_length appended above its
        top as predict's engine does. The JAX module keeps the bare ladder
        whatever max_length is, so a read past 32768 tokens there fails
        to fit its clamped bucket (ROADMAP queue 3)."""
        ladder = default_buckets()
        yield from bucketed_batches(
            reads,
            buckets=self.buckets or default_buckets(max(self.max_length, ladder[-1])),
            tokens_per_batch=self.tokens_per_batch,
            max_batch=self.max_batch,
        )

    def train_batches(self, epoch: int = 0) -> Iterator[Batch]:
        """The epoch's shuffled, bucketed batches; producing each is the span
        `data.batch` (read, encode, shuffle and bucket; `data.pad` inside it)."""
        batches = self._batches(self._shuffled(self._split_iter("train"), epoch))
        while True:
            with span("data.batch"):
                batch = next(batches, None)
            if batch is None:
                return
            yield batch

    def val_batches(self) -> Iterator[Batch]:
        yield from self._batches(self._split_iter("val"))

    def test_batches(self) -> Iterator[Batch]:
        yield from self._batches(self._split_iter("test"))

    def predict_batches(self) -> Iterator[Batch]:
        if self.predict_data_path is None:
            raise ValueError("no predict data path configured")
        yield from self._batches(iter_encoded_from_any(self.predict_data_path, self.max_length, has_targets=False))
