"""Parquet/JSON dataset encoders.

Copy of `deepchopper_tpu/io/parquet.py`: one row per read with the schema
{id: utf8, seq: utf8, qual: list<int32>, target: list<int32>}, written whole
or in chunks to `<stem>_chunks/<i>.parquet`. pyarrow is imported inside the
functions that need it (`require_pyarrow`), so the module imports where it
is absent; JSON needs nothing.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from .. import default
from ..ops.labels import parse_target_from_id
from ..ops.qual import encode_qual


def require_pyarrow():
    """(pyarrow, pyarrow.parquet), or an ImportError that names pyarrow."""
    try:
        import pyarrow as pa
        import pyarrow.parquet as pq
    except ImportError as exc:
        raise ImportError(f"parquet needs pyarrow, which cannot be imported here: {exc}") from exc
    return pa, pq


def _record_rows(fq_path: str | Path, kmer_size: int = 0):
    from .fastq import StreamingFastqReader

    for rec in StreamingFastqReader(fq_path):
        seq = rec.seq.decode("ascii").upper()
        if kmer_size > 0 and len(seq) < kmer_size:
            continue
        if len(rec.seq) != len(rec.qual):
            continue
        targets = parse_target_from_id(rec.name)
        yield {
            "id": rec.name,
            "seq": seq,
            "qual": encode_qual(rec.qual.decode("ascii")).tolist(),
            "target": [int(v) for se in targets for v in se],
        }


def _arrow_schema():
    pa, _ = require_pyarrow()
    return pa.schema(
        [
            pa.field("id", pa.string()),
            pa.field("seq", pa.string()),
            pa.field("qual", pa.list_(pa.int32())),
            pa.field("target", pa.list_(pa.int32())),
        ]
    )


def encode_fq_path_to_parquet(
    fq_path: str | Path, result_path: str | Path | None = None, kmer_size: int = 0, **_kw
) -> Path:
    """Encode one FASTQ to one parquet file (default: beside it, `.parquet`)."""
    pa, pq = require_pyarrow()
    fq_path = Path(fq_path)
    if result_path is None:
        result_path = fq_path.with_suffix(".parquet")
    rows = list(_record_rows(fq_path, kmer_size=kmer_size))
    pq.write_table(pa.Table.from_pylist(rows, schema=_arrow_schema()), result_path)
    return Path(result_path)


def encode_fq_paths_to_parquet(fq_paths: list[str | Path], **kw) -> list[Path]:
    return [encode_fq_path_to_parquet(p, **kw) for p in fq_paths]


def encode_fq_path_to_parquet_chunk(
    fq_path: str | Path, chunk_size: int = 1_000_000, parallel: bool = True, **_kw
) -> Path:
    """Encode one FASTQ to `<stem>_chunks/<i>.parquet`, `chunk_size` rows each."""
    pa, pq = require_pyarrow()
    fq_path = Path(fq_path)
    out_dir = fq_path.parent / f"{fq_path.stem}_chunks"
    out_dir.mkdir(parents=True, exist_ok=True)
    schema = _arrow_schema()
    chunk: list[dict] = []
    idx = 0
    for row in _record_rows(fq_path):
        chunk.append(row)
        if len(chunk) >= chunk_size:
            pq.write_table(pa.Table.from_pylist(chunk, schema=schema), out_dir / f"{idx}.parquet")
            chunk, idx = [], idx + 1
    if chunk:
        pq.write_table(pa.Table.from_pylist(chunk, schema=schema), out_dir / f"{idx}.parquet")
    return out_dir


def encode_fq_path_to_json(
    fq_path: str | Path, result_path: str | Path | None = None, kmer_size: int = 0, **_kw
) -> Path:
    """Encode one FASTQ to JSON lines, one row a line."""
    fq_path = Path(fq_path)
    if result_path is None:
        result_path = fq_path.with_suffix(".json")
    write_json(_record_rows(fq_path, kmer_size=kmer_size), result_path)
    return Path(result_path)


def write_json(records, path: str | Path) -> None:
    with open(path, "w") as fh:
        for row in records:
            fh.write(json.dumps(row) + "\n")


def write_parquet(records: list[dict], path: str | Path) -> None:
    pa, pq = require_pyarrow()
    pq.write_table(pa.Table.from_pylist(records, schema=_arrow_schema()), path)


def write_predicts(
    dataset: str | Path,
    output_fq_path: str | Path,
    predicts: list,
    smooth_window_size: int = 1,
    min_interval_size: int = 1,
    approved_interval_number: int = 0,
) -> None:
    """Chop a parquet dataset with externally supplied per-base labels and
    write a BGZF FASTQ.

    `predicts[i]` is the per-base 0/1 label vector of row i of the dataset
    ({id, seq, qual} columns), smoothed with `smooth_label_region` before the
    split. Quals are stored as Phred ints and written back offset by 33.
    """
    from ..ops.labels import smooth_label_region
    from .chop import split_records_by_remove_interval
    from .fastq import write_fq_parallel

    _, pq = require_pyarrow()
    table = pq.read_table(dataset, columns=["id", "seq", "qual"])
    ids = table.column("id").to_pylist()
    seqs = table.column("seq").to_pylist()
    quals = table.column("qual").to_pylist()

    records = []
    for i, (rid, seq, qual) in enumerate(zip(ids, seqs, quals)):
        labels = np.asarray(predicts[i], dtype=np.int8)
        intervals = smooth_label_region(labels, smooth_window_size, min_interval_size, approved_interval_number)
        qual_bytes = (np.asarray(qual, dtype=np.int64) + default.QUAL_OFFSET).astype(np.uint8).tobytes()
        records.extend(
            split_records_by_remove_interval(
                seq, rid, qual_bytes, intervals, default.MIN_CHOPED_SEQ_LEN, id_annotation=False
            )
        )
    write_fq_parallel(records, output_fq_path)


def extract_records_by_ids(fq_path: str | Path, ids: list[str]) -> list:
    """The records of a FASTQ whose names are in `ids`, in file order."""
    from .fastq import StreamingFastqReader

    wanted = set(ids)
    return [rec for rec in StreamingFastqReader(fq_path) if rec.name in wanted]


class JsonEncoder:
    """Class-style wrapper of `encode_fq_path_to_json`."""

    def __init__(self, option=None):
        self.option = option

    def encode(self, fq_path: str | Path, result_path: str | Path | None = None) -> Path:
        k = getattr(self.option, "kmer_size", 0) if self.option is not None else 0
        return encode_fq_path_to_json(fq_path, result_path, kmer_size=k)


class ParquetEncoder:
    """Class-style wrapper of the parquet encoders."""

    def __init__(self, option=None):
        self.option = option

    def encode(self, fq_path: str | Path, result_path: str | Path | None = None) -> Path:
        k = getattr(self.option, "kmer_size", 0) if self.option is not None else 0
        return encode_fq_path_to_parquet(fq_path, result_path, kmer_size=k)

    def encode_chunk(self, fq_path: str | Path, chunk_size: int = 1_000_000, parallel: bool = True):
        return encode_fq_path_to_parquet_chunk(fq_path, chunk_size=chunk_size, parallel=parallel)
