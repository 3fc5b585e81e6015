"""Streaming chop pipeline: the port of `deepchopper_tpu/chop/pipeline.py`.

Loads prediction shards (.pt/.npz), streams the FASTQ in chunks, smooths and
splits each read, and writes an incrementally compressed BGZF output that is
renamed at the end to `<stem>.<N>pd.<M>record.chop.fq.gz` (N predictions
loaded, M records written). Without an `output_prefix` the output lands in
the current directory. Per chunk, smoothing is batched: the chunk's reads are
padded into one (B, L) matrix and voted in one pass
(`ops.labels.majority_voting_batch`). Over several ranks,
`multihost_stream_chop` chops each rank's reads in parallel and merges the
parts on rank 0.
"""

from __future__ import annotations

import json
import logging
import os
import resource
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from .. import default, native
from ..io.bgzf import BGZF_EOF, open_bgzf_writer
from ..io.chop import ChopType, FastqRecord, split_records_by_intervals, split_records_by_remove_intervals
from ..io.fastq import iter_fastq_chunks
from ..io.predicts import Predict, load_predicts_from_batch_pts
from ..ops.labels import get_label_region, majority_voting_batch

log = logging.getLogger(__name__)


@dataclass
class ChopOptions:
    """Chop-stage knobs with the reference's tuned defaults."""

    smooth_window_size: int = default.SMOOTH_WINDOW_SIZE
    min_interval_size: int = default.MIN_INTERVAL_SIZE
    approved_interval_number: int = default.APPROVED_INTERVAL_NUMBER
    max_process_intervals: int = default.MAX_PROCESS_INTERVALS
    min_read_length_after_chop: int = default.MIN_READ_LENGTH_AFTER_CHOP
    output_chopped_seqs: bool = False
    chop_type: ChopType = ChopType.ALL
    chunk_size: int = default.CHOP_CHUNK_SIZE
    threads: int = 2
    max_batch_size: int | None = None
    output_prefix: str | None = None
    min_read_len: int = default.MIN_READ_LEN
    id_annotation: bool = True
    # BGZF deflate level (6, the reference writers' default). The output
    # decompresses to the same bytes at any level.
    compression_level: int = 6


@dataclass
class ChopStats:
    total_fq_count: int = 0
    total_output_count: int = 0
    predicts_loaded: int = 0
    elapsed_s: float = 0.0
    peak_rss_bytes: int = 0
    output_file: str = ""
    extras: dict = field(default_factory=dict)


def output_name(fq_path: Path, opts: ChopOptions, stats: ChopStats) -> str:
    """`<prefix or input stem>.<N>pd.<M>record.chop.fq.gz`; without a prefix
    it is a bare name, so the file lands in the current directory (only the
    last extension is removed from the input's name)."""
    base = opts.output_prefix if opts.output_prefix is not None else fq_path.stem
    return f"{base}.{stats.predicts_loaded}pd.{stats.total_output_count}record.chop.fq.gz"


def temp_output_path(opts: ChopOptions) -> Path:
    """The hidden file the output is written to before its final rename, in
    the directory `output_name` resolves to (the prefix's, else the current
    one), so the rename never crosses filesystems. The JAX package puts it
    beside the input instead."""
    out_dir = Path(opts.output_prefix).parent if opts.output_prefix is not None else Path.cwd()
    out_dir.mkdir(parents=True, exist_ok=True)
    return out_dir / f".deepchopper_temp_{os.getpid()}.fq.gz"


def select_intervals(smoothed: np.ndarray, opts: ChopOptions) -> list[tuple[int, int]]:
    """Regions of one smoothed label row -> the intervals to chop: regions of
    at least `min_interval_size`, none at all above `approved_interval_number`."""
    regions = native.label_regions(smoothed) if native.available() else get_label_region(smoothed)
    kept = [(s, e) for (s, e) in regions if e - s >= opts.min_interval_size]
    return [] if len(kept) > opts.approved_interval_number else kept


def _select_intervals_batch(predicts: list[Predict], opts: ChopOptions) -> list[list[tuple[int, int]]]:
    """`Predict.smooth_and_select_intervals` over a chunk of reads, smoothed
    in one batched pass."""
    if not predicts:
        return []
    lengths = np.array([len(p.prediction) for p in predicts], dtype=np.int64)
    mat = np.zeros((len(predicts), int(lengths.max())), dtype=np.int8)
    for i, p in enumerate(predicts):
        mat[i, : lengths[i]] = p.prediction
    smoothed = majority_voting_batch(mat, lengths, opts.smooth_window_size)
    return [select_intervals(smoothed[i, : lengths[i]], opts) for i in range(len(predicts))]


def process_chunk(chunk: list[FastqRecord], all_predicts: dict[str, Predict], opts: ChopOptions) -> list[FastqRecord]:
    """Chop one chunk. Per read, in the reference's order: no prediction ->
    dropped; short read -> passthrough; zero or too many intervals ->
    passthrough; truncated (prediction shorter than the read) -> passthrough;
    else chop."""
    paired = [(rec, p) for rec in chunk if (p := all_predicts.get(rec.name)) is not None]
    intervals_per_read = _select_intervals_batch([p for _, p in paired], opts)
    results: list[FastqRecord] = []
    for (rec, p), intervals in zip(paired, intervals_per_read):
        if len(p.seq) < opts.min_read_len or not intervals or len(intervals) > opts.max_process_intervals:
            results.append(rec)
        elif len(p.seq) != len(rec.qual):
            log.debug("truncated prediction, passthrough: %s", rec.name)
            results.append(rec)
        elif opts.output_chopped_seqs:
            results.extend(split_records_by_intervals(p.seq, rec.name, rec.qual, intervals))
        else:
            results.extend(
                split_records_by_remove_intervals(
                    p.seq, rec.name, rec.qual, intervals, opts.min_read_length_after_chop, opts.id_annotation,
                    opts.chop_type,
                )  # fmt: skip
            )
    return results


def run_chop(predict_paths: list[str | Path], fq_path: str | Path, opts: ChopOptions | None = None) -> ChopStats:
    """Load the shards under `predict_paths`, then chop `fq_path`."""
    opts = opts or ChopOptions()
    all_predicts: dict[str, Predict] = {}
    for p in predict_paths:
        all_predicts.update(load_predicts_from_batch_pts(p, default.IGNORE_LABEL, opts.max_batch_size))
    log.info("collected %d predictions", len(all_predicts))
    return stream_chop_with_predicts(all_predicts, fq_path, opts)


def predict_cli(
    predicts: list[str | Path],
    fq: str | Path,
    threads: int = 2,
    max_batch_size: int | None = None,
    smooth_window_size: int = default.SMOOTH_WINDOW_SIZE,
    min_interval_size: int = default.MIN_INTERVAL_SIZE,
    approved_interval_number: int = default.APPROVED_INTERVAL_NUMBER,
    max_process_intervals: int = default.MAX_PROCESS_INTERVALS,
    min_read_length_after_chop: int = default.MIN_READ_LENGTH_AFTER_CHOP,
    output_chopped_seqs: bool = False,
    chop_type: ChopType = ChopType.ALL,
    output_prefix: str | None = None,
) -> ChopStats:
    """`run_chop` with the reference's `PredictOptions` knobs as arguments."""
    opts = ChopOptions(
        smooth_window_size=smooth_window_size,
        min_interval_size=min_interval_size,
        approved_interval_number=approved_interval_number,
        max_process_intervals=max_process_intervals,
        min_read_length_after_chop=min_read_length_after_chop,
        output_chopped_seqs=output_chopped_seqs,
        chop_type=chop_type,
        threads=threads,
        max_batch_size=max_batch_size,
        output_prefix=output_prefix,
    )
    return run_chop(list(predicts), fq, opts)


def _write_chopped(writer, all_predicts: dict[str, Predict], fq_path: Path, opts: ChopOptions) -> tuple[int, int]:
    """Stream `fq_path` in chunks, chop each and write its records; returns
    (reads read, records written)."""
    fq_count = output_count = 0
    for chunk in iter_fastq_chunks(fq_path, opts.chunk_size):
        fq_count += len(chunk)
        results = process_chunk(chunk, all_predicts, opts)
        for rec in results:
            writer.write(rec.to_bytes())
        output_count += len(results)
    return fq_count, output_count


def _part_paths(out_dir: Path, rank: int) -> tuple[Path, Path]:
    """A rank's raw BGZF part and its JSON sidecar of counts."""
    return out_dir / f".dc_chop_part_{rank}.fq.gz", out_dir / f".dc_chop_part_{rank}.json"


def multihost_stream_chop(
    all_predicts: dict[str, Predict],
    fq_path: str | Path,
    opts: ChopOptions | None = None,
    rank: int = 0,
    nprocs: int = 1,
    barrier=None,
) -> ChopStats | None:
    """Shard-parallel chop: every rank chops the reads it predicted.

    Each rank streams the whole FASTQ, and `process_chunk` drops the reads
    it holds no prediction for, so another rank's reads cost only the parse.
    Rank r writes a raw BGZF part (no EOF block) and a sidecar of its counts
    beside the output (the prefix's directory, else the input's, which every
    rank reads). After `barrier(name)`, rank 0 concatenates the parts in rank
    order, appends the one EOF block and renames the result to
    `output_name`'s `<stem>.<N>pd.<M>record.chop.fq.gz`. A missing sidecar
    (a rank that died before the barrier) raises, and every part and sidecar
    is removed either way.

    Records are grouped by rank (rank 0's reads 0, n, 2n, ..., then rank
    1's), not in FASTQ order: the record multiset equals a one-rank run's,
    the bytes only with nprocs=1. Returns the merged ChopStats on rank 0,
    None on the others."""
    opts = opts or ChopOptions()
    fq_path = Path(fq_path)
    start = time.monotonic()
    out_dir = Path(opts.output_prefix).parent if opts.output_prefix is not None else fq_path.parent
    out_dir.mkdir(parents=True, exist_ok=True)
    part_path, sidecar = _part_paths(out_dir, rank)
    try:
        with open_bgzf_writer(part_path, threads=opts.threads, level=opts.compression_level, write_eof=False) as writer:
            fq_count, output_count = _write_chopped(writer, all_predicts, fq_path, opts)
        sidecar.write_text(json.dumps({"fq_count": fq_count, "output_count": output_count,
                                       "predicts_loaded": len(all_predicts)}))  # fmt: skip
    except BaseException:
        part_path.unlink(missing_ok=True)
        sidecar.unlink(missing_ok=True)
        raise

    if barrier is not None:
        barrier("deepchopper_chop_parts_done")
    if rank != 0:
        return None

    stats = ChopStats(total_fq_count=fq_count)
    temp_output = temp_output_path(opts)
    try:
        # Every sidecar is read inside the cleanup's scope: a missing one
        # must not leave the other ranks' parts behind for a retry to merge.
        for r in range(nprocs):
            sc = _part_paths(out_dir, r)[1]
            if not sc.exists():
                raise FileNotFoundError(f"missing chop part sidecar for rank {r}: {sc}")
            counts = json.loads(sc.read_text())
            stats.total_output_count += counts["output_count"]
            stats.predicts_loaded += counts["predicts_loaded"]
        with open(temp_output, "wb") as out:
            for r in range(nprocs):
                with open(_part_paths(out_dir, r)[0], "rb") as fh:
                    while buf := fh.read(4 << 20):
                        out.write(buf)
            out.write(BGZF_EOF)
        stats.output_file = output_name(fq_path, opts, stats)
        os.replace(temp_output, stats.output_file)
    except BaseException:
        temp_output.unlink(missing_ok=True)
        raise
    finally:
        for r in range(nprocs):
            for path in _part_paths(out_dir, r):
                path.unlink(missing_ok=True)
    stats.elapsed_s = time.monotonic() - start
    stats.peak_rss_bytes = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    return stats


def stream_chop_with_predicts(
    all_predicts: dict[str, Predict], fq_path: str | Path, opts: ChopOptions | None = None
) -> ChopStats:
    """Streaming chop with the predictions already in memory."""
    opts = opts or ChopOptions()
    fq_path = Path(fq_path)
    start = time.monotonic()
    stats = ChopStats(predicts_loaded=len(all_predicts))
    temp_output = temp_output_path(opts)
    try:
        with open_bgzf_writer(temp_output, threads=opts.threads, level=opts.compression_level) as writer:
            stats.total_fq_count, stats.total_output_count = _write_chopped(writer, all_predicts, fq_path, opts)
        stats.output_file = output_name(fq_path, opts, stats)
        os.replace(temp_output, stats.output_file)
    except BaseException:
        temp_output.unlink(missing_ok=True)
        raise
    stats.elapsed_s = time.monotonic() - start
    stats.peak_rss_bytes = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    log.info(
        "processed %d reads -> %d records in %.2fs (peak RSS %.1f MB) -> %s",
        stats.total_fq_count, stats.total_output_count, stats.elapsed_s, stats.peak_rss_bytes / 1e6,
        stats.output_file,
    )  # fmt: skip
    return stats
