"""Streamed fused predict+chop: FASTQ -> chopped BGZF in one pass.

Port of `deepchopper_tpu/infer/fused.py`:

* reads are encoded a chunk at a time by the native host plane
  (`data.span_batches`), with no Python object per read;
* smoothing and interval extraction run per batch as the device's labels
  land (threaded C++ majority vote over the padded matrix);
* each chunk is chopped and written as soon as all of its reads have
  predictions, in file order, straight from the chunk's byte buffer.

Four threads: the engine's prefetch thread encodes batches, the caller's
thread feeds the device and waits on its results, a chop worker votes and
chops, and the BGZF writer's own thread deflates and writes what the worker
hands it (`io.bgzf.BgzfWriter`). The chop semantics are those of
`chop.pipeline.process_chunk`.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import queue
import resource
import threading
import time
from collections import deque
from pathlib import Path

import numpy as np

from .. import native
from ..chop.pipeline import ChopOptions, ChopStats, output_name, select_intervals, temp_output_path
from ..data.span_batches import FastqChunk, SpanBatchSource
from ..io.bgzf import open_bgzf_writer
from ..io.chop import ChopType, split_records_by_intervals, split_records_by_remove_intervals
from ..ops.labels import majority_voting_batch
from ..ops.sequence import normalize_seq_bytes
from ..utils.trace import span, timed

log = logging.getLogger(__name__)


@dataclasses.dataclass
class FusedStats(ChopStats):
    """ChopStats plus a host/device stage breakdown (wall seconds)."""

    encode_s: float = 0.0  # wall minus device_s: the feed thread's own work, handoff_s included
    device_s: float = 0.0  # feed thread blocked on device results
    handoff_s: float = 0.0  # feed thread handing batches to the chop worker, blocked on its full queue included
    smooth_s: float = 0.0  # worker: majority vote + region extraction (overlaps the device)
    chop_write_s: float = 0.0  # worker: record split + handing it to the BGZF writer, its wait included
    first_write_s: float = 0.0  # wall from the start to the first chopped chunk handed to the writer
    # The engine over this pass: CUDA graph captures (inside device_s), its
    # dispatches, and the tokens it read and computed (padding included).
    compile_s: float = 0.0
    dispatches: int = 0
    tokens: int = 0
    padded_tokens: int = 0


def _engine_totals(s) -> tuple:
    """The `PredictStats` totals a pass reports the growth of."""
    return s.compile_s, s.dispatches, s.tokens, s.padded_tokens


_CHOP_TYPE_CODE = {ChopType.ALL: 0, ChopType.TERMINAL: 1, ChopType.INTERNAL: 2}


def _chop_chunk(chunk: FastqChunk, opts: ChopOptions, writer, stats: FusedStats) -> None:
    """Chop one completed chunk in record order, writing to `writer`.

    Per read: short read, no or too many intervals, or a truncated prediction
    -> passthrough unchanged. Runs the C++ chop kernel (`native.chop_records`,
    GIL-free) with the Python loop as fallback and oracle.
    """
    if native.available():
        pairs: list[int] = []
        offs = np.empty(chunk.n_records, np.int64)
        cnts = np.empty(chunk.n_records, np.int64)
        trunc = np.empty(chunk.n_records, np.uint8)
        for row in range(chunk.n_records):
            is_trunc, kept = chunk.intervals[row]
            offs[row] = len(pairs) // 2
            cnts[row] = len(kept)
            trunc[row] = int(is_trunc)
            for s, e in kept:
                pairs += (s, e)
        result = native.chop_records(
            chunk.buf, chunk.spans, np.asarray(pairs, np.int64), offs, cnts, trunc,
            opts.min_read_len, opts.max_process_intervals, opts.min_read_length_after_chop,
            opts.output_chopped_seqs, _CHOP_TYPE_CODE[opts.chop_type], opts.id_annotation,
        )  # fmt: skip
        if result is not None:
            data, n_out = result
            writer.write(data)
            stats.total_fq_count += chunk.n_records
            stats.total_output_count += n_out
            chunk.buf = chunk.spans = None
            return
    buf = chunk.buf
    mv = memoryview(buf)
    for row in range(chunk.n_records):
        id_off, name_len, s_off, s_len, q_off, q_len, d_off, d_len = (int(v) for v in chunk.spans[row])
        header_end = d_off + d_len if d_off >= 0 else id_off + name_len
        truncated, kept = chunk.intervals[row]
        stats.total_fq_count += 1
        if s_len < opts.min_read_len or not kept or len(kept) > opts.max_process_intervals or truncated:
            header, seq, qual = (mv[a:b].tobytes() for a, b in
                                 ((id_off, header_end), (s_off, s_off + s_len), (q_off, q_off + q_len)))  # fmt: skip
            writer.write(b"@%s\n%s\n+\n%s\n" % (header, seq, qual))
            stats.total_output_count += 1
            continue
        name = mv[id_off : id_off + name_len].tobytes().decode("ascii")
        seq = normalize_seq_bytes(buf[s_off : s_off + s_len]).tobytes()
        qual = mv[q_off : q_off + q_len].tobytes()
        if opts.output_chopped_seqs:
            recs = split_records_by_intervals(seq, name, qual, kept)
        else:
            recs = split_records_by_remove_intervals(
                seq, name, qual, kept, opts.min_read_length_after_chop, opts.id_annotation, opts.chop_type
            )
        for rec in recs:
            writer.write(rec.to_bytes())
        stats.total_output_count += len(recs)
    chunk.buf = chunk.spans = None  # release the chunk buffer early


def fused_predict_chop(
    engine,
    fq_path: str | Path,
    opts: ChopOptions | None = None,
    max_samples: int | None = None,
    chunk_bytes: int = 2 << 20,
) -> FusedStats:
    """Run the fused pipeline with `engine` (a `PredictEngine` built with
    `return_labels=True`); returns stats with a stage breakdown.

    Small chunks keep several in flight even for modest inputs, so completed
    chunks are chopped on the worker while later ones are still predicting;
    the lag before a bucket is force-flushed scales inversely, so the live
    chunks hold ~32 MB whatever the chunk size.
    """
    if not engine.return_labels:
        raise ValueError("construct PredictEngine(return_labels=True) for the fused path")
    opts = opts or ChopOptions()
    fq_path = Path(fq_path)
    stats = FusedStats()
    engine_before = _engine_totals(engine.stats)
    start = time.monotonic()

    order: deque[FastqChunk] = deque()
    source = SpanBatchSource(
        fq_path,
        max_length=engine.max_length,
        tokens_per_batch=engine.tokens_per_batch,
        buckets=list(engine.buckets),
        max_batch=engine.max_batch,
        max_samples=max_samples,
        chunk_bytes=chunk_bytes,
        on_chunk=order.append,
        max_lag_chunks=max(2, (32 << 20) // chunk_bytes),
    )
    temp_output = temp_output_path(opts)

    def chop_ready(writer) -> None:
        """Chop, in file order, every leading chunk whose reads all have
        intervals."""
        while order and order[0].remaining == 0:
            _chop_chunk(order.popleft(), opts, writer, stats)
            if not stats.first_write_s:
                stats.first_write_s = time.monotonic() - start

    def consume(batch, labels, writer) -> None:
        """Vote and extract regions for one batch, then chop the completed
        chunks. Runs on the worker: the C++ vote and region kernels release
        the GIL, so this overlaps the feed thread, and the writer deflates on
        its own thread."""
        with timed("chop.vote") as vote:
            pred_lens = (batch.lengths.astype(np.int64) - 1).clip(min=0)
            smoothed = majority_voting_batch(labels, pred_lens, opts.smooth_window_size)
        with timed("chop.regions") as regions:
            for i, (chunk, row) in enumerate(batch.refs):
                n = int(pred_lens[i])
                # A prediction shorter than the read: truncated at encode.
                chunk.intervals[row] = (n != int(chunk.spans[row, 3]), select_intervals(smoothed[i, :n], opts))
                chunk.remaining -= 1
                stats.predicts_loaded += 1
        stats.smooth_s += vote.seconds + regions.seconds
        with timed("chop.records") as records:
            chop_ready(writer)
        stats.chop_write_s += records.seconds

    work: queue.Queue = queue.Queue(maxsize=8)
    worker_err: list[BaseException] = []

    def worker_loop(writer) -> None:
        while True:
            with span("fused.worker_wait"):
                item = work.get()
            if item is None:
                return
            try:
                consume(*item, writer)
            except BaseException as exc:  # noqa: BLE001 - raised again on the feed thread
                worker_err.append(exc)
                return

    def put(item) -> bool:
        """Hand `item` to the worker; False once the worker has died (a dead
        worker leaves the queue full, so a blocking put would deadlock)."""
        while not worker_err:
            try:
                work.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    try:
        with open_bgzf_writer(temp_output, threads=opts.threads, level=opts.compression_level) as writer:
            worker = threading.Thread(target=worker_loop, args=(writer,), name="fused-chop", daemon=True)
            worker.start()
            try:
                t_last = time.monotonic()
                for batch, labels in engine.predict_batches(source.batches()):
                    stats.device_s += time.monotonic() - t_last  # time blocked in the iterator
                    with timed("fused.handoff") as handoff:
                        handed = put((batch, labels))
                    stats.handoff_s += handoff.seconds
                    if not handed:
                        break
                    t_last = time.monotonic()
            finally:
                # Stop the worker before the writer closes, even on error.
                while worker.is_alive():
                    try:
                        work.put(None, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                worker.join()
            if worker_err:
                raise worker_err[0]
            for chunk in order:
                if chunk.remaining:
                    raise RuntimeError(f"chunk {chunk.chunk_id}: {chunk.remaining} reads never predicted")
            chop_ready(writer)
        stats.output_file = output_name(fq_path, opts, stats)
        os.replace(temp_output, stats.output_file)
    except BaseException:
        temp_output.unlink(missing_ok=True)
        raise

    stats.elapsed_s = time.monotonic() - start
    stats.compile_s, stats.dispatches, stats.tokens, stats.padded_tokens = (
        now - was for now, was in zip(_engine_totals(engine.stats), engine_before)
    )
    # smooth/chop run on the worker and overlap the device: stage seconds are
    # per-stage busy time, not a partition of the wall time.
    stats.encode_s = max(stats.elapsed_s - stats.device_s, 0.0)
    stats.peak_rss_bytes = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    log.info(
        "fused: %d reads -> %d records in %.2fs (device-wait %.2fs, handoff-wait %.2fs, smooth %.2fs, "
        "chop+write %.2fs) -> %s",
        stats.total_fq_count, stats.total_output_count, stats.elapsed_s, stats.device_s, stats.handoff_s,
        stats.smooth_s, stats.chop_write_s, stats.output_file,
    )  # fmt: skip
    return stats
