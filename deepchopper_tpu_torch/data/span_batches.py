"""Zero-copy chunked FASTQ -> padded device batches over the native host plane.

Copy of `deepchopper_tpu/data/span_batches.py`, the feed of the fused
predict+chop path. The per-read Python of `data.fastq_module` is replaced by
whole-chunk calls:

  file bytes --(native.fq_index)--> span table
             --(bucket by length, NumPy)--> row groups
             --(native.encode_spans_batch, threaded C++)--> (B, W) int8/uint8

Reads stay as byte spans inside their chunk buffer until the chop stage
slices them. Without the native library (or with DEEPCHOPPER_NO_NATIVE=1)
`fq_index_py` and `encode_spans_py` compute the same tables in Python and
NumPy: they are the oracle of the native calls.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable, Iterator
from pathlib import Path

import numpy as np

from .. import default, native
from ..io.fastq import open_compressed_reader
from ..ops.sequence import normalize_seq_bytes, tokenize_bases
from ..utils.trace import span
from .bucketing import default_buckets

_CHUNK_BYTES = 8 << 20


@dataclasses.dataclass
class FastqChunk:
    """One raw chunk of the input file plus its record span table.

    `intervals[row]` is filled by the fused runner once the read's prediction
    has been smoothed: (truncated, list of adapter intervals). A chunk is
    choppable when `remaining == 0`.
    """

    chunk_id: int
    buf: np.ndarray  # uint8 raw bytes (records only; carry trimmed)
    spans: np.ndarray  # (n, 8) int64 from fq_index
    remaining: int
    intervals: list  # per row: None until predicted

    @property
    def n_records(self) -> int:
        return self.spans.shape[0]


@dataclasses.dataclass
class SpanBatch:
    """Duck-types data.bucketing.Batch for PredictEngine.predict_batches."""

    input_ids: np.ndarray  # (B, W) int8
    quals_raw: np.ndarray  # (B, W) uint8
    lengths: np.ndarray  # (B,) int32: valid tokens incl. SEP
    refs: list[tuple[FastqChunk, int]]  # (chunk, span row) per batch row


def fq_index_py(buf: bytes, final: bool = True) -> tuple[np.ndarray, int]:
    """`native.fq_index` in Python: the same (N, 8) span table and consumed
    byte count, the same errors."""
    n = len(buf)

    def line_end(start: int) -> tuple[int, int]:
        nl = buf.find(b"\n", start)
        end = nl if nl >= 0 else n
        length = end - start
        if length > 0 and buf[end - 1] == 0x0D:
            length -= 1
        return (nl + 1 if nl >= 0 else n), length

    rows: list[tuple[int, ...]] = []
    pos = consumed = 0
    while pos < n:
        while pos < n and buf[pos] in (0x0A, 0x0D):
            pos += 1
        if pos >= n:
            break
        if buf[pos] != 0x40:
            raise ValueError("fq_index: malformed header (expected '@')")
        id_off = pos + 1
        pos, id_len = line_end(id_off)
        if pos >= n:
            break
        head = buf[id_off : id_off + id_len]
        cut = min((i for i in (head.find(b" "), head.find(b"\t")) if i >= 0), default=-1)
        name_len, d_off, d_len = (id_len, -1, 0) if cut < 0 else (cut, id_off + cut + 1, id_len - cut - 1)
        s_off = pos
        pos, s_len = line_end(s_off)
        if pos >= n:
            break
        if buf[pos] != 0x2B:
            raise ValueError("fq_index: malformed '+' separator")
        pos, _ = line_end(pos)
        if pos >= n:
            break
        q_off = pos
        pos, q_len = line_end(q_off)
        if pos >= n and not final and (buf[n - 1] != 0x0A or q_len < s_len):
            break  # the quality line may continue in the next chunk
        if q_len != s_len:
            raise ValueError("fq_index: sequence/quality length mismatch")
        rows.append((id_off, name_len, s_off, s_len, q_off, q_len, d_off, d_len))
        consumed = pos
    return np.asarray(rows, np.int64).reshape(-1, 8), consumed


def encode_spans_py(
    buf: np.ndarray, spans: np.ndarray, rows: np.ndarray, width: int, max_len: int,
    out: tuple[np.ndarray, np.ndarray, np.ndarray],
) -> None:  # fmt: skip
    """`native.encode_spans_batch` in NumPy: for read i of length L and
    t = min(L, max_len - 1, width - 1), ids[i, :t] = normalized tokens,
    ids[i, t] = SEP, PAD after; quals[i, :t] = clip(phred, 0, 255), 0 after;
    lengths[i] = t + 1."""
    ids, quals, lengths = out
    for j, r in enumerate(rows):
        s_off, s_len, q_off = (int(v) for v in spans[r, 2:5])
        t = min(s_len, max_len - 1, width - 1)
        ids[j, :t] = tokenize_bases(normalize_seq_bytes(buf[s_off : s_off + t]))
        ids[j, t] = default.TOKEN_SEP
        ids[j, t + 1 :] = default.TOKEN_PAD
        quals[j, :t] = np.clip(buf[q_off : q_off + t].astype(np.int16) - default.QUAL_OFFSET, 0, 255)
        quals[j, t:] = 0
        lengths[j] = t + 1


def iter_fastq_chunks_indexed(path: str | Path, chunk_bytes: int = _CHUNK_BYTES) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Stream (buf, spans) pairs over a (possibly compressed) FASTQ."""
    use_native = native.available()
    fh = open_compressed_reader(path)
    carry = b""
    try:
        while True:
            with span("source.index"):
                data = fh.read(chunk_bytes)
                final = not data
                raw = carry + data if carry else data
                if not raw:
                    break
                buf = np.frombuffer(raw, np.uint8)
                spans, consumed = native.fq_index(buf, final=final) if use_native else fq_index_py(raw, final)
            if spans.shape[0]:
                yield buf, spans
            carry = raw[consumed:]
            if final:
                if carry.strip(b"\r\n"):
                    raise ValueError(f"{path}: truncated FASTQ record at EOF")
                break
    finally:
        fh.close()


class SpanBatchSource:
    """Bucketed batch generator over indexed chunks.

    `on_chunk` fires (in file order) as each chunk is indexed, letting the
    fused runner keep an ordered queue for in-order output. Buckets flush when
    full; a bucket whose oldest pending read is `max_lag_chunks` chunks old is
    force-flushed so chunk buffers do not pile up.
    """

    def __init__(
        self,
        path: str | Path,
        max_length: int = 32768,
        tokens_per_batch: int = 1 << 17,
        buckets: list[int] | None = None,
        max_batch: int = 512,
        max_samples: int | None = None,
        chunk_bytes: int = _CHUNK_BYTES,
        on_chunk: Callable[[FastqChunk], None] | None = None,
        max_lag_chunks: int = 2,
        threads: int | None = None,
    ):
        self.path = Path(path)
        self.max_length = max_length
        self.buckets = np.asarray(buckets or default_buckets(max_length), np.int64)
        self.tokens_per_batch = tokens_per_batch
        self.max_batch = max_batch
        self.max_samples = max_samples
        self.chunk_bytes = chunk_bytes
        self.on_chunk = on_chunk
        self.max_lag_chunks = max_lag_chunks
        self.threads = threads

    def _target_rows(self, width: int) -> int:
        return max(1, min(self.max_batch, self.tokens_per_batch // width))

    def _emit(self, width: int, pending: list[tuple[FastqChunk, np.ndarray]]) -> SpanBatch:
        """Encode pending (chunk, rows) groups into one padded batch."""
        with span("source.encode"):
            b = sum(rows.size for _, rows in pending)
            ids = np.empty((b, width), np.int8)
            quals = np.empty((b, width), np.uint8)
            lengths = np.empty(b, np.int32)
            refs: list[tuple[FastqChunk, int]] = []
            use_native = native.available()
            at = 0
            for chunk, rows in pending:
                nb = rows.size
                out = (ids[at : at + nb], quals[at : at + nb], lengths[at : at + nb])
                if use_native:
                    native.encode_spans_batch(
                        chunk.buf, chunk.spans, rows, width, self.max_length, default.TOKEN_SEP, default.TOKEN_PAD,
                        qual_offset=default.QUAL_OFFSET, threads=self.threads, out=out,
                    )  # fmt: skip
                else:
                    encode_spans_py(chunk.buf, chunk.spans, rows, width, self.max_length, out)
                refs.extend((chunk, int(r)) for r in rows)
                at += nb
        return SpanBatch(ids, quals, lengths, refs)

    def batches(self) -> Iterator[SpanBatch]:
        buckets = self.buckets
        # pending[i]: list of (chunk, row-array) groups; counts[i] their rows.
        pending: list[list[tuple[FastqChunk, np.ndarray]]] = [[] for _ in buckets]
        counts = np.zeros(len(buckets), np.int64)
        oldest = np.full(len(buckets), -1, np.int64)
        emitted = 0

        for chunk_id, (buf, spans) in enumerate(iter_fastq_chunks_indexed(self.path, self.chunk_bytes)):
            if self.max_samples is not None:
                left = self.max_samples - emitted - int(counts.sum())
                if left <= 0:
                    break
                spans = spans[:left]
            chunk = FastqChunk(chunk_id, buf, spans, spans.shape[0], [None] * spans.shape[0])
            if self.on_chunk is not None:
                self.on_chunk(chunk)
            widths = np.minimum(spans[:, 3], self.max_length - 1) + 1
            bucket_idx = np.minimum(np.searchsorted(buckets, widths, side="left"), len(buckets) - 1)
            for bi in np.unique(bucket_idx):
                rows = np.nonzero(bucket_idx == bi)[0].astype(np.int64)
                width = int(buckets[bi])
                target = self._target_rows(width)
                if oldest[bi] < 0:
                    oldest[bi] = chunk_id
                start = 0
                # Top up the pending group to target, emitting full batches.
                while counts[bi] + (rows.size - start) >= target:
                    take = target - int(counts[bi])
                    pending[bi].append((chunk, rows[start : start + take]))
                    start += take
                    yield self._emit(width, pending[bi])
                    emitted += target
                    pending[bi] = []
                    counts[bi] = 0
                    oldest[bi] = chunk_id if start < rows.size else -1
                if start < rows.size:
                    pending[bi].append((chunk, rows[start:]))
                    counts[bi] += rows.size - start
                    if oldest[bi] < 0:
                        oldest[bi] = chunk_id
            # Force-flush stale buckets so old chunk buffers can be chopped
            # and released instead of waiting for a full batch.
            for bi in range(len(buckets)):
                if counts[bi] and chunk_id - oldest[bi] >= self.max_lag_chunks:
                    yield self._emit(int(buckets[bi]), pending[bi])
                    emitted += int(counts[bi])
                    pending[bi] = []
                    counts[bi] = 0
                    oldest[bi] = -1
        for bi in range(len(buckets)):
            if counts[bi]:
                yield self._emit(int(buckets[bi]), pending[bi])
                pending[bi] = []
                counts[bi] = 0
