"""BGZF (blocked gzip) writer and reader.

Copy of `deepchopper_tpu/io/bgzf.py`, but for where the writer deflates: on a
thread of its own, behind a bounded queue, so a caller that hands it a burst
goes back to its own work. Blocks are independent deflate streams, so
compression runs many blocks per call in the native library's thread pool,
or, without it, one block per task on a Python thread pool (zlib releases
the GIL while it compresses).
"""

from __future__ import annotations

import collections
import functools
import io
import struct
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import BinaryIO

from .. import native
from ..utils.trace import span

# Max uncompressed payload per BGZF block.
MAX_BLOCK_SIZE = 65280
# Most payload a writer holds queued for its compressor thread: two of the
# fused runner's worst bursts of completed chunks (~32 MB each).
BACKLOG_BYTES = 64 << 20

# Standard 28-byte BGZF EOF marker block.
BGZF_EOF = bytes.fromhex("1f8b08040000000000ff0600424302001b0003000000000000000000")

_HEADER = struct.Struct("<4BI2BH2BHH")  # gzip header + XLEN + BC extra field
_FOOTER = struct.Struct("<2I")


def compress_block(data: bytes, level: int = 6) -> bytes:
    """Compress one <= 64 KiB payload into a standalone BGZF block."""
    compressor = zlib.compressobj(level, zlib.DEFLATED, -15)
    cdata = compressor.compress(data) + compressor.flush()
    bsize = len(cdata) + 26 - 1  # header (18) + footer (8) == 26; BSIZE stores total - 1
    header = _HEADER.pack(
        0x1F, 0x8B, 0x08, 0x04,  # magic, deflate, FEXTRA
        0,  # mtime
        0, 0xFF,  # XFL, OS = unknown
        6,  # XLEN
        0x42, 0x43,  # 'B', 'C'
        2,  # subfield data length
        bsize,  # total block size - 1
    )  # fmt: skip
    footer = _FOOTER.pack(zlib.crc32(data) & 0xFFFFFFFF, len(data) & 0xFFFFFFFF)
    return header + cdata + footer


class BgzfWriter(io.RawIOBase):
    """Streaming BGZF writer that deflates on a thread of its own.

    `write` cuts the payload into batches of whole blocks and queues them. One
    compressor thread deflates each batch (many blocks a call in the native
    library's thread pool, or without it one block a task on a Python thread
    pool: zlib releases the GIL) and writes it to the sink in the order it was
    queued, so the stream is that of one `native.bgzf_compress` over the whole
    payload, whatever the thread count. The queue holds at most
    `BACKLOG_BYTES` of payload: `write` waits only while it is full (span
    `chop.bgzf_wait`). The thread runs while the queue holds work and exits
    when it empties. An error of the deflate or the sink is raised on the next
    `write`, `flush` or `close`; `flush` and `close` wait until every queued
    batch is written. Closing writes the 28-byte EOF marker, unless
    `write_eof=False`: a rank of the shard-parallel chop writes a raw block
    stream, and the merge appends one EOF after every rank's part (BGZF
    blocks are standalone gzip members, so the concatenation is valid).
    """

    def __init__(self, sink: BinaryIO, threads: int = 4, level: int = 6, write_eof: bool = True):
        super().__init__()
        self._sink = sink
        self._write_eof = write_eof
        self._level = level
        self._threads = max(1, threads)
        self._buf = bytearray()
        self._batch = MAX_BLOCK_SIZE * max(8, self._threads * 8)
        self._native = native.available()
        self._pool = ThreadPoolExecutor(max_workers=self._threads) if not self._native and threads > 1 else None
        self._cond = threading.Condition()
        self._queue: collections.deque[bytes] = collections.deque()
        self._held = 0  # payload bytes queued or being deflated
        self._running = False  # a compressor thread is draining the queue
        self._thread: threading.Thread | None = None  # the last one started
        self._error: BaseException | None = None

    def writable(self) -> bool:
        return True

    def write(self, data) -> int:
        self._buf.extend(data)
        while len(self._buf) >= self._batch:
            chunk = bytes(self._buf[: self._batch])
            del self._buf[: self._batch]
            self._submit(chunk)
        return len(data)

    def _full(self, n: int) -> bool:
        return self._error is None and self._held > 0 and self._held + n > BACKLOG_BYTES

    def _submit(self, chunk: bytes) -> None:
        """Queue `chunk` for the compressor, waiting while the queue is full."""
        with self._cond:
            if self._full(len(chunk)):
                with span("chop.bgzf_wait"):
                    self._cond.wait_for(lambda: not self._full(len(chunk)))
            self._raise_error()
            self._queue.append(chunk)
            self._held += len(chunk)
            if not self._running:
                self._running = True
                self._thread = threading.Thread(target=self._compress_queue, name="bgzf-compress", daemon=True)
                self._thread.start()

    def _compress_queue(self) -> None:
        """The compressor thread: deflate and write the queued batches in
        order until the queue is empty, or drop them after an error."""
        while True:
            with self._cond:
                if self._error is not None:
                    self._queue.clear()
                    self._held = 0
                if not self._queue:
                    self._running = False
                    self._cond.notify_all()
                    return
                chunk = self._queue[0]
            try:
                with span("chop.bgzf"):
                    self._sink.write(self._deflate(chunk))
            except BaseException as exc:  # noqa: BLE001 - raised again on the writer's caller
                self._error = exc
            with self._cond:
                self._queue.popleft()
                self._held -= len(chunk)
                self._cond.notify_all()

    def _deflate(self, chunk: bytes) -> bytes:
        if self._native:
            return native.bgzf_compress(chunk, self._level, self._threads)
        blocks = [chunk[i : i + MAX_BLOCK_SIZE] for i in range(0, len(chunk), MAX_BLOCK_SIZE)]
        deflate = functools.partial(compress_block, level=self._level)
        return b"".join(self._pool.map(deflate, blocks) if self._pool is not None else map(deflate, blocks))

    def _raise_error(self) -> None:
        if self._error is not None:
            raise self._error

    def flush(self) -> None:
        if self.closed or self._sink.closed:
            return
        if self._buf:
            chunk = bytes(self._buf)
            self._buf.clear()
            self._submit(chunk)
        with self._cond:
            self._cond.wait_for(lambda: not self._running)
        self._raise_error()
        self._sink.flush()

    def close(self) -> None:
        if self.closed:
            return
        try:
            self.flush()
            if self._write_eof:
                self._sink.write(BGZF_EOF)
            self._sink.flush()
        finally:
            # The compressor exits once the queue is empty, or at once after an error.
            if self._thread is not None:
                self._thread.join()
            if self._pool is not None:
                self._pool.shutdown(wait=True)
            self._sink.close()
            super().close()


def open_bgzf_writer(path, threads: int = 4, level: int = 6, write_eof: bool = True) -> io.BufferedWriter:
    """Open a buffered BGZF writer at `path`."""
    raw = BgzfWriter(open(path, "wb"), threads=threads, level=level, write_eof=write_eof)
    return io.BufferedWriter(raw, buffer_size=MAX_BLOCK_SIZE)


class ParallelBgzfReader(io.RawIOBase):
    """Streaming BGZF reader that inflates complete blocks in parallel in the
    native library (callers open gzip instead when it is unavailable)."""

    _READ_CHUNK = 4 << 20

    def __init__(self, source, threads: int = 4):
        super().__init__()
        self._src = source
        self._threads = threads
        self._carry = b""  # partial compressed block
        self._out = b""  # decompressed, not yet consumed
        self._eof = False

    def readable(self) -> bool:
        return True

    @staticmethod
    def _complete_len(buf: bytes) -> int:
        """Byte length of the longest prefix made of complete BGZF blocks."""
        pos = 0
        n = len(buf)
        while pos + 18 <= n:
            bsize = (buf[pos + 16] | (buf[pos + 17] << 8)) + 1
            if pos + bsize > n:
                break
            pos += bsize
        return pos

    def _fill(self) -> None:
        while not self._out and not self._eof:
            chunk = self._src.read(self._READ_CHUNK)
            if not chunk:
                self._eof = True
                if self._carry.strip(b"\x00"):
                    raise ValueError("truncated BGZF stream")
                return
            buf = self._carry + chunk if self._carry else chunk
            cut = self._complete_len(buf)
            self._carry = buf[cut:]
            if cut:
                self._out = native.bgzf_decompress(buf[:cut], threads=self._threads)

    def readinto(self, b) -> int:
        if not self._out:
            self._fill()
        n = min(len(b), len(self._out))
        b[:n] = self._out[:n]
        self._out = self._out[n:]
        return n

    def close(self) -> None:
        if not self.closed:
            self._src.close()
        super().close()


def open_bgzf_reader(path, threads: int = 4) -> io.BufferedReader:
    raw = ParallelBgzfReader(open(path, "rb"), threads=threads)
    return io.BufferedReader(raw, buffer_size=1 << 20)
