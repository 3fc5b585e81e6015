"""BGZF (blocked gzip) writer and reader.

Copy of `deepchopper_tpu/io/bgzf.py`. Blocks are independent deflate streams,
so compression runs many blocks per call in the native library's thread pool,
or, without it, one block per task on a Python thread pool (zlib releases
the GIL while it compresses).
"""

from __future__ import annotations

import io
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import BinaryIO

from .. import native

# Max uncompressed payload per BGZF block.
MAX_BLOCK_SIZE = 65280

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
    """Streaming BGZF writer with thread-pooled block compression.

    Blocks are drained in order, so output is deterministic regardless of
    thread count. Closing writes the 28-byte EOF marker, unless
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
        self._native = native.available()
        if self._native:
            # Native path: many blocks per call; C++ threads the deflate.
            self._batch = MAX_BLOCK_SIZE * max(8, self._threads * 8)
            self._pool = None
        else:
            self._batch = MAX_BLOCK_SIZE
            self._pool = ThreadPoolExecutor(max_workers=self._threads) if threads > 1 else None
        self._pending: list = []
        self._max_pending = max(2, threads * 4)

    def writable(self) -> bool:
        return True

    def write(self, data) -> int:
        self._buf.extend(data)
        while len(self._buf) >= self._batch:
            chunk = bytes(self._buf[: self._batch])
            del self._buf[: self._batch]
            self._submit(chunk)
        return len(data)

    def _submit(self, chunk: bytes) -> None:
        if self._native:
            self._sink.write(native.bgzf_compress(chunk, self._level, self._threads))
            return
        if self._pool is None:
            self._sink.write(compress_block(chunk, self._level))
            return
        self._pending.append(self._pool.submit(compress_block, chunk, self._level))
        if len(self._pending) >= self._max_pending:
            # Drain the oldest half to bound memory while keeping the pool busy.
            drain = len(self._pending) // 2
            for fut in self._pending[:drain]:
                self._sink.write(fut.result())
            del self._pending[:drain]

    def flush(self) -> None:
        if self.closed or self._sink.closed:
            return
        if self._buf:
            chunk = bytes(self._buf)
            self._buf.clear()
            self._submit(chunk)
        for fut in self._pending:
            self._sink.write(fut.result())
        self._pending.clear()
        self._sink.flush()

    def close(self) -> None:
        if self.closed:
            return
        try:
            self.flush()
            if self._write_eof:
                self._sink.write(BGZF_EOF)
            self._sink.flush()
            if self._pool is not None:
                self._pool.shutdown(wait=True)
            self._sink.close()
        finally:
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
