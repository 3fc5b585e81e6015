"""Streaming FASTQ reader with compression sniffing.

Trimmed copy of `deepchopper_tpu/io/fastq.py`: magic-byte format detection,
a reader over plain, gzip/BGZF, one-member zip, bz2, xz and zstd input (zstd
through the system `libzstd.so.1`), and a record iterator whose record
boundaries come from the native buffer scanner (`native.fq_index`) over large
chunks, or from a per-line Python loop without it.
"""

from __future__ import annotations

import bz2
import gzip
import io
import lzma
import zipfile
from collections.abc import Iterator
from pathlib import Path

import numpy as np

from .. import native
from .chop import FastqRecord

_MAGICS: list[tuple[bytes, str]] = [
    (b"\x1f\x8b", "gzip"),
    (b"PK\x03\x04", "zip"),
    (b"BZh", "bz2"),
    (b"\xfd7zXZ\x00", "xz"),
    (b"\x28\xb5\x2f\xfd", "zstd"),
]

_NATIVE_CHUNK = 8 << 20


def detect_compression(path: str | Path) -> str:
    """Sniff compression from magic bytes.

    Returns one of: "plain", "gzip", "bgzip", "zip", "bz2", "xz", "zstd".
    """
    with open(path, "rb") as fh:
        head = fh.read(18)
    for magic, name in _MAGICS:
        if head.startswith(magic):
            if name == "gzip":
                # BGZF: FLG has FEXTRA and the extra field starts with 'BC'.
                if len(head) >= 14 and head[3] & 0x04 and head[12:14] == b"BC":
                    return "bgzip"
                return "gzip"
            return name
    return "plain"


def open_compressed_reader(path: str | Path) -> io.BufferedIOBase:
    """Open a binary reader that transparently decompresses."""
    kind = detect_compression(path)
    if kind == "bgzip" and native.available():
        from .bgzf import open_bgzf_reader

        return open_bgzf_reader(path)
    if kind in ("gzip", "bgzip"):
        return gzip.open(path, "rb")  # gzip reads concatenated BGZF members
    if kind == "bz2":
        return bz2.open(path, "rb")
    if kind == "xz":
        return lzma.open(path, "rb")
    if kind == "zip":
        zf = zipfile.ZipFile(path)
        names = zf.namelist()
        if len(names) != 1:
            zf.close()
            raise ValueError(f"zip archive {path} must contain exactly one file")
        return zf.open(names[0], "r")  # type: ignore[return-value]
    if kind == "zstd":
        from . import zstd_ctypes

        if not zstd_ctypes.available():
            raise NotImplementedError(f"{path}: zstd input needs the system libzstd.so.1")
        return zstd_ctypes.open_zstd_reader(path)
    return open(path, "rb")


class StreamingFastqReader:
    """Iterator over FASTQ records from any (possibly compressed) file."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self._fh = open_compressed_reader(self.path)

    def __iter__(self) -> Iterator[FastqRecord]:
        return self._iter_native() if native.available() else self._iter_python()

    def _iter_native(self) -> Iterator[FastqRecord]:
        fh = self._fh
        carry = b""
        try:
            while True:
                chunk = fh.read(_NATIVE_CHUNK)
                final = not chunk
                buf = carry + chunk if carry else chunk
                if not buf:
                    break
                spans, consumed = native.fq_index(np.frombuffer(buf, np.uint8), final=final)
                for row in spans:
                    id_off, id_len, s_off, s_len, q_off, q_len, d_off, d_len = (int(v) for v in row)
                    # Full header line (name + description, original separator).
                    end = d_off + d_len if d_off >= 0 else id_off + id_len
                    yield FastqRecord(buf[id_off:end].decode("ascii"), buf[s_off : s_off + s_len],
                                      buf[q_off : q_off + q_len])  # fmt: skip
                carry = buf[consumed:]
                if final:
                    if carry.strip(b"\r\n"):
                        raise ValueError(f"{self.path}: truncated FASTQ record at EOF")
                    break
        finally:
            fh.close()

    def _iter_python(self) -> Iterator[FastqRecord]:
        fh = self._fh
        try:
            while True:
                header = fh.readline()
                if not header:
                    break
                header = header.rstrip(b"\r\n")
                if not header:
                    continue
                if not header.startswith(b"@"):
                    raise ValueError(f"{self.path}: malformed FASTQ header: {header[:60]!r}")
                seq = fh.readline().rstrip(b"\r\n")
                plus = fh.readline()
                if not plus.startswith(b"+"):
                    raise ValueError(f"{self.path}: malformed FASTQ separator for {header[:60]!r}")
                qual = fh.readline().rstrip(b"\r\n")
                yield FastqRecord(header[1:].decode("ascii"), seq, qual)
        finally:
            fh.close()


def iter_fastq_chunks(path: str | Path, chunk_size: int) -> Iterator[list[FastqRecord]]:
    """Stream records in lists of `chunk_size`."""
    chunk: list[FastqRecord] = []
    for rec in StreamingFastqReader(path):
        chunk.append(rec)
        if len(chunk) >= chunk_size:
            yield chunk
            chunk = []
    if chunk:
        yield chunk
