"""Streaming FASTQ reader with compression sniffing.

Trimmed copy of `deepchopper_tpu/io/fastq.py`: the pure-Python record loop
over plain, gzip/BGZF, bz2 and xz input.
"""

from __future__ import annotations

import bz2
import gzip
import io
import lzma
from collections.abc import Iterator
from pathlib import Path

from .chop import FastqRecord

_MAGICS: list[tuple[bytes, str]] = [
    (b"\x1f\x8b", "gzip"),
    (b"PK\x03\x04", "zip"),
    (b"BZh", "bz2"),
    (b"\xfd7zXZ\x00", "xz"),
    (b"\x28\xb5\x2f\xfd", "zstd"),
]


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
    if kind in ("gzip", "bgzip"):
        return gzip.open(path, "rb")  # gzip reads concatenated BGZF members
    if kind == "bz2":
        return bz2.open(path, "rb")
    if kind == "xz":
        return lzma.open(path, "rb")
    if kind in ("zip", "zstd"):
        raise NotImplementedError(f"{path}: {kind} input is not supported by this reader")
    return open(path, "rb")


class StreamingFastqReader:
    """Iterator over FASTQ records from any (possibly compressed) file."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self._fh = open_compressed_reader(self.path)

    def __iter__(self) -> Iterator[FastqRecord]:
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
