"""Streaming BAM reader/writer for evaluation tooling.

Copy of `deepchopper_tpu/io/bam.py`. Records stream in constant memory
through the parallel BGZF inflater (`io/bgzf.open_bgzf_reader`) when the
native host library is available, else through `gzip`, and the parser
extracts the fields the eval pipeline needs: qname, mapq, cigar, softclips
(hardclip-aware, swapped on the reverse strand), flags, qualities and the SA
tag. Raw record blocks can also be iterated and written untouched, which is
how `tools.replacebam` swaps records between BAMs without re-encoding them.
"""

from __future__ import annotations

import gzip
import struct
from collections.abc import Iterator
from dataclasses import dataclass
from pathlib import Path

_CIGAR_OPS = "MIDNSHP=X"

FLAG_UNMAPPED = 0x4
FLAG_REVERSE = 0x10
FLAG_SECONDARY = 0x100
FLAG_SUPPLEMENTARY = 0x800


@dataclass
class BamRecord:
    """(reference: src/output/bam.rs:77-178)"""

    qname: str
    mapping_quality: int
    cigar: str
    left_softclip: int
    right_softclip: int
    is_forward: bool
    is_mapped: bool
    is_supplementary: bool
    is_secondary: bool
    quality: bytes
    sa_tag: str | None = None
    read_len: int = 0

    @property
    def qual(self) -> bytes:
        return self.quality


def parse_cigar_ops(cigar: str) -> list[tuple[int, str]]:
    ops: list[tuple[int, str]] = []
    num = 0
    for ch in cigar:
        if ch.isdigit():
            num = num * 10 + int(ch)
        elif ch in _CIGAR_OPS:
            ops.append((num, ch))
            num = 0
        else:
            # The reference's Cigar parser rejects unknown op codes
            # (src/output/bam.rs test_cigar_soft_clip, "1D5M10S5A" errors).
            raise ValueError(f"invalid CIGAR op {ch!r} in {cigar!r}")
    if num:
        # A trailing count with no op ("10S5") is a truncated CIGAR — reject
        # like the reference parser instead of silently dropping it.
        raise ValueError(f"truncated CIGAR (count without op) in {cigar!r}")
    return ops


def _calc_softclips(ops: list[tuple[int, str]]) -> tuple[int, int]:
    """Leading/trailing softclip lengths, skipping flanking hardclips
    (reference: src/output/bam.rs:39-65)."""
    n = len(ops)
    left = 0
    if n > 0 and ops[0][1] == "S":
        left = ops[0][0]
    elif n > 1 and ops[0][1] == "H" and ops[1][1] == "S":
        left = ops[1][0]
    right = 0
    if n > 0 and ops[-1][1] == "S":
        right = ops[-1][0]
    elif n > 1 and ops[-1][1] == "H" and ops[-2][1] == "S":
        right = ops[-2][0]
    return left, right


def left_right_soft_clip(cigar_string: str) -> tuple[int, int]:
    """(reference: src/output/bam.rs:73-77)"""
    return _calc_softclips(parse_cigar_ops(cigar_string))


_TAG_SIZES = {"A": 1, "c": 1, "C": 1, "s": 2, "S": 2, "i": 4, "I": 4, "f": 4}


def _parse_sa_tag(data: bytes) -> str | None:
    """Scan the auxiliary-tag block for SA:Z:."""
    i = 0
    n = len(data)
    while i + 3 <= n:
        tag = data[i : i + 2]
        typ = chr(data[i + 2])
        i += 3
        if typ in _TAG_SIZES:
            if tag == b"SA":  # numeric SA is malformed; skip
                i += _TAG_SIZES[typ]
                continue
            i += _TAG_SIZES[typ]
        elif typ in ("Z", "H"):
            end = data.index(b"\x00", i)
            if tag == b"SA" and typ == "Z":
                return data[i:end].decode("ascii", errors="replace")
            i = end + 1
        elif typ == "B":
            sub = chr(data[i])
            count = struct.unpack_from("<I", data, i + 1)[0]
            i += 5 + _TAG_SIZES[sub] * count
        else:
            break
    return None


_STREAM_CHUNK = 8 << 20


def _open_bam_stream(path: str | Path, threads: int = 4):
    """Decompressed byte stream over a BAM; parallel BGZF when native is up."""
    from .. import native

    if native.available():
        from .bgzf import open_bgzf_reader

        return open_bgzf_reader(path, threads=threads)
    return gzip.open(path, "rb")


def _read_exact(fh, n: int) -> bytes:
    out = fh.read(n)
    while len(out) < n:
        more = fh.read(n - len(out))
        if not more:
            raise ValueError("truncated BAM header")
        out += more
    return out


def read_bam_header_raw(fh) -> bytes:
    """Consume and return the raw header region (l_text..refs) after magic."""
    if _read_exact(fh, 4) != b"BAM\x01":
        raise ValueError("not a BAM stream")
    buf = bytearray()
    l_text_b = _read_exact(fh, 4)
    buf += l_text_b
    (l_text,) = struct.unpack("<i", l_text_b)
    buf += _read_exact(fh, l_text)
    nrb = _read_exact(fh, 4)
    buf += nrb
    (n_ref,) = struct.unpack("<i", nrb)
    for _ in range(n_ref):
        lb = _read_exact(fh, 4)
        buf += lb
        (l_name,) = struct.unpack("<i", lb)
        buf += _read_exact(fh, l_name + 4)
    return bytes(buf)


def read_bam_header(path: str | Path, threads: int = 4) -> bytes:
    with _open_bam_stream(path, threads) as fh:
        return read_bam_header_raw(fh)


def iter_bam_raw_blocks(path: str | Path, threads: int = 4) -> Iterator[tuple[str, int, bytes]]:
    """Stream (qname, flag, raw block incl. 4-byte size prefix) per record.

    Constant-memory: complete record blocks are cut from a rolling buffer over
    the parallel-inflated BGZF stream; raw blocks round-trip into BamWriter
    unchanged (how replacebam swaps records without re-encoding).
    """
    fh = _open_bam_stream(path, threads)
    try:
        read_bam_header_raw(fh)
        carry = b""
        while True:
            chunk = fh.read(_STREAM_CHUNK)
            if not chunk:
                if carry:
                    raise ValueError(f"{path}: truncated BAM record at EOF")
                return
            buf = carry + chunk if carry else chunk
            pos, n = 0, len(buf)
            while pos + 4 <= n:
                (block_size,) = struct.unpack_from("<i", buf, pos)
                if pos + 4 + block_size > n:
                    break
                l_read_name = buf[pos + 12]
                (flag,) = struct.unpack_from("<H", buf, pos + 18)
                qname = buf[pos + 36 : pos + 36 + l_read_name - 1].decode(
                    "ascii", errors="replace"
                )
                yield qname, flag, buf[pos : pos + 4 + block_size]
                pos += 4 + block_size
            carry = buf[pos:]
    finally:
        fh.close()


def _decode_record(block: bytes) -> BamRecord:
    """Parse one raw record block (incl. size prefix) into a BamRecord."""
    (
        _ref_id,
        _pos,
        l_read_name,
        mapq,
        _bin,
        n_cigar,
        flag,
        l_seq,
        _next_ref,
        _next_pos,
        _tlen,
    ) = struct.unpack_from("<iiBBHHHiiii", block, 4)
    p = 4 + 32
    qname = block[p : p + l_read_name - 1].decode("ascii", errors="replace")
    p += l_read_name
    cigar_ops: list[tuple[int, str]] = []
    for c in struct.unpack_from(f"<{n_cigar}I", block, p):
        cigar_ops.append((c >> 4, _CIGAR_OPS[c & 0xF]))
    p += 4 * n_cigar
    p += (l_seq + 1) // 2  # packed 4-bit sequence (skip)
    qual = block[p : p + l_seq]
    p += l_seq
    sa = _parse_sa_tag(block[p:])

    is_forward = not (flag & FLAG_REVERSE)
    left, right = _calc_softclips(cigar_ops)
    if not is_forward:
        left, right = right, left
    return BamRecord(
        qname=qname,
        mapping_quality=mapq,
        cigar="".join(f"{n}{op}" for n, op in cigar_ops),
        left_softclip=left,
        right_softclip=right,
        is_forward=is_forward,
        is_mapped=not (flag & FLAG_UNMAPPED),
        is_supplementary=bool(flag & FLAG_SUPPLEMENTARY),
        is_secondary=bool(flag & FLAG_SECONDARY),
        quality=qual if l_seq and qual[:1] != b"\xff" else b"",
        sa_tag=sa,
        read_len=l_seq,
    )


def iter_bam_records(path: str | Path, threads: int = 4) -> Iterator[BamRecord]:
    """Yield `BamRecord`s streaming in constant memory
    (reference: src/output/bam.rs:180-258)."""
    for _qname, _flag, block in iter_bam_raw_blocks(path, threads):
        yield _decode_record(block)


def read_bam_records(path: str | Path) -> dict[str, BamRecord]:
    """(reference: src/output/bam.rs `read_bam_records`) — keyed by qname."""
    return {rec.qname: rec for rec in iter_bam_records(path)}


def read_bam_records_parallel(path: str | Path, threads: int | None = None) -> dict[str, BamRecord]:
    """Multithreaded variant: BGZF blocks inflate on the native thread pool
    (reference: noodles MultithreadedReader, src/output/bam.rs:199)."""
    import os

    return {
        rec.qname: rec
        for rec in iter_bam_records(path, threads=threads or os.cpu_count() or 4)
    }


# ---------------------------------------------------------------------------
# Writing
# ---------------------------------------------------------------------------


class BamWriter:
    """Minimal BAM writer: BGZF-compressed magic + raw header + raw blocks.

    Pairs with iter_bam_raw_blocks for record-preserving rewrites
    (reference capability: noodles bam::io::Writer, src/bin/replacebam.rs:98-103).
    """

    def __init__(self, path: str | Path, header_raw: bytes, threads: int = 4):
        from .bgzf import open_bgzf_writer

        self._fh = open_bgzf_writer(path, threads=threads)
        self._fh.write(b"BAM\x01" + header_raw)

    def write_raw_block(self, block: bytes) -> None:
        self._fh.write(block)

    def close(self) -> None:
        self._fh.close()

    def __enter__(self) -> "BamWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def encode_bam_record(
    qname: str,
    flag: int = 4,
    mapq: int = 255,
    cigar: list[tuple[int, str]] | None = None,
    seq_len: int = 0,
    qual: bytes | None = None,
    tags: bytes = b"",
) -> bytes:
    """Encode a minimal unaligned-friendly record block (size prefix included).

    Sequence bases are written as N (the eval tooling never reads them); used
    by tests and dataset-manipulation tools that synthesize records.
    """
    name_b = qname.encode("ascii") + b"\x00"
    cigar = cigar or []
    packed_cigar = b"".join(
        struct.pack("<I", (n << 4) | _CIGAR_OPS.index(op)) for n, op in cigar
    )
    seq_bytes = bytes(((15 << 4) | 15,)) * ((seq_len + 1) // 2)  # all-N
    qual_b = qual if qual is not None else b"\xff" * seq_len
    body = (
        struct.pack(
            "<iiBBHHHiiii",
            -1,
            -1,
            len(name_b),
            mapq,
            0,
            len(cigar),
            flag,
            seq_len,
            -1,
            -1,
            0,
        )
        + name_b
        + packed_cigar
        + seq_bytes
        + qual_b
        + tags
    )
    return struct.pack("<i", len(body)) + body


def make_bam_header(text: str = "@HD\tVN:1.6\n") -> bytes:
    """Raw header region for a reference-less BAM."""
    t = text.encode("ascii")
    return struct.pack("<i", len(t)) + t + struct.pack("<i", 0)
