"""ctypes bridge to the native host data plane (`host_ops.cpp`).

Copy of `deepchopper_tpu/native/__init__.py` over its own copy of the C++
source. The shared library is built with g++ at first use into `build/native/`
at the repository root, named by a hash of the source and flags, so an edited
source rebuilds. Every entry point has a NumPy or pure-Python fallback at its
call site: `available()` gates the fast path, and `DEEPCHOPPER_NO_NATIVE=1`
forces the fallback (the parity tests' oracle).

`calls` counts the calls of each entry point since the last `reset_calls()`,
so a run can show that it went through the native plane.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

log = logging.getLogger(__name__)

_SRC = Path(__file__).resolve().parent / "host_ops.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "native"
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_TRIED = False

BGZF_MAX_PAYLOAD = 65280
BGZF_MAX_BLOCK = 65536

_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")

_BASE_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

calls: dict[str, int] = {
    "fq_index": 0, "encode_spans_batch": 0, "majority_vote_batch": 0, "label_regions": 0,
    "chop_records": 0, "bgzf_compress": 0, "bgzf_decompress": 0,
}  # fmt: skip


def reset_calls() -> None:
    for name in calls:
        calls[name] = 0


def _lib_path(flags: list[str]) -> Path:
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"_host_ops_{digest}.so"


def _build() -> Path:
    """Compile the library, preferring -march=native and falling back to a
    portable build. Each build writes a temporary file and renames it, so
    processes that build at once never load a half-written library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for extra in (["-march=native"], []):
        flags = [*_BASE_FLAGS, *extra]
        out = _lib_path(flags)
        if out.exists():
            return out
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
        cmd = ["g++", *flags, str(_SRC), "-o", str(tmp), "-lz", "-lpthread"]
        try:
            subprocess.run(cmd, check=True, capture_output=True, text=True)
        except (OSError, subprocess.CalledProcessError) as exc:
            tmp.unlink(missing_ok=True)
            log.debug("native build with flags %s failed: %s", extra, getattr(exc, "stderr", exc))
            continue
        os.replace(tmp, out)
        return out
    raise RuntimeError("g++ could not build host_ops.cpp")


def _bind(lib: ctypes.CDLL) -> None:
    lib.fq_index.restype = ctypes.c_longlong
    lib.fq_index.argtypes = [
        _u8p, ctypes.c_longlong, ctypes.c_longlong, _i64p,
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
    ]  # fmt: skip
    lib.encode_spans_batch.restype = None
    lib.encode_spans_batch.argtypes = [
        _u8p, _i64p, _i64p,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int,
        _i8p, _u8p, _i32p, ctypes.c_int, ctypes.c_int,
    ]  # fmt: skip
    lib.majority_vote_batch.restype = None
    lib.majority_vote_batch.argtypes = [
        _i8p, _i8p, _i64p,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
    ]  # fmt: skip
    lib.label_regions.restype = ctypes.c_longlong
    lib.label_regions.argtypes = [_i8p, ctypes.c_longlong, _i64p, ctypes.c_longlong]
    lib.chop_records.restype = ctypes.c_longlong
    lib.chop_records.argtypes = [
        _u8p, _i64p, ctypes.c_longlong,
        _i64p, _i64p, _i64p, _u8p,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        _u8p, ctypes.c_longlong, ctypes.POINTER(ctypes.c_longlong),
    ]  # fmt: skip
    lib.bgzf_compress_buffer.restype = ctypes.c_longlong
    lib.bgzf_compress_buffer.argtypes = [
        _u8p, ctypes.c_longlong, _u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]  # fmt: skip
    lib.bgzf_decompress_buffer.restype = ctypes.c_longlong
    lib.bgzf_decompress_buffer.argtypes = [
        _u8p, ctypes.c_longlong, _u8p, ctypes.c_longlong, ctypes.c_int,
    ]  # fmt: skip


def get_lib() -> ctypes.CDLL | None:
    """Load (building if needed) the native library; None when unavailable."""
    global _LIB, _TRIED
    if _LIB is not None:
        return _LIB
    if _TRIED or os.environ.get("DEEPCHOPPER_NO_NATIVE"):
        return None
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        try:
            lib = ctypes.CDLL(str(_build()))
            _bind(lib)
            _LIB = lib
        except Exception as exc:  # noqa: BLE001 - depends on the toolchain; callers fall back
            log.warning("native host ops unavailable (%s); using the NumPy fallback", exc)
            _TRIED = True
    return _LIB


def available() -> bool:
    return get_lib() is not None


def _threads(threads: int | None) -> int:
    return threads or os.cpu_count() or 1


# ---------------------------------------------------------------------------
# NumPy-typed wrappers
# ---------------------------------------------------------------------------


def fq_index(buf: np.ndarray, max_records: int | None = None, final: bool = True) -> tuple[np.ndarray, int]:
    """Index a FASTQ byte buffer -> ((N, 8) int64 span table, consumed bytes).

    Span table columns: [id_off, id_len, seq_off, seq_len, qual_off, qual_len,
    desc_off, desc_len]. A record truncated by the buffer end is not indexed
    and not consumed: carry `buf[consumed:]` into the next chunk.
    """
    lib = get_lib()
    assert lib is not None
    calls["fq_index"] += 1
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    if max_records is None:
        # A record is at least 8 bytes ("@x\nA\n+\nI\n" is the minimum shape).
        max_records = buf.size // 8 + 4
    out = np.empty((max_records, 8), dtype=np.int64)
    consumed = ctypes.c_longlong(0)
    n = lib.fq_index(buf, buf.size, max_records, out.reshape(-1), ctypes.byref(consumed), int(final))
    if n < 0:
        reasons = {
            -1: "malformed header (expected '@')",
            -2: "malformed '+' separator",
            -4: "sequence/quality length mismatch",
        }
        raise ValueError(f"fq_index: {reasons.get(int(n), f'error {n}')}")
    return out[:n], int(consumed.value)


def encode_spans_batch(
    buf: np.ndarray,
    spans: np.ndarray,
    rows: np.ndarray,
    width: int,
    max_len: int,
    sep_token: int,
    pad_token: int,
    qual_offset: int = 33,
    threads: int | None = None,
    out: tuple[np.ndarray, np.ndarray, np.ndarray] | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Encode `rows` of a span table into one padded batch.

    Returns (ids int8 (B, width), quals uint8 (B, width), lengths int32 (B,)).
    Pass `out` to fill a pre-allocated slice (cross-chunk batch assembly).
    """
    lib = get_lib()
    assert lib is not None
    calls["encode_spans_batch"] += 1
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    b = rows.size
    if out is None:
        ids = np.empty((b, width), np.int8)
        quals = np.empty((b, width), np.uint8)
        lengths = np.empty(b, np.int32)
    else:
        ids, quals, lengths = out
    lib.encode_spans_batch(
        buf, np.ascontiguousarray(spans.reshape(-1), np.int64), rows,
        b, width, max_len, sep_token, pad_token,
        ids, quals, lengths, qual_offset, _threads(threads),
    )  # fmt: skip
    return ids, quals, lengths


def majority_vote_batch(labels: np.ndarray, lengths: np.ndarray, window: int, threads: int | None = None) -> np.ndarray:
    lib = get_lib()
    assert lib is not None
    calls["majority_vote_batch"] += 1
    labels = np.ascontiguousarray(labels, dtype=np.int8)
    b, maxlen = labels.shape
    out = np.empty_like(labels)
    lib.majority_vote_batch(
        labels, out, np.ascontiguousarray(lengths, np.int64), b, maxlen, window, _threads(threads)
    )
    return out


def label_regions(labels: np.ndarray, max_regions: int | None = None) -> list[tuple[int, int]]:
    lib = get_lib()
    assert lib is not None
    calls["label_regions"] += 1
    labels = np.ascontiguousarray(labels, dtype=np.int8)
    if max_regions is None:
        # A 0/1 vector of length n has at most n//2 + 1 maximal 1-runs.
        max_regions = labels.size // 2 + 1
    out = np.empty(2 * max_regions, np.int64)
    n = lib.label_regions(labels, labels.size, out, max_regions)
    return [(int(out[2 * i]), int(out[2 * i + 1])) for i in range(n)]


def chop_records(
    buf: np.ndarray,
    spans: np.ndarray,
    ivals: np.ndarray,
    ival_off: np.ndarray,
    ival_cnt: np.ndarray,
    truncated: np.ndarray,
    min_read_len: int,
    max_process_intervals: int,
    min_chop_len: int,
    ocq: bool,
    chop_type: int,
    id_annotation: bool,
) -> tuple[bytes, int] | None:
    """Chop one indexed chunk entirely in C++; returns (fastq bytes, records).

    Returns None when the kernel reports an out-of-range interval (the caller
    falls back to the Python path, which raises the contractual error).
    """
    lib = get_lib()
    assert lib is not None
    calls["chop_records"] += 1
    n = spans.shape[0]
    ivals = np.ascontiguousarray(ivals.reshape(-1), np.int64)
    cap = int(buf.size + n * 96 + ivals.size * 96 + 1024)
    spans_flat = np.ascontiguousarray(spans.reshape(-1), np.int64)
    off = np.ascontiguousarray(ival_off, np.int64)
    cnt = np.ascontiguousarray(ival_cnt, np.int64)
    trunc = np.ascontiguousarray(truncated, np.uint8)
    while True:
        out = np.empty(cap, np.uint8)
        n_out = ctypes.c_longlong(0)
        rc = lib.chop_records(
            buf, spans_flat, n, ivals, off, cnt, trunc,
            min_read_len, max_process_intervals, min_chop_len,
            int(ocq), chop_type, int(id_annotation),
            out, cap, ctypes.byref(n_out),
        )  # fmt: skip
        if rc == -1:
            cap *= 2
            continue
        if rc < 0:
            return None
        return out[:rc].tobytes(), int(n_out.value)


def bgzf_compress(data: bytes | np.ndarray, level: int = 6, threads: int | None = None) -> bytes:
    """Deflate `data` into BGZF blocks (no EOF marker: the writer adds it)."""
    lib = get_lib()
    assert lib is not None
    calls["bgzf_compress"] += 1
    arr = np.frombuffer(data, np.uint8) if isinstance(data, (bytes, bytearray)) else data
    nblocks = (arr.size + BGZF_MAX_PAYLOAD - 1) // BGZF_MAX_PAYLOAD
    out = np.empty(nblocks * BGZF_MAX_BLOCK + 28, np.uint8)
    total = lib.bgzf_compress_buffer(np.ascontiguousarray(arr), arr.size, out, level, _threads(threads), 0)
    if total < 0:
        raise RuntimeError(f"bgzf_compress failed ({total})")
    return out[:total].tobytes()


def bgzf_decompress(data: bytes | np.ndarray, threads: int | None = None) -> bytes:
    lib = get_lib()
    assert lib is not None
    calls["bgzf_decompress"] += 1
    arr = np.frombuffer(data, np.uint8) if isinstance(data, (bytes, bytearray)) else data
    # The ISIZE sum gives the exact output size; start with a generous guess
    # and retry larger if the library reports a short buffer.
    cap = max(arr.size * 4, 1 << 16)
    while True:
        out = np.empty(cap, np.uint8)
        total = lib.bgzf_decompress_buffer(np.ascontiguousarray(arr), arr.size, out, cap, _threads(threads))
        if total == -3:
            cap *= 4
            continue
        if total < 0:
            raise RuntimeError(f"bgzf_decompress failed ({total})")
        return out[:total].tobytes()
