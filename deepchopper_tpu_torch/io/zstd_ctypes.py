"""Streaming zstd reader over the system `libzstd.so.1`, bound with ctypes.

Copy of the reader half of `deepchopper_tpu/io/zstd_ctypes.py`, with two
differences: a stream that ends inside a frame raises instead of reading as
a short file, and what the decoder still holds when the input runs out is
flushed before the end is reported.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import io
from pathlib import Path


class _Buffer(ctypes.Structure):
    # ZSTD_inBuffer and ZSTD_outBuffer share this layout.
    _fields_ = [("ptr", ctypes.c_void_p), ("size", ctypes.c_size_t), ("pos", ctypes.c_size_t)]


_lib = None
_lib_tried = False


def _load():
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    try:
        lib = ctypes.CDLL(ctypes.util.find_library("zstd") or "libzstd.so.1")
        lib.ZSTD_createDStream.restype = ctypes.c_void_p
        lib.ZSTD_freeDStream.argtypes = [ctypes.c_void_p]
        lib.ZSTD_initDStream.argtypes = [ctypes.c_void_p]
        lib.ZSTD_initDStream.restype = ctypes.c_size_t
        lib.ZSTD_decompressStream.argtypes = [ctypes.c_void_p, ctypes.POINTER(_Buffer), ctypes.POINTER(_Buffer)]
        lib.ZSTD_decompressStream.restype = ctypes.c_size_t
        lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
        lib.ZSTD_isError.restype = ctypes.c_uint
        lib.ZSTD_getErrorName.argtypes = [ctypes.c_size_t]
        lib.ZSTD_getErrorName.restype = ctypes.c_char_p
        lib.ZSTD_DStreamInSize.restype = ctypes.c_size_t
    except (OSError, AttributeError):
        return None
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


class _ZstdRaw(io.RawIOBase):
    """Streaming decompressor over a file, as a raw binary reader."""

    def __init__(self, path: str | Path):
        lib = _load()
        if lib is None:
            raise RuntimeError("libzstd is not available")
        self._lib = lib
        self._path = path
        self._fh = open(path, "rb")
        self._ds = lib.ZSTD_createDStream()
        if not self._ds:
            self._fh.close()
            raise RuntimeError("ZSTD_createDStream failed")
        lib.ZSTD_initDStream(self._ds)
        self._chunk = int(lib.ZSTD_DStreamInSize())
        self._in = _Buffer(None, 0, 0)
        self._in_bytes = b""  # keeps the ctypes-pointed input alive
        self._src_eof = False
        # The last ZSTD_decompressStream result: 0 once a frame is complete
        # and flushed, > 0 while a frame is open or output is still held.
        self._open = 1

    def readable(self) -> bool:
        return True

    def _step(self, out: _Buffer) -> None:
        ret = self._lib.ZSTD_decompressStream(self._ds, ctypes.byref(out), ctypes.byref(self._in))
        if self._lib.ZSTD_isError(ret):
            raise OSError(f"{self._path}: zstd decompress: {self._lib.ZSTD_getErrorName(ret).decode()}")
        self._open = ret

    def readinto(self, b) -> int:
        if not b:
            return 0
        mv = memoryview(b).cast("B")
        out_arr = (ctypes.c_char * len(mv)).from_buffer(mv)
        out = _Buffer(ctypes.cast(out_arr, ctypes.c_void_p), len(mv), 0)
        while out.pos == 0:
            if self._in.pos >= self._in.size and not self._src_eof:
                self._in_bytes = self._fh.read(self._chunk)
                self._src_eof = not self._in_bytes
                ptr = ctypes.cast(ctypes.c_char_p(self._in_bytes), ctypes.c_void_p) if self._in_bytes else None
                self._in = _Buffer(ptr, len(self._in_bytes), 0)
            if self._src_eof and self._in.pos >= self._in.size:
                if self._open == 0:
                    return 0
                self._step(out)  # flush what the decoder still holds
                if out.pos == 0:
                    raise OSError(f"{self._path}: truncated zstd stream (input ends inside a frame)")
                return out.pos
            self._step(out)
        return out.pos

    def close(self) -> None:
        if not self.closed:
            if getattr(self, "_ds", None):
                self._lib.ZSTD_freeDStream(self._ds)
                self._ds = None
            if getattr(self, "_fh", None):
                self._fh.close()
        super().close()


def open_zstd_reader(path: str | Path) -> io.BufferedReader:
    return io.BufferedReader(_ZstdRaw(path))
