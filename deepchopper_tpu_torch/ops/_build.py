"""Build the package's CUDA sources with `nvcc` and load them with ctypes.

Each `csrc/*.cu` file compiles on its own into a shared library with a plain
C interface (no PyTorch headers, so a build takes seconds), for `sm_90a`.
Libraries land in `build/` at the repository root, named by a hash of their
source and flags, so an edited source rebuilds and an unchanged one loads as
it is. Building happens at first use, never at import. A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)  # fmt: skip
SOURCES = ("mixer_fwd.cu", "mixer_bwd.cu")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise KernelBuildError("nvcc not found: the CUDA kernels need the CUDA toolkit (CUDA_HOME)")


def _target(source: str) -> Path:
    # Shared headers are part of every source's key: an edited header rebuilds.
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    text = (CSRC / source).read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
    digest = hashlib.sha256(text).hexdigest()[:16]
    return BUILD_DIR / f"{Path(source).stem}-{digest}.so"


def _start(source: str) -> tuple[Path, subprocess.Popen | None, Path]:
    out = _target(source)
    if out.exists():
        return out, None, out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return out, proc, tmp


def _finish(source: str, out: Path, proc: subprocess.Popen | None, tmp: Path) -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(f"nvcc failed on {source} (exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)


def build_all(sources: tuple[str, ...] = SOURCES) -> dict[str, Path]:
    """Compile every source that has no up-to-date library, all nvcc
    processes started together; returns {source: library path}."""
    started = [(s, *_start(s)) for s in sources]
    try:
        for s, out, proc, tmp in started:
            _finish(s, out, proc, tmp)
    finally:
        for _s, _out, proc, _tmp in started:
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()
    return {s: out for s, out, _p, _t in started}


def load(source: str) -> ctypes.CDLL:
    """The loaded library of `source`, built first if needed."""
    with _lock:
        lib = _loaded.get(source)
        if lib is None:
            path = build_all((source,))[source]
            lib = ctypes.CDLL(str(path))
            _loaded[source] = lib
        return lib
