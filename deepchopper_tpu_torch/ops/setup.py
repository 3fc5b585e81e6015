"""Runtime-setup kernel: y = x + 1 on one (8, 128) float32 tile.

Port of `_triv`, the Pallas kernel that `PredictEngine.runtime_setup`
launches in `deepchopper_tpu/infer/engine.py` (:316, pallas_call :336). The
port's `PredictEngine.runtime_setup` launches it once per engine, after it has
built and loaded every kernel library, and checks that the output is exact.

On CUDA tensors `setup_tile` launches the hand-written kernel
`csrc/setup.cu`, or raises; on CPU tensors it runs `setup_reference`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

SHAPE = (8, 128)

# Launches of the CUDA kernel since the last reset: one per wrapper call that
# reached the card. Read by chip_smoke.py to show the path ran through it.
launch_counts: dict[str, int] = _build.counters("setup")


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def setup_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: x + 1."""
    return x + 1.0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("setup.cu")
    ptr = ctypes.c_void_p
    lib.setup_fwd.argtypes = [ptr, ptr, ctypes.c_int, ctypes.c_int, ptr]
    lib.setup_fwd.restype = ctypes.c_int
    return lib


def setup_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch `csrc/setup.cu` on the current stream (no synchronise)."""
    if not x.is_cuda or x.dtype != torch.float32 or x.dim() != 2 or not 0 < x.shape[1] <= 1024:
        raise ValueError(f"setup_tile: needs a CUDA float32 (rows, <= 1024) tensor, got {x.dtype} {tuple(x.shape)} "
                         f"on {x.device}")  # fmt: skip
    x = x.contiguous()
    out = torch.empty_like(x)
    _build.launch(_lib().setup_fwd, x, x.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1], what="setup_fwd")
    launch_counts["setup"] += 1
    return out


def setup_tile(x: torch.Tensor) -> torch.Tensor:
    """x + 1: CPU tensors take the plain version, CUDA tensors launch the
    kernel, any other device raises."""
    if x.device.type == "cuda":
        return setup_cuda(x)
    if x.device.type == "cpu":
        return setup_reference(x)
    raise ValueError(f"setup_tile: no implementation for device {x.device}")
