"""Fused Hyena mixer: short conv -> gate -> causal FFT long conv -> gate.

Port of the mixer part of `deepchopper_tpu/ops/pallas_fft.py`
(`mixer_fft_conv_bm`, its Pallas kernel `_mixer_kernel` and its reference
`mixer_reference_xla`). The public function keeps the JAX layout:

    mixer_fft_conv_bm(proj_bm (B, 3D, L), k_short (3, 1, 3D), b_short (3D,),
                      k_long (L, D), bias (D,)) -> (B, D, L) in proj's dtype

with proj = [x2 | x1 | v] along 3D, each gate short-convolved in float32
(tap t multiplies x[n - (taps-1-t)], zero for n < 0), w = v * x1,
z = causal_conv(w, k_long) + w * bias, out = z * x2.

On a CUDA tensor the wrapper launches the hand-written kernel
`csrc/mixer_fwd.cu` (or raises); on a CPU tensor it runs `mixer_reference`,
the plain PyTorch version of the same math. Nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

# Launches of each CUDA kernel since the last reset: one per wrapper call
# that reached the card. Read by chip_smoke.py to show the main path ran
# through the kernels.
launch_counts: dict[str, int] = {"mixer_fwd": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def mixer_reference(
    proj_bm: torch.Tensor,
    k_short: torch.Tensor,
    b_short: torch.Tensor,
    k_long: torch.Tensor,
    bias: torch.Tensor,
) -> torch.Tensor:
    """Plain PyTorch mixer in float32 (math of `mixer_reference_xla`,
    batch-major, FFT at N = 2L)."""
    d_model = k_long.shape[1]
    seq_len = proj_bm.shape[2]
    n = 2 * seq_len
    taps = k_short.shape[0]
    p32 = proj_bm.float()
    ks = k_short.float()
    xp = F.pad(p32, (taps - 1, 0))
    uc = xp[:, :, 0:seq_len] * ks[0, 0][:, None]
    for t in range(1, taps):
        uc = uc + xp[:, :, t : t + seq_len] * ks[t, 0][:, None]
    uc = uc + b_short.float()[:, None]
    x2, x1, v = uc[:, :d_model], uc[:, d_model : 2 * d_model], uc[:, 2 * d_model :]
    w = v * x1
    k_f = torch.fft.rfft(k_long.float().T, n=n, dim=-1)  # (D, F)
    w_f = torch.fft.rfft(w, n=n, dim=-1)
    z = torch.fft.irfft(w_f * k_f, n=n, dim=-1)[..., :seq_len] + w * bias.float()[:, None]
    return (z * x2).to(proj_bm.dtype)


def fft_size(seq_len: int) -> int:
    """The kernel's transform length: the power of two >= 2L (at least 8)."""
    return max(8, 1 << (2 * seq_len - 1).bit_length())


def filter_spectrum(k_long: torch.Tensor, bias: torch.Tensor, n: int) -> torch.Tensor:
    """(D, n/2 + 1) complex64 spectrum of the zero-padded long filter with
    the skip bias as a delta tap (k[0] += bias) and 1/n folded in — the
    role of `khat_scrambled` in the JAX package, in natural order."""
    kt = k_long.float().T.clone()  # (D, L)
    kt[:, 0] += bias.float()
    return (torch.fft.rfft(kt, n=n, dim=-1) / n).contiguous()


@functools.lru_cache(maxsize=64)
def _twiddles(n: int, device: torch.device) -> torch.Tensor:
    """tw[j] = exp(-2 pi i j / n) for j in [0, n/2], complex64, computed in
    float64 on the host."""
    j = np.arange(n // 2 + 1, dtype=np.float64)
    tw = np.exp(-2j * np.pi * j / n).astype(np.complex64)
    return torch.from_numpy(tw).to(device)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from . import _build

    lib = _build.load("mixer_fwd.cu")
    ptr = ctypes.c_void_p
    lib.mixer_fwd.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr] + [ctypes.c_int] * 5 + [ptr]
    lib.mixer_fwd.restype = ctypes.c_int
    lib.mixer_fwd_scratch_bytes.argtypes = [ctypes.c_int] * 3
    lib.mixer_fwd_scratch_bytes.restype = ctypes.c_longlong
    return lib


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"mixer_fft_conv_bm: {msg}")


def mixer_fwd_cuda(
    proj_bm: torch.Tensor,
    k_short: torch.Tensor,
    b_short: torch.Tensor,
    k_long: torch.Tensor,
    bias: torch.Tensor,
) -> torch.Tensor:
    """Launch `csrc/mixer_fwd.cu` on the current stream (no synchronise)."""
    _check(proj_bm.is_cuda, "proj_bm must be a CUDA tensor")
    _check(proj_bm.dtype in _DTYPE_CODES, f"unsupported dtype {proj_bm.dtype}")
    _check(proj_bm.dim() == 3, f"proj_bm must be (B, 3D, L), got {tuple(proj_bm.shape)}")
    batch, width, seq_len = proj_bm.shape
    d_model = k_long.shape[1]
    taps = k_short.shape[0]
    _check(width == 3 * d_model, f"proj width {width} != 3 * d_model ({d_model})")
    _check(taps == 3, f"the kernel takes 3 short-conv taps, got {taps}")
    _check(tuple(k_short.shape) == (3, 1, width), f"k_short shape {tuple(k_short.shape)}")
    _check(tuple(b_short.shape) == (width,), f"b_short shape {tuple(b_short.shape)}")
    _check(tuple(k_long.shape) == (seq_len, d_model), f"k_long shape {tuple(k_long.shape)}")
    _check(tuple(bias.shape) == (d_model,), f"bias shape {tuple(bias.shape)}")
    dev = proj_bm.device
    for name, t in (("k_short", k_short), ("b_short", b_short), ("k_long", k_long), ("bias", bias)):
        _check(t.device == dev, f"{name} is on {t.device}, proj_bm on {dev}")

    n = fft_size(seq_len)
    log2n = n.bit_length() - 1
    proj = proj_bm.contiguous()
    taps_f = k_short.float().reshape(3, width).contiguous()
    bsh = b_short.float().contiguous()
    khat = filter_spectrum(k_long, bias, n)
    tw = _twiddles(n, dev)
    out = torch.empty((batch, d_model, seq_len), dtype=proj.dtype, device=dev)
    lib = _lib()
    scratch_bytes = lib.mixer_fwd_scratch_bytes(batch, d_model, log2n)
    scratch = torch.empty(max(scratch_bytes, 8), dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.mixer_fwd(
            proj.data_ptr(), taps_f.data_ptr(), bsh.data_ptr(), khat.data_ptr(), tw.data_ptr(),
            scratch.data_ptr(), out.data_ptr(),
            batch, d_model, seq_len, log2n, _DTYPE_CODES[proj.dtype], stream,
        )  # fmt: skip
    if err != 0:
        raise RuntimeError(f"mixer_fwd launch failed: cudaError {err} at (B={batch}, D={d_model}, L={seq_len})")
    launch_counts["mixer_fwd"] += 1
    return out


def mixer_fft_conv_bm(
    proj_bm: torch.Tensor,
    k_short: torch.Tensor,
    b_short: torch.Tensor,
    k_long: torch.Tensor,
    bias: torch.Tensor,
) -> torch.Tensor:
    """Batch-major fused mixer: proj_bm (B, 3D, L) -> (B, D, L).

    CPU tensors take the plain version; CUDA tensors launch the kernel;
    any other device raises."""
    if proj_bm.device.type == "cpu":
        return mixer_reference(proj_bm, k_short, b_short, k_long, bias)
    if proj_bm.device.type == "cuda":
        return mixer_fwd_cuda(proj_bm, k_short, b_short, k_long, bias)
    raise ValueError(f"mixer_fft_conv_bm: no implementation for device {proj_bm.device}")
