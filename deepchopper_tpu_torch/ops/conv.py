"""Causal FFT long conv: y = (v * k)[:L] + v * bias.

Port of `fft_causal_conv_pallas` in `deepchopper_tpu/ops/pallas_fft.py` (its
Pallas kernel `_conv_kernel`, driven by `_fft_causal_conv_pallas_impl`, and the
custom VJP `_conv_bwd`). Same contract and layout:

    fft_causal_conv(v (B, L, D) float32, k (L, D), bias (D,)) -> (B, L, D) float32

No model path reaches it, in the port as in the JAX package: it is the public
op behind `models.hyena.causal_conv`, and the ungated special case of
`ops/gated.py`.

`ConvFn` makes it differentiable and saves only its inputs. On CUDA tensors
the forward launches the hand-written kernel `csrc/conv_fwd.cu` (which reads
and writes the channel-last layout in place), or raises; on CPU tensors it
runs `conv_reference`. The backward is `conv_bwd_reference` on both: the JAX
backward is XLA code, not a kernel, so it stays plain PyTorch.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .mixer import MAX_SEQ_LEN, _twiddles, fft_size, filter_spectrum

# Launches of each CUDA kernel since the last reset: one per wrapper call
# that reached the card. Read by chip_smoke.py to show the path ran through it.
launch_counts: dict[str, int] = _build.counters("conv_fwd")


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def conv_reference(v: torch.Tensor, k: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch causal conv in float32 (FFT at N = 2L, the math of
    `models.hyena.fft_causal_conv` in the JAX package)."""
    seq_len = v.shape[1]
    n = 2 * seq_len
    v32 = v.float()
    k_f = torch.fft.rfft(k.float(), n=n, dim=0)  # (F, D)
    y = torch.fft.irfft(torch.fft.rfft(v32, n=n, dim=1) * k_f, n=n, dim=1)[:, :seq_len]
    return y + v32 * bias.float()


def conv_bwd_reference(v, dy, k, bias):
    """Backward with the math of `_conv_bwd` (pallas_fft.py:387-402):
    (dv, dk, dbias). dv = corr_k(dy) + dy bias, dk = sum over B of
    corr(dy, v), dbias = sum dy v."""
    seq_len = v.shape[1]
    n = 2 * seq_len
    dy32 = dy.float()
    v32 = v.float()
    k_f = torch.fft.rfft(k.float(), n=n, dim=0)
    dy_f = torch.fft.rfft(dy32, n=n, dim=1)
    v_f = torch.fft.rfft(v32, n=n, dim=1)
    dv = torch.fft.irfft(dy_f * k_f.conj(), n=n, dim=1)[:, :seq_len] + dy32 * bias.float()
    dk = torch.fft.irfft((dy_f * v_f.conj()).sum(dim=0), n=n, dim=0)[:seq_len]
    dbias = (dy32 * v32).sum(dim=(0, 1))
    return dv.to(v.dtype), dk.to(k.dtype), dbias.to(bias.dtype)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("conv_fwd.cu")
    ptr = ctypes.c_void_p
    lib.conv_fwd.argtypes = [ptr] * 5 + [ctypes.c_int] * 4 + [ptr]
    lib.conv_fwd.restype = ctypes.c_int
    lib.conv_fwd_scratch_bytes.argtypes = [ctypes.c_int] * 3
    lib.conv_fwd_scratch_bytes.restype = ctypes.c_longlong
    return lib


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"fft_causal_conv: {msg}")


def conv_fwd_cuda(v: torch.Tensor, k: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Launch `csrc/conv_fwd.cu` on the current stream (no synchronise)."""
    _check(v.is_cuda, "v must be a CUDA tensor")
    _check(v.dtype == torch.float32, f"v must be float32, got {v.dtype}")
    _check(v.dim() == 3, f"v must be (B, L, D), got {tuple(v.shape)}")
    batch, seq_len, d_model = v.shape
    _check(tuple(k.shape) == (seq_len, d_model), f"k shape {tuple(k.shape)}")
    _check(tuple(bias.shape) == (d_model,), f"bias shape {tuple(bias.shape)}")
    _check(seq_len <= MAX_SEQ_LEN, f"L = {seq_len} > {MAX_SEQ_LEN}")
    dev = v.device
    for name, t in (("k", k), ("bias", bias)):
        _check(t.device == dev, f"{name} is on {t.device}, v on {dev}")
    n = fft_size(seq_len)
    log2n = n.bit_length() - 1
    vc = v.contiguous()
    khat = filter_spectrum(k, bias, n)
    tw = _twiddles(n, dev)
    y = torch.empty_like(vc)
    lib = _lib()
    scratch = torch.empty(max(lib.conv_fwd_scratch_bytes(batch, d_model, log2n), 8), dtype=torch.uint8, device=dev)
    _build.launch(
        lib.conv_fwd, vc,
        vc.data_ptr(), khat.data_ptr(), tw.data_ptr(), scratch.data_ptr(), y.data_ptr(),
        batch, d_model, seq_len, log2n,
        what=f"conv_fwd at (B={batch}, L={seq_len}, D={d_model})",
    )  # fmt: skip
    launch_counts["conv_fwd"] += 1
    return y


class ConvFn(torch.autograd.Function):
    """The causal conv with its plain backward; saves only its inputs."""

    @staticmethod
    def forward(ctx, v, k, bias):
        ctx.save_for_backward(v, k, bias)
        if v.device.type == "cuda":
            return conv_fwd_cuda(v, k, bias)
        return conv_reference(v, k, bias)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        v, k, bias = ctx.saved_tensors
        return conv_bwd_reference(v, dy, k, bias)


def fft_causal_conv(v: torch.Tensor, k: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Causal long conv (B, L, D) -> (B, L, D) float32, differentiable.

    CPU tensors take the plain version; CUDA tensors launch the kernel; any
    other device raises."""
    if v.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fft_causal_conv: no implementation for device {v.device}")
    return ConvFn.apply(v, k, bias)
