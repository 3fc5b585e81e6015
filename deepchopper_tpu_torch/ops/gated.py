"""Gated causal FFT conv: gate -> causal FFT long conv -> gate.

Port of `gated_fft_conv_cm` in `deepchopper_tpu/ops/pallas_fft.py` (its
Pallas kernel `_gated_kernel`, the block-layout twin `_gated_kernel_v2` that
`DEEPCHOPPER_FFT_LAYOUT=v2` selects, and the custom VJP `_gated_bwd`). The
public function keeps the JAX contract with the batch and channel axes
swapped to match the port's (B, C, L) stream:

    gated_fft_conv_bm(uc_bm (B, 3D, L), k_long (L, D), bias (D,)) -> (B, D, L)

in uc's dtype, uc = [x2 | x1 | v] already short-convolved, w = v * x1,
z = causal_conv(w, k_long) + w * bias, out = z * x2. The gates and the conv run
in float32; the product w is formed after both gates are widened to float32
(as the JAX package's XLA route does, `models/hyena.py:278`; its Pallas kernels
round v * x1 to the input dtype first), in the kernel and in the plain version
alike.

`GatedFn` makes it differentiable and saves only its inputs. On CUDA tensors
the forward launches the hand-written kernel `gated_fwd` of
`csrc/mixer_fwd.cu` (the fused mixer's kernels without the short conv), or raises;
on CPU tensors it runs `gated_reference`. The backward is `gated_bwd_reference`
on both: the JAX backward is XLA code, not a kernel, so it stays plain PyTorch
(`torch.fft`, cuFFT on the card).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .mixer import _DTYPE_CODES, MAX_SEQ_LEN, _twiddles, fft_size, filter_spectrum

# Launches of each CUDA kernel since the last reset: one per wrapper call
# that reached the card. Read by chip_smoke.py to show the path ran through it.
launch_counts: dict[str, int] = _build.counters("gated_fwd")


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _gates(uc_bm: torch.Tensor, d_model: int):
    uc = uc_bm.float()
    return uc[:, :d_model], uc[:, d_model : 2 * d_model], uc[:, 2 * d_model :]


def gated_reference(uc_bm: torch.Tensor, k_long: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch gated conv in float32 (FFT at N = 2L), in uc's dtype."""
    d_model = k_long.shape[1]
    seq_len = uc_bm.shape[2]
    n = 2 * seq_len
    x2, x1, v = _gates(uc_bm, d_model)
    w = v * x1
    k_f = torch.fft.rfft(k_long.float().T, n=n, dim=-1)  # (D, F)
    z = torch.fft.irfft(torch.fft.rfft(w, n=n, dim=-1) * k_f, n=n, dim=-1)[..., :seq_len]
    return ((z + w * bias.float()[:, None]) * x2).to(uc_bm.dtype)


def gated_bwd_reference(uc_bm, dy_bm, k_long, bias):
    """Backward of the gated conv with the math of `_gated_bwd`
    (pallas_fft.py:586-622), batch-major: (duc, dk_long, dbias).

    dz = dy x2, dx2 = dy z, dw = corr_k(dz) + dz bias, dv = dw x1,
    dx1 = dw v, dk = sum over B of corr(dz, w), dbias = sum dz w."""
    d_model = k_long.shape[1]
    seq_len = uc_bm.shape[2]
    n = 2 * seq_len
    x2, x1, v = _gates(uc_bm, d_model)
    dy = dy_bm.float()
    b = bias.float()[:, None]
    w = v * x1
    k_f = torch.fft.rfft(k_long.float().T, n=n, dim=-1)
    w_f = torch.fft.rfft(w, n=n, dim=-1)
    z = torch.fft.irfft(w_f * k_f, n=n, dim=-1)[..., :seq_len] + w * b
    dz = dy * x2
    dz_f = torch.fft.rfft(dz, n=n, dim=-1)
    dw = torch.fft.irfft(dz_f * k_f.conj(), n=n, dim=-1)[..., :seq_len] + dz * b
    dk = torch.fft.irfft((dz_f * w_f.conj()).sum(dim=0), n=n, dim=-1)[..., :seq_len]
    duc = torch.cat([dy * z, dw * v, dw * x1], dim=1).to(uc_bm.dtype)
    return duc, dk.T.to(k_long.dtype), (dz * w).sum(dim=(0, 2)).to(bias.dtype)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("mixer_fwd.cu")
    ptr = ctypes.c_void_p
    lib.gated_fwd.argtypes = [ptr] * 4 + [ctypes.c_int] * 5 + [ptr]
    lib.gated_fwd.restype = ctypes.c_int
    return lib


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"gated_fft_conv_bm: {msg}")


def gated_fwd_cuda(uc_bm: torch.Tensor, k_long: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Launch `gated_fwd` of `csrc/mixer_fwd.cu` on the current stream (no
    synchronise)."""
    _check(uc_bm.is_cuda, "uc_bm must be a CUDA tensor")
    _check(uc_bm.dtype in _DTYPE_CODES, f"unsupported dtype {uc_bm.dtype}")
    _check(uc_bm.dim() == 3, f"uc_bm must be (B, 3D, L), got {tuple(uc_bm.shape)}")
    batch, width, seq_len = uc_bm.shape
    d_model = k_long.shape[1] if k_long.dim() == 2 else -1
    _check(width == 3 * d_model, f"uc width {width} != 3 * d_model ({d_model})")
    _check(tuple(k_long.shape) == (seq_len, d_model), f"k_long shape {tuple(k_long.shape)}")
    _check(tuple(bias.shape) == (d_model,), f"bias shape {tuple(bias.shape)}")
    _check(seq_len <= MAX_SEQ_LEN, f"L = {seq_len} > {MAX_SEQ_LEN}")
    dev = uc_bm.device
    for name, t in (("k_long", k_long), ("bias", bias)):
        _check(t.device == dev, f"{name} is on {t.device}, uc_bm on {dev}")
    n = fft_size(seq_len)
    log2n = n.bit_length() - 1
    uc = uc_bm.contiguous()
    khat = filter_spectrum(k_long, bias, n)
    tw = _twiddles(n, dev)
    out = torch.empty((batch, d_model, seq_len), dtype=uc.dtype, device=dev)
    _build.launch(
        _lib().gated_fwd, uc,
        uc.data_ptr(), khat.data_ptr(), tw.data_ptr(), out.data_ptr(),
        batch, d_model, seq_len, log2n, _DTYPE_CODES[uc.dtype],
        what=f"gated_fwd at (B={batch}, D={d_model}, L={seq_len})",
    )  # fmt: skip
    launch_counts["gated_fwd"] += 1
    return out


class GatedFn(torch.autograd.Function):
    """The gated conv with its plain backward. Saves only its inputs: the
    backward recomputes z, as `_gated_bwd` does."""

    @staticmethod
    def forward(ctx, uc_bm, k_long, bias):
        ctx.save_for_backward(uc_bm, k_long, bias)
        if uc_bm.device.type == "cuda":
            return gated_fwd_cuda(uc_bm, k_long, bias)
        return gated_reference(uc_bm, k_long, bias)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        uc_bm, k_long, bias = ctx.saved_tensors
        return gated_bwd_reference(uc_bm, dy, k_long, bias)


def gated_fft_conv_bm(uc_bm: torch.Tensor, k_long: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Batch-major gated conv: uc_bm (B, 3D, L) -> (B, D, L), differentiable.

    CPU tensors take the plain version; CUDA tensors launch the kernel; any
    other device raises."""
    if uc_bm.device.type not in ("cpu", "cuda"):
        raise ValueError(f"gated_fft_conv_bm: no implementation for device {uc_bm.device}")
    return GatedFn.apply(uc_bm, k_long, bias)
