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
and writes the channel-last layout in place, on the plan of `conv_fwd_plan`),
or raises; on CPU tensors it runs `conv_reference`. The backward is
`conv_bwd_reference` on both: the JAX backward is XLA code, not a kernel, so
it stays plain PyTorch.
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


# The plan of `csrc/conv_fwd.cu` (its header says why).
SMEM_LIMIT = 232448  # bytes of shared memory a block may use on sm_90
MAX_CHANNELS = 8  # channels a rows block: 8 float32 of a position fill a 32-byte sector
ROWS_THREADS = 256  # the rows block G aims at (measured on an H100 against larger tiles)
PAIR_LOG2N = 16  # N = 65536: a row is a cluster of two CTAs
PAIR_THREADS = 512


def values_per_thread(h: int) -> int:
    """`fft_radix::values_per_thread`: values a thread holds in a pass."""
    return h if h < 16 else (32 if h >= 4096 else 16)


def padded(h: int) -> int:
    """`fft_radix::padded`: float2 slots of one padded transform of h values."""
    return h + (h >> 4)


def quarter(h: int) -> int:
    """`fft_radix::quarter`: float2 slots of the quarter twiddle table."""
    return max(1, h >> 2)


@functools.lru_cache(maxsize=4096)
def conv_fwd_plan(batch: int, d_model: int, seq_len: int) -> dict:
    """How `csrc/conv_fwd.cu` runs a (B, L, D) conv: layout ("rows" up to
    N = 32768, "pair" at 65536), G (channels a block), V (values a thread in
    a transform pass), CW (channels a thread loads at once), threads and
    shared bytes a CTA, CTAs a row (2 in the pair), and the grid (CTAs).

    Rows: the block runs its 2G transforms of H = N/4 at once, H / V
    threads each. G is the power of two that gives ROWS_THREADS threads,
    but at least 2 and at most MAX_CHANNELS, halved until the 2G padded
    transforms and the quarter table fit SMEM_LIMIT, and no more than the
    next power of two >= D. Pair: one channel a cluster of two CTAs, one
    half of the row each."""
    n = fft_size(seq_len)
    log2n = n.bit_length() - 1
    h = n // 4
    v = values_per_thread(h)
    if log2n == PAIR_LOG2N:
        return {"layout": "pair", "G": 1, "V": 32, "CW": 1, "threads": PAIR_THREADS, "ctas": 2,
                "smem": (padded(h) + quarter(h)) * 8, "grid": 2 * batch * d_model}  # fmt: skip
    nt = h // v  # threads of one transform
    g = min(MAX_CHANNELS, max(2, ROWS_THREADS // (2 * nt)))
    while g > 1 and (g * 2 * padded(h) + quarter(h)) * 8 > SMEM_LIMIT:
        g //= 2
    g = min(g, 1 << (d_model - 1).bit_length())
    return {"layout": "rows", "G": g, "V": v, "CW": min(g, 4), "threads": 2 * g * nt, "ctas": 1,
            "smem": (g * 2 * padded(h) + quarter(h)) * 8, "grid": batch * -(-d_model // g)}  # fmt: skip


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("conv_fwd.cu")
    ptr = ctypes.c_void_p
    lib.conv_fwd.argtypes = [ptr] * 4 + [ctypes.c_int] * 5 + [ptr]
    lib.conv_fwd.restype = ctypes.c_int
    return lib


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"fft_causal_conv: {msg}")


def conv_fwd_cuda(v: torch.Tensor, k: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Launch `csrc/conv_fwd.cu` on the current stream (no synchronise), on
    the plan of `conv_fwd_plan`."""
    _check(v.is_cuda, "v must be a CUDA tensor")
    _check(v.dtype == torch.float32, f"v must be float32, got {v.dtype}")
    _check(v.dim() == 3, f"v must be (B, L, D), got {tuple(v.shape)}")
    batch, seq_len, d_model = v.shape
    _check(tuple(k.shape) == (seq_len, d_model), f"k shape {tuple(k.shape)}")
    _check(tuple(bias.shape) == (d_model,), f"bias shape {tuple(bias.shape)}")
    _check(seq_len <= MAX_SEQ_LEN, f"L = {seq_len} > {MAX_SEQ_LEN}")
    for name, t in (("k", k), ("bias", bias)):
        _check(t.device == v.device, f"{name} is on {t.device}, v on {v.device}")
    y = _conv_fwd_launch(v, k, bias, conv_fwd_plan(batch, d_model, seq_len))
    launch_counts["conv_fwd"] += 1
    return y


def _conv_fwd_launch(v: torch.Tensor, k: torch.Tensor, bias: torch.Tensor, plan: dict) -> torch.Tensor:
    """One launch of `csrc/conv_fwd.cu` on checked arguments with the G of
    `plan` (the kernel refuses a plan it does not take)."""
    batch, seq_len, d_model = v.shape
    n = fft_size(seq_len)
    vc = v.contiguous()
    khat = filter_spectrum(k, bias, n)
    tw = _twiddles(n, v.device)
    y = torch.empty_like(vc)
    _build.launch(
        _lib().conv_fwd, vc,
        vc.data_ptr(), khat.data_ptr(), tw.data_ptr(), y.data_ptr(),
        batch, d_model, seq_len, n.bit_length() - 1, plan["G"],
        what=f"conv_fwd at (B={batch}, L={seq_len}, D={d_model})",
    )  # fmt: skip
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
