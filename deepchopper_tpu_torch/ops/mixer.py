"""Fused Hyena mixer: short conv -> gate -> causal FFT long conv -> gate.

Port of the mixer part of `deepchopper_tpu/ops/pallas_fft.py`
(`mixer_fft_conv_bm`, its Pallas kernel `_mixer_kernel` and its reference
`mixer_reference_xla`). The public function keeps the JAX layout:

    mixer_fft_conv_bm(proj_bm (B, 3D, L), k_short (3, 1, 3D), b_short (3D,),
                      k_long (L, D), bias (D,)) -> (B, D, L) in proj's dtype

with proj = [x2 | x1 | v] along 3D, each gate short-convolved in float32
(tap t multiplies x[n - (taps-1-t)], zero for n < 0), w = v * x1,
z = causal_conv(w, k_long) + w * bias, out = z * x2.

It is differentiable through `MixerFn`, the counterpart of the JAX
package's `custom_vjp` (`_mixer_bm_fwd` / `_mixer_bm_bwd`): the forward saves
only its inputs and the backward recomputes the forward. On CUDA tensors the
forward launches the hand-written kernel `csrc/mixer_fwd.cu` and the backward
`csrc/mixer_bwd.cu` (the port of `_mixer_bwd_kernel`), or raises; on CPU
tensors they run `mixer_reference` and `mixer_bwd_reference`, the plain
PyTorch versions of the same math. Nothing falls back.
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
launch_counts: dict[str, int] = {"mixer_fwd": 0, "mixer_bwd": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _short_conv_gates(proj_bm: torch.Tensor, k_short: torch.Tensor, b_short: torch.Tensor) -> torch.Tensor:
    """The three gates [x2 | x1 | v] (B, 3D, L), short-convolved in float32."""
    seq_len = proj_bm.shape[2]
    taps = k_short.shape[0]
    xp = F.pad(proj_bm.float(), (taps - 1, 0))
    ks = k_short.float()
    uc = xp[:, :, 0:seq_len] * ks[0, 0][:, None]
    for t in range(1, taps):
        uc = uc + xp[:, :, t : t + seq_len] * ks[t, 0][:, None]
    return uc + b_short.float()[:, None]


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
    uc = _short_conv_gates(proj_bm, k_short, b_short)
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


@functools.lru_cache(maxsize=None)
def _bwd_lib() -> ctypes.CDLL:
    from . import _build

    lib = _build.load("mixer_bwd.cu")
    ptr = ctypes.c_void_p
    lib.mixer_bwd.argtypes = [ptr] * 9 + [ctypes.c_int] * 5 + [ptr]
    lib.mixer_bwd.restype = ctypes.c_int
    lib.mixer_bwd_scratch_bytes.argtypes = [ctypes.c_int] * 3
    lib.mixer_bwd_scratch_bytes.restype = ctypes.c_longlong
    return lib


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"mixer_fft_conv_bm: {msg}")


def _check_kernel_args(proj_bm, k_short, b_short, k_long, bias) -> None:
    """Raise on what the CUDA kernels do not take."""
    _check(proj_bm.is_cuda, "proj_bm must be a CUDA tensor")
    _check(proj_bm.dtype in _DTYPE_CODES, f"unsupported dtype {proj_bm.dtype}")
    _check(proj_bm.dim() == 3, f"proj_bm must be (B, 3D, L), got {tuple(proj_bm.shape)}")
    _batch, width, seq_len = proj_bm.shape
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


def mixer_fwd_cuda(
    proj_bm: torch.Tensor,
    k_short: torch.Tensor,
    b_short: torch.Tensor,
    k_long: torch.Tensor,
    bias: torch.Tensor,
) -> torch.Tensor:
    """Launch `csrc/mixer_fwd.cu` on the current stream (no synchronise)."""
    _check_kernel_args(proj_bm, k_short, b_short, k_long, bias)
    batch, width, seq_len = proj_bm.shape
    d_model = k_long.shape[1]
    dev = proj_bm.device
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


def _gate_cotangents_reference(proj_bm, dy_bm, k_short, b_short, k_long, bias, n: int):
    """Plain version of what `csrc/mixer_bwd.cu` computes: the gate
    cotangents dgates = [dx2 | dx1 | dv] (B, 3D, L) float32 and the filter
    spectrum cotangent dkhat (D, n/2 + 1) complex64, summed over the batch.
    The adjoint identities of pallas_fft.py:1240-1252, on rfft spectra."""
    d_model = k_long.shape[1]
    seq_len = proj_bm.shape[2]
    gates = _short_conv_gates(proj_bm, k_short, b_short)
    x2, x1, v = gates[:, :d_model], gates[:, d_model : 2 * d_model], gates[:, 2 * d_model :]
    khat = filter_spectrum(k_long, bias, n)
    w_f = torch.fft.rfft(v * x1, n=n, dim=-1)
    # irfft divides by n; the 1/n already lives in khat.
    z = torch.fft.irfft(w_f * khat, n=n, dim=-1)[..., :seq_len] * n
    dy = dy_bm.float()
    dz_f = torch.fft.rfft(dy * x2, n=n, dim=-1)
    dw = torch.fft.irfft(dz_f * khat.conj(), n=n, dim=-1)[..., :seq_len] * n
    dgates = torch.cat([dy * z, dw * v, dw * x1], dim=1)
    dkhat = (w_f.conj() * dz_f).sum(dim=0)
    return dgates, dkhat


def _grads_from_cotangents(proj_bm, dgates, dkhat, k_short, b_short, k_long, bias, n: int):
    """(dproj, dk_short, db_short, dk_long, dbias) from the gate cotangents
    and dkhat: the short-conv adjoint and its tap and bias sums
    (pallas_fft.py:1341-1354, :1447-1459), and (dk_long, dbias) through
    autograd of `filter_spectrum` (the role of jax.vjp(khat_scrambled)).

    dkhat holds sum_b conj(W_k) DZ_k for k in [0, n/2]. Each bin 0 < k < n/2
    of the half spectrum stands for the bins k and n - k of the full one,
    which contribute equally, so it is doubled; the result is the cotangent
    of khat in PyTorch's convention (dL/dRe + i dL/dIm)."""
    batch, width, seq_len = proj_bm.shape
    taps = k_short.shape[0]
    ks = k_short.float()[:, 0, :]  # (taps, 3D)
    # Adjoint of out[t] = sum_j ks[j] x[t + j - (taps-1)]: dx[s] = sum_j ks[j] dout[s + (taps-1) - j].
    dp = F.pad(dgates, (0, taps - 1))
    dproj = dp[:, :, 0:seq_len] * ks[taps - 1][:, None]
    for m in range(1, taps):
        dproj = dproj + dp[:, :, m : m + seq_len] * ks[taps - 1 - m][:, None]
    pp = F.pad(proj_bm.float(), (taps - 1, 0))
    dk_short = torch.stack([(dgates * pp[:, :, t : t + seq_len]).sum(dim=(0, 2)) for t in range(taps)])[:, None, :]
    db_short = dgates.sum(dim=(0, 2))
    g = dkhat.clone()
    g[:, 1 : n // 2] *= 2
    with torch.enable_grad():
        kl = k_long.detach().float().requires_grad_(True)
        b = bias.detach().float().requires_grad_(True)
        dk_long, dbias = torch.autograd.grad(filter_spectrum(kl, b, n), (kl, b), g)
    return (
        dproj.to(proj_bm.dtype),
        dk_short.to(k_short.dtype),
        db_short.to(b_short.dtype),
        dk_long.to(k_long.dtype),
        dbias.to(bias.dtype),
    )


def mixer_bwd_reference(proj_bm, dy_bm, k_short, b_short, k_long, bias):
    """Plain PyTorch backward of the mixer (FFT at N = 2L, as
    `mixer_reference`): (dproj, dk_short, db_short, dk_long, dbias)."""
    n = 2 * proj_bm.shape[2]
    dgates, dkhat = _gate_cotangents_reference(proj_bm, dy_bm, k_short, b_short, k_long, bias, n)
    return _grads_from_cotangents(proj_bm, dgates, dkhat, k_short, b_short, k_long, bias, n)


def mixer_bwd_cuda(proj_bm, dy_bm, k_short, b_short, k_long, bias):
    """Launch `csrc/mixer_bwd.cu` on the current stream (no synchronise), then
    the short-conv and filter adjoints in PyTorch:
    (dproj, dk_short, db_short, dk_long, dbias)."""
    _check_kernel_args(proj_bm, k_short, b_short, k_long, bias)
    batch, width, seq_len = proj_bm.shape
    d_model = k_long.shape[1]
    dev = proj_bm.device
    _check(dy_bm.device == dev, f"dy is on {dy_bm.device}, proj_bm on {dev}")
    _check(dy_bm.dtype == proj_bm.dtype, f"dy dtype {dy_bm.dtype} != proj dtype {proj_bm.dtype}")
    _check(tuple(dy_bm.shape) == (batch, d_model, seq_len), f"dy shape {tuple(dy_bm.shape)}")
    n = fft_size(seq_len)
    log2n = n.bit_length() - 1
    proj = proj_bm.contiguous()
    dy = dy_bm.contiguous()
    taps_f = k_short.float().reshape(3, width).contiguous()
    bsh = b_short.float().contiguous()
    khat = filter_spectrum(k_long, bias, n)
    tw = _twiddles(n, dev)
    dgates = torch.empty((batch, width, seq_len), dtype=torch.float32, device=dev)
    dkhat = torch.empty((d_model, n // 2 + 1), dtype=torch.complex64, device=dev)
    lib = _bwd_lib()
    scratch = torch.empty(lib.mixer_bwd_scratch_bytes(batch, d_model, log2n), dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.mixer_bwd(
            proj.data_ptr(), dy.data_ptr(), taps_f.data_ptr(), bsh.data_ptr(), khat.data_ptr(), tw.data_ptr(),
            scratch.data_ptr(), dgates.data_ptr(), dkhat.data_ptr(),
            batch, d_model, seq_len, log2n, _DTYPE_CODES[proj.dtype], stream,
        )  # fmt: skip
    if err != 0:
        raise RuntimeError(f"mixer_bwd launch failed: cudaError {err} at (B={batch}, D={d_model}, L={seq_len})")
    launch_counts["mixer_bwd"] += 1
    return _grads_from_cotangents(proj, dgates, dkhat, k_short, b_short, k_long, bias, n)


class MixerFn(torch.autograd.Function):
    """The fused mixer with its hand-written backward. Saves only its inputs:
    the backward recomputes the forward, as the JAX backward kernel does."""

    @staticmethod
    def forward(ctx, proj_bm, k_short, b_short, k_long, bias):
        ctx.save_for_backward(proj_bm, k_short, b_short, k_long, bias)
        if proj_bm.device.type == "cuda":
            return mixer_fwd_cuda(proj_bm, k_short, b_short, k_long, bias)
        return mixer_reference(proj_bm, k_short, b_short, k_long, bias)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        args = ctx.saved_tensors
        if args[0].device.type == "cuda":
            return mixer_bwd_cuda(args[0], dy, *args[1:])
        return mixer_bwd_reference(args[0], dy, *args[1:])


def mixer_fft_conv_bm(
    proj_bm: torch.Tensor,
    k_short: torch.Tensor,
    b_short: torch.Tensor,
    k_long: torch.Tensor,
    bias: torch.Tensor,
) -> torch.Tensor:
    """Batch-major fused mixer: proj_bm (B, 3D, L) -> (B, D, L), differentiable.

    CPU tensors take the plain versions; CUDA tensors launch the kernels;
    any other device raises."""
    if proj_bm.device.type not in ("cpu", "cuda"):
        raise ValueError(f"mixer_fft_conv_bm: no implementation for device {proj_bm.device}")
    return MixerFn.apply(proj_bm, k_short, b_short, k_long, bias)
