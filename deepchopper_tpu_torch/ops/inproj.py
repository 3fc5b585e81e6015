"""in_proj-fused Hyena mixer: in_proj GEMM -> short conv -> gate -> causal FFT
long conv -> gate.

Port of `mixer_fft_conv_inproj` in `deepchopper_tpu/ops/pallas_fft.py` (its
Pallas kernel `_mixer_inproj_kernel` and the custom VJP `_mixer_inproj_bwd`).
The public function keeps the JAX contract, with the in_proj weight in the
port's `nn.Linear` layout:

    mixer_fft_conv_inproj(x_bm (B, D, L), w_in (3D, D), b_in (3D,),
                          k_short (3, 1, 3D), b_short (3D,), k_long (L, D),
                          bias (D,)) -> (B, D, L) in x's dtype

It computes `ops.mixer`'s mixer of proj = w_in x + b_in. In the forward, proj
is held in float32, as the Pallas kernel holds it: x and w_in are taken in x's
dtype, multiplied and summed in float32, and b_in is added unrounded. The
backward recomputes proj the way `_inproj_composed` (pallas_fft.py:1164-1176)
does, as the model's `dense_cf` makes it: one `torch.matmul` in x's dtype,
rounded there, plus b_in rounded to x's dtype. So in bfloat16 the backward
differentiates a slightly different rounding of the same function, as in the
JAX package.

`InprojFn` saves only its inputs. On CUDA tensors the forward launches the
hand-written kernel `csrc/mixer_inproj_fwd.cu`, or raises, and the backward
runs `ops.mixer.mixer_bwd_cuda` (the kernel `csrc/mixer_bwd.cu`) on the
recomputed proj, then the matmul's VJP through autograd; on CPU tensors they
run `inproj_reference` and `ops.mixer.mixer_bwd_reference`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, mixer
from .mixer import _DTYPE_CODES, MAX_SEQ_LEN, _twiddles, fft_size, filter_spectrum

# Launches of each CUDA kernel since the last reset: one per wrapper call
# that reached the card. Read by chip_smoke.py to show the path ran through it.
launch_counts: dict[str, int] = _build.counters("mixer_inproj_fwd")


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def projection_f32(x_bm: torch.Tensor, w_in: torch.Tensor, b_in: torch.Tensor) -> torch.Tensor:
    """proj = w_in x + b_in (B, 3D, L) in float32, as the kernel forms it: x and
    w_in in x's dtype, widened, multiplied in float32; b_in unrounded."""
    return torch.matmul(w_in.to(x_bm.dtype).float(), x_bm.float()) + b_in.float()[:, None]


def projection_composed(x_bm: torch.Tensor, w_in: torch.Tensor, b_in: torch.Tensor) -> torch.Tensor:
    """proj in x's dtype, as `_inproj_composed` and the model's `dense_cf`
    make it: the matmul rounded to x's dtype, then b_in in x's dtype added."""
    dtype = x_bm.dtype
    return torch.matmul(w_in.to(dtype), x_bm) + b_in.to(dtype)[:, None]


def inproj_reference(x_bm, w_in, b_in, k_short, b_short, k_long, bias) -> torch.Tensor:
    """Plain PyTorch in_proj-fused mixer (float32 proj, FFT at N = 2L), in
    x's dtype."""
    proj = projection_f32(x_bm, w_in, b_in)
    return mixer.mixer_reference(proj, k_short, b_short, k_long, bias).to(x_bm.dtype)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("mixer_inproj_fwd.cu")
    ptr = ctypes.c_void_p
    lib.mixer_inproj_fwd.argtypes = [ptr] * 9 + [ctypes.c_int] * 5 + [ptr]
    lib.mixer_inproj_fwd.restype = ctypes.c_int
    lib.mixer_inproj_fwd_scratch_bytes.argtypes = [ctypes.c_int] * 4
    lib.mixer_inproj_fwd_scratch_bytes.restype = ctypes.c_longlong
    return lib


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"mixer_fft_conv_inproj: {msg}")


def mixer_inproj_fwd_cuda(x_bm, w_in, b_in, k_short, b_short, k_long, bias) -> torch.Tensor:
    """Launch `csrc/mixer_inproj_fwd.cu` on the current stream (no synchronise)."""
    _check(x_bm.is_cuda, "x_bm must be a CUDA tensor")
    _check(x_bm.dtype in _DTYPE_CODES, f"unsupported dtype {x_bm.dtype}")
    _check(x_bm.dim() == 3, f"x_bm must be (B, D, L), got {tuple(x_bm.shape)}")
    batch, d_model, seq_len = x_bm.shape
    width = 3 * d_model
    _check(tuple(w_in.shape) == (width, d_model), f"w_in shape {tuple(w_in.shape)} != (3D, D) = ({width}, {d_model})")
    _check(tuple(b_in.shape) == (width,), f"b_in shape {tuple(b_in.shape)}")
    _check(tuple(k_short.shape) == (3, 1, width), f"k_short shape {tuple(k_short.shape)} (the kernel takes 3 taps)")
    _check(tuple(b_short.shape) == (width,), f"b_short shape {tuple(b_short.shape)}")
    _check(tuple(k_long.shape) == (seq_len, d_model), f"k_long shape {tuple(k_long.shape)}")
    _check(tuple(bias.shape) == (d_model,), f"bias shape {tuple(bias.shape)}")
    _check(seq_len <= MAX_SEQ_LEN, f"L = {seq_len} > {MAX_SEQ_LEN}")
    dev = x_bm.device
    for name, t in (("w_in", w_in), ("b_in", b_in), ("k_short", k_short), ("b_short", b_short),
                    ("k_long", k_long), ("bias", bias)):  # fmt: skip
        _check(t.device == dev, f"{name} is on {t.device}, x_bm on {dev}")
    n = fft_size(seq_len)
    log2n = n.bit_length() - 1
    x = x_bm.contiguous()
    w = w_in.to(x.dtype).contiguous()
    bin32 = b_in.float().contiguous()
    taps = k_short.float().reshape(3, width).contiguous()
    bsh = b_short.float().contiguous()
    khat = filter_spectrum(k_long, bias, n)
    tw = _twiddles(n, dev)
    out = torch.empty((batch, d_model, seq_len), dtype=x.dtype, device=dev)
    lib = _lib()
    scratch = torch.empty(
        max(lib.mixer_inproj_fwd_scratch_bytes(batch, d_model, seq_len, log2n), 8), dtype=torch.uint8, device=dev
    )
    _build.launch(
        lib.mixer_inproj_fwd, x,
        x.data_ptr(), w.data_ptr(), bin32.data_ptr(), taps.data_ptr(), bsh.data_ptr(), khat.data_ptr(),
        tw.data_ptr(), scratch.data_ptr(), out.data_ptr(),
        batch, d_model, seq_len, log2n, _DTYPE_CODES[x.dtype],
        what=f"mixer_inproj_fwd at (B={batch}, D={d_model}, L={seq_len})",
    )  # fmt: skip
    launch_counts["mixer_inproj_fwd"] += 1
    return out


def inproj_bwd(x_bm, dy_bm, w_in, b_in, k_short, b_short, k_long, bias, mixer_bwd=None):
    """Backward of the in_proj-fused mixer, as `_mixer_inproj_bwd`: the VJP of
    `projection_composed` followed by the mixer, with the mixer's backward
    `mixer_bwd` (by default from `ops.mixer`: the kernel on CUDA tensors, the
    plain version on CPU ones). Returns the seven input gradients."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (x_bm, w_in, b_in)]
        proj = projection_composed(*leaves)
    if mixer_bwd is None:
        mixer_bwd = mixer.mixer_bwd_cuda if x_bm.device.type == "cuda" else mixer.mixer_bwd_reference
    dproj, dk_short, db_short, dk_long, dbias = mixer_bwd(proj.detach(), dy_bm, k_short, b_short, k_long, bias)
    dx, dw, db = torch.autograd.grad(proj, leaves, dproj)
    return dx, dw, db, dk_short, db_short, dk_long, dbias


class InprojFn(torch.autograd.Function):
    """The in_proj-fused mixer; saves only its inputs and recomputes proj and
    the mixer in its backward."""

    @staticmethod
    def forward(ctx, x_bm, w_in, b_in, k_short, b_short, k_long, bias):
        ctx.save_for_backward(x_bm, w_in, b_in, k_short, b_short, k_long, bias)
        if x_bm.device.type == "cuda":
            return mixer_inproj_fwd_cuda(x_bm, w_in, b_in, k_short, b_short, k_long, bias)
        return inproj_reference(x_bm, w_in, b_in, k_short, b_short, k_long, bias)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        x_bm, *params = ctx.saved_tensors
        return inproj_bwd(x_bm, dy.to(x_bm.dtype), *params)


def mixer_fft_conv_inproj(x_bm, w_in, b_in, k_short, b_short, k_long, bias) -> torch.Tensor:
    """in_proj + mixer, x_bm (B, D, L) -> (B, D, L), differentiable.

    CPU tensors take the plain versions; CUDA tensors launch the kernels; any
    other device raises."""
    if x_bm.device.type not in ("cpu", "cuda"):
        raise ValueError(f"mixer_fft_conv_inproj: no implementation for device {x_bm.device}")
    return InprojFn.apply(x_bm, w_in, b_in, k_short, b_short, k_long, bias)
