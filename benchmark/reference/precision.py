"""The reference's matrix products: float32 with TF32 off, or the control's
float8 (e4m3, one scale a tensor) on every operand that the configuration
runs in bfloat16, forward and backward."""

from __future__ import annotations

import torch

FP8_MAX = 448.0  # largest finite float8_e4m3fn


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 with one scale for the tensor, back in float32."""
    scale = t.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class _Fp8Matmul(torch.autograd.Function):
    """x @ w.T with x, w and the output's gradient rounded to float8."""

    @staticmethod
    def forward(ctx, x, w):
        xq, wq = fp8_round(x), fp8_round(w)
        ctx.save_for_backward(xq, wq)
        return xq @ wq.T

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        gq = fp8_round(g)
        gx = gq @ wq
        gw = gq.reshape(-1, gq.shape[-1]).T @ xq.reshape(-1, xq.shape[-1])
        return gx, gw


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None, mode: str = "f32") -> torch.Tensor:
    """x @ w.T + b in float32, or with the control's float8 operands (`mode="fp8"`)."""
    y = _Fp8Matmul.apply(x, w) if mode == "fp8" else x @ w.T
    return y if b is None else y + b


def strict_float32() -> None:
    """No TF32 in the reference's float32 products."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
