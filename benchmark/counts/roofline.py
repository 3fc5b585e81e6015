"""Least time of one call of the port's kernels: the larger of its bytes at
the card's HBM rate and its operations at the card's rate for them. Each
input byte is read once and each output byte written once, whatever a
kernel reads again; operations are what the algorithm needs at that shape.
The same counts hold whatever implements the call.

These reproduce the bound column of the port's kernel table (PERF.md,
rows 1, 2, 3 and 5): summed over the 17 ladder widths, mixer_fwd 1.403 ms,
mixer_bwd 2.925, scan_fwd 4.315, scan_bwd 7.575 (benchmark/tests).
"""

from __future__ import annotations

import math

from .peaks import EXPS_PER_S, F32_FLOPS_PER_S, HBM_BYTES_PER_S

CKPT_CHUNK = 32  # steps between the scan backward's saved states


def mixer_fwd_s(batch: int, d_model: int, seq_len: int, itemsize: int = 2) -> float:
    """Hyena's fused mixer forward: proj (B, 3D, L) read once, out (B, D, L)
    written once, filter taps read once; per row and channel a real FFT
    conv at N = 2L, the short conv and the gates."""
    n = 2 * seq_len
    nbytes = batch * 4 * d_model * seq_len * itemsize + 4 * (seq_len * d_model + 13 * d_model)
    flops = batch * d_model * (5 * n * math.log2(n) + 3 * n + 23 * seq_len)
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)


def mixer_bwd_s(batch: int, d_model: int, seq_len: int, itemsize: int = 2) -> float:
    """Its backward: proj and dy read once, dproj written once (7 streams of
    (B, D, L)), the parameters read and their gradients written; per row four
    real FFTs at N = 2L, the spectral products, the gate recompute and the
    short conv's adjoint."""
    n = 2 * seq_len
    nbytes = batch * 7 * d_model * seq_len * itemsize + 2 * 4 * (seq_len * d_model + 13 * d_model)
    flops = batch * d_model * (10 * n * math.log2(n) + 9 * n + 40 * seq_len + 3 * 12 * seq_len)
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)


def _scan_s(nbytes: float, flops: float, tokens: int, d_in: int, n: int) -> float:
    ops = max(flops / F32_FLOPS_PER_S, tokens * d_in * n / EXPS_PER_S)  # one exp a (token, channel, state)
    return max(nbytes / HBM_BYTES_PER_S, ops)


def scan_fwd_s(batch: int, seq_len: int, d_in: int = 512, n: int = 16) -> float:
    """The selective scan forward, float32: u, delta, B, C, A, D in; y out."""
    tok = batch * seq_len
    return _scan_s(4 * (3 * tok * d_in + 2 * tok * n + d_in * n + d_in), 6 * tok * d_in * n, tok, d_in, n)


def scan_bwd_s(batch: int, seq_len: int, d_in: int = 512, n: int = 16) -> float:
    """Its backward walk, float32: u, delta, dy, B, C, the saved states, A, D
    in; du, ddelta, dB, dC, dA, dD out."""
    tok = batch * seq_len
    ckpt = batch * -(-seq_len // CKPT_CHUNK) * n * d_in
    nbytes = 4 * (5 * tok * d_in + 4 * tok * n + ckpt + 2 * (d_in * n + d_in))
    return _scan_s(nbytes, 20 * tok * d_in * n, tok, d_in, n)
