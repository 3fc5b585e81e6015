"""Caduceus bidirectional-Mamba backbone in PyTorch.

Port of `deepchopper_tpu/models/caduceus.py`. The residual stream runs
batch-major (B, L, D) in float32; in_proj, x_proj and out_proj run in
`compute_dtype`, everything else (short conv, dt_proj, softplus, the scan,
gates, RMSNorm) in float32, as in the JAX package. The reverse direction of
the bidirectional mixer is flip-free: the mirrored short conv and the
reverse walk of the scan compute flip(mixer(flip(x))) without copies.
Parameter names follow the flax tree (`block_0.bimamba.mixer.in_proj`,
`conv1d_kernel`, `A_log`, ...) so `models/bridge.py` maps one onto the other.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.scan import selective_scan
from .config import CaduceusConfig
from .hyena import _lecun_normal_, init_dense_


def short_depthwise_conv(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv in x's dtype: y[t] = sum_j k[j] x[t - (taps-1) + j]
    + bias, zero before the sequence. x (B, L, W), kernel (taps, 1, W)."""
    taps, seq_len = kernel.shape[0], x.shape[1]
    k = kernel.to(x.dtype)
    xp = F.pad(x, (0, 0, taps - 1, 0))
    out = xp[:, 0:seq_len] * k[0, 0]
    for t in range(1, taps):
        out = out + xp[:, t : t + seq_len] * k[t, 0]
    return out + bias.to(x.dtype)


def short_depthwise_conv_rev(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Mirror of `short_depthwise_conv`: flip(conv(flip(x))) without flips,
    y[t] = sum_j k[j] x[t + (taps-1) - j] + bias, zero after the sequence."""
    taps, seq_len = kernel.shape[0], x.shape[1]
    k = kernel.to(x.dtype)
    xp = F.pad(x, (0, 0, 0, taps - 1))
    out = xp[:, 0:seq_len] * k[taps - 1, 0]
    for m in range(1, taps):
        out = out + xp[:, m : m + seq_len] * k[taps - 1 - m, 0]
    return out + bias.to(x.dtype)


def _linear(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A bias-free projection in `dtype`, returned in float32."""
    return F.linear(x.to(dtype), layer.weight.to(dtype)).float()


class MambaMixer(nn.Module):
    """One Mamba selective-SSM mixer, (B, L, d_model) float32 -> same.

    `reverse=True` computes the mixer on the flipped sequence, flipped back:
    the per-position ops commute with the flip, so only the short conv
    (mirrored) and the scan (reverse walk) differ."""

    def __init__(self, cfg: CaduceusConfig):
        super().__init__()
        self.cfg = cfg
        d_inner = cfg.d_model * cfg.expand
        self.in_proj = nn.Linear(cfg.d_model, 2 * d_inner, bias=False)
        self.conv1d_kernel = nn.Parameter(torch.empty(cfg.d_conv, 1, d_inner))
        self.conv1d_bias = nn.Parameter(torch.zeros(d_inner))
        self.x_proj = nn.Linear(d_inner, 2 * cfg.d_state + cfg.dt_rank, bias=False)
        self.dt_proj = nn.Linear(cfg.dt_rank, d_inner)
        self.A_log = nn.Parameter(torch.empty(d_inner, cfg.d_state))
        self.D = nn.Parameter(torch.ones(d_inner))
        self.out_proj = nn.Linear(d_inner, cfg.d_model, bias=False)

    def reset_parameters(self, gen: torch.Generator) -> None:
        """The flax initialisers: lecun_normal Dense kernels (the conv kernel's
        fan-in is taps x 1), zero biases, A_log = log(1..N), D = 1."""
        init_dense_(self.in_proj, gen)
        _lecun_normal_(self.conv1d_kernel, self.cfg.d_conv, gen)
        init_dense_(self.x_proj, gen)
        init_dense_(self.dt_proj, gen)
        init_dense_(self.out_proj, gen)
        with torch.no_grad():
            nn.init.zeros_(self.conv1d_bias)
            self.A_log.copy_(torch.log(torch.arange(1, self.cfg.d_state + 1, dtype=torch.float32)).expand_as(self.A_log))
            nn.init.ones_(self.D)

    def forward(self, x: torch.Tensor, reverse: bool = False) -> torch.Tensor:
        cfg = self.cfg
        dtype = getattr(torch, cfg.compute_dtype)
        xs, z = _linear(self.in_proj, x, dtype).chunk(2, dim=-1)
        conv = short_depthwise_conv_rev if reverse else short_depthwise_conv
        xs = F.silu(conv(xs, self.conv1d_kernel, self.conv1d_bias))
        dt, bp, cp = torch.split(_linear(self.x_proj, xs, dtype), [cfg.dt_rank, cfg.d_state, cfg.d_state], dim=-1)
        delta = F.softplus(self.dt_proj(dt))
        y = selective_scan(xs, delta, -torch.exp(self.A_log), bp, cp, self.D, reverse=reverse)
        return _linear(self.out_proj, y * F.silu(z), dtype)


class BiMambaMixer(nn.Module):
    """The mixer applied in both directions, outputs summed. "ph"
    (`bidirectional_weight_tie`) runs the same weights both ways; "ps" has a
    separate `mixer_rev` for the reverse pass."""

    def __init__(self, cfg: CaduceusConfig):
        super().__init__()
        self.cfg = cfg
        self.mixer = MambaMixer(cfg)
        if not cfg.bidirectional_weight_tie:
            self.mixer_rev = MambaMixer(cfg)

    def reset_parameters(self, gen: torch.Generator) -> None:
        self.mixer.reset_parameters(gen)
        if not self.cfg.bidirectional_weight_tie:
            self.mixer_rev.reset_parameters(gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        rev = self.mixer if self.cfg.bidirectional_weight_tie else self.mixer_rev
        return self.mixer(x) + rev(x, reverse=True)


class RMSNorm(nn.Module):
    """x * rsqrt(mean(x^2) + eps) * weight over the last axis, float32."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + self.eps) * self.weight


class CaduceusBlock(nn.Module):
    """Pre-norm residual block: r + bimamba(norm(r))."""

    def __init__(self, cfg: CaduceusConfig):
        super().__init__()
        self.norm = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon)
        self.bimamba = BiMambaMixer(cfg)

    def reset_parameters(self, gen: torch.Generator) -> None:
        self.bimamba.reset_parameters(gen)

    def forward(self, r: torch.Tensor) -> torch.Tensor:
        return r + self.bimamba(self.norm(r))


class CaduceusBackbone(nn.Module):
    """Embedding -> n_layer bidirectional Mamba blocks -> RMSNorm.

    forward(input_ids (B, L) int) -> hidden (B, L, D) float32."""

    def __init__(self, cfg: CaduceusConfig):
        super().__init__()
        self.cfg = cfg
        self.word_embeddings = nn.Embedding(cfg.padded_vocab_size, cfg.d_model)
        for i in range(cfg.n_layer):
            self.add_module(f"block_{i}", CaduceusBlock(cfg))
        self.norm_f = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon)

    def blocks(self) -> list[CaduceusBlock]:
        return [getattr(self, f"block_{i}") for i in range(self.cfg.n_layer)]

    def reset_parameters(self, gen: torch.Generator) -> None:
        # flax Embed init: variance_scaling(1, fan_in, normal) -> std 1/sqrt(D).
        with torch.no_grad():
            self.word_embeddings.weight.normal_(0.0, 1.0 / math.sqrt(self.cfg.d_model), generator=gen)
        for blk in self.blocks():
            blk.reset_parameters(gen)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        r = F.embedding(input_ids, self.word_embeddings.weight)
        for blk in self.blocks():
            r = blk(r)
        return self.norm_f(r)
