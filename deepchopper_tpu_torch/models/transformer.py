"""Transformer-encoder baseline backbone in PyTorch.

Port of `deepchopper_tpu/models/transformer.py`: token embedding plus a
sinusoidal position table, n pre-norm encoder layers, a final LayerNorm.
Numerics follow the flax layers: LayerNorm (epsilon 1e-6, flax's default,
not torch's 1e-5) and the residual stream in float32; the attention, its
q/k/v and output projections and the feed-forward in `compute_dtype`, cast
back to float32 at each residual add.

Flax's `MultiHeadDotProductAttention` keeps its q/k/v kernels as (d, H, d/H)
with (H, d/H) biases and its output kernel as (H, d/H, d); here each is one
`nn.Linear` over the flattened heads, which `models/bridge.py` reshapes into.
Attention is `F.scaled_dot_product_attention` (on the card its flash or
memory-efficient backends keep a 32768-wide read within the card's memory;
the JAX package computes it in XLA, outside any Pallas kernel). A
`pad_mask` (B, L), True where a key may be attended, masks keys as flax
does: masked scores become `finfo(dtype).min`, here added to the scores, so
a row whose keys are all masked attends uniformly, as in flax, not NaN.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .config import TransformerConfig
from .hyena import init_dense_

LN_EPS = 1e-6  # flax nn.LayerNorm's default


def sinusoidal_positions(max_len: int, d_model: int) -> np.ndarray:
    """(max_len, d_model) float32: sin on the even features, cos on the odd."""
    pos = np.arange(max_len)[:, None].astype(np.float32)
    div = np.exp(np.arange(0, d_model, 2).astype(np.float32) * (-np.log(10000.0) / d_model))
    pe = np.zeros((max_len, d_model), dtype=np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe


def _dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A flax Dense with `dtype`: input, kernel and bias in dtype."""
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


class SelfAttention(nn.Module):
    """Flax's `MultiHeadDotProductAttention` on (B, L, d), self-attention,
    no dropout; parameters `query`, `key`, `value` and `out`."""

    def __init__(self, d_model: int, n_heads: int):
        super().__init__()
        if d_model % n_heads:
            raise ValueError(f"d_model={d_model} is not a multiple of n_heads={n_heads}")
        self.n_heads = n_heads
        self.query = nn.Linear(d_model, d_model)
        self.key = nn.Linear(d_model, d_model)
        self.value = nn.Linear(d_model, d_model)
        self.out = nn.Linear(d_model, d_model)

    def reset_parameters(self, gen: torch.Generator) -> None:
        """flax DenseGeneral init: lecun_normal over the contracted axes
        (fan-in d for all four), zero biases."""
        for layer in (self.query, self.key, self.value, self.out):
            init_dense_(layer, gen)

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor | None, dtype: torch.dtype) -> torch.Tensor:
        b, seq_len, d = x.shape
        heads = [_dense(layer, x, dtype).view(b, seq_len, self.n_heads, d // self.n_heads).transpose(1, 2)
                 for layer in (self.query, self.key, self.value)]  # fmt: skip
        bias = None
        if pad_mask is not None:
            big_neg = torch.finfo(dtype).min
            bias = torch.where(pad_mask[:, None, None, :].to(x.device), 0.0, big_neg).to(dtype)
        y = F.scaled_dot_product_attention(*heads, attn_mask=bias)  # (B, H, L, d/H)
        return _dense(self.out, y.transpose(1, 2).reshape(b, seq_len, d), dtype)


class EncoderLayer(nn.Module):
    """x + attn(ln1(x)), then x + ff2(relu(ff1(ln2(x)))); x float32."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        self.ln1 = nn.LayerNorm(cfg.d_model, eps=LN_EPS)
        self.mha = SelfAttention(cfg.d_model, cfg.n_heads)
        self.ln2 = nn.LayerNorm(cfg.d_model, eps=LN_EPS)
        self.ff1 = nn.Linear(cfg.d_model, cfg.d_ff)
        self.ff2 = nn.Linear(cfg.d_ff, cfg.d_model)

    def reset_parameters(self, gen: torch.Generator) -> None:
        self.mha.reset_parameters(gen)
        init_dense_(self.ff1, gen)
        init_dense_(self.ff2, gen)
        for ln in (self.ln1, self.ln2):
            nn.init.ones_(ln.weight)
            nn.init.zeros_(ln.bias)

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor | None = None) -> torch.Tensor:
        dtype = getattr(torch, self.cfg.compute_dtype)
        x = x + self.mha(self.ln1(x), pad_mask, dtype).float()
        h = _dense(self.ff2, F.relu(_dense(self.ff1, self.ln2(x), dtype)), dtype)
        return x + h.float()


class TransformerBackbone(nn.Module):
    """Embedding + sinusoidal positions + n_layers pre-norm encoder layers +
    LayerNorm. forward(input_ids (B, L) int, pad_mask) -> hidden (B, L, D)
    float32."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Embedding(cfg.vocab_size, cfg.d_model)
        # Built from its formula at construction, as the JAX module builds it
        # at every trace: no checkpoint carries it.
        self.register_buffer("positions", torch.from_numpy(sinusoidal_positions(cfg.max_len, cfg.d_model)),
                             persistent=False)  # fmt: skip
        for i in range(cfg.n_layers):
            self.add_module(f"layer_{i}", EncoderLayer(cfg))
        self.ln_f = nn.LayerNorm(cfg.d_model, eps=LN_EPS)

    def layers(self) -> list[EncoderLayer]:
        return [getattr(self, f"layer_{i}") for i in range(self.cfg.n_layers)]

    def reset_parameters(self, gen: torch.Generator) -> None:
        # flax Embed init: variance_scaling(1, fan_in, normal) -> std 1/sqrt(D).
        with torch.no_grad():
            self.embed.weight.normal_(0.0, 1.0 / math.sqrt(self.cfg.d_model), generator=gen)
        for layer in self.layers():
            layer.reset_parameters(gen)
        nn.init.ones_(self.ln_f.weight)
        nn.init.zeros_(self.ln_f.bias)

    def forward(self, input_ids: torch.Tensor, pad_mask: torch.Tensor | None = None) -> torch.Tensor:
        x = F.embedding(input_ids, self.embed.weight) + self.positions[None, : input_ids.shape[1]]
        for layer in self.layers():
            x = layer(x, pad_mask)
        return self.ln_f(x)
