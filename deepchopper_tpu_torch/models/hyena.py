"""HyenaDNA-style long-convolution backbone in PyTorch.

Port of `deepchopper_tpu/models/hyena.py`. The residual stream runs
batch-major and channel-first, (B, D, L): every projection is one
`torch.matmul` of a (Cout, Cin) weight with the (B, Cin, L) stream, so
in_proj yields the (B, 3D, L) layout the fused mixer kernel reads with no
transpose. Parameter names follow the flax tree (`block_0.mixer.in_proj`,
`filter_fn.mlp_in`, ...) so `models/bridge.py` maps one onto the other.

Numerics follow the JAX package: matmuls and the residual stream in
`compute_dtype`, LayerNorm statistics in float32 with E[x^2] - E[x]^2, the
tanh GELU, and the mixer's gates and FFT in float32.

The mixer takes one of three routes, chosen where and as the JAX package
chooses them on its TPU (`HyenaOperator` there, `models/hyena.py:339-386`),
from the width L and two environment variables read at every forward
(`mixer_route`):
- fused (default): in_proj, then `ops.mixer` (short conv, gates and long conv
  in one kernel; the short conv in float32);
- unfused, with `DEEPCHOPPER_FUSE_SHORT=0`, when d_model % 8 != 0, or at a
  width the kernels do not take (`kernel_width`: 512 <= 2L <= 65536 and
  2L % 512 == 0): in_proj, `short_depthwise_conv_cf` in `compute_dtype`, then
  the gated conv: `ops.gated` at a kernel width, else its plain float32
  composition (the JAX package's XLA route there);
- in_proj-fused, with `DEEPCHOPPER_FUSE_INPROJ=1` on the fused route:
  `ops.inproj` (in_proj inside the mixer kernel).
In float32 they compute the same function. The JAX package's other two
mixer knobs, `DEEPCHOPPER_MIXER_BM` and `DEEPCHOPPER_FFT_LAYOUT`, pick TPU
block layouts of the same math; the port has one layout and reads neither.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv import fft_causal_conv
from ..ops.gated import gated_fft_conv_bm, gated_reference
from ..ops.inproj import mixer_fft_conv_inproj
from ..ops.mixer import fixed_filter, mixer_fft_conv_bm
from .config import HyenaConfig


def _jax_linspace(start: float, stop: float, num: int) -> np.ndarray:
    """float32 linspace rounded as `jnp.linspace` rounds it:
    start * (1 - step) + stop * step with step = iota / (num - 1)."""
    div = num - 1
    step = np.arange(div, dtype=np.float32) / np.float32(div)
    out = np.float32(start) * (np.float32(1) - step) + np.float32(stop) * step
    return np.concatenate([out, np.array([stop], np.float32)]).astype(np.float32)


def positional_features(emb_dim: int, max_seq_len: int) -> tuple[np.ndarray, np.ndarray]:
    """Hyena positional features z (max_seq_len, emb_dim) and time t
    (max_seq_len, 1), float32, built with the JAX package's formulas."""
    t = _jax_linspace(0.0, 1.0, max_seq_len)[:, None]
    bands = (emb_dim - 1) // 2
    t_rescaled = _jax_linspace(0.0, float(max_seq_len - 1), max_seq_len)[:, None]
    w = np.float32(2.0 * math.pi) * t_rescaled / np.float32(max_seq_len)
    f = _jax_linspace(1e-4, float(bands) - 1.0, bands)[None, :]
    phase = f * w
    z = np.concatenate([t, np.cos(-phase), np.sin(-phase)], axis=-1).astype(np.float32)
    return z, t


def _lecun_normal_(t: torch.Tensor, fan_in: int, gen: torch.Generator) -> torch.Tensor:
    """flax `lecun_normal`: normal truncated at +-2 sigma, rescaled to
    variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)


def init_dense_(layer: nn.Linear, gen: torch.Generator) -> None:
    """flax Dense init: lecun_normal kernel, zero bias."""
    _lecun_normal_(layer.weight, layer.in_features, gen)
    if layer.bias is not None:
        nn.init.zeros_(layer.bias)


def dense_cf(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Linear on a channel-first (B, Cin, L) stream -> (B, Cout, L) in dtype."""
    y = torch.matmul(layer.weight.to(dtype), x.to(dtype))
    if layer.bias is not None:
        y = y + layer.bias.to(dtype)[:, None]
    return y


class LayerNormCF(nn.Module):
    """LayerNorm over the channel axis of (B, C, L), statistics in float32
    (E[x^2] - E[x]^2 clamped at 0), output in `out_dtype`."""

    def __init__(self, channels: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean(dim=1, keepdim=True)
        var = torch.clamp((x32 * x32).mean(dim=1, keepdim=True) - mean * mean, min=0.0)
        y = (x32 - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight[:, None] + self.bias[:, None]).to(out_dtype)


class HyenaFilter(nn.Module):
    """Implicit long filter: sine MLP over positional features + decay
    modulation. forward(L) -> (k (L, D) float32, bias (D,) float32)."""

    def __init__(self, cfg: HyenaConfig):
        super().__init__()
        self.cfg = cfg
        d_filter = cfg.d_model * (cfg.hyena_order - 1)
        self.mlp_in = nn.Linear(cfg.emb_dim, cfg.filter_order)
        for i in range(cfg.num_inner_mlps):
            self.add_module(f"mlp_{i}", nn.Linear(cfg.filter_order, cfg.filter_order))
        self.mlp_out = nn.Linear(cfg.filter_order, d_filter, bias=False)
        if cfg.train_freq:
            for i in range(cfg.num_inner_mlps + 1):
                self.register_parameter(
                    f"sin_freq_{i}", nn.Parameter(torch.full((1, cfg.filter_order), cfg.activation_freq))
                )
        self.bias = nn.Parameter(torch.empty(d_filter))
        z, t = positional_features(cfg.emb_dim, cfg.max_seq_len)
        max_decay = math.log(cfg.modulation_target) / cfg.modulation_fast_decay_pct
        min_decay = math.log(cfg.modulation_target) / cfg.modulation_slow_decay_pct
        deltas = _jax_linspace(min_decay, max_decay, d_filter)[None, :]
        self.register_buffer("z", torch.from_numpy(z), persistent=False)
        self.register_buffer("t", torch.from_numpy(t), persistent=False)
        self.register_buffer("deltas", torch.from_numpy(deltas), persistent=False)

    def reset_parameters(self, gen: torch.Generator) -> None:
        for i in range(self.cfg.num_inner_mlps):
            init_dense_(getattr(self, f"mlp_{i}"), gen)
        init_dense_(self.mlp_in, gen)
        init_dense_(self.mlp_out, gen)
        with torch.no_grad():
            self.bias.normal_(0.0, 1.0, generator=gen)

    def _sine(self, x: torch.Tensor, idx: int) -> torch.Tensor:
        freq = getattr(self, f"sin_freq_{idx}") if self.cfg.train_freq else self.cfg.activation_freq
        return torch.sin(freq * x)

    def forward(self, seq_len: int) -> tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        z, t = self.z[:seq_len], self.t[:seq_len]
        h = self._sine(self.mlp_in(z), 0)
        for i in range(cfg.num_inner_mlps):
            h = self._sine(getattr(self, f"mlp_{i}")(h), i + 1)
        h = self.mlp_out(h)  # (L, d_filter)
        decay = torch.exp(-t * torch.abs(self.deltas))
        h = h * (decay + cfg.modulation_shift)
        bias = self.bias if cfg.use_bias else torch.zeros_like(self.bias)
        return h, bias


def causal_conv(v: torch.Tensor, k: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Causal long conv y = (v * k)[:L] + v * bias: v (B, L, D), k (L, D),
    bias (D,) -> (B, L, D) float32 (`ops.conv`). The JAX package's `impl`
    argument picks among TPU implementations; the port has one per device.
    No model route calls it, as in the JAX package."""
    return fft_causal_conv(v.float(), k, bias)


def short_depthwise_conv_cf(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Depthwise causal short conv on a channel-first stream, in x's dtype:
    x (B, W, L), kernel (taps, 1, W), bias (W,); tap t multiplies
    x[n - (taps-1-t)], zero for n < 0. The taps and bias are cast to x's
    dtype first, as `short_depthwise_conv_cm` casts them."""
    taps = kernel.shape[0]
    seq_len = x.shape[2]
    ks = kernel.to(x.dtype)
    xp = F.pad(x, (taps - 1, 0))
    out = xp[:, :, 0:seq_len] * ks[0, 0][:, None]
    for t in range(1, taps):
        out = out + xp[:, :, t : t + seq_len] * ks[t, 0][:, None]
    return out + bias.to(x.dtype)[:, None]


def kernel_width(seq_len: int) -> bool:
    """Whether the FFT kernels take width L: the JAX package's rule for its
    Pallas kernels, 512 <= 2L <= 65536 and 2L % 512 == 0."""
    n = 2 * seq_len
    return 512 <= n <= 65536 and n % 512 == 0


def gated_causal_conv(uc: torch.Tensor, k: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Gate -> causal long conv -> gate on a short-convolved (B, 3D, L)
    stream [x2 | x1 | v] -> (B, D, L) in uc's dtype: `ops.gated` at a kernel
    width, else its plain float32 composition, as `gated_causal_conv_cm`
    dispatches in the JAX package."""
    if kernel_width(uc.shape[2]):
        return gated_fft_conv_bm(uc, k, bias)
    return gated_reference(uc, k, bias)


def mixer_route(d_model: int, seq_len: int) -> str:
    """The mixer route the JAX package would take on its TPU for this
    d_model, width and environment: "fused", "unfused" or "inproj" (module
    docstring)."""
    if os.environ.get("DEEPCHOPPER_FUSE_SHORT", "1") != "1" or d_model % 8 != 0 or not kernel_width(seq_len):
        return "unfused"
    if os.environ.get("DEEPCHOPPER_FUSE_INPROJ", "0") == "1":
        return "inproj"
    return "fused"


class HyenaOperator(nn.Module):
    """Order-2 Hyena mixer: in_proj -> short conv/gate/long conv/gate ->
    out_proj, on a (B, D, L) stream, by the route `mixer_route` picks."""

    def __init__(self, cfg: HyenaConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        width = (cfg.hyena_order + 1) * d
        self.in_proj = nn.Linear(d, width)
        self.out_proj = nn.Linear(d, d)
        self.short_filter_kernel = nn.Parameter(torch.empty(cfg.short_filter_order, 1, width))
        self.short_filter_bias = nn.Parameter(torch.zeros(width))
        self.filter_fn = HyenaFilter(cfg)

    def reset_parameters(self, gen: torch.Generator) -> None:
        init_dense_(self.in_proj, gen)
        init_dense_(self.out_proj, gen)
        # flax lecun_normal on (taps, 1, W): fan_in = 1 * taps.
        _lecun_normal_(self.short_filter_kernel, self.cfg.short_filter_order, gen)
        nn.init.zeros_(self.short_filter_bias)
        self.filter_fn.reset_parameters(gen)

    def forward(self, u: torch.Tensor, memo: dict | None = None) -> torch.Tensor:
        """`memo`, for inference: the long filter and its spectra depend on the
        width alone, so they are computed once a width and kept in it."""
        dtype = getattr(torch, self.cfg.compute_dtype)
        if memo is None:
            k_long, bias = self.filter_fn(u.shape[2])
        else:
            key = (self, u.shape[2])
            if key not in memo:
                memo[key] = fixed_filter(*self.filter_fn(u.shape[2]))
            k_long, bias = memo[key]
        k_short, b_short = self.short_filter_kernel, self.short_filter_bias
        route = mixer_route(self.cfg.d_model, u.shape[2])
        if route == "inproj":
            w_in, b_in = self.in_proj.weight, self.in_proj.bias
            y = mixer_fft_conv_inproj(u.to(dtype), w_in, b_in, k_short, b_short, k_long, bias)
        else:
            proj = dense_cf(self.in_proj, u, dtype)  # (B, 3D, L)
            if route == "fused":
                y = mixer_fft_conv_bm(proj, k_short, b_short, k_long, bias)
            else:
                y = gated_causal_conv(short_depthwise_conv_cf(proj, k_short, b_short), k_long, bias)
        return dense_cf(self.out_proj, y, dtype)


class HyenaMlp(nn.Module):
    def __init__(self, cfg: HyenaConfig):
        super().__init__()
        self.cfg = cfg
        self.fc1 = nn.Linear(cfg.d_model, cfg.d_inner)
        self.fc2 = nn.Linear(cfg.d_inner, cfg.d_model)

    def reset_parameters(self, gen: torch.Generator) -> None:
        init_dense_(self.fc1, gen)
        init_dense_(self.fc2, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = getattr(torch, self.cfg.compute_dtype)
        h = F.gelu(dense_cf(self.fc1, x, dtype), approximate="tanh")
        return dense_cf(self.fc2, h, dtype)


class HyenaBlock(nn.Module):
    """Pre-norm residual block: r += mixer(ln1(r)); r += mlp(ln2(r))."""

    def __init__(self, cfg: HyenaConfig):
        super().__init__()
        self.cfg = cfg
        self.norm1 = LayerNormCF(cfg.d_model, cfg.layer_norm_epsilon)
        self.mixer = HyenaOperator(cfg)
        self.norm2 = LayerNormCF(cfg.d_model, cfg.layer_norm_epsilon)
        self.mlp = HyenaMlp(cfg)

    def reset_parameters(self, gen: torch.Generator) -> None:
        self.mixer.reset_parameters(gen)
        self.mlp.reset_parameters(gen)

    def forward(self, r: torch.Tensor, memo: dict | None = None) -> torch.Tensor:
        dtype = getattr(torch, self.cfg.compute_dtype)
        r = r + self.mixer(self.norm1(r, dtype), memo).to(r.dtype)
        r = r + self.mlp(self.norm2(r, dtype)).to(r.dtype)
        return r


class HyenaBackbone(nn.Module):
    """Embedding -> n_layer HyenaBlocks -> final LayerNorm.

    forward(input_ids (B, L) int, memo) -> hidden (B, D, L) in compute_dtype;
    `memo` as `HyenaOperator.forward`."""

    def __init__(self, cfg: HyenaConfig):
        super().__init__()
        self.cfg = cfg
        self.word_embeddings = nn.Embedding(cfg.padded_vocab_size, cfg.d_model)
        for i in range(cfg.n_layer):
            self.add_module(f"block_{i}", HyenaBlock(cfg))
        self.ln_f = LayerNormCF(cfg.d_model, cfg.layer_norm_epsilon)

    def blocks(self) -> list[HyenaBlock]:
        return [getattr(self, f"block_{i}") for i in range(self.cfg.n_layer)]

    def reset_parameters(self, gen: torch.Generator) -> None:
        # flax Embed init: variance_scaling(1, fan_in, normal) -> std 1/sqrt(D).
        with torch.no_grad():
            self.word_embeddings.weight.normal_(0.0, 1.0 / math.sqrt(self.cfg.d_model), generator=gen)
        for blk in self.blocks():
            blk.reset_parameters(gen)

    def forward(self, input_ids: torch.Tensor, memo: dict | None = None) -> torch.Tensor:
        dtype = getattr(torch, self.cfg.compute_dtype)
        emb = F.embedding(input_ids, self.word_embeddings.weight.to(dtype))  # (B, L, D)
        r = emb.transpose(1, 2).contiguous()  # (B, D, L)
        for blk in self.blocks():
            r = blk(r, memo)
        return self.ln_f(r, dtype)
