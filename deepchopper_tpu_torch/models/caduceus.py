"""Caduceus bidirectional-Mamba backbone in PyTorch.

Port of `deepchopper_tpu/models/caduceus.py`. The residual stream runs
batch-major (B, L, D) in float32; in_proj, x_proj and out_proj run in
`compute_dtype`, everything else (short conv, dt_proj, softplus, the scan,
gates, RMSNorm) in float32, as in the JAX package. The reverse direction of
the bidirectional mixer is flip-free: the mirrored short conv and the
reverse walk of the scan compute flip(mixer(flip(x))) without copies.
Parameter names follow the flax tree (`block_0.bimamba.mixer.in_proj`,
`conv1d_kernel`, `A_log`, ...) so `models/bridge.py` maps one onto the other.

A train step on the card keeps 44460 bytes of activations a token in each
block for its backward: at the JAX recipe's 2^17 tokens a batch, more than
an H100 holds. So while autograd records on a CUDA device, the backbone runs its
first k blocks under `torch.utils.checkpoint` (non-reentrant): each keeps
only its input and recomputes its forward, both scans included, in the
backward. k is the fewest blocks that bring the step's estimated peak under
the card's memory (`recompute_blocks`). The recompute runs the same ops on
the same inputs, so loss and gradients do not change; predict, eval and the
CPU recompute nothing.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

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


# Device memory of a train step (forward, backward, Adam), bytes a token at
# d_model 256, by compute dtype: measured by scripts/torch_caduceus_memory.py
# on an NVIDIA H100 80GB HBM3 (700 W) at (64, 1024) and (2, 32768), within
# 0.1% of each other. BLOCK: what a block keeps for its backward; REST: the
# rest of the peak at the forward's end (embedding, final norm, head, loss);
# RECOMPUTE: the backward's own buffers while a recomputed block holds its
# activations again. A recomputed block keeps its float32 input instead of BLOCK.
BLOCK_BYTES_PER_TOKEN = {"bfloat16": 44460, "float32": 44436}
REST_BYTES_PER_TOKEN = {"bfloat16": 13882, "float32": 23684}
RECOMPUTE_BYTES_PER_TOKEN = {"bfloat16": 5204, "float32": 4273}
# Share of the card's memory the step may plan to fill: the caching
# allocator's fragmentation takes the rest. Over a train epoch of many batch
# shapes on an 85.0 GB H100 (chip_smoke.py's phase_caduceus_scale, PERF.md),
# a plan at 0.85 ran out of memory with 69.7 GB allocated and 14.4 GB
# reserved but free; at 0.70 the epoch peaked at 58.8 GB allocated, 84.1 GB
# reserved.
MEMORY_MARGIN = 0.70


def step_bytes(tokens: int, n_layer: int, recomputed: int, d_model: int = 256,
               compute_dtype: str = "bfloat16") -> int:  # fmt: skip
    """Estimated peak device memory of a train step over `tokens` tokens with
    the first `recomputed` of n_layer blocks recomputed in the backward, the
    weights and optimizer state aside: the larger of the forward's end (the
    blocks kept, the inputs of those recomputed, the rest) and, with blocks
    recomputed, the backward through the last of them (its activations again
    beside the inputs kept). Block activations scale with d_model; the rest
    is the flagship head's."""
    block = BLOCK_BYTES_PER_TOKEN[compute_dtype] * d_model / 256
    kept = recomputed * 4 * d_model
    forward_end = REST_BYTES_PER_TOKEN[compute_dtype] + (n_layer - recomputed) * block + kept
    again = block + kept + RECOMPUTE_BYTES_PER_TOKEN[compute_dtype] if recomputed else 0
    return int(tokens * max(forward_end, again))


def recompute_blocks(batch: int, seq_len: int, n_layer: int, budget_bytes: float, d_model: int = 256,
                     compute_dtype: str = "bfloat16") -> int:  # fmt: skip
    """The fewest blocks k in [0, n_layer] to recompute so that a (batch,
    seq_len) train step's `step_bytes` fit `budget_bytes`. Raises
    torch.OutOfMemoryError, naming the tokens, the estimate and the budget,
    when even k = n_layer does not fit."""
    tokens = batch * seq_len
    for k in range(n_layer + 1):
        if step_bytes(tokens, n_layer, k, d_model, compute_dtype) <= budget_bytes:
            return k
    need = step_bytes(tokens, n_layer, n_layer, d_model, compute_dtype)
    raise torch.OutOfMemoryError(
        f"a Caduceus train step over {tokens} tokens ({batch} x {seq_len}) needs about {need / 1e9:.2f} GB of "
        f"device memory with all {n_layer} blocks recomputed, over the budget of {budget_bytes / 1e9:.2f} GB"
    )


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
        # Blocks recomputed in the backward, by (B, L), chosen at the shape's
        # first recorded forward; `_recompute` (tests, chip_smoke.py) forces k.
        self._recompute_k: dict[tuple[int, int], int] = {}
        self._recompute: int | None = None

    def blocks(self) -> list[CaduceusBlock]:
        return [getattr(self, f"block_{i}") for i in range(self.cfg.n_layer)]

    def reset_parameters(self, gen: torch.Generator) -> None:
        # flax Embed init: variance_scaling(1, fan_in, normal) -> std 1/sqrt(D).
        with torch.no_grad():
            self.word_embeddings.weight.normal_(0.0, 1.0 / math.sqrt(self.cfg.d_model), generator=gen)
        for blk in self.blocks():
            blk.reset_parameters(gen)

    def blocks_to_recompute(self, batch: int, seq_len: int, device: torch.device) -> int:
        """Blocks to recompute in a recorded (batch, seq_len) forward: the
        override if set, none on the CPU, else `recompute_blocks` against
        MEMORY_MARGIN of the card's memory less what is allocated now."""
        if self._recompute is not None:
            return min(max(self._recompute, 0), self.cfg.n_layer)
        key = (batch, seq_len)
        if key not in self._recompute_k:
            k = 0
            if device.type == "cuda":
                total = torch.cuda.get_device_properties(device).total_memory
                budget = total * MEMORY_MARGIN - torch.cuda.memory_allocated(device)
                k = recompute_blocks(batch, seq_len, self.cfg.n_layer, budget, self.cfg.d_model,
                                     self.cfg.compute_dtype)  # fmt: skip
            self._recompute_k[key] = k
        return self._recompute_k[key]

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        k = 0
        if self.training and torch.is_grad_enabled():
            k = self.blocks_to_recompute(*input_ids.shape, input_ids.device)
        r = F.embedding(input_ids, self.word_embeddings.weight)
        for i, blk in enumerate(self.blocks()):
            # No dropout in the block: the RNG state need not be kept.
            r = checkpoint(blk, r, use_reentrant=False, preserve_rng_state=False) if i < k else blk(r)
        return self.norm_f(r)
