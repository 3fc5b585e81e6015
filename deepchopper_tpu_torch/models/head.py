"""Token-classification heads with quality fusion, and the CNN baseline.

Port of `deepchopper_tpu/models/head.py`. `TokenClassificationHead` (the
channel-major head the JAX classifier uses by default): lin1 -> ReLU ->
+ quality -> (lin2(res) + res) -> ReLU -> lin3. With
`use_identity_layer_for_qual` the quality term is the normalized quality
broadcast over the hidden channels.

`TokenClassificationCnnHead` and `BenchmarkCNN` are conv stacks, each conv
followed by a BatchNorm and a ReLU, in float32. Convolutions pad as flax's
"SAME" (left (k-1)//2, right k//2, which is torch's "same"); flax's
(k, Cin, Cout) conv kernels are `nn.Conv1d`'s (Cout, Cin, k). `BatchNorm`
is flax's, not torch's: in train mode the statistics of every (row,
position), pads included, normalise the batch, with the biased variance
E[x^2] - E[x]^2, which also goes into the running variance, at momentum
0.99; in eval mode the running statistics normalise.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .config import CnnConfig, HeadConfig
from .hyena import _lecun_normal_, dense_cf, init_dense_


class TokenClassificationHead(nn.Module):
    """hidden (B, D, L), quals (B, L) float32 -> logits (B, L, num_class) float32."""

    def __init__(self, cfg: HeadConfig):
        super().__init__()
        if cfg.lin1_size != cfg.lin2_size:
            raise ValueError(f"lin1_size={cfg.lin1_size} and lin2_size={cfg.lin2_size} must be equal")
        self.cfg = cfg
        self.linear1 = nn.Linear(cfg.input_size, cfg.lin1_size)
        if cfg.use_qual and not cfg.use_identity_layer_for_qual:
            self.qual_linear1 = nn.Linear(1, cfg.lin1_size)
        self.linear2 = nn.Linear(cfg.lin1_size, cfg.lin2_size)
        self.linear3 = nn.Linear(cfg.lin2_size, cfg.num_class)

    def reset_parameters(self, gen: torch.Generator) -> None:
        for layer in (self.linear1, getattr(self, "qual_linear1", None), self.linear2, self.linear3):
            if layer is not None:
                init_dense_(layer, gen)

    def forward(self, hidden: torch.Tensor, input_quals: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        dtype = getattr(torch, cfg.compute_dtype)
        out = F.relu(dense_cf(self.linear1, hidden, dtype))  # (B, lin1, L)
        if cfg.use_qual:
            q = input_quals[:, None, :].to(dtype)  # (B, 1, L)
            qual_term = q if cfg.use_identity_layer_for_qual else dense_cf(self.qual_linear1, q, dtype)
            residual = out + qual_term
            out = F.relu(dense_cf(self.linear2, residual, dtype) + residual)
        else:
            out = F.relu(dense_cf(self.linear2, out, dtype))
        logits = dense_cf(self.linear3, out, dtype).float()  # (B, num_class, L)
        return logits.transpose(1, 2)


class BatchNorm(nn.Module):
    """flax `nn.BatchNorm` over the channels of (B, C, L): epsilon 1e-5,
    running statistics updated as momentum * running + (1 - momentum) *
    batch, the variance biased (torch's `BatchNorm1d` keeps the unbiased
    one and updates at 1 - momentum). `training` picks batch statistics
    (and updates the running ones) or the running statistics."""

    def __init__(self, channels: int, momentum: float = 0.99, eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def reset_parameters(self) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            mean = x.mean(dim=(0, 2))
            var = torch.clamp((x * x).mean(dim=(0, 2)) - mean * mean, min=0.0)
            with torch.no_grad():
                self.running_mean.mul_(self.momentum).add_((1.0 - self.momentum) * mean)
                self.running_var.mul_(self.momentum).add_((1.0 - self.momentum) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean[:, None]) * mul[:, None] + self.bias[:, None]


class _ConvNet(nn.Module):
    """Holds conv_i and bn_i at its top level, as the flax modules name them,
    and runs conv_i -> bn_i -> ReLU for each (filters, size) on (B, C, L)
    float32."""

    def _add_convs(self, in_channels: int, num_filters: tuple[int, ...], filter_sizes: tuple[int, ...]) -> None:
        self.n_convs = len(num_filters)
        for i, (nf, fs) in enumerate(zip(num_filters, filter_sizes)):
            self.add_module(f"conv_{i}", nn.Conv1d(in_channels, nf, fs, padding="same"))
            self.add_module(f"bn_{i}", BatchNorm(nf))
            in_channels = nf

    def _reset_convs(self, gen: torch.Generator) -> None:
        """flax Conv init: lecun_normal over the (k, Cin) fan-in, zero bias."""
        for i in range(self.n_convs):
            conv = getattr(self, f"conv_{i}")
            _lecun_normal_(conv.weight, conv.in_channels * conv.kernel_size[0], gen)
            nn.init.zeros_(conv.bias)
            getattr(self, f"bn_{i}").reset_parameters()

    def _convs(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_convs):
            x = F.relu(getattr(self, f"bn_{i}")(getattr(self, f"conv_{i}")(x)))
        return x


def _dense_cl(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """A float32 Dense on a channel-first (B, Cin, L) stream -> (B, L, Cout)."""
    return F.linear(x.transpose(1, 2), layer.weight, layer.bias)


class TokenClassificationCnnHead(_ConvNet):
    """Conv head: hidden (B, D, L), quals (B, L) -> logits (B, L, num_class)
    float32. The quality enters as the mean over classes of a num_class-wide
    projection, added to every hidden channel (the JAX package's
    broadcastable reading of the reference)."""

    def __init__(self, input_size: int, num_class: int, num_filters: tuple[int, ...], filter_sizes: tuple[int, ...]):
        super().__init__()
        self.qual_linear1 = nn.Linear(1, num_class)
        self._add_convs(input_size, num_filters, filter_sizes)
        self.dense = nn.Linear(num_filters[-1], num_class)

    def reset_parameters(self, gen: torch.Generator) -> None:
        init_dense_(self.qual_linear1, gen)
        self._reset_convs(gen)
        init_dense_(self.dense, gen)

    def forward(self, hidden: torch.Tensor, input_quals: torch.Tensor) -> torch.Tensor:
        qual = self.qual_linear1(input_quals[..., None].float())  # (B, L, num_class)
        x = F.relu(hidden.float() + qual.mean(dim=-1)[:, None, :])
        return _dense_cl(self.dense, self._convs(x))


class BenchmarkCNN(_ConvNet):
    """The standalone CNN baseline: embedding + quality projection -> ReLU ->
    conv stack -> Dense. forward(input_ids (B, L) int, input_quals (B, L)
    float32, memo) -> logits (B, L, num_class) float32; train mode
    normalises with batch statistics, eval mode with the running ones."""

    def __init__(self, cfg: CnnConfig, name: str = ""):
        super().__init__()
        self.name = name
        self.config = cfg  # the JAX module's field name: no `backbone_config`, so no head to tune
        self.embedding = nn.Embedding(cfg.vocab_size, cfg.embed_dim)
        self.qual_linear = nn.Linear(1, cfg.embed_dim)
        self._add_convs(cfg.embed_dim, cfg.num_filters, cfg.filter_sizes)
        self.dense = nn.Linear(cfg.num_filters[-1], cfg.num_class)

    def reset_parameters(self, gen: torch.Generator) -> None:
        # flax Embed init: variance_scaling(1, fan_in, normal) -> std 1/sqrt(D).
        with torch.no_grad():
            self.embedding.weight.normal_(0.0, self.config.embed_dim**-0.5, generator=gen)
        init_dense_(self.qual_linear, gen)
        self._reset_convs(gen)
        init_dense_(self.dense, gen)

    def forward(self, input_ids: torch.Tensor, input_quals: torch.Tensor, memo: dict | None = None) -> torch.Tensor:
        """`memo`: unused (no work of this model depends on the width alone)."""
        x = F.embedding(input_ids, self.embedding.weight) + self.qual_linear(input_quals[..., None].float())
        x = F.relu(x).transpose(1, 2)  # (B, embed, L)
        return _dense_cl(self.dense, self._convs(x))

    def graph_key(self, width: int):
        """Nothing outside its arguments and weights (see `_TokenClassifier`)."""
        return None
