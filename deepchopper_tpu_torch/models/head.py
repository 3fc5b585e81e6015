"""Token-classification head with quality fusion.

Port of `deepchopper_tpu/models/head.py` (the channel-major head the JAX
classifier uses by default): lin1 -> ReLU -> + quality -> (lin2(res) + res)
-> ReLU -> lin3. With `use_identity_layer_for_qual` the quality term is the
normalized quality broadcast over the hidden channels.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .config import HeadConfig
from .hyena import dense_cf, init_dense_


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
