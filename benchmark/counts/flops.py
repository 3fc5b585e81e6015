"""Model operations of one read's forward pass, from the configuration:
the products at 2 operations a multiply-add, the long convolutions as real
FFT convolutions at N = 2L, the scan's 6 operations a (token, channel,
state). A read is counted at its own length (its tokens and SEP): padding
and recompute are not the model's work. Training counts three forwards."""

from __future__ import annotations

import math


def _head(cfg: dict) -> int:
    h = cfg["head"]
    return 2 * (h["input_size"] * h["lin1_size"] + h["lin1_size"] * h["lin2_size"] + h["lin2_size"] * h["num_class"])


def forward_flops(cfg: dict, tokens: int) -> float:
    """Operations of the forward over one read of `tokens` tokens."""
    bb = cfg["backbone"]
    d = bb["d_model"]
    if cfg["family"] == "hyena":
        width = (bb["hyena_order"] + 1) * d
        dense = 2 * (d * width + d * d + 2 * d * bb["d_inner"])
        n = 2 * tokens
        conv = d * (5 * n * math.log2(n) + 3 * n + 23 * tokens)  # short conv, gates, FFT conv
        per_layer = dense * tokens + conv
    else:
        d_in, ns, r = d * bb["expand"], bb["d_state"], bb["dt_rank"]
        one_way = 2 * (d * 2 * d_in + d_in * (r + 2 * ns) + r * d_in + d_in * d + bb["d_conv"] * d_in) + 6 * d_in * ns
        per_layer = 2 * one_way * tokens
    return bb["n_layer"] * per_layer + _head(cfg) * tokens
