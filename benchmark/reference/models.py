"""Plain float32 forward of the two token classifiers, written from their
published equations over a dict of weights named as the served model's
`state_dict` names them.

HyenaDNA (Poli et al. 2023; Nguyen et al. 2023): pre-norm blocks of an
order-2 Hyena operator (in_proj, a causal depthwise short conv of 3 taps,
gates x2 * causal_conv(v * x1, h) with h an implicit filter: a sine MLP over
positional features times an exponential decay, plus a bias skip) and a
GELU MLP. Caduceus-Ph (Schiff et al. 2024): pre-RMSNorm blocks of a Mamba
mixer run forward and on the reversed sequence with the same weights,
outputs summed. Both end in DeepChopper's head: lin1, ReLU, + the read's
L2-normalised quality on every channel, lin2 with a residual, ReLU, lin3.

`mode="fp8"` is the control: every product the configuration runs in
bfloat16 takes float8 operands (`precision.linear`).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .precision import linear
from .scan import scan


def _layer_norm(x, w, b, eps):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * w + b


def _rms_norm(x, w, eps):
    return x / torch.sqrt((x * x).mean(-1, keepdim=True) + eps) * w


def head(p: dict, cfg: dict, hidden: torch.Tensor, quals: torch.Tensor, mode: str) -> torch.Tensor:
    """hidden (B, L, D), quals (B, L) -> logits (B, L, num_class)."""
    h = cfg["head"]
    if not (h["use_qual"] and h["use_identity_layer_for_qual"]):
        raise ValueError("the reference head adds the quality itself on every channel")
    out = F.relu(linear(hidden, p["head.linear1.weight"], p["head.linear1.bias"], mode))
    res = out + quals[..., None]
    out = F.relu(linear(res, p["head.linear2.weight"], p["head.linear2.bias"], mode) + res)
    return linear(out, p["head.linear3.weight"], p["head.linear3.bias"], mode)


# -- HyenaDNA ------------------------------------------------------------------


def hyena_features(bb: dict, device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Positional features z (S, emb_dim), time t (S, 1) over S = max_seq_len
    positions, and the per-channel decay rates (1, D), float32."""
    s = bb["max_seq_len"]
    t = np.linspace(0.0, 1.0, s)[:, None]
    bands = (bb["emb_dim"] - 1) // 2
    w = 2.0 * math.pi * np.linspace(0.0, s - 1.0, s)[:, None] / s
    f = np.linspace(1e-4, bands - 1.0, bands)[None, :]
    z = np.concatenate([t, np.cos(-f * w), np.sin(-f * w)], axis=-1)
    target = math.log(bb["modulation_target"])
    d_filter = bb["d_model"] * (bb["hyena_order"] - 1)
    deltas = np.linspace(target / bb["modulation_slow_decay_pct"], target / bb["modulation_fast_decay_pct"], d_filter)
    as_t = lambda a: torch.tensor(a, dtype=torch.float32, device=device)  # noqa: E731
    return as_t(z), as_t(t), as_t(deltas[None, :])


def hyena_filter(p: dict, pre: str, bb: dict, feats, seq_len: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The implicit long filter h (L, D) and its bias skip (D,)."""
    z, t, deltas = (f[:seq_len] if f.shape[0] > 1 else f for f in feats)
    freq = (lambda i: p[f"{pre}sin_freq_{i}"]) if bb["train_freq"] else (lambda i: bb["activation_freq"])
    h = torch.sin(freq(0) * (z @ p[pre + "mlp_in.weight"].T + p[pre + "mlp_in.bias"]))
    for i in range(bb["num_inner_mlps"]):
        h = torch.sin(freq(i + 1) * (h @ p[f"{pre}mlp_{i}.weight"].T + p[f"{pre}mlp_{i}.bias"]))
    h = h @ p[pre + "mlp_out.weight"].T
    h = h * (torch.exp(-t * deltas.abs()) + bb["modulation_shift"])
    bias = p[pre + "bias"] if bb["use_bias"] else torch.zeros_like(p[pre + "bias"])
    return h, bias


def _causal_fft_conv(w: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """(w * h)[:L] along dim 1 of w (B, L, D) with h (L, D)."""
    seq_len = w.shape[1]
    n = 2 * seq_len
    y = torch.fft.irfft(torch.fft.rfft(w, n=n, dim=1) * torch.fft.rfft(h, n=n, dim=0), n=n, dim=1)
    return y[:, :seq_len]


def _short_conv(x: torch.Tensor, k: torch.Tensor, b: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """Depthwise conv along dim 1 of x (B, L, C), taps k (T, 1, C): causal
    (tap j multiplies x[t - (T-1) + j]) or its mirror (x[t + (T-1) - j])."""
    taps, seq_len = k.shape[0], x.shape[1]
    pad = (0, 0, 0, taps - 1) if reverse else (0, 0, taps - 1, 0)
    xp = F.pad(x, pad)
    out = b
    for j in range(taps):
        start = taps - 1 - j if reverse else j
        out = out + xp[:, start : start + seq_len] * k[j, 0]
    return out


def hyena_block(p, pre, bb, feats, x, mode):
    d, eps = bb["d_model"], bb["layer_norm_epsilon"]
    m = pre + "mixer."
    h = _layer_norm(x, p[pre + "norm1.weight"], p[pre + "norm1.bias"], eps)
    proj = linear(h, p[m + "in_proj.weight"], p[m + "in_proj.bias"], mode)
    uc = _short_conv(proj, p[m + "short_filter_kernel"], p[m + "short_filter_bias"])
    x2, x1, v = uc[..., :d], uc[..., d : 2 * d], uc[..., 2 * d :]
    k_long, k_bias = hyena_filter(p, m + "filter_fn.", bb, feats, x.shape[1])
    w = v * x1
    y = (_causal_fft_conv(w, k_long) + w * k_bias) * x2
    x = x + linear(y, p[m + "out_proj.weight"], p[m + "out_proj.bias"], mode)
    h = _layer_norm(x, p[pre + "norm2.weight"], p[pre + "norm2.bias"], eps)
    h = F.gelu(linear(h, p[pre + "mlp.fc1.weight"], p[pre + "mlp.fc1.bias"], mode), approximate="tanh")
    return x + linear(h, p[pre + "mlp.fc2.weight"], p[pre + "mlp.fc2.bias"], mode)


# -- Caduceus -------------------------------------------------------------------


def mamba_mixer(p, m, bb, x, reverse, mode):
    d_in = bb["d_model"] * bb["expand"]
    xs, z = linear(x, p[m + "in_proj.weight"], None, mode).split(d_in, dim=-1)
    xs = F.silu(_short_conv(xs, p[m + "conv1d_kernel"], p[m + "conv1d_bias"], reverse))
    dt, bp, cp = linear(xs, p[m + "x_proj.weight"], None, mode).split(
        [bb["dt_rank"], bb["d_state"], bb["d_state"]], dim=-1
    )
    delta = F.softplus(dt @ p[m + "dt_proj.weight"].T + p[m + "dt_proj.bias"])
    y = scan(xs, delta, -torch.exp(p[m + "A_log"]), bp, cp, p[m + "D"], reverse=reverse)
    return linear(y * F.silu(z), p[m + "out_proj.weight"], None, mode)


def caduceus_block(p, pre, bb, x, mode):
    h = _rms_norm(x, p[pre + "norm.weight"], bb["layer_norm_epsilon"])
    fwd = pre + "bimamba.mixer."
    rev = fwd if bb["bidirectional_weight_tie"] else pre + "bimamba.mixer_rev."
    return x + mamba_mixer(p, fwd, bb, h, False, mode) + mamba_mixer(p, rev, bb, h, True, mode)


# -- the classifier --------------------------------------------------------------


def forward(p: dict, cfg: dict, ids: torch.Tensor, quals: torch.Tensor, mode: str = "f32",
            recompute: bool = False, feats=None) -> torch.Tensor:  # fmt: skip
    """Logits (B, L, num_class) float32 of token ids (B, L) and normalised
    quals (B, L). `recompute`: each block keeps only its input for the
    backward and runs again there (plain `torch.utils.checkpoint`)."""
    bb = cfg["backbone"]
    x = p["backbone.word_embeddings.weight"][ids]
    hyena = cfg["family"] == "hyena"
    if hyena and feats is None:
        feats = hyena_features(bb, ids.device)
    for i in range(bb["n_layer"]):
        pre = f"backbone.block_{i}."
        if hyena:
            fn = lambda x, pre=pre: hyena_block(p, pre, bb, feats, x, mode)  # noqa: E731
        else:
            fn = lambda x, pre=pre: caduceus_block(p, pre, bb, x, mode)  # noqa: E731
        x = checkpoint(fn, x, use_reentrant=False) if recompute else fn(x)
    if hyena:
        x = _layer_norm(x, p["backbone.ln_f.weight"], p["backbone.ln_f.bias"], bb["layer_norm_epsilon"])
    else:
        x = _rms_norm(x, p["backbone.norm_f.weight"], bb["layer_norm_epsilon"])
    return head(p, cfg, x, quals, mode)
