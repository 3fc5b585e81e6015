"""Model configurations for the Hyena token classifiers.

Copy of the Hyena part of `deepchopper_tpu/models/config.py`. Field names and
defaults are the JAX config's, so a config converts field by field; the JAX
`conv_impl` field is left out, as the port has one long-conv implementation
(`ops/mixer.py`).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HyenaConfig:
    """HyenaDNA backbone hyperparameters (small-32k defaults)."""

    d_model: int = 256
    n_layer: int = 4
    d_inner: int = 1024
    vocab_size: int = 12
    pad_vocab_size_multiple: int = 8
    emb_dim: int = 5  # positional-embedding feature dim (odd: t + bands*(re,im))
    filter_order: int = 64  # width of the implicit-filter MLP
    short_filter_order: int = 3  # depthwise conv kernel size
    hyena_order: int = 2
    num_inner_mlps: int = 2
    max_seq_len: int = 32770
    activation_freq: float = 10.0  # sine activation frequency (w)
    train_freq: bool = True
    use_bias: bool = True
    layer_norm_epsilon: float = 1e-5
    # Exponential filter modulation
    modulation_fast_decay_pct: float = 0.3
    modulation_slow_decay_pct: float = 1.5
    modulation_target: float = 1e-2
    modulation_shift: float = 0.0
    # Matmuls and the residual stream run in this dtype; the mixer's FFT and
    # LayerNorm statistics always run in float32.
    compute_dtype: str = "bfloat16"

    @property
    def padded_vocab_size(self) -> int:
        m = self.pad_vocab_size_multiple
        return ((self.vocab_size + m - 1) // m) * m


SMALL_32K = HyenaConfig()
TINY_1K = HyenaConfig(d_model=128, n_layer=2, d_inner=512, max_seq_len=1026)
MEDIUM_160K = HyenaConfig(d_model=256, n_layer=8, d_inner=1024, max_seq_len=160_002)
MEDIUM_450K = HyenaConfig(d_model=256, n_layer=8, d_inner=1024, max_seq_len=450_002)
LARGE_1M = HyenaConfig(d_model=256, n_layer=8, d_inner=1024, max_seq_len=1_000_002)

HYENA_CONFIGS: dict[str, HyenaConfig] = {
    "hyenadna-tiny-1k-seqlen": TINY_1K,
    "hyenadna-small-32k-seqlen": SMALL_32K,
    "hyenadna-medium-160k-seqlen": MEDIUM_160K,
    "hyenadna-medium-450k-seqlen": MEDIUM_450K,
    "hyenadna-large-1m-seqlen": LARGE_1M,
}


@dataclasses.dataclass(frozen=True)
class HeadConfig:
    """Token-classification head."""

    input_size: int = 256
    lin1_size: int = 1024
    lin2_size: int = 1024
    num_class: int = 2
    use_identity_layer_for_qual: bool = True
    use_qual: bool = True
    # Matmul dtype; parameters stay float32 and logits are returned float32.
    compute_dtype: str = "bfloat16"
