"""Model configurations for the Hyena, Caduceus, transformer and CNN token
classifiers.

Copy of `deepchopper_tpu/models/config.py`.
Field names and defaults are the JAX configs', so a config converts field by
field. Two JAX fields are left out, each because the port has a single
implementation per device: Hyena's `conv_impl` (the long conv is `ops/mixer.py`,
`ops/gated.py` or `ops/inproj.py`, by the mixer route that the environment
variables DEEPCHOPPER_FUSE_SHORT and DEEPCHOPPER_FUSE_INPROJ and d_model pick,
as in the JAX package: `models/hyena.py:mixer_route`) and Caduceus's
`scan_chunk` (the scan is `ops/scan.py`).
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
class CaduceusConfig:
    """Caduceus bidirectional-Mamba backbone hyperparameters (the
    caduceus-*_seqlen-131k_d_model-256_n_layer-16 defaults)."""

    d_model: int = 256
    n_layer: int = 16
    vocab_size: int = 12
    pad_vocab_size_multiple: int = 8
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 16  # ceil(d_model / 16)
    max_seq_len: int = 131072
    layer_norm_epsilon: float = 1e-5
    # in_proj, x_proj and out_proj run in this dtype; everything else
    # (residual stream, conv, dt_proj, scan, RMSNorm) in float32.
    compute_dtype: str = "bfloat16"
    # True = "ph" (forward and reverse mixers share weights); False = "ps"
    # (a separate reverse mixer).
    bidirectional_weight_tie: bool = True

    @property
    def padded_vocab_size(self) -> int:
        m = self.pad_vocab_size_multiple
        return ((self.vocab_size + m - 1) // m) * m


CADUCEUS_PH_131K = CaduceusConfig()
CADUCEUS_PS_131K = CaduceusConfig(bidirectional_weight_tie=False)
CADUCEUS_TINY = CaduceusConfig(d_model=64, n_layer=2, d_state=8, dt_rank=4, max_seq_len=1024)
CADUCEUS_TINY_PS = CaduceusConfig(
    d_model=64, n_layer=2, d_state=8, dt_rank=4, max_seq_len=1024, bidirectional_weight_tie=False
)

CADUCEUS_CONFIGS: dict[str, CaduceusConfig] = {
    "caduceus-ph_seqlen-131k_d_model-256_n_layer-16": CADUCEUS_PH_131K,
    "caduceus-ps_seqlen-131k_d_model-256_n_layer-16": CADUCEUS_PS_131K,
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


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """Transformer-encoder baseline. LayerNorm and the residual stream run in
    float32; attention, its projections and the feed-forward in
    `compute_dtype`."""

    vocab_size: int = 12
    d_model: int = 256
    n_heads: int = 8
    n_layers: int = 4
    d_ff: int = 1024
    max_len: int = 32768
    compute_dtype: str = "bfloat16"


@dataclasses.dataclass(frozen=True)
class CnnConfig:
    """CNN baseline. The JAX module computes in float32 whatever
    `compute_dtype` says (its layers take no dtype), and so does the port."""

    vocab_size: int = 12
    embed_dim: int = 100
    num_filters: tuple[int, ...] = (128, 256, 512)
    filter_sizes: tuple[int, ...] = (7, 9, 11)
    num_class: int = 2
    compute_dtype: str = "bfloat16"
