"""Top-level token classifiers: backbone + quality-fusing head.

Port of `deepchopper_tpu/models/classifier.py`: `HyenaTokenClassifier`,
`CaduceusTokenClassifier` and `TransformerTokenClassifier`. Each takes
input_ids (B, L) int and input_quals (B, L) float32 and returns logits
(B, L, 2) float32. For the inference
engine's CUDA graphs, each also takes a `memo` of work that depends on the
width alone, and names what its forward reads from outside its arguments
and weights (`graph_key`).
"""

from __future__ import annotations

import torch
from torch import nn

from .caduceus import CaduceusBackbone
from .config import CaduceusConfig, HeadConfig, HyenaConfig, TransformerConfig
from .head import BenchmarkCNN, TokenClassificationHead
from .hyena import HyenaBackbone, mixer_route
from .transformer import TransformerBackbone


class _TokenClassifier(nn.Module):
    def __init__(self, backbone: nn.Module, backbone_config, head_config: HeadConfig, name: str):
        super().__init__()
        self.name = name
        self.backbone_config = backbone_config
        self.head_config = head_config
        self.backbone = backbone
        self.head = TokenClassificationHead(head_config)

    def reset_parameters(self, gen: torch.Generator) -> None:
        self.backbone.reset_parameters(gen)
        self.head.reset_parameters(gen)

    def graph_key(self, width: int):
        """What a forward at `width` reads besides its arguments and weights,
        and could read otherwise later: a forward captured as a CUDA graph is
        replayed only under the same key."""
        return None


class HyenaTokenClassifier(_TokenClassifier):
    """The Hyena backbone, whose (B, D, L) hidden state the head reads as it is."""

    def __init__(self, backbone_config: HyenaConfig, head_config: HeadConfig, name: str = ""):
        super().__init__(HyenaBackbone(backbone_config), backbone_config, head_config, name)

    def forward(self, input_ids: torch.Tensor, input_quals: torch.Tensor, memo: dict | None = None) -> torch.Tensor:
        """`memo`: keeps the long filters (and their spectra) of each width,
        for inference on fixed weights (`HyenaOperator.forward`)."""
        return self.head(self.backbone(input_ids, memo), input_quals)

    def graph_key(self, width: int) -> str:
        """The mixer route, which follows the environment (`mixer_route`)."""
        return mixer_route(self.backbone_config.d_model, width)


class CaduceusTokenClassifier(_TokenClassifier):
    """The Caduceus backbone, whose (B, L, D) hidden state reaches the
    channel-first head as a transposed view."""

    def __init__(self, backbone_config: CaduceusConfig, head_config: HeadConfig, name: str = ""):
        super().__init__(CaduceusBackbone(backbone_config), backbone_config, head_config, name)

    def forward(self, input_ids: torch.Tensor, input_quals: torch.Tensor, memo: dict | None = None) -> torch.Tensor:
        """`memo`: unused (no work of this backbone depends on the width alone)."""
        return self.head(self.backbone(input_ids).transpose(1, 2), input_quals)


class TransformerTokenClassifier(_TokenClassifier):
    """The transformer-encoder baseline, whose (B, L, D) hidden state reaches
    the channel-first head as a transposed view."""

    def __init__(self, backbone_config: TransformerConfig, head_config: HeadConfig, name: str = ""):
        super().__init__(TransformerBackbone(backbone_config), backbone_config, head_config, name)

    def forward(self, input_ids: torch.Tensor, input_quals: torch.Tensor, memo: dict | None = None,
                pad_mask: torch.Tensor | None = None) -> torch.Tensor:  # fmt: skip
        """`memo`: unused. `pad_mask` (B, L) bool, True where a key may be
        attended; the engine and the trainer pass none, as the JAX ones do."""
        return self.head(self.backbone(input_ids, pad_mask).transpose(1, 2), input_quals)


TokenClassifier = HyenaTokenClassifier | CaduceusTokenClassifier | TransformerTokenClassifier | BenchmarkCNN
