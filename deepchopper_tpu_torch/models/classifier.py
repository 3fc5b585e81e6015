"""Top-level token classifier: Hyena backbone + quality-fusing head.

Port of `deepchopper_tpu/models/classifier.py:HyenaTokenClassifier`.
"""

from __future__ import annotations

import torch
from torch import nn

from .config import HeadConfig, HyenaConfig
from .head import TokenClassificationHead
from .hyena import HyenaBackbone


class HyenaTokenClassifier(nn.Module):
    """input_ids (B, L) int, input_quals (B, L) float32 -> logits (B, L, 2) float32."""

    def __init__(self, backbone_config: HyenaConfig, head_config: HeadConfig, name: str = ""):
        super().__init__()
        self.name = name
        self.backbone_config = backbone_config
        self.head_config = head_config
        self.backbone = HyenaBackbone(backbone_config)
        self.head = TokenClassificationHead(head_config)

    def reset_parameters(self, gen: torch.Generator) -> None:
        self.backbone.reset_parameters(gen)
        self.head.reset_parameters(gen)

    def forward(self, input_ids: torch.Tensor, input_quals: torch.Tensor) -> torch.Tensor:
        return self.head(self.backbone(input_ids), input_quals)
