"""Token classifiers (Hyena, Caduceus, transformer, CNN), their registry and the JAX-parameter bridge."""

from .caduceus import BiMambaMixer, CaduceusBackbone, MambaMixer
from .classifier import CaduceusTokenClassifier, HyenaTokenClassifier, TransformerTokenClassifier
from .config import (
    CADUCEUS_CONFIGS,
    HYENA_CONFIGS,
    CaduceusConfig,
    CnnConfig,
    HeadConfig,
    HyenaConfig,
    TransformerConfig,
)
from .head import BenchmarkCNN, TokenClassificationCnnHead, TokenClassificationHead
from .hyena import HyenaBackbone, HyenaFilter, HyenaOperator
from .registry import MODEL_REGISTRY, DeepChopper, build_model, load_checkpoint, save_checkpoint
from .transformer import TransformerBackbone

__all__ = [
    "CADUCEUS_CONFIGS",
    "HYENA_CONFIGS",
    "MODEL_REGISTRY",
    "BenchmarkCNN",
    "BiMambaMixer",
    "CaduceusBackbone",
    "CaduceusConfig",
    "CaduceusTokenClassifier",
    "CnnConfig",
    "DeepChopper",
    "HeadConfig",
    "HyenaBackbone",
    "HyenaConfig",
    "HyenaFilter",
    "HyenaOperator",
    "HyenaTokenClassifier",
    "MambaMixer",
    "TokenClassificationCnnHead",
    "TokenClassificationHead",
    "TransformerBackbone",
    "TransformerConfig",
    "TransformerTokenClassifier",
    "build_model",
    "load_checkpoint",
    "save_checkpoint",
]
