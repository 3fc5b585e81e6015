"""Model registry and the `DeepChopper` factory.

Port of `deepchopper_tpu/models/registry.py`. Factories return the
classifier `nn.Module` on the requested device, in eval mode (the trainer
puts its model in train mode). Random initialisation draws from a seeded
`torch.Generator` with the flax initialisers' distributions (its numbers
differ from JAX's). Trainer checkpoints are `torch.save` of a dict holding
the `state_dict` (the CNN's BatchNorm running statistics included), the
optimizer state and the run's metadata.

A model folder (`save_pretrained`, `from_pretrained_dir`, and
`from_pretrained` of a folder) holds the JAX package's `config.json`
(`model_name` and the `backbone` config's fields) and the port's own weights,
`model.pt`, a checkpoint as above; the JAX package's `model.dc` (flax
msgpack) is not read.
"""

from __future__ import annotations

import dataclasses
import json
import logging
from collections.abc import Callable
from pathlib import Path

import torch

from ..device import resolve_device
from .classifier import CaduceusTokenClassifier, HyenaTokenClassifier, TokenClassifier, TransformerTokenClassifier
from .config import (
    CADUCEUS_CONFIGS,
    CADUCEUS_TINY,
    CADUCEUS_TINY_PS,
    HYENA_CONFIGS,
    CnnConfig,
    HeadConfig,
    TransformerConfig,
)
from .head import BenchmarkCNN

log = logging.getLogger(__name__)

MODEL_REGISTRY: dict[str, Callable[[], TokenClassifier]] = {}


def register(name: str):
    def deco(fn):
        MODEL_REGISTRY[name] = fn
        return fn

    return deco


def _default_head() -> HeadConfig:
    return HeadConfig(
        input_size=256,
        lin1_size=1024,
        lin2_size=1024,
        num_class=2,
        use_identity_layer_for_qual=True,
        use_qual=True,
    )


@register("hyenadna-small-32k-seqlen")
@register("rna002")
@register("rna004")
def _hyena_small() -> HyenaTokenClassifier:
    return HyenaTokenClassifier(HYENA_CONFIGS["hyenadna-small-32k-seqlen"], _default_head())


@register("hyenadna-tiny-1k-seqlen")
def _hyena_tiny() -> HyenaTokenClassifier:
    return HyenaTokenClassifier(
        HYENA_CONFIGS["hyenadna-tiny-1k-seqlen"], dataclasses.replace(_default_head(), input_size=128)
    )


@register("transformer")
def _transformer() -> TransformerTokenClassifier:
    return TransformerTokenClassifier(TransformerConfig(), _default_head())


@register("cnn")
def _cnn() -> BenchmarkCNN:
    return BenchmarkCNN(CnnConfig())


@register("caduceus-ph_seqlen-131k_d_model-256_n_layer-16")
def _caduceus_131k() -> CaduceusTokenClassifier:
    return CaduceusTokenClassifier(CADUCEUS_CONFIGS["caduceus-ph_seqlen-131k_d_model-256_n_layer-16"], _default_head())


@register("caduceus-ps_seqlen-131k_d_model-256_n_layer-16")
def _caduceus_131k_ps() -> CaduceusTokenClassifier:
    """Untied (separate reverse-mixer) variant."""
    return CaduceusTokenClassifier(CADUCEUS_CONFIGS["caduceus-ps_seqlen-131k_d_model-256_n_layer-16"], _default_head())


def _tiny_head() -> HeadConfig:
    return dataclasses.replace(_default_head(), input_size=64, lin1_size=128, lin2_size=128)


@register("caduceus-tiny")
def _caduceus_tiny() -> CaduceusTokenClassifier:
    return CaduceusTokenClassifier(CADUCEUS_TINY, _tiny_head())


@register("caduceus-tiny-ps")
def _caduceus_tiny_ps() -> CaduceusTokenClassifier:
    return CaduceusTokenClassifier(CADUCEUS_TINY_PS, _tiny_head())


def build_model(name: str, head_overrides: dict | None = None) -> TokenClassifier:
    """Build a registered model, optionally overriding head hyperparameters
    (`lin1_size`, which implies `lin2_size`, and `use_identity_layer_for_qual`)."""
    if name not in MODEL_REGISTRY:
        raise KeyError(f"unknown model {name!r}; available: {sorted(MODEL_REGISTRY)}")
    model = MODEL_REGISTRY[name]()
    if head_overrides:
        over = dict(head_overrides)
        if "lin1_size" in over and "lin2_size" not in over:
            over["lin2_size"] = over["lin1_size"]
        if not hasattr(model, "head_config"):
            raise ValueError(f"model {name!r} has no tunable head")
        model = type(model)(model.backbone_config, dataclasses.replace(model.head_config, **over))
    model.name = name
    return model


def save_checkpoint(
    path: str | Path, model: torch.nn.Module, optimizer_state: dict | None = None, metadata: dict | None = None
) -> None:
    """Write a trainer checkpoint atomically (temporary file, then rename)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = {
        "state_dict": {k: v.detach().cpu() for k, v in model.state_dict().items()},
        "optimizer": optimizer_state,
        "metadata": metadata or {},
    }
    tmp = path.with_name(path.name + ".tmp")
    torch.save(payload, tmp)
    tmp.replace(path)


def load_checkpoint(path: str | Path) -> tuple[dict, dict | None, dict]:
    """(state_dict, optimizer state or None, metadata) of a trainer
    checkpoint, or of a bare `state_dict` saved with `torch.save`."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(payload, dict) and "state_dict" in payload and "metadata" in payload:
        return payload["state_dict"], payload.get("optimizer"), payload["metadata"]
    return payload, None, {}


def load_state_strict(model: torch.nn.Module, state: dict, source: str | Path) -> None:
    """load_state_dict that names every shape mismatch (a checkpoint trained
    with other head overrides) in one ValueError."""
    own = model.state_dict()
    bad = [f"{k}: checkpoint {tuple(v.shape)} vs model {tuple(own[k].shape)}"
           for k, v in state.items() if k in own and tuple(v.shape) != tuple(own[k].shape)]  # fmt: skip
    if bad:
        raise ValueError(
            f"checkpoint {source} does not match the model configuration "
            f"({len(bad)} shape mismatches): " + "; ".join(bad[:5])
        )
    model.load_state_dict(state, strict=True)


class DeepChopper:
    """Factory with the reference's entry points, returning classifier modules."""

    PRETRAINED_ALIASES = {
        "yangliz5/deepchopper": "rna002",
        "yangliz5/deepchopper-rna004": "rna004",
        "rna002": "rna002",
        "rna004": "rna004",
    }

    @staticmethod
    def new(
        name: str = "hyenadna-small-32k-seqlen",
        seed: int = 0,
        device: str | torch.device = "cuda",
        head_overrides: dict | None = None,
    ) -> TokenClassifier:
        dev = resolve_device(device)
        model = build_model(name, head_overrides)
        gen = torch.Generator(device="cpu").manual_seed(seed)
        model.reset_parameters(gen)
        return model.to(dev).eval()

    @staticmethod
    def from_checkpoint(
        checkpoint_path: str | Path,
        name: str = "hyenadna-small-32k-seqlen",
        device: str | torch.device = "cuda",
        head_overrides: dict | None = None,
    ) -> TokenClassifier:
        """Load a trainer checkpoint or a bare `state_dict` saved with
        `torch.save`; `head_overrides` must be those it was trained with."""
        dev = resolve_device(device)
        model = build_model(name, head_overrides)
        state, _opt, _meta = load_checkpoint(checkpoint_path)
        load_state_strict(model, state, checkpoint_path)
        return model.to(dev).eval()

    @staticmethod
    def from_pretrained(
        model_name: str,
        torch_checkpoint: str | Path | None = None,
        random_init: bool = False,
        device: str | torch.device = "cuda",
    ) -> TokenClassifier:
        """Pretrained weights: a model folder (`save_pretrained`) when
        `model_name` is a directory with a config.json; else with no weights
        given this is a HARD ERROR (silent random weights predict garbage)
        unless `random_init=True`."""
        local = Path(model_name)
        if local.is_dir() and (local / "config.json").exists():
            return DeepChopper.from_pretrained_dir(local, device=device)
        name = DeepChopper.PRETRAINED_ALIASES.get(model_name, model_name)
        if torch_checkpoint is not None:
            from .convert import load_reference_state_dict

            dev = resolve_device(device)
            model = build_model(name)
            load_reference_state_dict(model, torch_checkpoint)
            return model.to(dev).eval()
        if random_init:
            log.warning("random_init=True: %s is using UNTRAINED weights", model_name)
            return DeepChopper.new(name, device=device)
        raise FileNotFoundError(
            f"no pretrained weights available for {model_name!r}: this environment has "
            "no network egress, so pass --torch-checkpoint <path to the reference torch "
            "state_dict> or --checkpoint <port checkpoint>. "
            "Use --random-init to run with untrained weights (tests/benchmarks only)."
        )

    @staticmethod
    def save_pretrained(model: TokenClassifier, directory: str | Path) -> Path:
        """Write a model folder: config.json (the JAX package's: model name
        and backbone config) and the weights, model.pt."""
        directory = Path(directory)
        directory.mkdir(parents=True, exist_ok=True)
        cfg = getattr(model, "backbone_config", None)
        cfg_dict = dataclasses.asdict(cfg) if dataclasses.is_dataclass(cfg) else {}
        (directory / "config.json").write_text(json.dumps({"model_name": model.name, "backbone": cfg_dict}, indent=1))
        save_checkpoint(directory / "model.pt", model, metadata={"name": model.name})
        return directory

    @staticmethod
    def from_pretrained_dir(directory: str | Path, device: str | torch.device = "cuda") -> TokenClassifier:
        """Load a folder written by `save_pretrained`."""
        directory = Path(directory)
        meta = json.loads((directory / "config.json").read_text())
        return DeepChopper.from_checkpoint(directory / "model.pt", meta["model_name"], device=device)

    @staticmethod
    def to_hub(model: TokenClassifier, repo_id: str, directory: str | Path | None = None) -> Path:
        """Prepare a hub upload folder (`save_pretrained`'s layout) for a
        later `huggingface-cli upload <repo_id> <folder>`; nothing is sent."""
        directory = Path(directory or f"hub_upload_{repo_id.replace('/', '_')}")
        return DeepChopper.save_pretrained(model, directory)
