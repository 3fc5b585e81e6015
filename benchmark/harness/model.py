"""The served model: the port's registry model of a configuration, checked
against the configuration's file, with the harness's weights loaded."""

from __future__ import annotations

import dataclasses

import torch

from .weights import make_weights


def check_config(model, cfg: dict) -> None:
    """Raise unless the registry model runs the file's numbers, every one."""
    for part, have in (("backbone", model.backbone_config), ("head", model.head_config)):
        got, want = dataclasses.asdict(have), cfg[part]
        if got != want:
            diff = {k: (got.get(k), want.get(k)) for k in set(got) | set(want) if got.get(k) != want.get(k)}
            raise ValueError(f"{cfg['registry_name']} {part} differs from its configuration file: {diff}")


def served_model(cfg: dict, seed: int, device: torch.device):
    """(the port's model on `device` with the seed's weights, the weights)."""
    from deepchopper_tpu_torch.models.registry import build_model

    model = build_model(cfg["registry_name"])
    check_config(model, cfg)
    model = model.to(device)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    weights = make_weights(shapes, cfg["init"], seed, device)
    model.load_state_dict(weights, strict=True)
    return model, weights
