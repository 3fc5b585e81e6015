"""JAX parameter tree -> port state_dict.

The role `deepchopper_tpu/models/convert.py` plays between checkpoint
layouts: given the flax parameter tree of a classifier as nested dicts
of numpy arrays (`jax.tree.map(np.asarray, params)`), return the
`state_dict` of the port's module with the same weights, so both packages
compute the same function. Module paths are the flax paths; flax `Dense`
kernels are (Cin, Cout) and transpose into `nn.Linear`'s (Cout, Cin).
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

# flax leaf name -> torch parameter name (tensors that keep their layout).
_RENAMES = {"scale": "weight", "embedding": "weight"}


def flax_to_state_dict(params: Mapping) -> dict[str, torch.Tensor]:
    """Flatten a flax classifier tree into the port's state_dict."""
    out: dict[str, torch.Tensor] = {}

    def walk(node: Mapping, prefix: str) -> None:
        for key, val in node.items():
            if isinstance(val, Mapping):
                walk(val, f"{prefix}{key}.")
                continue
            arr = np.asarray(val, dtype=np.float32)
            if key == "kernel":
                if arr.ndim != 2:
                    raise ValueError(f"{prefix}kernel: expected a 2-D Dense kernel, got {arr.shape}")
                name, arr = "weight", arr.T
            else:
                name = _RENAMES.get(key, key)
            out[prefix + name] = torch.tensor(arr)

    walk(params, "")
    return out


def load_flax_params(module: torch.nn.Module, params: Mapping) -> torch.nn.Module:
    """Copy a flax parameter tree into `module` (strict: every key must match
    in name and shape)."""
    sd = flax_to_state_dict(params)
    own = module.state_dict()
    bad = [k for k in sd if k in own and tuple(own[k].shape) != tuple(sd[k].shape)]
    if bad:
        raise ValueError(
            "shape mismatch: " + "; ".join(f"{k}: {tuple(sd[k].shape)} vs {tuple(own[k].shape)}" for k in bad[:5])
        )
    module.load_state_dict(sd, strict=True)
    return module
