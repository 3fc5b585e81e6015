"""JAX parameter tree -> port state_dict.

The role `deepchopper_tpu/models/convert.py` plays between checkpoint
layouts: given the flax parameter tree of a classifier as nested dicts
of numpy arrays (`jax.tree.map(np.asarray, params)`), return the
`state_dict` of the port's module with the same weights, so both packages
compute the same function. Module paths are the flax paths; flax `Dense`
kernels are (Cin, Cout) and transpose into `nn.Linear`'s (Cout, Cin); the
attention's `DenseGeneral` kernels, (d, H, d/H) for query, key and value
and (H, d/H, d) for out, flatten their heads first, and their (H, d/H)
biases flatten; `Conv` kernels (k, Cin, Cout) become `nn.Conv1d`'s
(Cout, Cin, k). A BatchNorm's `batch_stats` (mean, var) go into its
running-statistics buffers.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

# flax leaf name -> torch parameter name (tensors that keep their layout).
_RENAMES = {"scale": "weight", "embedding": "weight", "mean": "running_mean", "var": "running_var"}
_QKV = ("query", "key", "value")


def _kernel(arr: np.ndarray, module: str, where: str) -> np.ndarray:
    """A flax kernel in the layout of the port's `weight`; `module` is the
    name of the flax module that holds it."""
    if arr.ndim == 2:
        return arr.T
    if arr.ndim == 3 and module in _QKV:
        return arr.reshape(arr.shape[0], -1).T
    if arr.ndim == 3 and module == "out":
        return arr.reshape(-1, arr.shape[-1]).T
    if arr.ndim == 3 and module.startswith("conv"):
        return arr.transpose(2, 1, 0)
    raise ValueError(f"{where}: no port layout for a {arr.ndim}-D kernel of module {module!r} ({arr.shape})")


def flax_to_state_dict(params: Mapping, batch_stats: Mapping | None = None) -> dict[str, torch.Tensor]:
    """Flatten a flax classifier tree, and its BatchNorms' `batch_stats`
    tree, into the port's state_dict."""
    out: dict[str, torch.Tensor] = {}

    def walk(node: Mapping, prefix: str, module: str) -> None:
        for key, val in node.items():
            if isinstance(val, Mapping):
                walk(val, f"{prefix}{key}.", key)
                continue
            arr = np.asarray(val, dtype=np.float32)
            name = _RENAMES.get(key, key)
            if key == "kernel":
                name, arr = "weight", _kernel(arr, module, prefix + key)
            elif key == "bias" and arr.ndim == 2 and module in _QKV:
                arr = arr.reshape(-1)
            out[prefix + name] = torch.tensor(arr)

    walk(params, "", "")
    walk(batch_stats or {}, "", "")
    return out


def load_flax_params(module: torch.nn.Module, params: Mapping, batch_stats: Mapping | None = None) -> torch.nn.Module:
    """Copy a flax parameter tree (and `batch_stats`, for a model with
    BatchNorms) into `module` (strict: every key must match in name and
    shape)."""
    sd = flax_to_state_dict(params, batch_stats)
    own = module.state_dict()
    bad = [k for k in sd if k in own and tuple(own[k].shape) != tuple(sd[k].shape)]
    if bad:
        raise ValueError(
            "shape mismatch: " + "; ".join(f"{k}: {tuple(sd[k].shape)} vs {tuple(own[k].shape)}" for k in bad[:5])
        )
    module.load_state_dict(sd, strict=True)
    return module
