"""The served weights, made from the run seed on the device.

Each leaf of the model's `state_dict` takes the first rule of the
configuration's `init` list whose pattern it contains: `normal` with a mean
and a standard deviation (`std`, or `fan_in`: 1/sqrt of that dimension of
the leaf), `const`, `values` (the leaf written out: the head's class bias,
set so that the random model labels a share of the bases as adapter and the
chop has intervals to cut) or `log_arange` (log 1..N along the last axis,
Mamba's A_log). The normals come from one `torch.randn` call on the device's own
generator, cut into the leaves, all in float32 (the dtype the model keeps
its parameters in). The same tensors go to the program and the reference.
"""

from __future__ import annotations

import math

import torch


def _rule(name: str, rules: list[dict]) -> dict:
    for rule in rules:
        if rule["match"] in name:
            return rule
    raise KeyError(f"no init rule matches {name!r}")


def make_weights(shapes: dict[str, tuple[int, ...]], rules: list[dict], seed: int, device) -> dict[str, torch.Tensor]:
    """{name: float32 tensor on `device`} for every (name, shape) given."""
    picks = {name: _rule(name, rules) for name in shapes}
    total = sum(math.prod(s) for n, s in shapes.items() if picks[n]["kind"] == "normal")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape in shapes.items():
        rule, size = picks[name], math.prod(shape)
        if rule["kind"] == "normal":
            std = rule["std"] if "std" in rule else 1.0 / math.sqrt(shape[rule["fan_in"]])
            out[name] = flat[at : at + size].view(shape) * std + rule.get("mean", 0.0)
            at += size
        elif rule["kind"] == "const":
            out[name] = torch.full(shape, float(rule["value"]), device=device)
        elif rule["kind"] == "values":
            out[name] = torch.tensor(rule["values"], device=device, dtype=torch.float32).reshape(shape)
        elif rule["kind"] == "log_arange":
            out[name] = torch.log(torch.arange(1, shape[-1] + 1, device=device, dtype=torch.float32)).expand(shape).clone()
        else:
            raise ValueError(f"unknown init kind {rule['kind']!r} for {name}")
    return out
