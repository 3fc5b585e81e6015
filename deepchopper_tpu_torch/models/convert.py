"""Reference torch checkpoint -> port Hyena classifier.

Port of the Hyena part of `deepchopper_tpu/models/convert.py`: maps the
reference's Lightning/HF state-dict layout (`net.backbone` is the HF
hyenadna port, `net.head` the MLP head) onto the port's module. Linear
weights keep torch's (Cout, Cin) layout; the depthwise short-conv weight
(W, 1, k) becomes the port's (k, 1, W).
"""

from __future__ import annotations

from pathlib import Path

import torch


def _load(path: str | Path) -> dict[str, torch.Tensor]:
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    out = {}
    for k, v in obj.items():
        if not isinstance(v, torch.Tensor):
            continue
        for prefix in ("net.", "model.", "module."):
            if k.startswith(prefix):
                k = k[len(prefix) :]
        out[k] = v.detach().float()
    return out


def _find(sd: dict[str, torch.Tensor], *candidates: str) -> torch.Tensor:
    for cand in candidates:
        if cand in sd:
            return sd[cand]
    for cand in candidates:
        hits = [k for k in sd if k.endswith(cand)]
        if len(hits) == 1:
            return sd[hits[0]]
    raise KeyError(f"none of {candidates} found in torch state dict ({len(sd)} keys)")


def load_reference_state_dict(model: torch.nn.Module, path: str | Path) -> torch.nn.Module:
    """Load a reference DeepChopper checkpoint into a port Hyena classifier."""
    sd = _load(path)
    own = model.state_dict()
    new: dict[str, torch.Tensor] = {}

    def linear(dst: str, src: str) -> None:
        new[f"{dst}.weight"] = _find(sd, f"{src}.weight")
        if f"{dst}.bias" in own:
            new[f"{dst}.bias"] = _find(sd, f"{src}.bias")

    vocab = own["backbone.word_embeddings.weight"].shape[0]
    new["backbone.word_embeddings.weight"] = _find(
        sd,
        "backbone.backbone.embeddings.word_embeddings.weight",
        "backbone.embeddings.word_embeddings.weight",
        "embeddings.word_embeddings.weight",
    )[:vocab]
    n_layer = model.backbone_config.n_layer
    for i in range(n_layer):
        dst = f"backbone.block_{i}"
        for pt in (f"backbone.backbone.layers.{i}", f"backbone.layers.{i}", f"layers.{i}"):
            if any(k.startswith(pt + ".") for k in sd):
                break
        for norm in ("norm1", "norm2"):
            new[f"{dst}.{norm}.weight"] = _find(sd, f"{pt}.{norm}.weight")
            new[f"{dst}.{norm}.bias"] = _find(sd, f"{pt}.{norm}.bias")
        linear(f"{dst}.mlp.fc1", f"{pt}.mlp.fc1")
        linear(f"{dst}.mlp.fc2", f"{pt}.mlp.fc2")
        linear(f"{dst}.mixer.in_proj", f"{pt}.mixer.in_proj")
        linear(f"{dst}.mixer.out_proj", f"{pt}.mixer.out_proj")
        new[f"{dst}.mixer.short_filter_kernel"] = _find(sd, f"{pt}.mixer.short_filter.weight").permute(2, 1, 0)
        new[f"{dst}.mixer.short_filter_bias"] = _find(sd, f"{pt}.mixer.short_filter.bias")
        filt = f"{pt}.mixer.filter_fn.implicit_filter"
        new[f"{dst}.mixer.filter_fn.bias"] = _find(sd, f"{pt}.mixer.filter_fn.bias")
        seq = sorted({int(k.split(".")[-2]) for k in sd if k.startswith(filt + ".")})
        linears = [j for j in seq if f"{filt}.{j}.weight" in sd]
        freqs = [j for j in seq if f"{filt}.{j}.freq" in sd]
        names = ["mlp_in"] + [f"mlp_{n}" for n in range(len(linears) - 2)] + ["mlp_out"]
        for name, j in zip(names, linears):
            linear(f"{dst}.mixer.filter_fn.{name}", f"{filt}.{j}")
        for n, j in enumerate(freqs):
            key = f"{dst}.mixer.filter_fn.sin_freq_{n}"
            if key in own:
                new[key] = _find(sd, f"{filt}.{j}.freq").reshape(own[key].shape)
    for p in ("weight", "bias"):
        new[f"backbone.ln_f.{p}"] = _find(sd, f"backbone.backbone.ln_f.{p}", f"backbone.ln_f.{p}", f"ln_f.{p}")
    for lin in ("linear1", "linear2", "linear3", "qual_linear1"):
        if f"head.{lin}.weight" in own:
            linear(f"head.{lin}", f"head.{lin}")
    model.load_state_dict(new, strict=True)
    return model
