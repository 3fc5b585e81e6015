"""Reference torch checkpoint -> port Hyena or Caduceus classifier.

Port of `deepchopper_tpu/models/convert.py`: maps the reference's
Lightning/HF state-dict layout (`net.backbone` is the HF hyenadna or
caduceus port, `net.head` the MLP head) onto the port's module. Linear
weights keep torch's (Cout, Cin) layout; a depthwise conv weight (W, 1, k)
becomes the port's (k, 1, W).
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


def _layer_prefix(sd: dict[str, torch.Tensor], i: int) -> str:
    for pt in (f"backbone.backbone.layers.{i}", f"backbone.layers.{i}", f"layers.{i}"):
        if any(k.startswith(pt + ".") for k in sd):
            break
    return pt


def load_reference_state_dict(model: torch.nn.Module, path: str | Path) -> torch.nn.Module:
    """Load a reference DeepChopper checkpoint into a port classifier."""
    from .classifier import CaduceusTokenClassifier

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
    if isinstance(model, CaduceusTokenClassifier):
        _caduceus_backbone(sd, model.backbone_config, new, linear)
    else:
        _hyena_backbone(sd, model.backbone_config.n_layer, own, new, linear)
    for lin in ("linear1", "linear2", "linear3", "qual_linear1"):
        if f"head.{lin}.weight" in own:
            linear(f"head.{lin}", f"head.{lin}")
    model.load_state_dict(new, strict=True)
    return model


def _hyena_backbone(sd, n_layer: int, own, new, linear) -> None:
    for i in range(n_layer):
        dst = f"backbone.block_{i}"
        pt = _layer_prefix(sd, i)
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


def _caduceus_backbone(sd, cfg, new, linear) -> None:
    """The HF Caduceus layout: `layers.{i}.norm`, the mixer under
    `mixer.mamba_fwd`, `mixer.submodule.mamba_fwd` or `mixer`, and for "ps"
    the reverse mixer under `mixer.mamba_rev` or `mixer.submodule.mamba_rev`
    (a "ps" model without those keys is an error)."""

    def mixer(dst: str, mx: str) -> None:
        for lin in ("in_proj", "x_proj", "dt_proj", "out_proj"):
            linear(f"{dst}.{lin}", f"{mx}.{lin}")
        new[f"{dst}.conv1d_kernel"] = _find(sd, f"{mx}.conv1d.weight").permute(2, 1, 0)
        new[f"{dst}.conv1d_bias"] = _find(sd, f"{mx}.conv1d.bias")
        new[f"{dst}.A_log"] = _find(sd, f"{mx}.A_log")
        new[f"{dst}.D"] = _find(sd, f"{mx}.D")

    for i in range(cfg.n_layer):
        dst = f"backbone.block_{i}"
        pt = _layer_prefix(sd, i)
        new[f"{dst}.norm.weight"] = _find(sd, f"{pt}.norm.weight")
        for mx in (f"{pt}.mixer.mamba_fwd", f"{pt}.mixer.submodule.mamba_fwd", f"{pt}.mixer"):
            if any(k.startswith(mx + ".") for k in sd):
                break
        mixer(f"{dst}.bimamba.mixer", mx)
        if not cfg.bidirectional_weight_tie:
            for mr in (f"{pt}.mixer.mamba_rev", f"{pt}.mixer.submodule.mamba_rev"):
                if any(k.startswith(mr + ".") for k in sd):
                    break
            else:
                raise KeyError(f"untied (ps) model expects {pt}.mixer.mamba_rev.* keys in the checkpoint")
            mixer(f"{dst}.bimamba.mixer_rev", mr)
    new["backbone.norm_f.weight"] = _find(sd, "backbone.backbone.norm_f.weight", "backbone.norm_f.weight", "norm_f.weight")
