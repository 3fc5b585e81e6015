"""What the benchmark's Caduceus cell rests on, on the CPU: the port's tiny
Caduceus-Ph and -Ps against the benchmark's plain float32 reference
(`benchmark/reference/models.py`), with and without the block recompute,
and the reader of scan_fwd's roofline on a synthetic trace.

Tolerances: logits within 1e-4 of max|logit| (float32 rounding through two
bidirectional blocks), gradients within 1e-4 of each leaf's max|g|, as
`benchmark/tests/test_bench_reference.py` holds the Ph model; the
recompute runs the same ops on the same inputs, so its gradients are
equal bit for bit.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark.counts.roofline import scan_fwd_s
from benchmark.harness.spec import metric_reader
from benchmark.harness.weights import make_weights
from benchmark.reference import models as reference
from benchmark.tests.conftest import tiny_config
from deepchopper_tpu_torch.models.registry import build_model
from deepchopper_tpu_torch.train.loss import continuous_interval_loss

TINY = {"ph": "caduceus-tiny", "ps": "caduceus-tiny-ps"}
LOGIT_TOL = 1e-4
GRAD_TOL = 1e-4


def _f32_pair(variant: str, seed: int = 5):
    """The port's tiny classifier in float32, the reference's config and
    one set of the benchmark's seeded weights loaded into it."""
    tiny = build_model(TINY[variant])
    bb = dataclasses.replace(tiny.backbone_config, compute_dtype="float32")
    head = dataclasses.replace(tiny.head_config, compute_dtype="float32")
    model = type(tiny)(bb, head)
    cfg = {**tiny_config("caduceus"), "registry_name": TINY[variant], "backbone": dataclasses.asdict(bb),
           "head": dataclasses.asdict(head)}  # fmt: skip
    # The untied reverse mixer's skip takes the forward mixer's rule.
    rules = [{"match": "mixer_rev.D", "kind": "const", "value": 1.0}, *cfg["init"]]
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    weights = make_weights(shapes, rules, seed, torch.device("cpu"))
    model.load_state_dict(weights)
    return model, cfg, weights


def _batch(rows: int = 3, width: int = 96, seed: int = 2):
    """Token ids, normalised quals and 0/1 labels; the last row half padding."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(7, 11, (rows, width))
    quals = rng.integers(5, 40, (rows, width)).astype(np.float32)
    labels = (rng.random((rows, width)) < 0.3).astype(np.int64)
    ids[-1, width // 2 :], quals[-1, width // 2 :], labels[-1, width // 2 :] = 4, 0, -100
    quals /= np.linalg.norm(quals, axis=1, keepdims=True)
    return torch.from_numpy(ids), torch.from_numpy(quals), torch.from_numpy(labels)


def _port_grads(model, batch, recompute: int | None = None) -> dict[str, torch.Tensor]:
    ids, quals, labels = batch
    model.train()
    model.zero_grad()
    model.backbone._recompute = recompute
    continuous_interval_loss(model(ids, quals), labels).backward()
    model.backbone._recompute = None
    return {k: p.grad.clone() for k, p in model.named_parameters()}


@pytest.mark.parametrize("check", ["logits", "gradients", "recompute"])
@pytest.mark.parametrize("variant", ["ph", "ps"])
def test_tiny_caduceus_matches_the_benchmark_reference(variant, check):
    model, cfg, weights = _f32_pair(variant)
    batch = _batch()
    ids, quals, labels = batch
    if check == "logits":
        model.eval()
        with torch.no_grad():
            got, want = model(ids, quals), reference.forward(weights, cfg, ids, quals)
        assert (got - want).abs().max() <= LOGIT_TOL * want.abs().max()
        assert torch.equal(got.argmax(-1), want.argmax(-1))
        return
    grads = _port_grads(model, batch)
    if check == "gradients":
        leaves = {k: v.clone().requires_grad_() for k, v in weights.items()}
        logits = reference.forward(leaves, cfg, ids, quals, recompute=True)
        want = torch.autograd.grad(continuous_interval_loss(logits, labels), list(leaves.values()), allow_unused=True)
        for (k, _), g in zip(leaves.items(), want):
            assert g is not None and (grads[k] - g).abs().max() <= GRAD_TOL * max(g.abs().max(), 1e-12), k
    else:
        again = _port_grads(model, batch, recompute=cfg["backbone"]["n_layer"] // 2)
        assert all(torch.equal(again[k], g) for k, g in grads.items())


# -- the reader on a synthetic trace -----------------------------------------------------

CFG = {"backbone": {"n_layer": 16, "d_model": 256, "expand": 2, "d_state": 16}}


def _run(kind: str, shapes: dict, device_s: dict[str, float]):
    fake = SimpleNamespace(window_s=10.0, time_of=lambda op: device_s.get(op, 0.0))
    return SimpleNamespace(cell=SimpleNamespace(config=CFG), layer={"kind": kind, "shapes": shapes}, trace=fake)


SHAPES = {(128, 1024): 2}


@pytest.mark.parametrize("name", ["scan_fwd_roofline"])
def test_caduceus_readers_on_a_synthetic_trace(name):
    read = metric_reader(name)
    want = 100 * 2 * 2 * 16 * scan_fwd_s(128, 1024) / 0.05
    assert read(_run("predict", SHAPES, {"scan_fwd": 0.05})) == pytest.approx(want, rel=1e-12)
    assert read(_run("train", SHAPES, {"scan_fwd": 0.05})) is None
    assert read(SimpleNamespace(cell=SimpleNamespace(config=CFG), layer={"kind": "predict", "shapes": SHAPES},
                                trace=None)) is None  # fmt: skip
    assert read(_run("predict", SHAPES, {})) is None  # no scan kernel in the window
