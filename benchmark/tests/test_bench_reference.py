"""The frozen reference against the port's CPU path, in float32, on the
registry's tiny HyenaDNA and Caduceus: logits, the loss's gradients, the
encoding, the chop; and the reference scan's own backward against a
step-by-step scan in float64."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from benchmark.harness.traffic import make_reads
from benchmark.harness.weights import make_weights
from benchmark.reference import chop as ref_chop
from benchmark.reference import judge, models
from benchmark.reference.encode import encode
from benchmark.reference.scan import scan

from .conftest import tiny_config, tiny_traffic


def _f32_pair(family: str, seed: int = 11):
    """The port's tiny classifier computing in float32, its config for the
    reference, and one set of weights loaded into it."""
    from deepchopper_tpu_torch.models.registry import build_model

    cfg = tiny_config(family)
    cfg["backbone"]["compute_dtype"] = cfg["head"]["compute_dtype"] = "float32"
    tiny = build_model(cfg["registry_name"])
    model = type(tiny)(dataclasses.replace(tiny.backbone_config, compute_dtype="float32"),
                       dataclasses.replace(tiny.head_config, compute_dtype="float32"))  # fmt: skip
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    w = make_weights(shapes, cfg["init"], seed, torch.device("cpu"))
    model.load_state_dict(w)
    return model, cfg, w


def _batch(family: str, width: int = 512, rows: int = 3):
    reads = make_reads({**tiny_traffic("drna-labelled"), "lengths": {**tiny_traffic("drna")["lengths"], "max": 500}},
                       rows, 3)  # fmt: skip
    enc = [encode(*reads.record(i)[1:], width, 1024, tuple(reads.spans[i])) for i in range(rows)]
    return tuple(torch.from_numpy(np.stack(col)) for col in zip(*enc))


@pytest.mark.parametrize("family", ["hyena", "caduceus"])
def test_logits_match_the_port_in_float32(family):
    model, cfg, w = _f32_pair(family)
    ids, quals, _ = _batch(family)
    with torch.no_grad():
        got = models.forward(w, cfg, ids, quals)
        want = model(ids, quals)
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


# Worst leaf, as a share of its largest gradient. Hyena's: float32 itself
# is off by ~8e-3 there (both the port and the reference, against this
# reference in float64: the sine MLP of the implicit filter), and the two
# agree to ~5e-3.
GRAD_TOL = {"hyena": 1e-2, "caduceus": 1e-4}


@pytest.mark.parametrize("family", ["hyena", "caduceus"])
def test_gradients_match_the_port_in_float32(family):
    from deepchopper_tpu_torch.train.loss import continuous_interval_loss

    model, cfg, w = _f32_pair(family)
    batch = tuple(t.numpy() for t in _batch(family))
    from deepchopper_tpu_torch.train.metrics import binary_stats_arrays

    loss, grads, counts = judge._loss_and_grads({k: v.clone().requires_grad_() for k, v in w.items()}, cfg, batch,
                                                torch.device("cpu"), "f32", 1.0)  # fmt: skip
    model.train()
    logits = model(*(torch.from_numpy(a) for a in batch[:2]))
    want = continuous_interval_loss(logits, torch.from_numpy(batch[2]))
    want.backward()
    assert abs(loss - float(want.detach())) <= 1e-5 * abs(float(want.detach()))
    assert counts.tolist() == binary_stats_arrays(logits.argmax(-1), torch.from_numpy(batch[2])).tolist()
    for k, p in model.named_parameters():
        assert (grads[k] - p.grad).abs().max() <= GRAD_TOL[family] * max(p.grad.abs().max(), 1e-12), k


def _scan_steps(u, delta, A, Bp, Cp, D):
    h = torch.zeros(u.shape[0], u.shape[2], A.shape[1], dtype=u.dtype)
    ys = []
    for t in range(u.shape[1]):
        h = torch.exp(delta[:, t, :, None] * A) * h + (delta[:, t] * u[:, t])[..., None] * Bp[:, t, None, :]
        ys.append((h * Cp[:, t, None, :]).sum(-1) + D * u[:, t])
    return torch.stack(ys, 1)


@pytest.mark.parametrize("reverse", [False, True])
def test_scan_and_its_backward(reverse, monkeypatch):
    from benchmark.reference import scan as scan_mod

    monkeypatch.setattr(scan_mod, "CHUNK_ELEMENTS", 2 * 3 * 8 * 5)  # chunks of 5 steps over 37
    g = torch.Generator().manual_seed(0)
    b, L, d, n = 2, 37, 8, 4
    args = [torch.randn(s, generator=g, dtype=torch.float64) for s in ((b, L, d), (b, L, d), (d, n), (b, L, n), (b, L, n), (d,))]
    args[1] = torch.nn.functional.softplus(args[1])
    args[2] = -torch.exp(args[2] * 0.3)
    leaves = [a.clone().requires_grad_() for a in args]
    ref_leaves = [a.clone().requires_grad_() for a in args]
    y = scan(*leaves, reverse=reverse)
    flip = (lambda t: torch.flip(t, (1,))) if reverse else (lambda t: t)
    want = flip(_scan_steps(*[flip(t) if t.dim() == 3 else t for t in ref_leaves]))
    assert torch.allclose(y, want, rtol=1e-10, atol=1e-10)
    dy = torch.randn(y.shape, generator=g, dtype=torch.float64)
    got = torch.autograd.grad(y, leaves, dy)
    exp = torch.autograd.grad(want, ref_leaves, dy)
    for a, e in zip(got, exp):
        assert torch.allclose(a, e, rtol=1e-9, atol=1e-9)


def test_encoding_matches_the_port():
    from deepchopper_tpu_torch.data.bucketing import encode_read, pad_batch

    reads = make_reads(tiny_traffic("drna-labelled"), 6, 8)
    for i in range(6):
        name, seq, qual = reads.record(i)
        span = tuple(int(v) for v in reads.spans[i])
        er = encode_read(name, seq.decode(), np.frombuffer(qual, np.uint8).astype(np.int32) - 33, [span], 1024)
        batch = pad_batch([er], 1024)
        ids, q, labels = encode(seq, qual, 1024, 1024, span)
        assert np.array_equal(batch.input_ids[0], ids) and np.array_equal(batch.labels[0], labels)
        assert np.abs(batch.quals[0] - q).max() <= 1e-6


def test_chop_matches_the_port():
    from deepchopper_tpu_torch.chop.pipeline import ChopOptions, select_intervals
    from deepchopper_tpu_torch.io.chop import ChopType, split_records_by_remove_intervals
    from deepchopper_tpu_torch.ops.labels import majority_voting

    opts, rules = ChopOptions(), ref_chop.ChopRules()
    rng = np.random.default_rng(4)
    reads = make_reads(tiny_traffic("drna"), 300, 4)
    chopped = 0
    for i in range(len(reads)):
        name, seq, qual = reads.record(i)
        # Blocky labels: runs of random length, so that some reads have 1-4 intervals.
        runs = rng.geometric(rng.choice([0.01, 0.05, 0.2]), len(seq))
        labels = (np.repeat(np.arange(len(runs)) % 2, runs)[: len(seq)] ^ rng.integers(0, 2)).astype(np.int8)
        kept = select_intervals(majority_voting(labels, opts.smooth_window_size), opts)
        if len(seq) < opts.min_read_len or not kept or len(kept) > opts.max_process_intervals:
            want = [b"@%s\n%s\n+\n%s\n" % (name.encode(), seq, qual)]
        else:
            recs = split_records_by_remove_intervals(seq, name, qual, kept, opts.min_read_length_after_chop,
                                                     opts.id_annotation, ChopType.ALL)  # fmt: skip
            want = [r.to_bytes() for r in recs]
            chopped += 1
        assert ref_chop.chop(name, seq, qual, labels.tolist(), False, rules) == want
    assert chopped > 20
