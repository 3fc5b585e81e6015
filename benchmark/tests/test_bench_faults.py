"""A run with the timed path broken underneath comes out `correct: false`,
once for each fault the cells can have (one chip: no exchange between
chips to leave out): labels or chopped records altered where they are
produced; a train step that returns its state unchanged; half of a batch
left out, the mean taken over the rest, in the whole step or in the loss
alone. The harness's look for a chip is
skipped: the run is the CPU's, at a tiny size, under the cells' limits."""

from __future__ import annotations

import json

import pytest
import torch

from .conftest import tiny_cell


def _correct(cell, capsys) -> bool:
    from benchmark.run import run_cell

    assert run_cell(cell, 2**31 + 101, 0.3, False, torch.device("cpu"), 0.0) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])["correct"]


def test_sound_runs_are_correct(capsys):
    assert _correct(tiny_cell("hyena", "fused"), capsys)
    assert _correct(tiny_cell("hyena", "train"), capsys)


def test_labels_altered_where_produced(monkeypatch, capsys):
    from deepchopper_tpu_torch.infer.engine import PredictEngine

    step = PredictEngine.step
    monkeypatch.setattr(PredictEngine, "step", lambda self, ids, q: 1 - step(self, ids, q))
    assert not _correct(tiny_cell("hyena", "fused"), capsys)


def test_chopped_records_altered_where_written(monkeypatch, capsys):
    from deepchopper_tpu_torch.infer import fused

    chop_chunk = fused._chop_chunk

    class Altering:
        def __init__(self, writer):
            self.writer = writer

        def write(self, data):
            self.writer.write(bytes(data).replace(b"\n+\n", b"\n+\n!", 1)[:-1] + b"\n")

    monkeypatch.setattr(fused, "_chop_chunk", lambda chunk, opts, writer, stats: chop_chunk(chunk, opts, Altering(writer), stats))
    assert not _correct(tiny_cell("hyena", "fused"), capsys)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "half_batch_loss"])
def test_train_faults(fault, monkeypatch, capsys):
    from deepchopper_tpu_torch.train import step as step_mod

    train_step = step_mod.train_step
    if fault == "half_batch_loss":
        # Half the rows left out of the loss and its gradient alone; the
        # step's (tp, fp, fn, tn) still count every row.
        loss = step_mod.continuous_interval_loss

        def half_loss(logits, labels, *args, **kwargs):
            half = logits.shape[0] // 2 or 1
            return loss(logits[:half], labels[:half], *args, **{**kwargs, "counts": None})

        monkeypatch.setattr(step_mod, "continuous_interval_loss", half_loss)
        assert not _correct(tiny_cell("hyena", "train"), capsys)
        return

    def broken(model, optimizer, batch, *args, **kwargs):
        if fault == "half_batch":
            half = batch["input_ids"].shape[0] // 2 or 1
            return train_step(model, optimizer, {k: v[:half] for k, v in batch.items()}, *args, **kwargs)
        snapshot = [p.detach().clone() for p in model.parameters()]
        out = train_step(model, optimizer, batch, *args, **kwargs)
        with torch.no_grad():
            for p, s in zip(model.parameters(), snapshot):
                p.copy_(s)
        return out

    monkeypatch.setattr(step_mod, "train_step", broken)
    assert not _correct(tiny_cell("hyena", "train"), capsys)
