"""A fine-tuning job's step, as the port's `train` runs it: `train.step.
train_step` with `train.step.make_optimizer`'s Adam, on the batches of
`data.parquet_module.DataModule.train_batches` over a labelled FASTQ, each
moved to the card as `train.loop.Trainer` moves it, the loss and stats read
back every step as `Trainer.fit` reads them.

Set-up builds the model and its optimizer once and drives them through the
first steps on the window's own feed (these are the steps the reference
follows), then one step at every full-batch shape the mix reaches, so that
the cuFFT plans, the allocator and Caduceus's per-shape recompute plan are
all in place. The window runs steps until `--seconds` have passed; the
file holds more batches than the window can take, so every window step is
a full 2^17-token batch.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np

from benchmark.harness.traffic import length_set, make_reads, widths_reached
from benchmark.reference import judge

CHECKED_STEPS = 3


def _to_device(batch, device):
    """The batch's tensors on the card, as `Trainer._device_batch` makes them."""
    import torch

    return {
        "input_ids": torch.from_numpy(batch.input_ids).to(device, torch.int64),
        "input_quals": torch.from_numpy(batch.quals).to(device),
        "labels": torch.from_numpy(batch.labels).to(device, torch.int64),
    }


def _step(model, optimizer, inputs) -> tuple[float, np.ndarray]:
    """One step; its loss and (tp, fp, fn, tn), read back as `Trainer.fit` reads them."""
    from deepchopper_tpu_torch.train.step import train_step

    aux = train_step(model, optimizer, inputs)
    return float(aux["loss"]), aux["stats"].cpu().numpy()


def _warm_inputs(rows: int, width: int, seed: int, device) -> dict:
    """A labelled batch of full reads at (rows, width) for a warm step."""
    import torch

    rng = np.random.default_rng([seed, 5, width])
    ids = rng.integers(7, 11, (rows, width))
    ids[:, -1] = 1
    quals = rng.integers(5, 40, (rows, width)).astype(np.float32)
    quals[:, -1] = 0
    quals /= np.linalg.norm(quals, axis=1, keepdims=True)
    labels = np.zeros((rows, width), np.int64)
    labels[:, width // 3 : width // 3 + 60] = 1
    labels[:, -1] = -100
    return {"input_ids": torch.from_numpy(ids).to(device), "input_quals": torch.from_numpy(quals).to(device),
            "labels": torch.from_numpy(labels).to(device)}  # fmt: skip


def first_steps(cell, seed: int, device, tmp: Path) -> dict:
    """The model, its optimizer and the feed, driven through the checked
    steps: the state `setup` hands on, before its warm steps."""
    import torch

    from deepchopper_tpu_torch.data.parquet_module import DataModule
    from deepchopper_tpu_torch.train.step import make_optimizer

    from benchmark.harness.model import served_model

    mix = cell.traffic
    model, weights = served_model(cell.config, seed, device)
    model.train()
    optimizer = make_optimizer(model.parameters(), mix["learning_rate"])
    reads = make_reads(mix, mix["reads"], seed)
    fq = reads.write_fastq(tmp / "train.fq")
    val = make_reads(mix, 8, seed, stream=1, prefix="val_read").write_fastq(tmp / "val.fq")
    dm = DataModule(train_data_path=str(fq), val_data_path=str(val), max_length=mix["max_length"],
                    tokens_per_batch=mix["tokens_per_batch"], max_batch=mix["max_batch"],
                    shuffle_buffer=mix["shuffle_buffer"], seed=seed)  # fmt: skip
    batches = dm.train_batches(0)
    theta0 = {k: p.detach().to("cpu", copy=True) for k, p in model.named_parameters()}
    checked = {"losses": [], "stats": [], "batches": [], "grad1": None}
    for step in range(mix.get("checked_steps", CHECKED_STEPS)):
        batch = next(batches)
        checked["batches"].append((batch.input_ids.copy(), batch.quals.copy(), batch.labels.copy(), list(batch.read_ids)))
        loss, stats = _step(model, optimizer, _to_device(batch, device))
        checked["losses"].append(loss)
        checked["stats"].append(stats)
        if step == 0:
            beta1 = optimizer.param_groups[0]["betas"][0]
            # Adam's first moment after one step is (1 - beta1) g; a leaf with
            # no state got no gradient.
            moments = {k: optimizer.state.get(p, {}).get("exp_avg") for k, p in model.named_parameters()}
            checked["grad1_vec"] = {k: None if m is None else (m / (1 - beta1)).to("cpu", torch.float32, copy=True)
                                    for k, m in moments.items()}  # fmt: skip
            checked["grad1"] = {k: 0.0 if g is None else float(g.norm()) for k, g in checked["grad1_vec"].items()}
    checked["change"] = {k: float((p.detach().cpu() - theta0[k]).norm()) for k, p in model.named_parameters()}
    return {"model": model, "optimizer": optimizer, "weights": weights, "reads": reads, "batches": batches,
            "checked": checked}  # fmt: skip


def setup(cell, seed: int, device, tmp: Path, tracer) -> dict:
    import torch

    from deepchopper_tpu_torch.data.bucketing import default_buckets

    mix = cell.traffic
    state = first_steps(cell, seed, device, tmp)
    model, optimizer = state["model"], state["optimizer"]
    widths = widths_reached(length_set(mix, mix["reads"]), default_buckets(mix["max_length"]), mix["max_length"])
    for w in widths:
        rows = max(1, min(mix["max_batch"], mix["tokens_per_batch"] // w))
        _step(model, optimizer, _warm_inputs(rows, w, seed, device))
    if device.type == "cuda":
        torch.cuda.synchronize()
    return state


def window(state: dict, seconds: float, tracer) -> dict:
    import torch

    model, optimizer, batches = state["model"], state["optimizer"], state["batches"]
    device = next(model.parameters()).device
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    steps, tokens, wait_s, losses, shapes = 0, 0, 0.0, [], {}
    with tracer.window():
        t0 = time.monotonic()
        while True:
            t_wait = time.monotonic()
            with tracer.span("bench.datamodule"):
                batch = next(batches, None)
            if batch is None:
                raise RuntimeError("the traffic ran out of batches inside the window: give the mix more reads")
            with tracer.span("bench.to_device"):
                inputs = _to_device(batch, device)
            wait_s += time.monotonic() - t_wait
            with tracer.span("bench.train_step"):
                losses.append(_step(model, optimizer, inputs)[0])
            steps += 1
            tokens += int(batch.lengths.sum())
            shape = tuple(batch.input_ids.shape)
            shapes[shape] = shapes.get(shape, 0) + 1
            state.setdefault("window_lengths", []).append(batch.lengths.copy())
            if time.monotonic() - t0 >= seconds:
                break
        window_s = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    return {"window_s": window_s, "steps": steps, "tokens": tokens, "wait_s": wait_s, "losses": losses,
            "shapes": shapes, "peak": peak, "setup_peak": setup_peak if cuda else 0}  # fmt: skip


def release(state: dict) -> None:
    for key in ("model", "optimizer", "batches"):
        state.pop(key)


def check(cell, state: dict, win: dict, device, mode: str = "f32", rows_kept: float = 1.0) -> dict[str, float]:
    """The compared numbers of the first steps against the reference's
    (`judge.train_gaps`), and the rows of their batches that the program
    encoded otherwise than the reference encodes the raw reads."""
    mix, checked = cell.traffic, state["checked"]
    ref_batches, wrong_rows = [], 0
    for ids, quals, labels, read_ids in checked["batches"]:
        ref = judge.reference_batch(state["reads"], read_ids, ids.shape[1], mix["max_length"])
        wrong_rows += judge.batch_mismatches((ids, quals, labels), ref)
        ref_batches.append(ref)
    ref = judge.train_reference(state["weights"], cell.config, ref_batches, mix["learning_rate"], device, mode,
                                rows_kept)  # fmt: skip
    shapes = [tuple(b[0].shape) for b in checked["batches"]]
    print(f"first steps {shapes}: program losses {checked['losses']}, reference {ref['losses']}", file=sys.stderr)
    out = judge.train_gaps(checked, ref, log=lambda text: print(text, file=sys.stderr))
    out["batch_mismatch"] = float(wrong_rows)
    out["window_loss_nonfinite"] = float(sum(not np.isfinite(x) for x in win["losses"]))
    return out


def end_to_end(cell, state: dict, win: dict) -> dict[str, float]:
    return {"train_tokens_per_s": win["tokens"] / win["window_s"], "train_peak_gb": win["peak"] / 1e9}


def layer_inputs(cell, state: dict, win: dict) -> dict:
    from benchmark.counts.flops import forward_flops

    flops = sum(forward_flops(cell.config, int(n)) for lengths in state.get("window_lengths", []) for n in lengths)
    return {
        "kind": "train",
        "window_s": win["window_s"],
        "shapes": win["shapes"],
        "model_flops": 3 * flops,
        "wait_s": win["wait_s"],
    }


def attempted_failed(cell, state: dict, win: dict, compared: dict) -> tuple[int, int]:
    return win["steps"], int(compared["window_loss_nonfinite"])
