"""Port sweep (train/sweep.py), trainer loggers and config YAML reader vs the
JAX package, on the CPU.

The sweep's pieces are numpy: for the same seed and history the port's
samples, TPE suggestions and prune decisions must equal JAX's, and
`run_sweep` with the same stub `train_fn` must write the same results.json,
byte for byte. The loggers must write the same files with the same contents
for the same rows; the clock, the uuid and the host name are fixed for both
(the masked fields). A real `train --sweep --device cpu` runs two tiny
trials, the second pruned, in this process and again on two gloo ranks (a
subprocess with a timeout: ranks that disagreed on the prune would hang).
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import uuid
from pathlib import Path

import numpy as np
import pytest
import yaml

from deepchopper_tpu.train import loop as jax_loop
from deepchopper_tpu.train import sweep as jax_sweep
from deepchopper_tpu.train.config import TrainConfig as JaxTrainConfig
from deepchopper_tpu_torch import cli
from deepchopper_tpu_torch.data.synth import synth_labelled_fastq
from deepchopper_tpu_torch.train import loop as port_loop
from deepchopper_tpu_torch.train import sweep as port_sweep
from deepchopper_tpu_torch.train.config import TrainConfig, read_yaml

REPO = Path(__file__).resolve().parent.parent
TIMEOUT = 240  # seconds the two-rank sweep may take before its test fails

SPACE = {
    "optimizer.lr": "interval(1e-4, 1e-1)",
    "optimizer.weight_decay": "interval(0.0, 0.5)",
    "model.lin1_size": "choice(128, 256, 1024)",
    "model.use_identity_layer_for_qual": "choice(false, true)",
    "trainer.max_epochs": "3",
}


def test_search_space_dims_equal_jax():
    assert port_sweep.SearchSpace(SPACE).dims() == jax_sweep.SearchSpace(SPACE).dims()


@pytest.mark.parametrize("seed", [0, 1, 1234])
def test_search_space_samples_equal_jax(seed):
    port_rng, jax_rng = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(5):
        assert port_sweep.SearchSpace(SPACE).sample(port_rng) == jax_sweep.SearchSpace(SPACE).sample(jax_rng)


def _history(n: int, seed: int) -> list[tuple[dict, float]]:
    rng = np.random.default_rng(seed)
    space = jax_sweep.SearchSpace(SPACE)
    out = [(space.sample(rng), float(rng.normal())) for _ in range(n)]
    if n > 2:
        out[1] = (out[1][0], float("inf"))  # a failed trial
    return out


@pytest.mark.parametrize("n_history", [0, 4, 6, 11])
def test_tpe_suggestions_equal_jax(n_history):
    port = port_sweep.TPESampler(port_sweep.SearchSpace(SPACE), seed=7, n_startup_trials=5)
    ref = jax_sweep.TPESampler(jax_sweep.SearchSpace(SPACE), seed=7, n_startup_trials=5)
    history = _history(n_history, seed=n_history)
    for _ in range(3):
        assert port.suggest(history) == ref.suggest(history)


@pytest.mark.parametrize("direction", ["maximize", "minimize"])
@pytest.mark.parametrize("eta", [2, 3])
def test_pruner_decisions_equal_jax(direction, eta):
    port = port_sweep.SuccessiveHalvingPruner(1, eta, direction)
    ref = jax_sweep.SuccessiveHalvingPruner(1, eta, direction)
    rng = np.random.default_rng(eta)
    decisions = []
    for _trial in range(8):
        for epoch in range(9):
            value = float("nan") if rng.random() < 0.05 else float(rng.random())
            got, want = port.report(epoch, value), ref.report(epoch, value)
            assert got == want
            decisions.append(got)
    assert port.rungs == ref.rungs
    assert any(decisions) and not all(decisions)


def _stub(cfg, epoch_callback=None):
    """A trainer stand-in: val/f1 peaks at lr 1e-2, one row per epoch."""
    f1 = float(np.exp(-abs(np.log10(cfg.optimizer.lr) + 2.0)))
    if cfg.model.lin1_size == 1024:
        raise RuntimeError("stub trial failure")
    best = 0.0
    for epoch in range(cfg.trainer.max_epochs):
        best = max(best, f1 * (epoch + 1) / cfg.trainer.max_epochs)
        if epoch_callback is not None:
            try:
                epoch_callback({"epoch": epoch, "val/f1": best})
            except (port_loop.TrialPruned, jax_loop.TrialPruned):
                return {"best_val_f1": best, "pruned": 1.0}
    return {"best_val_f1": best}


def _stub_without_callback(cfg):
    return _stub(cfg)


@pytest.mark.parametrize(
    "variant",
    [
        {"train_fn": _stub},
        {"train_fn": _stub_without_callback},
        {"train_fn": _stub, "sampler": "random"},
        {"train_fn": _stub, "direction": "minimize", "n_startup_trials": 2, "reduction_factor": 2},
    ],
)
def test_run_sweep_writes_the_jax_results_json(variant, tmp_path):
    kwargs = {"n_trials": 9, "seed": 3, "n_startup_trials": 3, **variant}
    space = {k: v for k, v in SPACE.items() if k != "model.use_identity_layer_for_qual"}
    port = port_sweep.run_sweep(TrainConfig(), space, output_dir=tmp_path / "port", **kwargs)
    ref = jax_sweep.run_sweep(JaxTrainConfig(), space, output_dir=tmp_path / "jax", **kwargs)
    assert (tmp_path / "port" / "results.json").read_bytes() == (tmp_path / "jax" / "results.json").read_bytes()
    assert [t.number for t in port] == [t.number for t in ref]
    assert any(not np.isfinite(t.metric) for t in port)  # the failing trials are recorded, not fatal


# -- loggers ---------------------------------------------------------------------


ROWS = [
    {"epoch": 0, "train/loss": 0.5, "val/f1": np.float32(0.25), "lr": 2e-4, "time_s": 1.5},
    {"epoch": 1, "train/loss": 0.25, "val/f1": np.float64(0.5), "lr": 2e-5, "time_s": 1.25, "note": "x"},
]


def _tree(root: Path) -> dict[str, bytes]:
    """Files under root by relative path, the root's absolute path masked."""
    return {str(p.relative_to(root)): p.read_bytes().replace(str(root.resolve()).encode(), b"<root>")
            for p in sorted(root.rglob("*")) if p.is_file()}  # fmt: skip


@pytest.mark.parametrize(
    "names", ["csv", "jsonl", "wandb_offline", "wandb", "mlflow", "csv,jsonl,wandb_offline,mlflow"]
)
def test_loggers_write_the_jax_files(names, tmp_path, monkeypatch):
    import platform
    import time

    monkeypatch.setattr(time, "time", lambda: 1760000000.25)
    monkeypatch.setattr(time, "strftime", lambda fmt, *a: fmt.replace("%", "9"))
    monkeypatch.setattr(uuid, "uuid4", lambda: uuid.UUID(int=0x1234))
    monkeypatch.setattr(platform, "node", lambda: "host")
    run_config = dataclasses.asdict(TrainConfig())
    for pkg, root in ((port_loop, tmp_path / "port"), (jax_loop, tmp_path / "jax")):
        logger = pkg.MultiLogger(root, names, run_config)
        for row in ROWS:
            logger.log(row)
    port, ref = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert port and port == ref


def test_trainer_records_its_config_in_the_wandb_and_mlflow_files(tmp_path):
    fq = synth_labelled_fastq(tmp_path / "reads.fq", np.full(12, 120), seed=2)
    rc = cli.main(["train", f"data.train_data_path={fq}", "data.max_length=256", "model.name=hyenadna-tiny-1k-seqlen",
                   "trainer.max_epochs=1", "trainer.loggers=wandb_offline,mlflow", f"output_dir={tmp_path}",
                   "--device", "cpu"])  # fmt: skip
    assert rc == 0
    out = tmp_path / "train"
    meta = json.loads(next(out.glob("wandb/offline-run-*/files/wandb-metadata.json")).read_text())
    assert meta["config"]["model"]["name"] == "hyenadna-tiny-1k-seqlen" and meta["config"]["device"] == "cpu"
    history = next(out.glob("wandb/offline-run-*/files/wandb-history.jsonl")).read_text().splitlines()
    assert len(history) == 1 and json.loads(history[0])["_step"] == 0
    run = next(p for p in (out / "mlruns" / "0").iterdir() if p.is_dir())
    assert (run / "params" / "seed").read_text() == "None"
    assert len((run / "metrics" / "val" / "f1").read_text().splitlines()) == 1


# -- YAML -------------------------------------------------------------------------


@pytest.mark.parametrize("path", sorted(str(p.relative_to(REPO)) for p in (REPO / "configs").rglob("*.yaml")))
def test_read_yaml_equals_pyyaml_on_every_config(path):
    text = (REPO / path).read_text()
    assert read_yaml(text) == yaml.safe_load(text)


def test_read_yaml_resolves_scalars_as_pyyaml():
    text = (
        "a: 1\nb: 1.0e-3\nc: 1e-3\nd: '1'\ne: \"x # y\"   # note\nf:\n  g: true\n  h: null\n  i: ~\n  j:\n"
        "k: .inf\nl: -3\nm: 010\nn: 0x1f\no: 1_000\np: choice(false, true)\nq: yes\nr: 1.5e+3\ns: 'it''s'\n"
    )
    assert read_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", ["a:\n  - 1\n", "a: [1, 2]\n", "a: {b: 1}\n", "a: &x 1\n", "a: |\n  text\n"])
def test_read_yaml_refuses_other_forms(text):
    with pytest.raises(ValueError):
        read_yaml(text)


# -- train --sweep ------------------------------------------------------------------


SWEEP_YAML = """\
# Two trials; the second (lr 0.002, above the first's 0.001 at the rung of
# epoch 1, monitor lr, minimized) is pruned after its first epoch.
n_trials: 2
n_startup_trials: 5
optimized_metric: best_val_f1
direction: maximize
monitor: lr
monitor_mode: minimize
reduction_factor: 2
params:
  model.lin1_size: choice(64, 128)
  optimizer.lr: choice(0.002, 0.001)
"""


def _sweep_args(tmp: Path, fq: Path, out: str, *extra: str) -> list[str]:
    return ["train", "--sweep", str(tmp / "sweep.yaml"), f"data.train_data_path={fq}", "data.max_length=256",
            "data.tokens_per_batch=4096", "model.name=hyenadna-tiny-1k-seqlen", "trainer.max_epochs=2",
            "trainer.loggers=csv", "seed=0", f"output_dir={tmp / out}", *extra, "--device", "cpu"]  # fmt: skip


@pytest.fixture(scope="module")
def sweep_data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sweep")
    (tmp / "sweep.yaml").write_text(SWEEP_YAML)
    return tmp, synth_labelled_fastq(tmp / "reads.fq", np.full(24, 150), seed=3)


def _trials(path: Path) -> list[dict]:
    return sorted(json.loads(path.read_text()), key=lambda t: t["number"])


def test_train_sweep_on_the_cpu_prunes_the_second_trial(sweep_data):
    tmp, fq = sweep_data
    assert cli.main(_sweep_args(tmp, fq, "one")) == 0
    trials = _trials(tmp / "one" / "sweep" / "results.json")
    assert [t["overrides"] for t in trials] == [{"model.lin1_size": "128", "optimizer.lr": "0.001"},
                                                {"model.lin1_size": "128", "optimizer.lr": "0.002"}]  # fmt: skip
    assert [t["pruned"] for t in trials] == [False, True]
    assert all(np.isfinite(t["metric"]) for t in trials)
    # The pruned trial stopped after one epoch; the other ran both.
    rows = [(tmp / "one" / "sweep" / f"trial_{i}" / "train" / "metrics.csv").read_text().splitlines() for i in (0, 1)]
    assert [len(r) - 1 for r in rows] == [2, 1]


def test_train_sweep_on_two_ranks_stops_every_rank_together(sweep_data):
    tmp, fq = sweep_data
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.Popen([sys.executable, "-m", "deepchopper_tpu_torch", *_sweep_args(tmp, fq, "two",
                             "trainer.n_devices=2")], cwd=tmp, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)  # fmt: skip
    try:
        stdout, stderr = proc.communicate(timeout=TIMEOUT)
    finally:
        proc.kill()
    assert proc.returncode == 0, stderr[-3000:]
    assert stdout.count("sweep done:") == 1
    trials = _trials(tmp / "two" / "sweep" / "results.json")
    assert [t["pruned"] for t in trials] == [False, True]
    assert [t["overrides"]["optimizer.lr"] for t in trials] == ["0.001", "0.002"]
    assert all(np.isfinite(t["metric"]) for t in trials)


def test_train_sweep_without_cuda_exits_nonzero_before_any_trial(sweep_data, tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is available")
    tmp, fq = sweep_data
    args = _sweep_args(tmp, fq, str(tmp_path / "none"))[:-2]  # drop --device cpu
    assert cli.main(args) == 2
    assert not (tmp_path / "none").exists()
