"""Port training path (deepchopper_tpu_torch.train, data.parquet_module, the
`train`/`eval` CLI) vs the JAX package, on the CPU.

Inputs are made by numpy from a seed; JAX parameters from `init_params` or
`DeepChopper.new` go through `models/bridge.py` into the port, and so do the
JAX gradients, so every port `param.grad` is compared with its JAX leaf by
name. Both sides run at compute_dtype float32; the mixer runs its plain
versions (JAX: autodiff of its reference in interpret mode; port:
`mixer_bwd_reference`).

Tolerances: loss within 1e-5 relative; each gradient leaf within 1e-4 of its
own max|g| (measured: <= 3.4e-5 on the narrow model, <= 1.7e-5 on the
flagship at L = 256); stats equal. Three
Adam steps at lr 1e-3 are held two ways, with their reasons at each test.

The batches' seeds are fixed. A gradient comparison is void on a batch where
a head ReLU's pre-activation lies within rounding of its kink: the two
packages can then disagree on the ReLU's mask, and a whole token's gradient
enters one side only (narrow model, seed 20: a pre-activation of 3.2e-6
gives a 2.9e-2 error in head.linear1). Such a batch is a tie, not a fault.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepchopper_tpu.models import config as jax_config
from deepchopper_tpu.models.classifier import HyenaTokenClassifier as JaxClassifier
from deepchopper_tpu.models.registry import DeepChopper as JaxDeepChopper
from deepchopper_tpu.models.registry import init_params
from deepchopper_tpu.train import loss as jax_loss
from deepchopper_tpu.train import metrics as jax_metrics
from deepchopper_tpu_torch.data.synth import synth_labelled_fastq
from deepchopper_tpu_torch.models import bridge
from deepchopper_tpu_torch.models.classifier import HyenaTokenClassifier
from deepchopper_tpu_torch.models.config import HeadConfig, HyenaConfig
from deepchopper_tpu_torch.train import loss as port_loss
from deepchopper_tpu_torch.train import metrics as port_metrics
from deepchopper_tpu_torch.train.config import TrainConfig, apply_override, load_config, save_config
from deepchopper_tpu_torch.train.loop import EarlyStopping, PlateauScheduler, Trainer, train
from deepchopper_tpu_torch.train.step import make_optimizer, train_step

REPO = Path(__file__).resolve().parent.parent
GRAD_TOL = 1e-4


def _port_config(cls, jax_cfg):
    return cls(**{f.name: getattr(jax_cfg, f.name) for f in dataclasses.fields(cls)})


def _pair(backbone, head, params):
    """(JAX module, port module) at float32 with the same weights."""
    bb32 = dataclasses.replace(backbone, compute_dtype="float32")
    hd32 = dataclasses.replace(head, compute_dtype="float32")
    jax_mod = JaxClassifier(backbone_config=bb32, head_config=hd32)
    port = HyenaTokenClassifier(_port_config(HyenaConfig, bb32), _port_config(HeadConfig, hd32))
    bridge.load_flax_params(port, jax.tree.map(np.asarray, params))
    return jax_mod, port.train()


def _narrow():
    backbone = jax_config.HyenaConfig(d_model=64, n_layer=2, d_inner=128, max_seq_len=1026)
    head = jax_config.HeadConfig(input_size=64, lin1_size=128, lin2_size=128)
    return backbone, head, init_params(JaxClassifier(backbone_config=backbone, head_config=head), seed=1)


def _flagship():
    bundle = JaxDeepChopper.new("hyenadna-small-32k-seqlen", seed=0)
    return bundle.module.backbone_config, bundle.module.head_config, bundle.params


def _batch(batch: int, seq_len: int, seed: int):
    """ids, normalized quals and 0/1 labels with -100 on the right padding
    of the last row."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(7, 12, (batch, seq_len)).astype(np.int32)
    quals = rng.integers(5, 40, (batch, seq_len)).astype(np.float32)
    labels = (rng.random((batch, seq_len)) < 0.3).astype(np.int32)
    ids[-1, seq_len // 2 :] = 4
    quals[-1, seq_len // 2 :] = 0
    labels[-1, seq_len // 2 :] = -100
    quals /= np.sqrt((quals * quals).sum(-1, keepdims=True))
    return ids, quals, labels


def _torch_batch(ids, quals, labels):
    return {
        "input_ids": torch.from_numpy(ids).long(),
        "input_quals": torch.from_numpy(quals),
        "labels": torch.from_numpy(labels).long(),
    }


def _jax_loss_fn(jax_mod, ids, quals, labels, lam):
    def loss_fn(params):
        logits = jax_mod.apply({"params": params}, jnp.asarray(ids), jnp.asarray(quals))
        return jax_loss.continuous_interval_loss(logits, jnp.asarray(labels), lam), logits

    return loss_fn


# -- loss and metrics ---------------------------------------------------------


@pytest.mark.parametrize("lam", [0.0, 0.5])
def test_loss_and_stats_match_jax(lam):
    rng = np.random.default_rng(int(lam * 10))
    logits = rng.standard_normal((3, 40, 2)).astype(np.float32)
    labels = rng.integers(0, 2, (3, 40)).astype(np.int32)
    labels[1, 25:] = -100  # right padding
    labels[2, :] = -100  # a fully ignored row
    want = float(jax_loss.continuous_interval_loss(jnp.asarray(logits), jnp.asarray(labels), lam))
    got = float(port_loss.continuous_interval_loss(torch.from_numpy(logits), torch.from_numpy(labels).long(), lam))
    assert abs(got - want) <= 1e-6 * abs(want)
    preds = logits.argmax(-1)
    want_stats = np.asarray(jax_metrics.binary_stats_arrays(jnp.asarray(preds), jnp.asarray(labels)))
    got_stats = port_metrics.binary_stats_arrays(torch.from_numpy(preds), torch.from_numpy(labels).long())
    np.testing.assert_array_equal(got_stats.numpy(), want_stats)
    a, b = port_metrics.stats_from_array(got_stats), jax_metrics.stats_from_array(want_stats)
    assert (a.f1, a.precision, a.recall, a.accuracy) == (b.f1, b.precision, b.recall, b.accuracy)


def test_loss_of_an_all_ignored_batch_is_zero():
    logits = torch.randn(2, 8, 2)
    labels = torch.full((2, 8), -100)
    assert float(port_loss.continuous_interval_loss(logits, labels, 0.5)) == 0.0


# -- one train step -----------------------------------------------------------


@pytest.mark.parametrize("model", ["narrow", "flagship"])
def test_train_step_matches_jax_value_and_grad(model):
    backbone, head, params = _narrow() if model == "narrow" else _flagship()
    jax_mod, port = _pair(backbone, head, params)
    ids, quals, labels = _batch(2, 256, seed=11)
    lam = 0.5
    (loss, logits), grads = jax.value_and_grad(_jax_loss_fn(jax_mod, ids, quals, labels, lam), has_aux=True)(params)
    want_grads = bridge.flax_to_state_dict(jax.tree.map(np.asarray, grads))
    want_stats = np.asarray(jax_metrics.binary_stats_arrays(jnp.argmax(logits, -1), jnp.asarray(labels)))

    opt = make_optimizer(port.parameters(), 1e-3)
    aux = train_step(port, opt, _torch_batch(ids, quals, labels), lam)
    assert abs(float(aux["loss"]) - float(loss)) <= 1e-5 * abs(float(loss))
    np.testing.assert_array_equal(aux["stats"].numpy(), want_stats)
    named = dict(port.named_parameters())
    assert named.keys() == want_grads.keys()
    worst = 0.0
    for name, want in want_grads.items():
        got = named[name].grad
        assert got is not None, name
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        assert err <= GRAD_TOL * scale, f"{name}: err {err:.3e}, max|g| {scale:.3e}"
        worst = max(worst, err / scale) if scale else worst
    print(f"{model}: worst gradient error {worst:.2e} of the leaf's max|g|")


ADAM_SEED = 39


def _adam_run(own_gradients: bool):
    """Three Adam steps (lr 1e-3) from the same params in both packages.
    Returns (per-step (port loss, JAX loss), |port - JAX| over all params)."""
    backbone, head, params = _narrow()
    jax_mod, port = _pair(backbone, head, params)
    lr = 1e-3
    tx = optax.adam(lr)
    opt_state = tx.init(params)
    opt = make_optimizer(port.parameters(), lr)
    named = dict(port.named_parameters())
    jparams, losses = params, []
    for step in range(3):
        ids, quals, labels = _batch(2, 256, seed=ADAM_SEED + step)
        (loss, _logits), grads = jax.value_and_grad(_jax_loss_fn(jax_mod, ids, quals, labels, 0.0), has_aux=True)(
            jparams
        )
        updates, opt_state = tx.update(grads, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        if own_gradients:
            got = float(train_step(port, opt, _torch_batch(ids, quals, labels))["loss"])
        else:
            with torch.no_grad():
                logits = port(torch.from_numpy(ids).long(), torch.from_numpy(quals))
            got = float(port_loss.continuous_interval_loss(logits, torch.from_numpy(labels).long()))
            for name, g in bridge.flax_to_state_dict(jax.tree.map(np.asarray, grads)).items():
                named[name].grad = g
            opt.step()
        losses.append((got, float(loss)))
    want = bridge.flax_to_state_dict(jax.tree.map(np.asarray, jparams))
    diffs = torch.cat([(named[k].detach() - v).abs().flatten() for k, v in want.items()])
    return losses, diffs


def test_three_adam_steps_match_optax():
    """The port's optimizer fed JAX's gradients, and the port's forward at the
    parameters it reaches, against optax: per-step loss within 1e-5 relative,
    parameters within 1e-6 on >= 99.9% of entries (measured: all, max
    9.5e-7) and within 6 lr everywhere."""
    losses, diffs = _adam_run(own_gradients=False)
    for step, (got, want) in enumerate(losses):
        assert abs(got - want) <= 1e-5 * abs(want), step
    close = int((diffs <= 1e-6).sum())
    print(f"JAX gradients, 3 Adam steps: {close}/{diffs.numel()} entries within 1e-6, max {float(diffs.max()):.3e}")
    assert close >= 0.999 * diffs.numel()
    assert float(diffs.max()) <= 6e-3


def test_three_adam_steps_on_own_gradients():
    """Each package on its own gradients. Adam's update g / (|g| + 1e-8) is
    steep for the few entries whose gradient is near 1e-8, where the two
    packages' gradients differ by rounding (about 2e-6 of the leaf's max):
    after the first step such entries differ by up to 6e-4, and they shift
    every later gradient at about 1e-3 relative. Measured: losses within
    7.5e-8, 4.8e-6 and 4.0e-4 relative at steps 0, 1, 2; 10,088 of 120,834
    entries within 1e-6, max 2.3e-3 (2.3 lr). So step 0 is held to 1e-5, the
    later steps to 1e-3, every entry to 6 lr."""
    losses, diffs = _adam_run(own_gradients=True)
    print(f"own gradients, 3 Adam steps: losses {losses}; {int((diffs <= 1e-6).sum())}/{diffs.numel()} entries "
          f"within 1e-6, max {float(diffs.max()):.3e}")  # fmt: skip
    for step, (got, want) in enumerate(losses):
        assert abs(got - want) <= (1e-5 if step == 0 else 1e-3) * abs(want), step
    assert float(diffs.max()) <= 6e-3


def test_global_norm_clip_matches_optax():
    from deepchopper_tpu_torch.train.step import clip_by_global_norm_

    rng = np.random.default_rng(0)
    grads = [rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (5,))]
    for max_norm in (0.5, 100.0):
        want, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(g) for g in grads], None)
        params = [torch.nn.Parameter(torch.zeros(g.shape)) for g in grads]
        for p, g in zip(params, grads):
            p.grad = torch.from_numpy(g.copy())
        clip_by_global_norm_(params, max_norm)
        for p, w in zip(params, want):
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(w), rtol=1e-6, atol=0)


# -- data module ----------------------------------------------------------------


def test_datamodule_batches_equal_jax(tmp_path):
    from deepchopper_tpu.data.parquet_module import DataModule as JaxDataModule
    from deepchopper_tpu_torch.data.parquet_module import DataModule

    lengths = np.random.default_rng(3).integers(100, 700, 50)
    fq = synth_labelled_fastq(tmp_path / "reads.fq", lengths, seed=3)
    kw = dict(train_data_path=str(fq), max_length=1024, tokens_per_batch=2048, shuffle_buffer=8, seed=5)
    ours, theirs = DataModule(**kw), JaxDataModule(**kw)
    streams = {
        "train0": (ours.train_batches(0), theirs.train_batches(0)),
        "train1": (ours.train_batches(1), theirs.train_batches(1)),
        "val": (ours.val_batches(), theirs.val_batches()),
        "test": (ours.test_batches(), theirs.test_batches()),
    }
    for name, (got, want) in streams.items():
        got, want = list(got), list(want)
        assert len(got) == len(want) > 0, name
        for a, b in zip(got, want):
            assert a.read_ids == b.read_ids, name
            for field in ("input_ids", "labels", "quals", "ids", "lengths"):
                np.testing.assert_array_equal(getattr(a, field), getattr(b, field), err_msg=f"{name}.{field}")
    assert sum(len(b.read_ids) for b in DataModule(**kw).val_batches()) == 5


def test_datamodule_refuses_parquet(tmp_path, monkeypatch):
    """Where pyarrow cannot be imported, a parquet source raises an
    ImportError that names it (the FASTQ sources above need no pyarrow)."""
    from deepchopper_tpu_torch.data.parquet_module import DataModule

    monkeypatch.setitem(sys.modules, "pyarrow", None)
    monkeypatch.setitem(sys.modules, "pyarrow.parquet", None)
    with pytest.raises(ImportError, match="pyarrow"):
        list(DataModule(train_data_path=str(tmp_path / "train.parquet")).train_batches())


# -- config ---------------------------------------------------------------------


def test_config_yaml_roundtrip(tmp_path):
    yaml = pytest.importorskip("yaml")
    cfg = load_config(None, ["optimizer.lr=1e-8", "model.name=it's", "trainer.gradient_clip=0.5", "seed=3"])
    save_config(cfg, tmp_path / "c.yaml")
    data = yaml.safe_load((tmp_path / "c.yaml").read_text())
    assert data == dataclasses.asdict(cfg)
    loaded = load_config(tmp_path / "c.yaml")
    assert loaded == cfg and loaded.optimizer.lr == 1e-8 and loaded.trainer.limit_val_batches is None


def test_config_overrides_and_unknown_key():
    cfg = load_config(None, ["trainer.max_epochs=7", "model.lambda_penalty=0.5", "train=false", "device=cpu"])
    assert (cfg.trainer.max_epochs, cfg.model.lambda_penalty, cfg.train, cfg.device) == (7, 0.5, False, "cpu")
    with pytest.raises(KeyError):
        apply_override(TrainConfig(), "model.nonexistent", "1")


def test_plateau_and_early_stopping():
    s = PlateauScheduler(factor=0.1, patience=2)
    lr = s.step(1.0, 1.0)
    for _ in range(2):
        lr = s.step(1.5, lr)
    assert lr == 1.0
    assert s.step(1.5, lr) == pytest.approx(0.1)
    es = EarlyStopping(patience=2, mode="max")
    assert not es.step(0.5) and not es.step(0.4) and es.step(0.4) and es.best == 0.5


# -- trainer --------------------------------------------------------------------


def tiny_cfg(fq, out_dir, **over) -> TrainConfig:
    return load_config(
        None,
        [
            f"data.train_data_path={fq}",
            "data.max_length=256",
            "data.tokens_per_batch=4096",
            "data.shuffle_buffer=16",
            "model.name=hyenadna-tiny-1k-seqlen",
            "optimizer.lr=0.002",
            f"output_dir={out_dir}",
            "test=false",
            "device=cpu",
        ]
        + [f"{k}={v}" for k, v in over.items()],
    )


@pytest.fixture(scope="module")
def sep_fastq(tmp_path_factory):
    return synth_labelled_fastq(tmp_path_factory.mktemp("sep") / "train.fq", np.full(100, 180), seed=0)


@pytest.fixture(scope="module")
def fit_run(sep_fastq, tmp_path_factory):
    out = tmp_path_factory.mktemp("out")
    trainer = Trainer(tiny_cfg(sep_fastq, out, **{"trainer.max_epochs": 5}))
    return trainer, trainer.fit(), out


def test_fit_learns_logs_and_checkpoints(fit_run):
    trainer, metrics, out = fit_run
    assert len(trainer.history) == 5
    assert trainer.history[-1]["train/loss"] < trainer.history[0]["train/loss"] * 0.5
    assert metrics["best_val_f1"] >= 0.95
    lines = (out / "train" / "metrics.csv").read_text().strip().splitlines()
    assert len(lines) == 6 and lines[0].startswith("epoch,")
    assert (out / "train" / "config.yaml").exists()
    assert trainer.best_ckpt_path is not None and trainer.best_ckpt_path.exists()
    assert (out / "train" / "checkpoints" / "last.ckpt").exists()
    assert all(np.isfinite(trainer.step_losses)) and trainer.global_step == len(trainer.step_losses)


def test_resume_restores_epoch_and_adam_state(fit_run, sep_fastq, tmp_path):
    from deepchopper_tpu_torch.models.registry import load_checkpoint

    trainer, _metrics, out = fit_run
    last = out / "train" / "checkpoints" / "last.ckpt"
    state, opt_state, meta = load_checkpoint(last)
    assert meta["epoch"] == 4 and meta["step"] == trainer.global_step and meta["lr"] == 0.002
    cfg = tiny_cfg(sep_fastq, tmp_path, **{"trainer.max_epochs": 6})
    cfg.ckpt_path = str(last)
    resumed = Trainer(cfg)
    model, optimizer = resumed._build()
    start, best = resumed._restore(last, model, optimizer)
    assert (start, best, resumed.global_step) == (5, meta["best_metric"], meta["step"])
    for (name, want), got in zip(state.items(), model.state_dict().values()):
        assert torch.equal(got, want), name
    moments = optimizer.state_dict()["state"]
    assert moments.keys() == opt_state["state"].keys()
    for k, st in opt_state["state"].items():
        assert torch.equal(moments[k]["exp_avg"], st["exp_avg"]) and torch.equal(moments[k]["exp_avg_sq"], st["exp_avg_sq"])
    resumed.fit()
    assert [row["epoch"] for row in resumed.history] == [5]


def test_test_on_best_checkpoint(fit_run):
    trainer, _metrics, out = fit_run
    res = trainer.test()
    assert set(res) >= {"loss", "f1", "precision", "recall"} and np.isfinite(res["loss"])
    assert (out / "train" / "test_metrics.json").exists()


def test_fast_dev_run_writes_no_checkpoint(sep_fastq, tmp_path):
    metrics = train(tiny_cfg(sep_fastq, tmp_path, **{"trainer.fast_dev_run": "true"}))
    assert np.isfinite(metrics["best_val_f1"])
    assert not (tmp_path / "train" / "checkpoints").exists()


def test_trainer_refuses_several_devices_and_missing_cuda(sep_fastq, tmp_path):
    # More cards than are visible raise ValueError, as JAX's make_mesh does.
    n = max(2, torch.cuda.device_count() + 1)
    with pytest.raises(ValueError, match=f"requested {n} devices, have {torch.cuda.device_count()}"):
        Trainer(tiny_cfg(sep_fastq, tmp_path, device="cuda", **{"trainer.n_devices": n}))
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    from deepchopper_tpu_torch.device import DeviceUnavailable

    with pytest.raises(DeviceUnavailable):
        Trainer(tiny_cfg(sep_fastq, tmp_path, device="cuda"))
    assert not (tmp_path / "train").exists()


def test_from_checkpoint_checks_head_shapes(fit_run, tmp_path):
    from deepchopper_tpu_torch.models.registry import DeepChopper

    trainer, _metrics, _out = fit_run
    model = DeepChopper.from_checkpoint(trainer.best_ckpt_path, "hyenadna-tiny-1k-seqlen", device="cpu")
    assert not model.training
    with pytest.raises(ValueError, match="shape mismatches"):
        DeepChopper.from_checkpoint(
            trainer.best_ckpt_path, "hyenadna-tiny-1k-seqlen", device="cpu", head_overrides={"lin1_size": 64}
        )
    torch.save(model.state_dict(), tmp_path / "bare.pt")
    bare = DeepChopper.from_checkpoint(tmp_path / "bare.pt", "hyenadna-tiny-1k-seqlen", device="cpu")
    for (name, want), got in zip(model.state_dict().items(), bare.state_dict().values()):
        assert torch.equal(got, want), name


# -- CLI ------------------------------------------------------------------------


def _cli(*args: str, cwd: Path) -> subprocess.CompletedProcess:
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    return subprocess.run(
        [sys.executable, "-m", "deepchopper_tpu_torch", *args], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=300,
    )  # fmt: skip


def test_cli_train_then_predict_from_its_checkpoint(tmp_path):
    fq = synth_labelled_fastq(tmp_path / "reads.fq", np.full(20, 150), seed=1)
    overrides = [f"data.train_data_path={fq}", "data.max_length=256", "model.name=hyenadna-tiny-1k-seqlen",
                 "trainer.max_epochs=1", "output_dir=runs"]  # fmt: skip
    res = _cli("train", *overrides, "--device", "cpu", cwd=tmp_path)
    assert res.returncode == 0, res.stderr
    assert "train done: {" in res.stdout and "test/f1" in res.stdout
    best = sorted((tmp_path / "runs" / "train" / "checkpoints").glob("epoch_*.ckpt"))
    assert best
    res = _cli("predict", str(fq), "--checkpoint", str(best[-1]), "--model", "hyenadna-tiny-1k-seqlen",
               "--max-length", "256", "--device", "cpu", "-o", "pred", cwd=tmp_path)  # fmt: skip
    assert res.returncode == 0, res.stderr
    assert sum(len(np.load(p)["id"]) for p in (tmp_path / "pred" / "0").glob("*.npz")) == 20
    res = _cli("eval", *overrides, f"model.checkpoint={best[-1]}", "--device", "cpu", cwd=tmp_path)
    assert res.returncode == 0, res.stderr
    assert "eval done: {" in res.stdout


def test_cli_train_without_cuda_exits_nonzero_and_writes_nothing(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is available")
    fq = synth_labelled_fastq(tmp_path / "reads.fq", np.full(4, 150), seed=1)
    res = _cli("train", f"data.train_data_path={fq}", "output_dir=runs", cwd=tmp_path)
    assert res.returncode != 0
    assert "CUDA is not available" in res.stderr
    assert not (tmp_path / "runs").exists()
