"""Training/eval orchestration: epoch loop, callbacks, checkpoints, loggers.

Port of `deepchopper_tpu/train/loop.py`: ModelCheckpoint top-1 on
`callbacks.monitor` plus last, EarlyStopping, ReduceLROnPlateau on val/loss,
fast_dev_run, overfit_batches, limit_*_batches and test-on-best.
Checkpoints carry the epoch, the step, the best metric, the lr and the full
optimizer state, so a resume keeps Adam's moments.

Over several ranks (`trainer.n_devices`, `parallel/`) the JAX loop's
batch-sharded mesh becomes DDP, one rank a card. Every rank reads the same
seeded batch stream; a batch's rows are padded to a multiple of the ranks
and rank r steps on the row block [r B/n, (r+1) B/n), as a batch-sharded
`NamedSharding` lays them out, with the global batch's loss denominators
(`loss.loss_counts`) and gradients summed, not averaged: the loss and the
gradients are those of one device running the whole batch. Val and test
metrics are summed over the ranks, so the plateau scheduler and early
stopping step alike everywhere; checkpoints, the config and the loggers are
written by rank 0 alone, each followed by a barrier.

What differs from the JAX loop: one rank's rows are not padded to a multiple
of 8 (that padding only avoided XLA recompiles); the wandb-offline and mlflow
loggers are not ported yet (ROADMAP.md queue 1, item 7).
"""

from __future__ import annotations

import csv
import dataclasses
import itertools
import json
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from .. import default
from ..data.bucketing import Batch
from ..data.parquet_module import DataModule
from ..device import resolve_device
from ..models.registry import DeepChopper, load_checkpoint, load_state_strict, save_checkpoint
from ..parallel import all_reduce_sum, barrier, check_world, local_device, process_shard_info
from ..utils.pylogger import RankedLogger
from .config import TrainConfig, format_config_tree, save_config
from .loss import loss_counts
from .metrics import BinaryStats, stats_from_array
from .step import eval_step, get_lr, make_optimizer, set_lr, train_step

log = RankedLogger(__name__, rank_zero_only=True)  # one line a run, not one a rank


@dataclasses.dataclass
class PlateauScheduler:
    """ReduceLROnPlateau (mode=min, factor=0.1, patience=10 by default)."""

    factor: float = 0.1
    patience: int = 10
    min_lr: float = 0.0
    best: float = float("inf")
    bad_epochs: int = 0

    def step(self, metric: float, lr: float) -> float:
        if metric < self.best:
            self.best = metric
            self.bad_epochs = 0
            return lr
        self.bad_epochs += 1
        if self.bad_epochs > self.patience:
            self.bad_epochs = 0
            return max(lr * self.factor, self.min_lr)
        return lr


@dataclasses.dataclass
class EarlyStopping:
    patience: int = 40
    mode: str = "max"
    min_delta: float = 0.0
    best: float | None = None
    bad_epochs: int = 0

    def improved(self, value: float) -> bool:
        if self.best is None:
            return True
        if self.mode == "max":
            return value > self.best + self.min_delta
        return value < self.best - self.min_delta

    def step(self, value: float) -> bool:
        """Record a metric; returns True when training should stop."""
        if self.improved(value):
            self.best = value
            self.bad_epochs = 0
            return False
        self.bad_epochs += 1
        return self.bad_epochs >= self.patience


class CsvLogger:
    """Per-epoch metrics CSV."""

    def __init__(self, path: Path):
        self.path = path
        self._fields: list[str] | None = None

    def log(self, row: dict[str, Any]) -> None:
        row = {k: (f"{v:.6g}" if isinstance(v, float) else v) for k, v in row.items()}
        new = self._fields is None
        if new:
            self._fields = list(row)
            self.path.parent.mkdir(parents=True, exist_ok=True)
        with open(self.path, "a", newline="") as fh:
            w = csv.DictWriter(fh, fieldnames=self._fields, extrasaction="ignore")
            if new:
                w.writeheader()
            w.writerow(row)


class JsonlLogger:
    """Per-epoch metrics as JSON lines."""

    def __init__(self, path: Path):
        self.path = path

    def log(self, row: dict[str, Any]) -> None:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        with open(self.path, "a") as fh:
            fh.write(json.dumps({k: _jsonable(v) for k, v in row.items()}) + "\n")


def _jsonable(v: Any) -> Any:
    if isinstance(v, (np.floating, np.integer)):
        return v.item()
    return v


class MultiLogger:
    """Fan a metrics row out to several backends (csv, tensorboard, jsonl)."""

    def __init__(self, out_dir: Path, names: str):
        self.backends: list[Any] = []
        for name in (n.strip() for n in names.split(",") if n.strip()):
            if name == "csv":
                self.backends.append(CsvLogger(out_dir / "metrics.csv"))
            elif name == "tensorboard":
                from .tb_logger import TensorBoardLogger

                self.backends.append(TensorBoardLogger(out_dir / "tb"))
            elif name == "jsonl":
                self.backends.append(JsonlLogger(out_dir / "metrics.jsonl"))
            elif name in ("wandb", "wandb_offline", "mlflow"):
                log.warning("logger backend %r is not ported yet (ROADMAP.md queue 1, item 7)", name)
            else:
                log.warning("unknown logger backend %r (csv, tensorboard, jsonl)", name)

    def log(self, row: dict[str, Any]) -> None:
        for b in self.backends:
            b.log(dict(row))


def param_count(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


class TrialPruned(Exception):
    """Raised by an epoch callback to stop an unpromising sweep trial early."""


def world_size(cfg: TrainConfig) -> int:
    """The ranks the CLI's `train` and `eval` start for `cfg`:
    `trainer.n_devices`, where None is every visible card, or 1 on the CPU.
    Raises ValueError for more cards than are visible and DeviceUnavailable
    when the card is missing."""
    n = cfg.trainer.n_devices
    if n is not None and n > 1:
        check_world(n, cfg.device)
        return n
    if resolve_device(cfg.device).type == "cpu":
        return 1
    return torch.cuda.device_count() if n is None else 1


def rank_block(a: np.ndarray, fill, rank: int, world: int) -> np.ndarray:
    """Rank `rank`'s block of a batch's rows, the rows first padded with
    `fill` up to a multiple of `world`: rows [r B/n, (r+1) B/n)."""
    rows = -(-len(a) // world)
    pad = rows * world - len(a)
    if pad:
        a = np.concatenate([a, np.full((pad, *a.shape[1:]), fill, a.dtype)])
    return a[rank * rows : (rank + 1) * rows]


def _sum_gradients(state, bucket):
    """DDP communication hook: sum a bucket of gradients over the ranks
    (DDP's default divides the sum by the world size). Unannotated: DDP
    checks a hook's annotations against its own types, and this module's
    are strings."""
    del state
    return dist.all_reduce(bucket.buffer(), async_op=True).get_future().then(lambda fut: fut.value()[0])


def data_parallel(model: torch.nn.Module, device: torch.device) -> torch.nn.parallel.DistributedDataParallel:
    """`model` under DDP with its gradients summed over the ranks: each rank's
    loss is its rows' share of the global mean (`loss.loss_counts`), so the
    sum is the global gradient, where DDP's default average would be the
    mean of the ranks' own means."""
    ddp = torch.nn.parallel.DistributedDataParallel(model, device_ids=[device] if device.type == "cuda" else None)
    ddp.register_comm_hook(None, _sum_gradients)
    return ddp


class Trainer:
    """Epoch loop + callbacks over `train_step`, on one device or on one rank
    of several (a process group set up by `parallel.launch` or a launcher)."""

    def __init__(self, cfg: TrainConfig, epoch_callback=None):
        """`epoch_callback(row)` is invoked after every epoch with the metrics
        row; raising `TrialPruned` from it ends fit() early.

        The ranks are those of the process group this process is in (one
        without a group); `trainer.n_devices` None takes them as they are.
        Raises DeviceUnavailable when cfg.device is "cuda" and there is no
        CUDA, and ValueError when an explicit `trainer.n_devices` asks for
        more cards than are visible or differs from the group's size."""
        self.rank, self.world = process_shard_info()
        n = cfg.trainer.n_devices
        if n is not None and n > 1:
            check_world(n, cfg.device)
        if n is not None and n != self.world:
            raise ValueError(
                f"trainer.n_devices={n} and this process is one of {self.world} ranks: start the ranks with "
                "parallel.launch (the CLI's train and eval do) or a launcher"
            )
        self.cfg = cfg
        self.device = local_device(cfg.device)
        self.out_dir = Path(cfg.output_dir) / cfg.task_name
        self.ckpt_dir = self.out_dir / "checkpoints"
        self.logger = MultiLogger(self.out_dir, cfg.trainer.loggers if self.rank == 0 else "")
        self.history: list[dict[str, float]] = []
        self.step_losses: list[float] = []
        self.global_step = 0
        self.best_ckpt_path: Path | None = None
        self.epoch_callback = epoch_callback
        self.pruned = False

    # -- setup -------------------------------------------------------------

    def _build(self) -> tuple[torch.nn.Module, torch.optim.Optimizer]:
        cfg = self.cfg
        head_overrides = {
            k: v
            for k, v in (
                ("lin1_size", cfg.model.lin1_size),
                ("use_identity_layer_for_qual", cfg.model.use_identity_layer_for_qual),
            )
            if v is not None
        }
        if cfg.model.checkpoint:
            model = DeepChopper.from_checkpoint(
                cfg.model.checkpoint, cfg.model.name, device=self.device, head_overrides=head_overrides or None
            )
        elif cfg.model.torch_checkpoint:
            model = DeepChopper.from_pretrained(
                cfg.model.name, torch_checkpoint=cfg.model.torch_checkpoint, device=self.device
            )
        else:
            model = DeepChopper.new(
                cfg.model.name, seed=cfg.seed or 0, device=self.device, head_overrides=head_overrides or None
            )
        model.train()
        optimizer = make_optimizer(model.parameters(), cfg.optimizer.lr, cfg.optimizer.weight_decay)
        return model, optimizer

    def _device_batch(self, batch: Batch) -> tuple[dict[str, torch.Tensor], tuple[int, int] | None]:
        """This rank's rows of `batch` on its device, and the denominators of
        the whole batch's loss (None for one rank: the rows are the batch)."""
        ids, quals, labels = batch.input_ids, batch.quals, batch.labels
        counts = None
        if self.world > 1:
            counts = loss_counts(labels)
            ids = rank_block(ids, default.TOKEN_PAD, self.rank, self.world)
            quals = rank_block(quals, 0, self.rank, self.world)
            labels = rank_block(labels, default.IGNORE_LABEL, self.rank, self.world)
        dev = self.device
        tensors = {
            "input_ids": torch.from_numpy(ids).to(dev, torch.int64),
            "input_quals": torch.from_numpy(quals).to(dev),
            "labels": torch.from_numpy(labels).to(dev, torch.int64),
        }
        return tensors, counts

    def _on_rank_zero(self, write, *args) -> None:
        """Run a writer on rank 0 alone, then wait for every rank."""
        if self.rank == 0:
            write(*args)
        barrier("deepchopper_rank0_write")

    # -- loops -------------------------------------------------------------

    def _run_eval(self, model, batches, limit: int | None) -> dict[str, float]:
        total = BinaryStats()
        losses: list[float] = []
        for i, batch in enumerate(batches):
            if limit is not None and i >= limit:
                break
            inputs, counts = self._device_batch(batch)
            out = eval_step(model, inputs, self.cfg.model.lambda_penalty, counts)
            losses.append(float(out["loss"]))
            total = total + stats_from_array(out["stats"].cpu())
        return {
            "loss": float(np.mean(losses)) if losses else float("nan"),
            "f1": total.f1,
            "precision": total.precision,
            "recall": total.recall,
            "acc": total.accuracy,
        }

    def fit(self, datamodule: DataModule | None = None) -> dict[str, float]:
        cfg = self.cfg
        dm = datamodule or DataModule(**dataclasses.asdict(cfg.data))
        save_ckpts = True
        if cfg.trainer.fast_dev_run:
            # One batch, one epoch, no checkpoints.
            cfg = dataclasses.replace(
                cfg,
                trainer=dataclasses.replace(cfg.trainer, max_epochs=1, limit_train_batches=1, limit_val_batches=1),
            )
            save_ckpts = False
            log.info("fast_dev_run: 1 batch / 1 epoch / no checkpoints")
        overfit_cache: list | None = None
        if cfg.trainer.overfit_batches:
            # Train AND validate on the same cached batches.
            overfit_cache = list(itertools.islice(dm.train_batches(0), cfg.trainer.overfit_batches))
            log.info("overfit mode: %d cached batches", len(overfit_cache))
        model, optimizer = self._build()
        step_model = data_parallel(model, self.device) if self.world > 1 else model
        log.info("model %s: %d params on %s, %d rank(s)", cfg.model.name, param_count(model), self.device, self.world)
        if self.rank == 0:
            self.out_dir.mkdir(parents=True, exist_ok=True)
            save_config(cfg, self.out_dir / "config.yaml")
            log.info("run config:\n%s", format_config_tree(cfg))

        plateau = PlateauScheduler(cfg.optimizer.plateau_factor, cfg.optimizer.plateau_patience, cfg.optimizer.min_lr)
        stopper = EarlyStopping(cfg.callbacks.early_stop_patience, cfg.callbacks.monitor_mode, cfg.callbacks.min_delta)
        best_metric: float | None = None
        mode_max = cfg.callbacks.monitor_mode == "max"

        start_epoch = 0
        if cfg.ckpt_path:
            start_epoch, best_metric = self._restore(cfg.ckpt_path, model, optimizer)
            log.info("resumed from %s at epoch %d", cfg.ckpt_path, start_epoch)
            if best_metric is not None:
                stopper.best = best_metric

        for epoch in range(start_epoch, cfg.trainer.max_epochs):
            t0 = time.monotonic()
            train_stats = BinaryStats()
            train_losses: list[float] = []
            train_src = overfit_cache if overfit_cache is not None else dm.train_batches(epoch)
            for i, batch in enumerate(train_src):
                if cfg.trainer.limit_train_batches is not None and i >= cfg.trainer.limit_train_batches:
                    break
                inputs, counts = self._device_batch(batch)
                aux = train_step(step_model, optimizer, inputs, cfg.model.lambda_penalty, cfg.trainer.gradient_clip,
                                 counts)  # fmt: skip
                self.global_step += 1
                train_losses.append(float(aux["loss"]))
                self.step_losses.append(train_losses[-1])
                train_stats = train_stats + stats_from_array(aux["stats"].cpu())
                if i % cfg.trainer.log_every_n_steps == 0:
                    log.info("epoch %d step %d loss=%.4f", epoch, i, train_losses[-1])

            val = self._run_eval(
                model,
                iter(overfit_cache) if overfit_cache is not None else dm.val_batches(),
                cfg.trainer.limit_val_batches,
            )
            lr = get_lr(optimizer)
            new_lr = plateau.step(val["loss"], lr)
            if new_lr != lr:
                log.info("plateau: lr %.2e -> %.2e", lr, new_lr)
                set_lr(optimizer, new_lr)

            row = {
                "epoch": epoch,
                "train/loss": float(np.mean(train_losses)) if train_losses else float("nan"),
                "train/f1": train_stats.f1,
                "val/loss": val["loss"],
                "val/f1": val["f1"],
                "val/precision": val["precision"],
                "val/recall": val["recall"],
                "lr": new_lr,
                "time_s": time.monotonic() - t0,
            }
            self.history.append(row)
            self.logger.log(row)  # rank 0's backends; the others have none
            log.info(
                "epoch %d: train/loss=%.4f val/loss=%.4f val/f1=%.4f (%.1fs)",
                epoch, row["train/loss"], val["loss"], val["f1"], row["time_s"],
            )  # fmt: skip

            monitored = val[cfg.callbacks.monitor.split("/")[-1]]
            improved = best_metric is None or (monitored > best_metric if mode_max else monitored < best_metric)
            if improved:
                best_metric = monitored
                if save_ckpts:
                    self.best_ckpt_path = self.ckpt_dir / f"epoch_{epoch:03d}_f1_{val['f1']:.4f}.ckpt"
                    self._save(self.best_ckpt_path, model, optimizer, epoch, best_metric)
                    log.info("new best %s=%.4f -> %s", cfg.callbacks.monitor, monitored, self.best_ckpt_path)
            if cfg.callbacks.save_last and save_ckpts:
                self._save(self.ckpt_dir / "last.ckpt", model, optimizer, epoch, best_metric)

            if self.epoch_callback is not None:
                try:
                    self.epoch_callback(row)
                except TrialPruned:
                    self.pruned = True
                    log.info("trial pruned at epoch %d", epoch)
                    break

            if stopper.step(monitored):
                log.info("early stopping at epoch %d (patience %d)", epoch, stopper.patience)
                break

        key = "best_" + cfg.callbacks.monitor.replace("/", "_")
        result = {key: best_metric if best_metric is not None else float("nan")}
        self._on_rank_zero((self.out_dir / "result.json").write_text, json.dumps(result))
        return result

    def test(self, datamodule: DataModule | None = None, ckpt_path: str | Path | None = None) -> dict[str, float]:
        """Test on the best checkpoint (or `ckpt_path`)."""
        cfg = self.cfg
        dm = datamodule or DataModule(**dataclasses.asdict(cfg.data))
        ckpt = ckpt_path or self.best_ckpt_path
        if ckpt is not None:
            cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, checkpoint=str(ckpt)))
            self.cfg = cfg
        model, _optimizer = self._build()
        metrics = self._run_eval(model, dm.test_batches(), None)
        row = {"epoch": -1, **{f"test/{k}": v for k, v in metrics.items()}}
        self._on_rank_zero(self._write_json, self.out_dir / "test_metrics.json", row)
        log.info("test: %s", row)
        return metrics

    @staticmethod
    def _write_json(path: Path, row: dict) -> None:
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(row))

    # -- checkpoint io -----------------------------------------------------

    def _save(self, path: Path, model, optimizer, epoch: int, best: float | None) -> None:
        """Write a checkpoint of `model` (never its DDP wrapper) from rank 0."""
        meta = {"epoch": epoch, "step": self.global_step, "best_metric": best, "model": self.cfg.model.name,
                "lr": get_lr(optimizer)}  # fmt: skip
        self._on_rank_zero(save_checkpoint, path, model, optimizer.state_dict(), meta)

    def _restore(self, path: str | Path, model, optimizer) -> tuple[int, float | None]:
        state, opt_state, meta = load_checkpoint(path)
        load_state_strict(model, state, path)
        if opt_state is not None:
            optimizer.load_state_dict(opt_state)
        elif meta.get("lr") is not None:
            set_lr(optimizer, float(meta["lr"]))
        self.global_step = int(meta.get("step", 0))
        return int(meta.get("epoch", -1)) + 1, meta.get("best_metric")


# ---------------------------------------------------------------------------
# Task entry points
# ---------------------------------------------------------------------------


def train(cfg: TrainConfig, epoch_callback=None) -> dict[str, float]:
    """Train, then test on the best checkpoint when cfg.test is set."""
    if cfg.seed is not None:
        np.random.seed(cfg.seed)
        torch.manual_seed(cfg.seed)
    trainer = Trainer(cfg, epoch_callback=epoch_callback)
    metrics: dict[str, float] = {}
    if cfg.train:
        metrics.update(trainer.fit())
        if trainer.pruned:
            metrics["pruned"] = 1.0
    if cfg.test and not trainer.pruned:
        metrics.update({f"test/{k}": v for k, v in trainer.test().items()})
    return metrics


def evaluate(cfg: TrainConfig) -> dict[str, float]:
    """Evaluate a checkpoint on the test split, or predict when
    data.predict_data_path is set."""
    trainer = Trainer(cfg)
    if cfg.data.predict_data_path:
        from ..infer.engine import PredictEngine

        model = (
            DeepChopper.from_checkpoint(cfg.model.checkpoint, cfg.model.name, device=trainer.device)
            if cfg.model.checkpoint
            else DeepChopper.new(cfg.model.name, device=trainer.device)
        )
        engine = PredictEngine(
            model, max_length=cfg.data.max_length, tokens_per_batch=cfg.data.tokens_per_batch, device=trainer.device
        )
        # Over several ranks each writes its own {rank}_{batch} shards.
        stats = engine.predict_file(cfg.data.predict_data_path, trainer.out_dir / "predictions")
        reads = all_reduce_sum(torch.tensor([stats.reads], dtype=torch.int64, device=trainer.device))
        return {"predict/reads": float(reads.item())}
    return {f"test/{k}": v for k, v in trainer.test(ckpt_path=cfg.model.checkpoint).items()}
