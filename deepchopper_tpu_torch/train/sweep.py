"""Hyperparameter search over the trainer: TPE sampling + ASHA-style pruning.

Copy of `deepchopper_tpu/train/sweep.py` (numpy only): `SearchSpace` (the
Hydra/Optuna grammar `interval(lo, hi)`, log-uniform when both bounds are
positive and span >= 10x, `choice(a, b, ...)`, or a literal fixed value),
`TPESampler` (after `n_startup` random trials, Parzen densities l(x)/g(x)
over the good and bad trials, categorical dimensions by smoothed
frequencies), `SuccessiveHalvingPruner` (ASHA rungs at epochs r, r*eta,
r*eta^2, ...: a trial below the top-1/eta quantile of its rung is pruned),
`Trial` and `run_sweep`, which writes `results.json`.

Each trial of `run_sweep`'s own trainer runs on the ranks `train` would use
(`loop.on_ranks`: `trainer.n_devices`, one rank a card, or a launcher's).
Over several ranks rank 0 takes the prune decision from a copy of the
sweep's pruner and every rank stops at the same epoch; the trial returns
the values it reported at each epoch, and the sweep's pruner learns them in
order, as one process would have reported them.
"""

from __future__ import annotations

import copy
import dataclasses
import inspect
import json
import logging
import math
import re
from pathlib import Path
from typing import Any

import numpy as np
import torch

from ..device import DeviceUnavailable
from ..parallel import all_reduce_sum, local_device, process_shard_info
from .config import TrainConfig, apply_override, load_config
from .loop import TrialPruned, on_ranks, train

log = logging.getLogger(__name__)

_INTERVAL = re.compile(r"interval\(\s*([-\d.eE+]+)\s*,\s*([-\d.eE+]+)\s*\)")
_CHOICE = re.compile(r"choice\((.*)\)")

@dataclasses.dataclass
class SearchSpace:
    """key -> spec string, e.g. {"optimizer.lr": "interval(1e-4, 1e-1)",
    "model.name": "choice(cnn, transformer)"}."""

    params: dict[str, str]

    def dims(self) -> dict[str, tuple[str, Any]]:
        """Parsed dimensions: key -> ("log"|"lin", (lo, hi)) or ("cat", opts)."""
        out: dict[str, tuple[str, Any]] = {}
        for key, spec in self.params.items():
            m = _INTERVAL.fullmatch(spec.strip())
            if m:
                lo, hi = float(m.group(1)), float(m.group(2))
                kind = "log" if lo > 0 and hi / lo >= 10 else "lin"
                out[key] = (kind, (lo, hi))
                continue
            m = _CHOICE.fullmatch(spec.strip())
            if m:
                out[key] = ("cat", [o.strip() for o in m.group(1).split(",")])
                continue
            out[key] = ("fixed", spec)
        return out

    def sample(self, rng: np.random.Generator) -> dict[str, Any]:
        out: dict[str, Any] = {}
        for key, (kind, arg) in self.dims().items():
            if kind in ("log", "lin"):
                lo, hi = arg
                if kind == "log":
                    out[key] = float(np.exp(rng.uniform(math.log(lo), math.log(hi))))
                else:
                    out[key] = float(rng.uniform(lo, hi))
            elif kind == "cat":
                out[key] = arg[int(rng.integers(len(arg)))]
            else:
                out[key] = arg
        return out


class TPESampler:
    """Independent-dimension TPE (the sampler the reference configures,
    optuna.samplers.TPESampler with n_startup_trials, hyena_optuna.yaml:40-44).
    """

    def __init__(
        self,
        space: SearchSpace,
        seed: int = 1234,
        n_startup_trials: int = 5,
        gamma: float = 0.25,
        n_candidates: int = 24,
    ):
        self.space = space
        self.rng = np.random.default_rng(seed)
        self.n_startup = n_startup_trials
        self.gamma = gamma
        self.n_candidates = n_candidates

    # -- Parzen pieces -----------------------------------------------------

    @staticmethod
    def _parzen_logpdf(x: np.ndarray, obs: np.ndarray, lo: float, hi: float) -> np.ndarray:
        """log density of a Parzen mixture over `obs` evaluated at `x`,
        with a flat prior component over [lo, hi]."""
        span = hi - lo
        bw = max(span / max(len(obs), 1) * 1.5, 1e-3 * span, 1e-12)
        # components: each observation + one uniform prior over the range
        diffs = (x[:, None] - obs[None, :]) / bw
        comp = -0.5 * diffs**2 - math.log(bw * math.sqrt(2 * math.pi))
        prior = np.full((x.shape[0], 1), -math.log(max(span, 1e-12)))
        allc = np.concatenate([comp, prior], axis=1)
        m = allc.max(axis=1, keepdims=True)
        return (m[:, 0] + np.log(np.exp(allc - m).mean(axis=1)))

    def suggest(self, history: list[tuple[dict[str, Any], float]]) -> dict[str, Any]:
        """history: [(overrides, signed_metric)] where LOWER is better
        (run_sweep passes sign-corrected values)."""
        finite = [(o, v) for o, v in history if np.isfinite(v)]
        if len(finite) < self.n_startup:
            return self.space.sample(self.rng)
        finite.sort(key=lambda t: t[1])
        n_good = max(1, int(math.ceil(self.gamma * len(finite))))
        good = [o for o, _ in finite[:n_good]]
        bad = [o for o, _ in finite[n_good:]] or good

        out: dict[str, Any] = {}
        for key, (kind, arg) in self.space.dims().items():
            if kind in ("log", "lin"):
                lo, hi = arg
                tf = (lambda v: math.log(v)) if kind == "log" else (lambda v: v)
                inv = (lambda v: float(np.exp(v))) if kind == "log" else float
                tlo, thi = tf(lo), tf(hi)
                g_obs = np.array([tf(o[key]) for o in good if key in o])
                b_obs = np.array([tf(o[key]) for o in bad if key in o])
                if len(g_obs) == 0:
                    out[key] = inv(self.rng.uniform(tlo, thi))
                    continue
                # candidates drawn from the good mixture (+ uniform exploration)
                picks = self.rng.integers(len(g_obs) + 1, size=self.n_candidates)
                bw = max((thi - tlo) / max(len(g_obs), 1) * 1.5, 1e-3 * (thi - tlo))
                cand = np.where(
                    picks < len(g_obs),
                    g_obs[np.minimum(picks, len(g_obs) - 1)]
                    + self.rng.normal(0, bw, self.n_candidates),
                    self.rng.uniform(tlo, thi, self.n_candidates),
                )
                cand = np.clip(cand, tlo, thi)
                score = self._parzen_logpdf(cand, g_obs, tlo, thi)
                if len(b_obs):
                    score = score - self._parzen_logpdf(cand, b_obs, tlo, thi)
                out[key] = inv(cand[int(np.argmax(score))])
            elif kind == "cat":
                opts = arg
                gc = np.array([sum(1 for o in good if str(o.get(key)) == c) for c in opts], float)
                bc = np.array([sum(1 for o in bad if str(o.get(key)) == c) for c in opts], float)
                score = np.log(gc + 1.0) - np.log(bc + 1.0)
                # sample proportionally to exp(score) to keep exploration
                p = np.exp(score - score.max())
                p /= p.sum()
                out[key] = opts[int(self.rng.choice(len(opts), p=p))]
            else:
                out[key] = arg
        return out


class SuccessiveHalvingPruner:
    """ASHA-style rung pruning: at epochs r*eta^k a trial must be in the top
    1/eta fraction of values reported at that rung by earlier trials."""

    def __init__(self, min_resource: int = 1, reduction_factor: int = 3, direction: str = "maximize"):
        self.min_resource = min_resource
        self.eta = reduction_factor
        self.sign = -1.0 if direction == "maximize" else 1.0  # lower = better internally
        self.rungs: dict[int, list[float]] = {}

    def rung_epochs(self, max_epochs: int) -> list[int]:
        out, r = [], self.min_resource
        while r <= max_epochs:
            out.append(r)
            r *= self.eta
        return out

    def report(self, epoch: int, value: float) -> bool:
        """Record `value` (raw metric) at `epoch`; True => prune."""
        if epoch + 1 not in self.rung_epochs(1 << 30):
            return False
        rung = self.rungs.setdefault(epoch + 1, [])
        v = self.sign * value if np.isfinite(value) else math.inf
        prune = False
        if len(rung) >= self.eta - 1:
            cutoff = float(np.quantile(rung, 1.0 / self.eta))
            prune = v > cutoff
        rung.append(v)
        return prune


@dataclasses.dataclass
class Trial:
    number: int
    overrides: dict[str, Any]
    metric: float
    metrics: dict[str, float]
    pruned: bool = False


def ranked_trial(
    cfg: TrainConfig, pruner: SuccessiveHalvingPruner | None, monitor: str
) -> tuple[dict[str, float], list[tuple[int, float]]]:
    """`train(cfg)` on this rank with pruning: rank 0 asks `pruner` (its own
    copy) at every epoch and the decision is summed over the ranks, so every
    rank stops at the same epoch. Returns the metrics and the (epoch, value)
    pairs reported."""
    rank, _world = process_shard_info()
    device = local_device(cfg.device)
    reports: list[tuple[int, float]] = []

    def _cb(row: dict[str, float]) -> None:
        if pruner is None:
            return
        epoch, value = int(row["epoch"]), float(row.get(monitor, float("nan")))
        reports.append((epoch, value))
        prune = torch.tensor([int(rank == 0 and pruner.report(epoch, value))], device=device)
        if all_reduce_sum(prune).item():
            raise TrialPruned

    return train(cfg, epoch_callback=_cb), reports


def run_sweep(
    base_config: TrainConfig | str | Path | None,
    space: SearchSpace | dict[str, str],
    n_trials: int = 10,
    optimized_metric: str = "best_val_f1",
    direction: str = "maximize",
    seed: int = 1234,
    output_dir: str | Path = "sweep",
    train_fn=None,
    sampler: str = "tpe",
    n_startup_trials: int = 5,
    pruning: bool = True,
    monitor: str | None = None,
    monitor_mode: str | None = None,
    min_resource: int = 1,
    reduction_factor: int = 3,
) -> list[Trial]:
    """Run `n_trials` TPE-sampled configs with ASHA pruning; returns trials
    sorted best-first and writes `<output_dir>/results.json`.

    `train_fn(cfg[, epoch_callback])` replaces the trainer (an
    `epoch_callback` raising `TrialPruned` prunes); by default each trial is
    `train` on its ranks (`ranked_trial`). A trial that raises is recorded
    with a NaN metric and its traceback logged, as in the JAX package;
    DeviceUnavailable ends the sweep."""
    accepts_callback = train_fn is not None and "epoch_callback" in inspect.signature(train_fn).parameters
    if isinstance(space, dict):
        space = SearchSpace(space)
    rng = np.random.default_rng(seed)
    tpe = TPESampler(space, seed=seed, n_startup_trials=n_startup_trials)
    # The pruner watches a per-epoch row key, by default the per-epoch form
    # of optimized_metric (best_val_f1 -> val/f1) in the metric's own
    # direction.
    if monitor is None:
        monitor = "val/f1" if optimized_metric == "best_val_f1" else optimized_metric
    if monitor_mode is None:
        monitor_mode = direction if monitor == optimized_metric else (
            "minimize" if "loss" in monitor else "maximize"
        )
    pruner = (
        SuccessiveHalvingPruner(min_resource, reduction_factor, monitor_mode) if pruning else None
    )
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)

    trials: list[Trial] = []
    sign = -1.0 if direction == "maximize" else 1.0
    signed_history: list[tuple[dict[str, Any], float]] = []
    for t in range(n_trials):
        cfg = copy.deepcopy(base_config) if isinstance(base_config, TrainConfig) else load_config(base_config)
        overrides = tpe.suggest(signed_history) if sampler == "tpe" else space.sample(rng)
        for key, value in overrides.items():
            apply_override(cfg, key, str(value))
        cfg.output_dir = str(output_dir / f"trial_{t}")

        def _cb(row: dict[str, float]) -> None:
            if pruner is not None and pruner.report(int(row["epoch"]), float(row.get(monitor, float("nan")))):
                raise TrialPruned

        pruned = False
        try:
            if train_fn is None:
                metrics, reports = on_ranks(ranked_trial, cfg, copy.deepcopy(pruner), monitor)
                for epoch, value in reports:
                    pruner.report(epoch, value)
            elif accepts_callback:
                metrics = train_fn(cfg, epoch_callback=_cb)
            else:
                metrics = train_fn(cfg)  # a train_fn without callback support
            pruned = bool(metrics.get("pruned"))
            metric = float(metrics.get(optimized_metric, float("nan")))
        except DeviceUnavailable:
            raise
        except Exception as exc:  # a bad config doesn't end the sweep
            log.warning("trial %d failed: %s", t, exc, exc_info=True)
            metrics, metric = {}, float("nan")
        trials.append(Trial(t, overrides, metric, dict(metrics), pruned))
        # Pruned trials still inform TPE (their partial metric is real).
        signed_history.append((overrides, sign * metric if np.isfinite(metric) else math.inf))
        log.info("trial %d%s: %s=%s %s", t, " (pruned)" if pruned else "", optimized_metric, metric, overrides)

    trials.sort(key=lambda tr: sign * tr.metric if np.isfinite(tr.metric) else math.inf)
    (output_dir / "results.json").write_text(
        json.dumps([dataclasses.asdict(tr) for tr in trials], indent=2, default=str)
    )
    return trials
