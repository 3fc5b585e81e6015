"""Train and eval steps.

Port of `deepchopper_tpu/train/step.py`: loss and logits, backward, update,
argmax stats. The optimizer is `torch.optim.Adam` (or `AdamW` with weight
decay) with optax's defaults (betas 0.9/0.999, eps 1e-8, decoupled weight
decay), the same update as `optax.adam` / `optax.adamw`. The learning rate
lives in the optimizer's `param_groups`, the counterpart of the JAX loop's
`optax.inject_hyperparams` leaf, so the plateau scheduler rewrites it between
epochs.

A batch is a dict of tensors on the model's device: `input_ids` (B, W) int64,
`input_quals` (B, W) float32 and `labels` (B, W) int64 (-100 = ignored).

Over several ranks each rank steps on its block of a global batch's rows,
with the global batch's `counts` (`loss.loss_counts`), and its model under
DDP with gradients summed (`train.loop`): the loss, its gradients and the
(tp, fp, fn, tn) stats are then the global batch's, on every rank.
"""

from __future__ import annotations

import torch

from ..parallel import all_reduce_sum
from .loss import continuous_interval_loss
from .metrics import binary_stats_arrays


def make_optimizer(
    params, learning_rate: float = 2e-4, weight_decay: float = 0.0
) -> torch.optim.Optimizer:
    """Adam(2e-4) per the reference recipe; AdamW when weight_decay is set."""
    if weight_decay:
        return torch.optim.AdamW(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)
    return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)


def get_lr(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


@torch.no_grad()
def clip_by_global_norm_(params, max_norm: float) -> None:
    """Scale the gradients in place by max_norm / max(norm, max_norm), as
    `optax.clip_by_global_norm` does (no epsilon added to the norm, unlike
    `torch.nn.utils.clip_grad_norm_`)."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum((g.float() * g.float()).sum() for g in grads))
    scale = max_norm / torch.clamp(norm, min=max_norm)
    for g in grads:
        g.mul_(scale.to(g.dtype))


def train_step(
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    batch: dict[str, torch.Tensor],
    lambda_penalty: float = 0.0,
    gradient_clip: float | None = None,
    counts: tuple[int, int] | None = None,
) -> dict[str, torch.Tensor]:
    """One optimizer step; returns {"loss": scalar, "stats": (tp, fp, fn, tn)}
    on the device (the stats from the logits before the update).

    With `counts` (a rank's rows of a global batch, `model` under DDP with
    summed gradients) the loss and stats returned are summed over the ranks,
    and the clip sees the gradients after DDP's all-reduce: the global ones,
    as optax's clip does."""
    optimizer.zero_grad(set_to_none=True)
    logits = model(batch["input_ids"], batch["input_quals"])
    loss = continuous_interval_loss(logits, batch["labels"], lambda_penalty, counts=counts)
    loss.backward()
    if gradient_clip:
        clip_by_global_norm_([p for group in optimizer.param_groups for p in group["params"]], gradient_clip)
    optimizer.step()
    stats = binary_stats_arrays(torch.argmax(logits.detach(), dim=-1), batch["labels"])
    loss = loss.detach()
    if counts is not None:
        all_reduce_sum(loss)
        all_reduce_sum(stats)
    return {"loss": loss, "stats": stats}


@torch.no_grad()
def eval_step(
    model: torch.nn.Module, batch: dict[str, torch.Tensor], lambda_penalty: float = 0.0,
    counts: tuple[int, int] | None = None,
) -> dict[str, torch.Tensor]:
    """Loss, stats and logits of a batch; with `counts`, as in `train_step`,
    the loss and stats summed over the ranks (the logits stay the rank's)."""
    logits = model(batch["input_ids"], batch["input_quals"])
    loss = continuous_interval_loss(logits, batch["labels"], lambda_penalty, counts=counts)
    stats = binary_stats_arrays(torch.argmax(logits, dim=-1), batch["labels"])
    if counts is not None:
        all_reduce_sum(loss)
        all_reduce_sum(stats)
    return {"loss": loss, "stats": stats, "logits": logits}
