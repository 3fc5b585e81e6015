"""Loss: masked cross-entropy + continuity penalty.

Port of `deepchopper_tpu/train/loss.py`. CE ignores -100 labels; the penalty
is lambda * mean(adjacent prediction/target disagreement), with adjacency
taken within each read under the valid mask (the JAX package's deliberate
fix of the reference, which flattens the batch first; identical for
lambda = 0, the shipped default). The penalty is a count over argmax
predictions, so it carries no gradient.

Both terms are global means over the whole batch, as JAX computes them on a
batch-sharded mesh. A rank that holds a block of the batch's rows passes the
batch's `counts` (`loss_counts` of the global labels, known to every rank
without communication): its loss is then its rows' share of the global mean,
and the ranks' losses, and their gradients, sum to the global ones. DDP's
default, the mean of the ranks' own means, is another loss whenever the
ranks hold different numbers of valid labels.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import default


def loss_counts(labels: np.ndarray, ignore_index: int = default.IGNORE_LABEL) -> tuple[int, int]:
    """(valid labels, valid adjacent pairs within a row) of a host batch: the
    denominators of the loss's two means."""
    mask = labels != ignore_index
    return int(mask.sum()), int((mask[..., 1:] & mask[..., :-1]).sum())


def masked_cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, ignore_index: int = default.IGNORE_LABEL, count: int | None = None
) -> torch.Tensor:
    """Mean CE over positions whose label != ignore_index: the NLL sum over
    max(count, 1), where `count` defaults to these labels' valid count.

    logits: (..., C) float; labels: (...) int."""
    mask = labels != ignore_index
    safe_labels = torch.where(mask, labels, 0).long()
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, safe_labels[..., None])[..., 0]
    total = torch.where(mask, nll, 0.0).sum()
    return total / (torch.clamp(mask.sum(), min=1) if count is None else max(count, 1))


def continuous_interval_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    lambda_penalty: float = 0.0,
    ignore_index: int = default.IGNORE_LABEL,
    counts: tuple[int, int] | None = None,
) -> torch.Tensor:
    """CE plus lambda x the continuity penalty; `counts` = the global
    `loss_counts` when `labels` are a rank's rows of a larger batch."""
    loss = masked_cross_entropy(logits, labels, ignore_index, None if counts is None else counts[0])
    if lambda_penalty == 0.0:
        return loss
    mask = labels != ignore_index
    preds = torch.argmax(logits, dim=-1)
    pair_mask = mask[..., 1:] & mask[..., :-1]
    disagree = (preds[..., 1:] != labels[..., :-1]) & pair_mask
    penalty = disagree.sum() / (torch.clamp(pair_mask.sum(), min=1) if counts is None else max(counts[1], 1))
    return loss + lambda_penalty * penalty
