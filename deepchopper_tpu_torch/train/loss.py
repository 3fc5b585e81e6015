"""Loss: masked cross-entropy + continuity penalty.

Port of `deepchopper_tpu/train/loss.py`. CE ignores -100 labels; the penalty
is lambda * mean(adjacent prediction/target disagreement), with adjacency
taken within each read under the valid mask (the JAX package's deliberate
fix of the reference, which flattens the batch first; identical for
lambda = 0, the shipped default). The penalty is a count over argmax
predictions, so it carries no gradient.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import default


def masked_cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, ignore_index: int = default.IGNORE_LABEL
) -> torch.Tensor:
    """Mean CE over positions whose label != ignore_index.

    logits: (..., C) float; labels: (...) int."""
    mask = labels != ignore_index
    safe_labels = torch.where(mask, labels, 0).long()
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, safe_labels[..., None])[..., 0]
    total = torch.where(mask, nll, 0.0).sum()
    count = torch.clamp(mask.sum(), min=1)
    return total / count


def continuous_interval_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    lambda_penalty: float = 0.0,
    ignore_index: int = default.IGNORE_LABEL,
) -> torch.Tensor:
    loss = masked_cross_entropy(logits, labels, ignore_index)
    if lambda_penalty == 0.0:
        return loss
    mask = labels != ignore_index
    preds = torch.argmax(logits, dim=-1)
    pair_mask = mask[..., 1:] & mask[..., :-1]
    disagree = (preds[..., 1:] != labels[..., :-1]) & pair_mask
    penalty = disagree.sum() / torch.clamp(pair_mask.sum(), min=1)
    return loss + lambda_penalty * penalty
