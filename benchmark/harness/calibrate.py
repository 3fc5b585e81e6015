"""The head's class bias of a predict cell's random model, set from the seed
so that the chop has as many reads to cut as the traffic mix states.

A random model's adapter logit has a mean of its own on every seed, so a
fixed bias leaves the share of reads the chop cuts, and with it the chop
worker's load, to the seed. Here the reference (float32) runs over the
mix's calibration reads with the seed's weights; a read gets an interval
once its 21-base majority vote holds 13 adapter bases in a row, that is
once the bias lifts the largest 13-run minimum of its windows' medians of
the logit difference above 0. The bias is set at the quantile of those
thresholds that leaves `adapter_read_share` of the reads above it. The
same weights go to the program and the reference.
"""

from __future__ import annotations

import numpy as np
import torch
from numpy.lib.stride_tricks import sliding_window_view

from benchmark.reference import chop as ref_chop
from benchmark.reference import judge

from .traffic import bucket_widths, make_reads

BIAS = "head.linear3.bias"


def vote_thresholds(d: np.ndarray, window: int) -> np.ndarray:
    """Per base, the value t for which the majority vote of the labels
    (d > -b) is 1 at that base for every bias b above -t: the windows of
    `reference.chop.majority_vote` (clipped at the read's start, moved left
    at its end), a tie keeping the base's own label."""
    n, half = d.shape[0], window // 2
    full = np.median(sliding_window_view(d, window), axis=1)  # the window starting at each base
    out = np.empty(n)
    out[half : n - half] = full[: n - 2 * half]
    out[n - half :] = full[n - window]
    for i in range(half):
        size = i + half + 1
        top = np.sort(d[:size])[::-1]
        k = size // 2
        out[i] = top[k] if size % 2 else max(top[k], min(top[k - 1], d[i]))
    return out


def read_thresholds(diff: dict[int, np.ndarray], rules: ref_chop.ChopRules = ref_chop.ChopRules()) -> np.ndarray:
    """Per read, the value t for which the chop finds an interval in the
    labels (diff > -b) for every bias b above -t: a run of
    `min_interval_size` voted adapter bases, not counting the first base."""
    window, run = rules.smooth_window | 1, rules.min_interval_size
    out = []
    for d in diff.values():
        if d.shape[0] < window + run:
            out.append(-np.inf)
            continue
        vote = vote_thresholds(d.astype(np.float64), window)[1:]
        out.append(float(sliding_window_view(vote, run).min(axis=1).max()))
    return np.asarray(out)


def set_adapter_bias(weights: dict[str, torch.Tensor], cfg: dict, mix: dict, seed: int, buckets: list[int],
                     device) -> float:  # fmt: skip
    """Writes the head's class bias into `weights` (adapter minus other = b,
    split evenly) and returns b."""
    reads = make_reads(mix, mix["calibration_reads"], seed, stream=2, prefix="calibration_read")
    items = list(enumerate(bucket_widths(reads.lengths(), buckets, mix["max_length"])))
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    try:
        logits = judge.read_logits(weights, cfg, reads, items, mix["max_length"], device)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    old = weights[BIAS].float().cpu().numpy()
    diff = {i: lg[:, 1] - lg[:, 0] - (old[1] - old[0]) for i, lg in logits.items()}
    b = -float(np.quantile(read_thresholds(diff), 1.0 - mix["adapter_read_share"]))
    weights[BIAS] = torch.tensor([-b / 2, b / 2], dtype=weights[BIAS].dtype, device=weights[BIAS].device)
    return b
