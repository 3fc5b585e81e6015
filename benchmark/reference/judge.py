"""The numbers that decide `correct`, worked out by the reference and
compared with what the program produced.

Predict: the widest (and the mean) gap by which the logit of the label the
program chose lies below the reference's best logit at that base (0 where
they agree), over every base of a sample of reads; the sampled reads whose
chopped records differ from the reference's chop of the program's labels;
reads in the output that are no input read or come out of order. Train:
the first steps' loss and (tp, fp, fn, tn), the first gradient and the
parameters' change after the steps, each leaf's norm against the
reference's (`train_gaps`).
"""

from __future__ import annotations

import gzip
import math
from collections import defaultdict

import numpy as np
import torch

from . import chop as ref_chop
from .encode import encode
from .models import forward, hyena_features
from .precision import strict_float32

# Tokens a reference forward takes at once (rows of one width).
BLOCK_TOKENS = 1 << 16


def _blocks(items: list, width_of) -> list[tuple[int, list]]:
    by_width = defaultdict(list)
    for it in items:
        by_width[width_of(it)].append(it)
    out = []
    for w, group in sorted(by_width.items()):
        rows = max(1, BLOCK_TOKENS // w)
        out += [(w, group[i : i + rows]) for i in range(0, len(group), rows)]
    return out


@torch.no_grad()
def read_logits(weights: dict, cfg: dict, reads, items: list[tuple[int, int]], max_length: int,
                device, mode: str = "f32") -> dict[int, np.ndarray]:  # fmt: skip
    """{read index: (n, num_class) float32 logits over its n bases} for
    (read index, width) items, each read padded to its width."""
    strict_float32()
    feats = hyena_features(cfg["backbone"], device) if cfg["family"] == "hyena" else None
    out = {}
    for width, block in _blocks(items, lambda it: it[1]):
        enc = [encode(*reads.record(i)[1:], width, max_length) for i, _ in block]
        ids = torch.from_numpy(np.stack([e[0] for e in enc])).to(device)
        quals = torch.from_numpy(np.stack([e[1] for e in enc])).to(device)
        logits = forward(weights, cfg, ids, quals, mode, feats=feats).float().cpu().numpy()
        for row, (i, _) in enumerate(block):
            out[i] = logits[row, : min(len(reads.record(i)[1]), max_length - 1)]
    return out


def label_gaps(ref: dict[int, np.ndarray], labels: dict[int, np.ndarray], band: float) -> tuple[float, ...]:
    """Over reads and bases, with gap = ref[best] - ref[label]: (the widest
    gap, the mean gap, the share of bases outside the tie band - the
    reference's best logit `band` or more above the other - whose label is
    not the reference's best); all inf where a read's labels are missing or
    of the wrong length."""
    worst, total, n, flipped, clear = 0.0, 0.0, 0, 0, 0
    for i, lg in ref.items():
        lab = labels.get(i)
        if lab is None or lab.shape != (lg.shape[0],) or lab.min() < 0 or lab.max() >= lg.shape[1]:
            return math.inf, math.inf, math.inf
        gap = lg.max(axis=1) - lg[np.arange(lg.shape[0]), lab.astype(np.int64)]
        outside = np.sort(lg, axis=1)[:, -1] - np.sort(lg, axis=1)[:, -2] >= band
        worst = max(worst, float(gap.max()) if gap.size else 0.0)
        total, n = total + float(gap.sum()), n + gap.size
        flipped, clear = flipped + int((outside & (gap > 0)).sum()), clear + int(outside.sum())
    return worst, total / max(n, 1), flipped / max(clear, 1)


def read_output(path) -> dict[str, list[bytes]]:
    """{read name: its records, in order} of a chopped (BGZF) FASTQ, in the
    order the reads first appear; a record's read is its name up to the
    first '|'."""
    out: dict[str, list[bytes]] = defaultdict(list)
    with gzip.open(path, "rb") as fh:
        lines = fh.read().split(b"\n")
    for k in range(0, len(lines) - 3, 4):
        rec = b"\n".join(lines[k : k + 4]) + b"\n"
        out[lines[k][1:].split(b"|", 1)[0].split(None, 1)[0].decode()].append(rec)
    return out


def chop_mismatches(reads, labels: dict[int, np.ndarray], output: dict[str, list[bytes]], max_length: int,
                    rules: ref_chop.ChopRules = ref_chop.ChopRules()) -> int:  # fmt: skip
    """Sampled reads whose records in `output` differ from the reference's
    chop of the labels the program gave them."""
    bad = 0
    for i, lab in labels.items():
        name, seq, qual = reads.record(i)
        want = ref_chop.chop(name, seq, qual, lab.tolist(), len(seq) >= max_length, rules)
        bad += output.get(name, []) != want  # a read whose parts are all too short leaves none
    return bad


def reads_cut(output: dict[str, list[bytes]]) -> int:
    """Reads whose records in `output` are parts of the read (named
    `<read>|<start>:<end>|<kind>`) rather than the whole read."""
    return sum(any(rec.split(b"\n", 1)[0].startswith(b"@%s|" % name.encode()) for rec in recs)
               for name, recs in output.items())  # fmt: skip


def stray_records(names: list[str], output: dict[str, list[bytes]]) -> int:
    """Reads in the output that are not input reads, or that come out of the
    input's order."""
    index = {n: i for i, n in enumerate(names)}
    bad, last = 0, -1
    for name in output:
        i = index.get(name)
        if i is None or i < last:
            bad += 1
        else:
            last = i
    return bad


# -- training ---------------------------------------------------------------------


def reference_batch(reads, read_ids: list[str], width: int, max_length: int) -> tuple[np.ndarray, ...]:
    """(ids, quals, labels) of a batch of labelled reads, from the raw reads."""
    rows = []
    for rid in read_ids:
        i = int(rid.split("|", 1)[0].rsplit("_", 1)[1])
        name, seq, qual = reads.record(i)
        if name != rid:
            raise ValueError(f"batch read {rid!r} is not the harness's read {i} ({name!r})")
        rows.append(encode(seq, qual, width, max_length, tuple(int(v) for v in reads.spans[i])))
    return tuple(np.stack(col) for col in zip(*rows))


def batch_mismatches(program: tuple[np.ndarray, ...], ref: tuple[np.ndarray, ...]) -> int:
    """Rows where the program's (ids, quals, labels) differ from the
    reference's encoding (quals within 1e-6: the two normalise in float32
    and float64)."""
    ids, quals, labels = program
    rids, rquals, rlabels = ref
    bad = (ids != rids).any(1) | (labels != rlabels).any(1) | (np.abs(quals - rquals) > 1e-6).any(1)
    return int(bad.sum())


def _loss_and_grads(p: dict, cfg: dict, batch, device, mode: str, rows_kept: float,
                    loss_rows_kept: float = 1.0) -> tuple[float, dict, np.ndarray]:  # fmt: skip
    """Mean cross-entropy over the valid labels of a batch, its gradient and
    the (tp, fp, fn, tn) counts of the logits' argmax against the labels, in
    blocks of rows, each block's blocks recomputed in the backward.
    `rows_kept` < 1 is the half-batch fault on the whole step: only the
    first share of the rows count, the mean taken over them;
    `loss_rows_kept` < 1 the same fault in the loss alone, the counts still
    taken over every row."""
    ids, quals, labels = batch
    n_rows = max(1, int(round(ids.shape[0] * rows_kept)))
    ids, quals, labels = ids[:n_rows], quals[:n_rows], labels[:n_rows]
    n_loss = max(1, int(round(n_rows * loss_rows_kept)))
    count = max(int((labels[:n_loss] != -100).sum()), 1)
    feats = hyena_features(cfg["backbone"], device) if cfg["family"] == "hyena" else None
    grads = {k: torch.zeros_like(v) for k, v in p.items()}
    rows = max(1, BLOCK_TOKENS // ids.shape[1])
    total = 0.0
    counts = np.zeros(4, np.int64)
    for s in range(0, n_rows, rows):
        t_ids = torch.from_numpy(ids[s : s + rows]).to(device)
        t_q = torch.from_numpy(quals[s : s + rows]).to(device)
        t_lab = torch.from_numpy(labels[s : s + rows]).to(device)
        logits = forward(p, cfg, t_ids, t_q, mode, recompute=True, feats=feats)
        mask = t_lab != -100
        with torch.no_grad():
            pred, lab = logits.argmax(-1) == 1, t_lab == 1
            counts += [int(x) for x in ((pred & lab & mask).sum(), (pred & ~lab & mask).sum(),
                                        (~pred & lab & mask).sum(), (~pred & ~lab & mask).sum())]  # fmt: skip
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -torch.gather(logp, -1, torch.where(mask, t_lab, 0)[..., None])[..., 0]
        in_loss = (torch.arange(s, s + t_lab.shape[0], device=device) < n_loss)[:, None]
        part = torch.where(mask & in_loss, nll, 0.0).sum() / count
        got = torch.autograd.grad(part, list(p.values()), allow_unused=True)
        for (k, _), g in zip(p.items(), got):
            if g is not None:
                grads[k] += g
        total += float(part.detach())
    return total, grads, counts


def train_reference(weights: dict, cfg: dict, batches: list, lr: float, device, mode: str = "f32",
                    rows_kept: float = 1.0, loss_rows_kept: float = 1.0, betas=(0.9, 0.999),
                    eps: float = 1e-8) -> dict:  # fmt: skip
    """Adam (optax's and torch's update) over `batches` from `weights`:
    {"losses": [...], "stats": [(tp, fp, fn, tn) of each step], "grad1":
    {leaf: first gradient}, "change": {leaf: parameters after the steps
    minus before}} (float32, on `device`)."""
    strict_float32()
    p = {k: v.detach().clone().requires_grad_() for k, v in weights.items() if v.is_floating_point()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, stats, grad1 = [], [], None
    for t, batch in enumerate(batches, start=1):
        loss, grads, counts = _loss_and_grads(p, cfg, batch, device, mode, rows_kept, loss_rows_kept)
        losses.append(loss)
        stats.append(counts)
        if grad1 is None:
            grad1 = {k: g.clone() for k, g in grads.items()}
        with torch.no_grad():
            for k, x in p.items():
                g = grads[k]
                m[k].mul_(betas[0]).add_(g, alpha=1 - betas[0])
                v2[k].mul_(betas[1]).addcmul_(g, g, value=1 - betas[1])
                denom = (v2[k] / (1 - betas[1] ** t)).sqrt_().add_(eps)
                x.addcdiv_(m[k], denom, value=-lr / (1 - betas[0] ** t))
    change = {k: (x.detach() - weights[k]) for k, x in p.items()}
    return {"losses": losses, "stats": stats, "grad1": grad1, "change": change}


def leaf_gaps(prog: dict[str, float], ref: dict[str, float], leaves: list[str]) -> dict[str, float]:
    """{leaf: |prog norm - ref norm| / max(ref norm, median ref norm)}."""
    med = float(np.median([ref[k] for k in leaves]))
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in leaves}


def train_gaps(prog: dict, ref: dict, log=None) -> dict[str, float]:
    """The readings of the first steps: `prog` holds the program's losses,
    (tp, fp, fn, tn) counts and per-leaf norms of the first gradient and of
    the change. A cell's limits file names the ones it compares (PERF.md
    gives the readings each choice was made from).

    - `loss_gap`: the first step's loss. Each Adam step of lr on every
      element drives this random model's loss down by a factor of 5, so from
      the second step rounding alone moves it by up to tens of percent.
    - `stats_gap`: the first step's (tp, fp, fn, tn), sum of |program -
      reference| over the reference's total: argmax flips, and every label
      a step leaves out.
    - `grad_gap`, `change_gap`: the worst leaf's gap of norms (module
      docstring); `grad_gap_median`, `change_gap_median`: the median leaf's.
    - `grad_dev_median`, `grad_dev`: where `prog` holds the first gradient
      itself (`grad1_vec`, None for a leaf without one), the median and the
      worst leaf's norm of the program's gradient minus the reference's,
      over the larger of the leaf's and the median leaf's reference norm.
      Adam's first step moves every element by the learning rate whatever
      the gradient's size, and a gradient over half the rows keeps nearly
      the norm of the whole batch's: both norms above miss rows left out
      of the loss, which change the gradient's direction.
    `log`, if given, gets each step's loss gap and the leaves' gaps."""
    gnorm = {k: float(g.norm()) for k, g in ref["grad1"].items()}
    cnorm = {k: float(c.norm()) for k, c in ref["change"].items()}
    leaves = sorted(gnorm)
    med = float(np.median([gnorm[k] for k in leaves]))
    # Leaves the reference's gradient leaves at rounding move under Adam by
    # rounding alone: left out of the change.
    moving = [k for k in leaves if gnorm[k] >= 1e-3 * med]
    steps = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog["losses"], ref["losses"])]
    grads = leaf_gaps(prog["grad1"], gnorm, leaves)
    change = leaf_gaps(prog["change"], cnorm, moving)
    vec = prog.get("grad1_vec")
    if vec is not None:
        ref_g = ref["grad1"]
        diff = {k: float(ref_g[k].norm() if vec[k] is None else (vec[k].to(ref_g[k].device) - ref_g[k]).norm())
                for k in leaves}  # fmt: skip
        devs = {k: diff[k] / max(gnorm[k], med, 1e-30) for k in leaves}
    want = np.asarray(ref["stats"][0], np.float64)
    got = np.asarray(prog["stats"][0], np.float64)
    if log is not None:
        worst = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:4]  # noqa: E731
        pct = lambda d: [float(np.percentile(list(d.values()), q)) for q in (50, 75, 90, 100)]  # noqa: E731
        log(f"loss gap by step {steps}; first step (tp, fp, fn, tn) {got.tolist()} against {want.tolist()}; "
            f"gradient leaf gaps p50/75/90/100 {pct(grads)}, worst {worst(grads)}; "
            f"change leaf gaps p50/75/90/100 {pct(change)}, worst {worst(change)}"
            + (f"; gradient leaf deviations p50/75/90/100 {pct(devs)}, worst {worst(devs)}" if vec is not None else ""))  # fmt: skip
    out = {
        "loss_gap": steps[0],
        "stats_gap": float(np.abs(got - want).sum() / max(want.sum(), 1.0)),
        "grad_gap": max(grads.values()),
        "grad_gap_median": float(np.median(list(grads.values()))),
        "change_gap": max(change.values()),
        "change_gap_median": float(np.median(list(change.values()))),
    }
    if vec is not None:
        out["grad_dev"] = max(devs.values())
        out["grad_dev_median"] = float(np.median(list(devs.values())))
    return out
