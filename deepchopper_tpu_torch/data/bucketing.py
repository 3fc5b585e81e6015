"""Length-bucketed fixed-shape batching.

Copy of `deepchopper_tpu/data/bucketing.py`. Reads are routed into a ladder
of 17 widths; right padding and the causal backbone make padding inert.

Batch contract per read:
* input_ids  = base tokens[:T] + SEP, padded with PAD(4)       (int32)
* labels     = target 0/1 over T + IGNORE at SEP + IGNORE pads (int32)
* input_quals= phred[:T] + 0, L2-normalized per read, 0 pads   (float32)
* id         = [len, truncated, ord(c)...] padded to 256       (int32)
where T = min(len(seq), max_length - 1) and truncated = len >= max_length.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Iterable, Iterator

import numpy as np

from .. import default
from ..io.predicts import pack_read_ids
from ..ops.labels import vectorize_targets
from ..ops.qual import normalize_quals
from ..ops.sequence import tokenize_bases


@dataclasses.dataclass
class EncodedRead:
    """One tokenized read, pre-padding."""

    id: str
    input_ids: np.ndarray  # (T+1,) int32, ends with SEP
    labels: np.ndarray  # (T+1,) int32, ends with IGNORE
    quals: np.ndarray  # (T+1,) float32, L2-normalized
    truncated: bool
    raw_len: int
    seq: str | None = None
    quals_raw: np.ndarray | None = None  # (T+1,) uint8 phred ints, 0 at SEP


@dataclasses.dataclass
class Batch:
    """One fixed-shape padded batch."""

    input_ids: np.ndarray  # (B, W) int32
    labels: np.ndarray  # (B, W) int32
    quals: np.ndarray  # (B, W) float32
    ids: np.ndarray  # (B, 256) int32
    lengths: np.ndarray  # (B,) int32 — valid token count incl. SEP
    read_ids: list[str]
    seqs: list[str | None] | None = None
    quals_raw: np.ndarray | None = None  # (B, W) uint8 phred ints (device-norm path)


_BUCKET_LADDER = [
    256, 512, 768, 1024, 1280, 1536, 2048, 2560, 3072, 4096,
    5120, 6144, 8192, 12288, 16384, 24576, 32768,
]


def default_buckets(max_length: int = 32768, min_width: int = 256) -> list[int]:
    """Bucket widths up to max_length (always included)."""
    buckets = [w for w in _BUCKET_LADDER if min_width <= w < max_length]
    if max_length > (buckets[-1] if buckets else 0):
        buckets.append(max_length)
    return buckets


def encode_read(
    rid: str,
    seq: str,
    qual_scores: np.ndarray,
    targets: list[tuple[int, int]] | None,
    max_length: int,
) -> EncodedRead:
    """Tokenize one read per the reference tokenizer contract."""
    n = len(seq)
    truncated = n >= max_length
    t_len = min(n, max_length - 1)

    ids = np.empty(t_len + 1, dtype=np.int32)
    ids[:t_len] = tokenize_bases(seq[:t_len])
    ids[t_len] = default.TOKEN_SEP

    labels = np.full(t_len + 1, default.IGNORE_LABEL, dtype=np.int32)
    if targets:
        flat = [v for se in targets for v in se]
        first_end = flat[1] if len(flat) > 1 else 0
        if truncated and first_end + 2 > max_length:
            labels[:t_len] = 0
        else:
            labels[:t_len] = vectorize_targets(flat, t_len)
    else:
        labels[:t_len] = 0

    raw = np.zeros(t_len + 1, dtype=np.uint8)
    np.clip(qual_scores[:t_len], 0, 255, out=raw[:t_len], casting="unsafe")
    quals = normalize_quals(raw.astype(np.float32))

    return EncodedRead(rid, ids, labels, quals, truncated, n, seq, raw)


def pick_bucket(length: int, buckets: list[int]) -> int:
    """Smallest bucket width >= length (lengths beyond the last bucket clamp)."""
    for w in buckets:
        if length <= w:
            return w
    return buckets[-1]


def pad_batch(reads: list[EncodedRead], width: int) -> Batch:
    """Right-pad encoded reads into one fixed (B, width) batch."""
    b = len(reads)
    input_ids = np.full((b, width), default.TOKEN_PAD, dtype=np.int32)
    labels = np.full((b, width), default.IGNORE_LABEL, dtype=np.int32)
    quals = np.zeros((b, width), dtype=np.float32)
    quals_raw = np.zeros((b, width), dtype=np.uint8)
    lengths = np.zeros(b, dtype=np.int32)
    for i, r in enumerate(reads):
        n = len(r.input_ids)
        input_ids[i, :n] = r.input_ids
        labels[i, :n] = r.labels
        quals[i, :n] = r.quals
        if r.quals_raw is not None:
            quals_raw[i, :n] = r.quals_raw
        lengths[i] = n
    ids = pack_read_ids([r.id for r in reads], [r.truncated for r in reads])
    return Batch(
        input_ids,
        labels,
        quals,
        ids,
        lengths,
        [r.id for r in reads],
        [r.seq for r in reads],
        quals_raw,
    )


def bucketed_batches(
    reads: Iterable[EncodedRead],
    buckets: list[int] | None = None,
    tokens_per_batch: int = 1 << 17,
    max_batch: int = 512,
    min_batch: int = 1,
) -> Iterator[Batch]:
    """Group encoded reads into fixed-shape batches.

    Each bucket accumulates until its batch size target
    (`tokens_per_batch // width`, clamped to [min_batch, max_batch]) is hit;
    remainders flush at the end as smaller batches.
    """
    buckets = buckets or default_buckets()
    pending: dict[int, list[EncodedRead]] = {w: [] for w in buckets}
    for r in reads:
        w = pick_bucket(len(r.input_ids), buckets)
        pending[w].append(r)
        target = max(min_batch, min(max_batch, tokens_per_batch // w))
        if len(pending[w]) >= target:
            yield pad_batch(pending[w], w)
            pending[w] = []
    for w, rs in pending.items():
        if rs:
            yield pad_batch(rs, w)
