"""The one generator of the benchmark's reads, driven by a traffic mix's
parameters (`benchmark/traffic/<mix>.json`).

Read lengths follow the mix's distribution: a lognormal body, a share of
reads from a second, wider lognormal, clipped to [min, max]. They are drawn
with the mix's own `length_seed`, so every run seed gets the same set of
lengths, in an order of its own; bases (uniform ACGT) and phred scores
(uniform in the mix's range) come from the run seed. A labelled mix plants
one adapter of `adapter.length` A's, flanked by bases other than A, in each
read, and names it `<name>|<start>:<end>`, the form the training data's ids
take. All of it is made with whole-array NumPy calls.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

_ACGT = np.frombuffer(b"ACGT", np.uint8)
_CGT = np.frombuffer(b"CGT", np.uint8)


@dataclasses.dataclass
class Reads:
    names: list[str]
    seq: np.ndarray  # uint8, every read's bases end to end
    qual: np.ndarray  # uint8 phred + 33, the same layout
    offsets: np.ndarray  # (n + 1,) int64
    spans: np.ndarray | None = None  # (n, 2) adapter [start, end) of a labelled mix

    def __len__(self) -> int:
        return len(self.names)

    def lengths(self) -> np.ndarray:
        return np.diff(self.offsets)

    def record(self, i: int) -> tuple[str, bytes, bytes]:
        a, b = self.offsets[i], self.offsets[i + 1]
        return self.names[i], self.seq[a:b].tobytes(), self.qual[a:b].tobytes()

    def write_fastq(self, path: Path) -> Path:
        with open(path, "wb") as fh:
            for i, name in enumerate(self.names):
                a, b = self.offsets[i], self.offsets[i + 1]
                fh.writelines((b"@", name.encode(), b"\n", self.seq[a:b], b"\n+\n", self.qual[a:b], b"\n"))
        return path


def length_set(mix: dict, n: int) -> np.ndarray:
    """The mix's n read lengths, the same for every run seed."""
    spec = mix["lengths"]
    rng = np.random.default_rng(spec["length_seed"])
    tail = rng.random(n) < spec["tail"]["share"]
    body = rng.lognormal(np.log(spec["body"]["median"]), spec["body"]["sigma"], n)
    wide = rng.lognormal(np.log(spec["tail"]["median"]), spec["tail"]["sigma"], n)
    return np.clip(np.where(tail, wide, body), spec["min"], spec["max"]).astype(np.int64)


def make_reads(mix: dict, n: int, seed: int, stream: int = 0, prefix: str = "bench_read") -> Reads:
    """n reads of the mix for run seed `seed`; `stream` tells apart sets of
    one run (the window's, a warm-up's)."""
    rng = np.random.default_rng([seed, stream])
    lengths = rng.permutation(length_set(mix, n))
    offsets = np.concatenate([[0], np.cumsum(lengths)])
    total = int(offsets[-1])
    seq = _ACGT[rng.integers(0, 4, total, dtype=np.uint8)]
    lo, hi = mix["phred"]
    qual = rng.integers(33 + lo, 33 + hi + 1, total, dtype=np.uint8)
    names = [f"{prefix}_{i}" for i in range(n)]
    spans = None
    adapter = mix.get("adapter")
    if adapter:
        size = adapter["length"]
        if lengths.min() < size + 30:
            raise ValueError(f"reads shorter than {size + 30} leave no room for a {size}-base adapter")
        start = 10 + (rng.random(n) * (lengths - size - 30)).astype(np.int64)
        at = offsets[:-1] + start
        seq[(at[:, None] + np.arange(size)).ravel()] = ord("A")
        seq[at - 1] = _CGT[rng.integers(0, 3, n)]
        seq[at + size] = _CGT[rng.integers(0, 3, n)]
        spans = np.stack([start, start + size], axis=1)
        names = [f"{nm}|{s}:{e}" for nm, (s, e) in zip(names, spans.tolist())]
    return Reads(names, seq, qual, offsets, spans)


def bucket_widths(lengths: np.ndarray, buckets: list[int], max_length: int) -> list[int]:
    """The bucket width each read of these lengths (and SEP) lands in."""
    tokens = np.minimum(lengths, max_length - 1) + 1
    idx = np.minimum(np.searchsorted(np.asarray(buckets), tokens, side="left"), len(buckets) - 1)
    return [int(buckets[i]) for i in idx]


def widths_reached(lengths: np.ndarray, buckets: list[int], max_length: int) -> list[int]:
    """The bucket widths that reads of these lengths (and SEP) land in."""
    return sorted(set(bucket_widths(lengths, buckets, max_length)))
