"""Seeded synthetic nanopore-like FASTQ for smoke runs, benchmarks and
training tests (unlabelled reads, or reads with a planted adapter).

The read-length distribution is the JAX package's benchmark mix
(`bench.py:synth_fastq`): a lognormal body around 1.2 kb, and 4% of reads
from a wider lognormal around 7 kb, clipped to [200, 32000].
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def read_lengths(n_reads: int, seed: int = 0, mean_len: int = 1200) -> np.ndarray:
    rng = np.random.default_rng(seed)
    out = np.empty(n_reads, dtype=np.int64)
    for i in range(n_reads):
        if rng.random() < 0.04:
            out[i] = int(np.clip(rng.lognormal(np.log(7000), 0.7), 200, 32000))
        else:
            out[i] = int(np.clip(rng.lognormal(np.log(mean_len), 0.45), 200, 32000))
    return out


def synth_fastq(path: str | Path, lengths: np.ndarray, seed: int = 0) -> Path:
    """Write one read per entry of `lengths` (random ACGT, phred 5..39)."""
    rng = np.random.default_rng(seed + 1)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    path = Path(path)
    with open(path, "wb") as fh:
        for i, n in enumerate(lengths):
            seq = rng.choice(bases, int(n)).tobytes()
            qual = rng.integers(33 + 5, 33 + 40, int(n)).astype(np.uint8).tobytes()
            fh.write(b"@bench_read_" + str(i).encode() + b"\n" + seq + b"\n+\n" + qual + b"\n")
    return path


def synth_labelled_fastq(path: str | Path, lengths: np.ndarray, seed: int = 0, adapter_len: int = 60) -> Path:
    """Write one labelled read per entry of `lengths` (each >= adapter_len + 30):
    random ACGT with a planted all-A adapter of `adapter_len` bases whose
    flanking bases are non-A, so the label boundary is exactly the A-run. The
    adapter's span goes into the id as `bench_read_<i>|<start>:<end>`, the
    form `ops/labels.parse_target_from_id` reads (the recipe of the JAX
    package's separable training set, tests/test_train_harness.py)."""
    rng = np.random.default_rng(seed + 2)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    non_a = np.frombuffer(b"CGT", dtype=np.uint8)
    path = Path(path)
    with open(path, "wb") as fh:
        for i, n in enumerate(lengths):
            n = int(n)
            if n < adapter_len + 30:
                raise ValueError(f"read {i}: length {n} leaves no room for a {adapter_len}-base adapter")
            seq = rng.choice(bases, n)
            start = int(rng.integers(10, n - adapter_len - 20))
            end = start + adapter_len
            seq[start:end] = ord("A")
            seq[start - 1] = rng.choice(non_a)
            seq[end] = rng.choice(non_a)
            qual = rng.integers(33 + 5, 33 + 40, n).astype(np.uint8).tobytes()
            rid = f"bench_read_{i}|{start}:{end}".encode()
            fh.write(b"@" + rid + b"\n" + seq.tobytes() + b"\n+\n" + qual + b"\n")
    return path
