"""Seeded synthetic nanopore-like FASTQ for smoke runs and benchmarks.

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
