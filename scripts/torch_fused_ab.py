#!/usr/bin/env python3
"""Reads/s of the PyTorch port's `predict --fused-chop` on the flagship, for
several checkouts of the repository in turns, on one GPU.

    python3 scripts/torch_fused_ab.py [--reps 5] CHECKOUT [CHECKOUT ...]

The reads are chip_smoke.py's (300 reads of the benchmark's length mix, with
reads in the 24576 and 32768 buckets), written once. Each run is a fresh
process importing `deepchopper_tpu_torch` from one checkout: it calls the
CLI's `predict --fused-chop --random-init` on hyenadna-small-32k-seqlen twice
in its own directory, the first pass to build and warm up, and reports the
second pass's `FusedStats` (reads/s over `elapsed_s`, the stream alone). The
checkouts take turns, the order reversed every round (A B, B A, A B, ...), so
drift on the card falls on both alike. Prints each run as it ends, then the
median, the lowest and the highest reads/s of each checkout, and the card's
name and power limit. Exits non-zero without a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

CHILD = r"""
import json, sys
import torch
from deepchopper_tpu_torch import cli
args = ["predict", sys.argv[1], "--model", "hyenadna-small-32k-seqlen", "--random-init", "--fused-chop"]
parser = cli.build_parser()
cli.predict(parser.parse_args(args))
stats = cli.predict(parser.parse_args(args))
torch.cuda.synchronize()
engine = stats.extras["engine"]
print(json.dumps({"reads": stats.total_fq_count, "records": stats.total_output_count, "elapsed_s": stats.elapsed_s,
                  "reads_per_s": stats.total_fq_count / stats.elapsed_s,
                  "tokens_per_s": engine.tokens / stats.elapsed_s, "device_s": stats.device_s,
                  "encode_s": stats.encode_s, "batches": engine.batches}))
"""


def run_one(checkout: Path, fq: Path, cwd: Path) -> dict:
    cwd.mkdir(parents=True)
    env = {**os.environ, "PYTHONPATH": str(checkout)}
    res = subprocess.run([sys.executable, "-c", CHILD, str(fq)], cwd=cwd, env=env, capture_output=True, text=True,
                         timeout=900)  # fmt: skip
    if res.returncode != 0:
        raise SystemExit(f"fused run in {checkout} failed ({res.returncode}):\n{res.stderr[-4000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("checkouts", nargs="+", type=Path)
    parser.add_argument("--reps", type=int, default=5)
    opts = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_fused_ab: CUDA is not available; this needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke

    checkouts = [c.resolve() for c in opts.checkouts]
    runs: dict[Path, list[float]] = {c: [] for c in checkouts}
    with tempfile.TemporaryDirectory(dir=REPO / "build" if (REPO / "build").is_dir() else None) as tmp:
        work = Path(tmp)
        fq = chip_smoke.bench_reads(work)
        for rep in range(opts.reps):
            for i, checkout in enumerate(checkouts if rep % 2 == 0 else checkouts[::-1]):
                got = run_one(checkout, fq, work / f"run{rep}-{i}")
                runs[checkout].append(got["reads_per_s"])
                print(json.dumps({"checkout": str(checkout), "round": rep, **got}), flush=True)
    for checkout, rates in runs.items():
        print(f"{checkout}: predict --fused-chop reads/s median {statistics.median(rates):.1f}, "
              f"min {min(rates):.1f}, max {max(rates):.1f} over {len(rates)} runs: "
              f"{', '.join(f'{r:.1f}' for r in rates)}")  # fmt: skip
    print(chip_smoke.gpu_line())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
