#!/usr/bin/env python3
"""Reads/s of the PyTorch port's `predict --fused-chop` on the flagship, for
several checkouts of the repository in turns, on one GPU.

    python3 scripts/torch_fused_ab.py [--reps 5] [--reads 300] CHECKOUT[@MODE] [CHECKOUT[@MODE] ...]

The reads are chip_smoke.py's (`--reads` of the benchmark's length mix, 300
by default, with reads in the 24576 and 32768 buckets), written once. Each
run is a fresh process importing `deepchopper_tpu_torch` from one checkout:
it calls the CLI's `predict --fused-chop --random-init` on
hyenadna-small-32k-seqlen twice in its own directory, each call with an
engine of its own, then `fused_predict_chop` once more on the second call's
engine, and reports the three passes' `FusedStats` (reads/s over
`elapsed_s`, the stream alone: `runtime_setup`, which builds the kernels,
is off it) and each pass's peak device memory. The first pass is the fresh
process's (every first use on the stream: library handles, cuFFT plans,
and, where the checkout has them, the capture of each shape's CUDA graph);
the second, a fresh engine in a warm process (graphs captured again, the
rest warm); the third, the steady state (an engine that has run these reads
before). A checkout named with `@padded` runs each batch as one dispatch
padded up to the smallest row variant that holds it, in place of the
engine's plan (the JAX engine's greedy split), to measure that plan against
the split; the engine keeps the split. `@eager` runs every dispatch as the
eager `step` (no CUDA graphs), to measure the graphs within one checkout.
The checkouts take turns, the order reversed every round (A B, B A, A B,
...), so drift on the card falls on both alike. Prints each run as it ends,
then the median, the lowest and the highest reads/s of each checkout and
pass, and the card's name and power limit. Exits non-zero without a GPU.
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
from deepchopper_tpu_torch.chop import ChopOptions
from deepchopper_tpu_torch.infer import engine as engine_module
from deepchopper_tpu_torch.infer.fused import fused_predict_chop

made = []


class Recorded(engine_module.PredictEngine):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        made.append(self)


engine_module.PredictEngine = Recorded
if sys.argv[2] == "padded":
    def one_dispatch(self, b, w):
        target = next((v for v in self._row_variants(w) if v >= b), b)
        return [(0, b, target)]

    Recorded._plan_dispatches = one_dispatch
elif sys.argv[2] == "eager":
    Recorded._run = lambda self, shape, ids, quals: self._eager(ids, quals)
args = ["predict", sys.argv[1], "--model", "hyenadna-small-32k-seqlen", "--random-init", "--fused-chop"]
parser = cli.build_parser()
passes = []
# The engine's totals grow over a pass; a checkout without graphs has no
# compile_s or captures (None).
names = ("compile_s", "captures", "dispatches")


def engine_totals():
    engine = made[-1].stats
    return (engine.tokens, engine.padded_tokens, *(getattr(engine, name, None) for name in names))


for k in range(3):
    was = engine_totals() if k == 2 else (0,) * (2 + len(names))
    torch.cuda.reset_peak_memory_stats()
    if k < 2:
        stats = cli.predict(parser.parse_args(args))
    else:
        stats = fused_predict_chop(made[-1], sys.argv[1], ChopOptions(output_prefix="again"))
    torch.cuda.synchronize()
    engine = made[-1].stats
    grown = [None if now is None else now - before for now, before in zip(engine_totals(), was)]
    passes.append({"reads": stats.total_fq_count, "records": stats.total_output_count, "elapsed_s": stats.elapsed_s,
                   "reads_per_s": stats.total_fq_count / stats.elapsed_s, "tokens_per_s": grown[0] / stats.elapsed_s,
                   "device_s": stats.device_s, "encode_s": stats.encode_s, **dict(zip(names, grown[2:])),
                   "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "padded_per_token": grown[1] / grown[0],
                   # (rows, width) shapes the engine has dispatched, and of those the ones dispatched once
                   "shapes": len(getattr(engine, "shape_counts", {})) or None,
                   "shapes_once": sum(n == 1 for n in getattr(engine, "shape_counts", {}).values())})
print(json.dumps(passes))
"""

PASSES = ("fresh process", "fresh engine, warm process", "the same engine again")


def run_one(checkout: str, fq: Path, cwd: Path) -> list[dict]:
    cwd.mkdir(parents=True)
    path, _, plan = checkout.partition("@")
    env = {**os.environ, "PYTHONPATH": path}
    res = subprocess.run([sys.executable, "-c", CHILD, str(fq), plan], cwd=cwd, env=env, capture_output=True, text=True,
                         timeout=900)  # fmt: skip
    if res.returncode != 0:
        raise SystemExit(f"fused run in {checkout} failed ({res.returncode}):\n{res.stderr[-4000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("checkouts", nargs="+", help="A checkout's root, with @padded or @eager")
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--reads", type=int, default=300, help="Reads of the benchmark's length mix")
    opts = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_fused_ab: CUDA is not available; this needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke

    checkouts = [str(Path(c.partition("@")[0]).resolve()) + c[len(c.partition("@")[0]) :] for c in opts.checkouts]
    runs: dict[tuple[str, int], list[float]] = {(c, k): [] for c in checkouts for k in range(len(PASSES))}
    with tempfile.TemporaryDirectory(dir=REPO / "build" if (REPO / "build").is_dir() else None) as tmp:
        work = Path(tmp)
        fq = chip_smoke.bench_reads(work, opts.reads)
        for rep in range(opts.reps):
            for i, checkout in enumerate(checkouts if rep % 2 == 0 else checkouts[::-1]):
                for k, got in enumerate(run_one(checkout, fq, work / f"run{rep}-{i}")):
                    runs[checkout, k].append(got["reads_per_s"])
                    print(json.dumps({"checkout": checkout, "round": rep, "pass": k + 1, **got}), flush=True)
    for (checkout, k), rates in runs.items():
        print(f"{checkout}, pass {k + 1} ({PASSES[k]}): "
              f"predict --fused-chop over {opts.reads} reads, reads/s median {statistics.median(rates):.1f}, "
              f"min {min(rates):.1f}, max {max(rates):.1f} over {len(rates)} runs: "
              f"{', '.join(f'{r:.1f}' for r in rates)}")  # fmt: skip
    print(chip_smoke.gpu_line())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
