#!/usr/bin/env python3
"""Where the baselines' `predict` time goes on one GPU.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 scripts/torch_baselines_profile.py [--reads 300]

First, the process's first transformer `predict` pass (random init, seed 0,
`chip_smoke.py`'s read mix) with the flash attention backend forced. Then,
for `transformer` and `cnn`: three `predict` passes of one engine on the
default backends (the first captures its CUDA graphs lazily, the later ones
replay them), each pass's seconds and reads/s; the third pass under
`torch.profiler`, device time by kernel (the 14 largest rows). Then the
attention alone at (1, 8, 32768, 32) bf16, the transformer's widest call, on each
`F.scaled_dot_product_attention` backend the card offers and on the default
choice (CUDA events, 5 runs after 2 warm-ups). Every line names the card and
its power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import shutil
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reads", type=int, default=300, help="Reads of the length mix")
    opts = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_baselines_profile: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as cs
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.profiler import ProfilerActivity, profile

    from deepchopper_tpu_torch.infer.engine import PredictEngine
    from deepchopper_tpu_torch.models.registry import DeepChopper

    card = cs.gpu_line()
    print(f"gpu: {card}, torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    work = REPO / "build" / "baselines_profile"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    fq = cs.bench_reads(work, opts.reads)
    # The process's first transformer pass with the flash backend forced,
    # before any pass on the default (cuDNN) backend: the default engine's
    # first pass below then pays only what the flash pass did not warm.
    engine = PredictEngine(DeepChopper.new("transformer", seed=0, device="cuda"), device="cuda")
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        engine.predict_file(fq, work / "transformer_flash")
    torch.cuda.synchronize()
    print(f"transformer first pass of the process, flash attention forced, on {card}: {engine.stats.elapsed_s:.3f} s, "
          f"{engine.stats.reads_per_s:.1f} reads/s", flush=True)
    for name in cs.BASELINES:
        engine = PredictEngine(DeepChopper.new(name, seed=0, device="cuda"), device="cuda")
        for i in range(3):
            reads, elapsed = engine.stats.reads, engine.stats.elapsed_s
            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if i == 2 else None
            t0 = time.perf_counter()
            with prof if prof is not None else contextlib.nullcontext():
                engine.predict_file(fq, work / f"{name}_{i}")
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            reads, elapsed = engine.stats.reads - reads, engine.stats.elapsed_s - elapsed
            print(f"{name} pass {i} on {card}: {reads} reads in {elapsed:.3f} s, {reads / elapsed:.1f} reads/s "
                  f"({engine.stats.captures} CUDA graphs captured so far, {engine.stats.compile_s:.3f} s)", flush=True)
        cs.print_device_time(prof, wall * 1e3, f"{name} pass 2 on {card}")

    q = torch.randn(1, 8, 32768, 32, device="cuda", dtype=torch.bfloat16)
    attend = lambda: torch.nn.functional.scaled_dot_product_attention(q, q, q)  # noqa: E731
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.MATH):  # fmt: skip
        try:
            with sdpa_kernel(backend):
                ms = cs.time_ms(attend)
        except RuntimeError as exc:
            print(f"attention (1, 8, 32768, 32) bf16, {backend.name}: unavailable ({str(exc)[:100]})")
            continue
        print(f"attention (1, 8, 32768, 32) bf16, {backend.name} on {card}: {ms:.3f} ms")
    print(f"attention (1, 8, 32768, 32) bf16, default choice on {card}: {cs.time_ms(attend):.3f} ms")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
