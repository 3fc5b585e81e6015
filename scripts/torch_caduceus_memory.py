#!/usr/bin/env python3
"""Device memory and time of the Caduceus flagship's train step, by the
number of blocks recomputed in the backward, on one GPU.

    python3 scripts/torch_caduceus_memory.py [--reps N] [--out FILE]

1. For each compute dtype (bfloat16, the registry's; float32, chip_smoke.py's
   gradient parity) and each batch shape (bf16 at (64, 1024) and
   (2, 32768), f32 at (32, 1024) and (1, 32768)), one train step
   (forward, backward, Adam; chip_smoke.py's seeded training batch) with k =
   0, 8 and 16 of the 16 blocks recomputed (the backbone's `_recompute`
   override): the bytes a token the forward keeps for the backward, and the
   step's peak (`max_memory_allocated`), both above what was allocated
   before the step (weights, gradients, Adam state), beside
   `models.caduceus.step_bytes`'s estimate with the constants in the code.
   From k = 0 and k = 16, the constants of `step_bytes`, the largest over
   the two shapes: a block's bytes a token (BLOCK: the kept bytes'
   difference over 16, plus the 4 x d_model bytes a recomputed block
   keeps), the rest of the peak (REST: the k = 0 peak less 16 blocks), and
   the backward's buffers while a recomputed block is held again
   (RECOMPUTE: the k = 16 peak less one block and 16 kept inputs).
2. With the measured constants, the k that `recompute_blocks` picks against
   the budget of `CaduceusBackbone.blocks_to_recompute` at (64, 1024),
   (2, 32768), (128, 1024), (4, 32768) and (1, 131072), bfloat16, and the
   step at that k and at k = 16: ms/step (host clock around `--reps` steps
   ending in a synchronise, after 2 warm-up steps), tokens/s, peak memory.
   The float32 step at (2, 32768) with k = 0 is tried last: its peak, or
   that it does not fit.
Prints the card's name and power limit; `--out` keeps the whole log. Exits
non-zero without a GPU.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402  (at the repository root, put on the path above)

FLAGSHIP = "caduceus-ph_seqlen-131k_d_model-256_n_layer-16"
SHAPES = {"bfloat16": ((64, 1024), (2, 32768)), "float32": ((32, 1024), (1, 32768))}
TIMED = ((64, 1024), (2, 32768), (128, 1024), (4, 32768), (1, 131072))
LOG: list[str] = []


def say(line: str) -> None:
    print(line, flush=True)
    LOG.append(line)


def model_in(dtype: str):
    """The flagship's random-init weights (seed 0) in train mode, in `dtype`."""
    from deepchopper_tpu_torch.models.registry import DeepChopper

    if dtype == "float32":
        return chip_smoke.f32_model(FLAGSHIP)
    return DeepChopper.new(FLAGSHIP, seed=0, device="cuda").train()


def step_memory(model, opt, batch) -> tuple[int, int]:
    """(bytes the forward keeps, the step's peak), above what was allocated before it."""
    import torch

    from deepchopper_tpu_torch.train.loss import continuous_interval_loss

    opt.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    loss = continuous_interval_loss(model(batch["input_ids"], batch["input_quals"]), batch["labels"])
    kept = torch.cuda.memory_allocated() - before
    loss.backward()
    opt.step()
    torch.cuda.synchronize()
    return kept, torch.cuda.max_memory_allocated() - before


def fit(dtype: str) -> tuple[float, float, float]:
    """Part 1 for one dtype: the measured (BLOCK, REST, RECOMPUTE) bytes a token."""
    import torch

    from deepchopper_tpu_torch.models import caduceus
    from deepchopper_tpu_torch.train.step import make_optimizer

    model = model_in(dtype)
    n, d_model = model.backbone_config.n_layer, model.backbone_config.d_model
    opt = make_optimizer(model.parameters(), 2e-4)
    blocks, rests, again = [], [], []
    for shape in SHAPES[dtype]:
        batch = chip_smoke.training_batch(*shape, seed=9)
        tokens = shape[0] * shape[1]
        model.backbone._recompute = 0
        step_memory(model, opt, batch)  # first use: the kernels' build, cuBLAS's workspaces, Adam's state
        got = {}
        for k in (0, 8, 16):
            model.backbone._recompute = k
            got[k] = step_memory(model, opt, batch)
            kept, peak = got[k]
            say(f"memory {dtype} {shape} k={k}: the forward keeps {kept / tokens:.0f} B a token ({kept / 1e9:.2f} GB), "
                f"peak {peak / tokens:.0f} B a token ({peak / 1e9:.2f} GB); step_bytes with the code's constants "
                f"{caduceus.step_bytes(tokens, n, k, d_model, dtype) / 1e9:.2f} GB")  # fmt: skip
        block = (got[0][0] - got[16][0]) / (n * tokens) + 4 * d_model
        blocks.append(block)
        rests.append(got[0][1] / tokens - n * block)
        again.append(got[16][1] / tokens - block - n * 4 * d_model)
        del batch
        torch.cuda.empty_cache()
    fits = (max(blocks), max(rests), max(again))
    say(f"fit {dtype}: " + "; ".join(f"{name} {max(v):.0f} B a token ({', '.join(f'{x:.0f}' for x in v)})" for name, v in
                                     (("BLOCK", blocks), ("REST", rests), ("RECOMPUTE", again))))  # fmt: skip
    model.backbone._recompute = None
    return fits


def time_steps(model, opt, shape, k: int | None, reps: int) -> tuple[float, float, int]:
    """(ms/step, peak GB, k) of `reps` bf16 train steps at `shape`, k forced or the policy's."""
    import torch

    from deepchopper_tpu_torch.train.step import train_step

    batch = chip_smoke.training_batch(*shape, seed=9)
    model.backbone._recompute = k
    for _ in range(2):
        train_step(model, opt, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = train_step(model, opt, batch)
    float(out["loss"])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / reps * 1e3
    used = model.backbone.blocks_to_recompute(*shape, batch["input_ids"].device)
    return ms, torch.cuda.max_memory_allocated() / 1e9, used


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=3, help="Timed train steps a shape")
    parser.add_argument("--out", type=Path, default=None, help="Also write the log here")
    opts = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_caduceus_memory: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = chip_smoke.gpu_line()
    say(f"gpu: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; total_memory "
        f"{torch.cuda.get_device_properties(0).total_memory}")  # fmt: skip

    from deepchopper_tpu_torch.models import caduceus
    from deepchopper_tpu_torch.train.step import make_optimizer

    for dtype in ("bfloat16", "float32"):
        block, rest, again = fit(dtype)
        caduceus.BLOCK_BYTES_PER_TOKEN[dtype], caduceus.REST_BYTES_PER_TOKEN[dtype] = block, rest
        caduceus.RECOMPUTE_BYTES_PER_TOKEN[dtype] = again
        torch.cuda.empty_cache()

    model = model_in("bfloat16")
    opt = make_optimizer(model.parameters(), 2e-4)
    for shape in TIMED:
        tokens = shape[0] * shape[1]
        for k in (None, 16):
            ms, peak, used = time_steps(model, opt, shape, k, opts.reps)
            say(f"train step {shape} bf16 on {card}, {'policy' if k is None else 'forced'} k={used}: {ms:.2f} ms/step, "
                f"{tokens / ms * 1e3:.0f} tokens/s, peak memory {peak:.2f} GB")  # fmt: skip
            torch.cuda.empty_cache()
    say(f"policy picks: {model.backbone._recompute_k}")
    del model, opt
    torch.cuda.empty_cache()

    model = model_in("float32")
    opt = make_optimizer(model.parameters(), 2e-4)
    model.backbone._recompute = 0
    batch = chip_smoke.training_batch(2, 32768, seed=9)
    try:
        kept, peak = step_memory(model, opt, batch)
        say(f"float32 (2, 32768) k=0: the forward keeps {kept / 1e9:.2f} GB, peak {peak / 1e9:.2f} GB above the weights")
    except torch.OutOfMemoryError as exc:  # a measurement: the answer is that it does not fit
        say(f"float32 (2, 32768) k=0: does not fit ({str(exc).splitlines()[0]})")
    if opts.out:
        opts.out.parent.mkdir(parents=True, exist_ok=True)
        opts.out.write_text("\n".join(LOG) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
