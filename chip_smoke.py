#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`deepchopper_tpu_torch`) on one GPU.

Run from the repository root:  python3 chip_smoke.py [--profile]

1. Prints the card's name and power limit, and runs `runtime_setup` on a
   fresh flagship engine: it builds every CUDA kernel of the predict and
   train paths from `deepchopper_tpu_torch/csrc` with nvcc (sm_90a), all nvcc
   processes started together, loads each library and launches the setup
   kernel (`csrc/setup.cu`, x + 1 on an (8, 128) tile) once. Prints setup_s
   and its build seconds, holds the setup kernel to x + 1 exactly and times
   it beside `torch.add`, after printing the host µs of each part of its
   launch path (ctypes call, allocation, stream lookup, device guard, checks).
2. Holds each kernel to its plain PyTorch version on the card, at every one
   of the 17 bucket widths:
   - the fused Hyena mixer at D = 256, B = 2, and its backward at D = 256,
     B = 3, in float32 (<= 1e-4 * max|ref|: f32 FFT rounding at N = 65536)
     and bfloat16 (<= 1e-2 * max|ref| against the plain version in the same
     dtype: bf16 output rounding is about 4e-3); each of the backward's five
     gradients, and a second call must be bitwise equal. Then, at the
     flagship batch shapes (forward B = 2^17 // W, backward min(512, 2^17 //
     W)), each again in bfloat16, timed beside the least time the card could
     take (bytes at 3.35 TB/s, f32 flops at 67 TFLOP/s) and, for the
     forward, beside the radix-2 design's time, for the backward with the
     layout its kernel runs (rows, pair or park) and the time of the filter
     VJP, the one part of its call left in PyTorch; the forward's call is
     split into kernel, the wrapper's device work and host time at W = 1024,
     8192 and 32768 (torch.profiler).
   - the three selective-scan kernels at Caduceus's widths (Din = 512,
     N = 16), B = 2^17 // W, both directions, float32, and at the ragged
     L = 1000 and at the config's max_seq_len L = 131072 (B = 1): scan_fwd's
     y and scan_ckpt's states within 1e-5 of max|ref|, scan_bwd's du,
     ddelta, dBp, dCp within 1e-5 and dA, dD (sums over B * L terms) within
     1e-4 of each one's max|ref|, all three bitwise repeatable; timed on
     the ladder beside their bounds (bytes, f32 flops, and exps at 16 a
     clock per SM), each width's line with scan_fwd's and scan_ckpt's plans
     (channels a block, segments).
   - the gated conv (gated_fwd, the unfused Hyena route) and the
     in_proj-fused mixer (mixer_inproj_fwd) at D = 256, B = 2, f32 (1e-4 of
     max|ref|) and bf16 (1e-2); the causal conv (conv_fwd) in f32 only; the
     gated and causal convs again across their layouts' boundaries and at
     off-ladder widths with D = 12, 20 (and 6 for the conv) and odd batches,
     each width's layout printed (rows of G rows or channels, or the two-CTA
     pair). Then each at B = 2^17 // W, timed beside its plain version and its bound (the
     in_proj kernel's also counts its GEMM at the bf16 tensor-core peak), the
     in_proj kernel also beside the composed route (torch.matmul + mixer_fwd),
     the conv beside its library call (depthwise F.conv1d).
     The causal conv's own path, the public op `models.hyena.causal_conv`,
     runs once a width over the ladder (no model route reaches it).
3. Drives `predict --random-init` (the CLI's own parser and code path) over
   ~300 seeded reads with the benchmark's length mix, including reads in the
   24576 and 32768 buckets, on hyenadna-small-32k-seqlen and on
   caduceus-ph_seqlen-131k_d_model-256_n_layer-16, both at full width and
   depth. The engine dispatches each batch as its plan's (rows, width)
   parts, each a CUDA graph captured at its first dispatch, whose eager run
   is that dispatch's own. Checks that the shards hold every read with
   finite logits and that the kernel ran once a layer (Hyena) or twice a
   layer (Caduceus) per dispatch (graph replays count). Re-runs the widest and
   the fullest batch with the plain mixer or
   scan on the card: in bfloat16 the argmax agrees on >= 99.9% of the
   positions outside the bf16 tie band, in float32 the logits agree within a
   fixed limit; a faulty version must fail both rules (see
   check_against_plain). Reports reads/s and tokens/s, lazy captures
   included, beside the capture seconds and the padded tokens, then again for
   a second pass on the same engine (its graphs captured).
   Hyena runs on each of its three mixer routes (default fused,
   DEEPCHOPPER_FUSE_SHORT=0 unfused: gated_fwd once a layer and mixer_fwd
   never; DEEPCHOPPER_FUSE_INPROJ=1: mixer_inproj_fwd once a layer), and
   each route other than the default is also held, in f32, to the default
   route's logits on the same batches.
   Then the north-star main path, `predict --fused-chop --random-init` on
   hyenadna-small-32k-seqlen over the same reads (phase_fused): the native
   host plane must run, mixer_fwd once a layer per batch and the setup
   kernel once; the chopped FASTQ must equal, byte for byte after
   decompression and under the same name, the two-phase path's (`predict
   --shard-format npz`, then `chop`; and through `pt`), and a control with
   one read's labels flipped must differ. Then a second pass on the CLI's
   engine, its graphs captured: byte-identical to the first. Prints each
   pass's reads/s, tokens/s, stage breakdown, capture seconds, dispatches
   and padded tokens, and setup_s. At the widest and the fullest batch of
   each family, bf16 and f32, every graph's output must equal the eager
   step's bitwise, and a replay without the copy-in of the next inputs must
   fail that rule (check_graph_replay). Then the flagship's whole ladder is
   captured by `warmup()`: its peak and held device memory beside the eager
   step's peak (phase_graph_memory).
4. The host-only commands on what the main path wrote (phase_eval; no
   kernel runs, and nothing calls `encode` or reads a parquet source, so
   the phase needs no pyarrow): a BAM written by the port's `BamWriter` with a
   seeded record for every read but one (mapped, unmapped, secondary,
   supplementary, MAPQ on both sides of 20, soft clips on both ends and
   strands, SA tags on some); `eval-bam` through the CLI over the
   flagship's npz shards from step 3's predict and over the fused phase's pt
   shards: the two runs' JSON files byte-identical, named pd300, the
   withheld read alone under missing_bam_record, every id a read of the
   FASTQ, and a BAM with a second read withheld (the control) must change
   the overlap results. Then `stat` on the FASTQ and the BAM (count, min and
   max of the lengths written), `tools diff` of the reads against the fused
   chop output, `tools select --type internal`, and a fresh process that
   imports deepchopper_tpu_torch and resolves its 71 top-level names
   without importing pyarrow or a kernel wrapper (then reports whether
   pyarrow imports on this machine). Last, with pyarrow blocked, a ratio
   split of 64 labelled reads gives the batches of the split with pyarrow
   as the machine has it (the parquet cache where pyarrow imports), writes
   no cache, trains two flagship steps through `train`, and a parquet
   source raises an ImportError naming pyarrow. Prints the phase's wall
   time, and
   the whole smoke's before the kernel table.
5. Train-step parity, each model and Hyena route: one float32 forward and
   backward with the kernels and with the plain version swapped in; every
   gradient leaf within a limit of its max, and a faulty backward must fail
   it (train_parity).
6. Drives `train` (the CLI's parser and code path) on each model, Hyena on
   each route, at full width: one epoch over ~300 labelled reads with the benchmark's length mix
   and reads in the 24576 and 32768 buckets, a val pass, test on the best
   checkpoint; checks finite losses, the checkpoints and the launches per
   batch, then `predict --checkpoint <best>` on a few reads. Caduceus trains
   at 2^16 tokens per batch (its activations at 2^17 outgrow the card).
   Then overfits one full Hyena batch (loss below half its first value
   within 100 steps) and times the train step of each model: ms/step,
   tokens/s and peak memory.
7. The transformer and CNN baselines, the sweep, the model folder and the
   web core (phase_baselines): `predict --random-init` through the CLI on
   `transformer` and `cnn` at full width over the phase-3 reads (every read
   present, finite logits; reads/s, tokens/s, capture seconds); one narrow
   batch and one row of the 32768 batch in float32 on the card against the
   same port model on the CPU within 1e-4 of max|logit|, with a control
   that must fail (the transformer without its positions, the CNN with
   train-mode BatchNorm); one `train` epoch of each from
   configs/experiment/{transformer,cnn}.yaml with the csv, jsonl,
   wandb_offline and mlflow loggers (finite losses, each logger's file),
   then `predict --checkpoint <best> --model cnn` against the checkpoint's
   model, BatchNorm buffers included; `train --sweep`, 2 trials of one epoch
   over optimizer.lr and model.lin1_size on the flagship (results.json with
   2 trials; mixer_fwd and mixer_bwd at 4 a batch in each); save_pretrained
   of the flagship and from_pretrained_dir (logits bitwise equal), then
   `predict --model <folder>`; `predict_record` on one 24575-base record
   (its 24576 tokens fill the 24576 bucket) against the fused path's labels
   for that read (the same smoothed intervals).
8. With `--profile`, profiles one warm `predict --fused-chop` pass of the
   flagship (graphs replayed: the mixer kernel must show in its device
   time), then one more pass of predict and three train steps of each
   model: device time by kernel and the device's busy share.
9. Prints the kernel table as one JSON line (launches from the train runs;
   conv_fwd's from its op's run; setup's from the fused run) and, last, the
   contract line.

Any failed phase exits non-zero without the contract line. Without CUDA, or
outside a checkout of the repository, it exits non-zero at once.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores
TOKENS_PER_BATCH = 1 << 17
# Caduceus keeps ~0.73 MB of activations per token for its backward (23.95 GB
# at 2^15 tokens, PERF.md): 2^17 tokens would outgrow the card's 80 GB, 2^16
# fits with room to spare.
CADUCEUS_TRAIN_TOKENS = 1 << 16
N_READS = 300


class SmokeFailure(RuntimeError):
    pass


def gpu_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )  # fmt: skip
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 5, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed(phase, *args):
    """Run one phase and print its wall time."""
    t0 = time.perf_counter()
    out = phase(*args)
    print(f"[{phase.__name__}: {time.perf_counter() - t0:.1f} s]", flush=True)
    return out


class Counts:
    """The launch counters of several op modules, reset and read together."""

    def __init__(self, *modules):
        self.modules = modules

    def reset(self) -> None:
        for module in self.modules:
            module.reset_launch_counts()

    def read(self) -> dict[str, int]:
        return {k: v for module in self.modules for k, v in module.launch_counts.items()}


@contextlib.contextmanager
def route_env(env: dict):
    """Set the Hyena mixer route's environment variables (as the JAX package
    reads them) for the duration, then restore them."""
    import os

    saved = {k: os.environ.get(k) for k in ROUTE_KEYS}
    for k in ROUTE_KEYS:
        os.environ.pop(k, None)
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


ROUTE_KEYS = ("DEEPCHOPPER_FUSE_SHORT", "DEEPCHOPPER_FUSE_INPROJ")
UNFUSED = {"DEEPCHOPPER_FUSE_SHORT": "0"}
INPROJ = {"DEEPCHOPPER_FUSE_INPROJ": "1"}


def mixer_inputs(batch: int, d_model: int, seq_len: int, dtype, seed: int):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    proj = torch.randn(batch, 3 * d_model, seq_len, generator=gen, device=dev).to(dtype)
    k_short = torch.randn(3, 1, 3 * d_model, generator=gen, device=dev) / math.sqrt(3)
    b_short = torch.randn(3 * d_model, generator=gen, device=dev) * 0.1
    decay = torch.exp(-torch.arange(seq_len, device=dev, dtype=torch.float32) / (seq_len / 8))
    k_long = torch.randn(seq_len, d_model, generator=gen, device=dev) * decay[:, None]
    bias = torch.randn(d_model, generator=gen, device=dev)
    return proj, k_short, b_short, k_long, bias


def compare_mixer(args, tol: float) -> tuple[float, float]:
    """Kernel vs plain version on the same inputs: (max-abs error, max|ref|).
    Fails above tol * max|ref|."""
    import torch

    from deepchopper_tpu_torch.ops import mixer

    got = mixer.mixer_fft_conv_bm(*args)
    torch.cuda.synchronize()
    ref = mixer.mixer_reference(*args)
    torch.cuda.synchronize()
    batch, _, seq_len = args[0].shape
    where = f"mixer B={batch} L={seq_len} {args[0].dtype}"
    if got.shape != ref.shape or got.dtype != ref.dtype:
        raise SmokeFailure(f"{where}: {got.shape}/{got.dtype} vs {ref.shape}/{ref.dtype}")
    err = (got.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    if not math.isfinite(err) or err > tol * scale:
        raise SmokeFailure(f"{where}: err {err:.3e} > {tol} * {scale:.3e}")
    return err, scale


def mixer_bound(batch: int, d_model: int, seq_len: int, itemsize: int) -> tuple[float, float]:
    """(bytes, flops) the mixer must move and do: proj read once, out written
    once, filter taps read once; a real FFT conv at N = 2L per row."""
    n = 2 * seq_len
    nbytes = batch * 4 * d_model * seq_len * itemsize + 4 * (seq_len * d_model + 13 * d_model)
    flops = batch * d_model * (5 * n * math.log2(n) + 3 * n + 23 * seq_len)
    return nbytes, flops


SPLIT_WIDTHS = (1024, 8192, 32768)
# The radix-2 mixer_fwd's call at each width, bf16, B = 2^17 // W (PERF.md's
# first by-width row, H100 80GB HBM3 at 700 W), printed beside this run's.
RADIX2_MIXER_MS = {256: 1.248, 512: 1.362, 768: 2.153, 1024: 1.631, 1280: 2.616, 1536: 2.199, 2048: 1.718,
                   2560: 2.827, 3072: 2.360, 4096: 1.829, 5120: 3.098, 6144: 2.567, 8192: 2.057, 12288: 3.189,
                   16384: 2.650, 24576: 3.920, 32768: 3.375}  # fmt: skip


def print_mixer_call_split(d_model: int, reps: int = 5) -> None:
    """The timed mixer call split into the kernel and the wrapper's own device
    work (filter_spectrum's rfft, casts), from torch.profiler's kernel times
    over `reps` calls, at three ladder widths (bf16, B = 2^17 // W); what the
    CUDA-event time of a call holds beyond both is host time and gaps."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from deepchopper_tpu_torch.ops import mixer

    print("mixer_fwd call split (ms a call; profiler kernel times, CUDA-event call time):")
    for seq_len in SPLIT_WIDTHS:
        batch = TOKENS_PER_BATCH // seq_len
        args = mixer_inputs(batch, d_model, seq_len, torch.bfloat16, seed=seq_len + 2)
        call_ms = time_ms(lambda: mixer.mixer_fft_conv_bm(*args), reps=reps)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                mixer.mixer_fft_conv_bm(*args)
            torch.cuda.synchronize()
        kernel = other = 0.0
        names = set()
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
                if "mixer_fwd" in e.key:
                    kernel += e.self_device_time_total / 1e3 / reps
                else:
                    other += e.self_device_time_total / 1e3 / reps
                    names.add(e.key[:40])
        if not kernel:
            print(f"  W={seq_len:6d}: call {call_ms:.3f}; kernel time not measured (the profiler saw no device time)")
            continue
        print(f"  W={seq_len:6d} B={batch:4d}: call {call_ms:.3f}, kernel {kernel:.3f}, wrapper's device work "
              f"{other:.3f} ({'; '.join(sorted(names))}), host and gaps {call_ms - kernel - other:.3f}")  # fmt: skip
        del args


def phase_kernels() -> dict:
    import torch

    from deepchopper_tpu_torch.data.bucketing import default_buckets
    from deepchopper_tpu_torch.ops import mixer

    d_model = 256
    widths = default_buckets(32768)
    if len(widths) != 17:
        raise SmokeFailure(f"expected the 17-width ladder, got {widths}")
    worst_bf16 = 0.0
    print("mixer_fwd vs plain at D=256, B=2 (max-abs err / max|ref|):")
    for seq_len in widths:
        errs = {}
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
            errs[dtype] = compare_mixer(mixer_inputs(2, d_model, seq_len, dtype, seed=seq_len), tol)
        worst_bf16 = max(worst_bf16, errs[torch.bfloat16][0])
        (e32, s32), (e16, s16) = errs[torch.float32], errs[torch.bfloat16]
        print(
            f"  L={seq_len:6d} N={mixer.fft_size(seq_len):6d} f32 {e32:.2e} ({e32 / s32:.1e})"
            f"  bf16 {e16:.2e} ({e16 / s16:.1e})"
        )

    print("mixer_fwd at flagship batch shapes, bf16 (B = 2^17 // W):")
    totals = {"ms": 0.0, "plain_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0, "bound_ms": 0.0}
    for seq_len in widths:
        batch = min(512, TOKENS_PER_BATCH // seq_len)
        args = mixer_inputs(batch, d_model, seq_len, torch.bfloat16, seed=seq_len + 1)
        err, scale = compare_mixer(args, 1e-2)
        worst_bf16 = max(worst_bf16, err)
        ms = time_ms(lambda: mixer.mixer_fft_conv_bm(*args))
        plain_ms = time_ms(lambda: mixer.mixer_reference(*args), reps=3)
        nbytes, flops = mixer_bound(batch, d_model, seq_len, 2)
        bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
        bound = max(bytes_ms, ops_ms)
        for k, v in (("ms", ms), ("plain_ms", plain_ms), ("bytes_ms", bytes_ms), ("ops_ms", ops_ms), ("bound_ms", bound)):
            totals[k] += v
        print(
            f"  W={seq_len:6d} B={batch:4d} err {err:.2e} ({err / scale:.1e})  kernel {ms:8.3f} ms  "
            f"plain {plain_ms:8.3f} ms  bound {bound:.3f} ms ({'bytes' if bytes_ms >= ops_ms else 'operations'}; "
            f"bytes {bytes_ms:.3f}, f32 ops {ops_ms:.3f})  kernel/bound {ms / bound:.1f}x  "
            f"radix-2 design {RADIX2_MIXER_MS[seq_len]:.3f} ms"
        )
        del args
    print(
        f"  ladder total: kernel {totals['ms']:.3f} ms, plain {totals['plain_ms']:.3f} ms, "
        f"bound {totals['bound_ms']:.3f} ms"
    )
    print_mixer_call_split(d_model)
    return {
        "name": "mixer_fwd",
        "route": "cuda",
        "source": "deepchopper_tpu_torch/csrc/mixer_fwd.cu",
        "replaces": "deepchopper_tpu/ops/pallas_fft.py:671",
        "launches": None,
        "max_abs_err": worst_bf16,
        "ms": totals["ms"],
        "plain_ms": totals["plain_ms"],
        "bound_ms": totals["bound_ms"],
        "bound_by": "bytes" if totals["bytes_ms"] >= totals["ops_ms"] else "operations",
        "library_ms": None,
    }


def mixer_bwd_inputs(batch: int, d_model: int, seq_len: int, dtype, seed: int):
    import torch

    proj, k_short, b_short, k_long, bias = mixer_inputs(batch, d_model, seq_len, dtype, seed)
    gen = torch.Generator(device="cuda").manual_seed(seed + 7)
    dy = torch.randn(batch, d_model, seq_len, generator=gen, device="cuda").to(dtype)
    return proj, dy, k_short, b_short, k_long, bias


def compare_mixer_bwd(args, tol: float, where: str) -> tuple[float, float]:
    """Backward kernel vs plain version on the same inputs, each of the five
    gradients within tol * its max|ref|; a second call must be bitwise equal.
    Returns (max-abs error, worst error / max|ref|) over the five."""
    import torch

    from deepchopper_tpu_torch.ops import mixer

    got = mixer.mixer_bwd_cuda(*args)
    again = mixer.mixer_bwd_cuda(*args)
    torch.cuda.synchronize()
    ref = mixer.mixer_bwd_reference(*args)
    torch.cuda.synchronize()
    worst_abs = worst_rel = 0.0
    for name, g, a, r in zip(("dproj", "dk_short", "db_short", "dk_long", "dbias"), got, again, ref):
        if g.shape != r.shape or g.dtype != r.dtype:
            raise SmokeFailure(f"{where} {name}: {g.shape}/{g.dtype} vs {r.shape}/{r.dtype}")
        if not torch.equal(g, a):
            raise SmokeFailure(f"{where} {name}: two calls on the same inputs differ")
        err = (g.float() - r.float()).abs().max().item()
        scale = r.float().abs().max().item()
        if not math.isfinite(err) or err > tol * scale:
            raise SmokeFailure(f"{where} {name}: err {err:.3e} > {tol} * {scale:.3e}")
        worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, err / scale)
    return worst_abs, worst_rel


def mixer_bwd_bound(batch: int, d_model: int, seq_len: int, itemsize: int) -> tuple[float, float]:
    """(bytes, flops) the mixer backward must move and do: proj and dy read
    once, dproj written once (4 + 3 streams of (B, D, L)), the parameters
    read and their gradients written; per row four real FFTs at N = 2L, the
    spectral products and the gate recompute, and the short-conv adjoint."""
    n = 2 * seq_len
    nbytes = batch * 7 * d_model * seq_len * itemsize + 2 * 4 * (seq_len * d_model + 13 * d_model)
    flops = batch * d_model * (10 * n * math.log2(n) + 9 * n + 40 * seq_len + 3 * 12 * seq_len)
    return nbytes, flops


def phase_bwd_kernel() -> dict:
    """The backward kernel against its plain version at D = 256, B = 3 (odd)
    at every ladder width, in f32 (1e-4 of each gradient's max) and bf16
    (1e-2), bitwise repeatable; then at the flagship training shapes in bf16,
    held again and timed beside the bound, each width with the layout the
    kernel runs and the time of the part of the call left in PyTorch (the
    filter's VJP)."""
    import torch

    from deepchopper_tpu_torch.data.bucketing import default_buckets
    from deepchopper_tpu_torch.ops import mixer

    d_model = 256
    widths = default_buckets(32768)
    print("mixer_bwd vs plain at D=256, B=3 (worst of the five gradients: max-abs err, of max|ref|):")
    for seq_len in widths:
        line = f"  L={seq_len:6d} N={mixer.fft_size(seq_len):6d}"
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
            where = f"mixer_bwd B=3 L={seq_len} {dtype}"
            err, rel = compare_mixer_bwd(mixer_bwd_inputs(3, d_model, seq_len, dtype, seed=seq_len), tol, where)
            line += f"  {str(dtype)[6:]} {err:.2e} ({rel:.1e})"
        print(line + "  bitwise repeatable")

    print("mixer_bwd at flagship training shapes, bf16 (B = min(512, 2^17 // W)); kernel = the wrapper's call:")
    totals = {"ms": 0.0, "plain_ms": 0.0, "tail_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0, "bound_ms": 0.0}
    worst = 0.0
    for seq_len in widths:
        batch = min(512, TOKENS_PER_BATCH // seq_len)
        args = mixer_bwd_inputs(batch, d_model, seq_len, torch.bfloat16, seed=seq_len + 1)
        err, rel = compare_mixer_bwd(args, 1e-2, f"mixer_bwd B={batch} L={seq_len} bf16")
        worst = max(worst, err)
        ms = time_ms(lambda: mixer.mixer_bwd_cuda(*args))
        plain_ms = time_ms(lambda: mixer.mixer_bwd_reference(*args), reps=3)
        # The PyTorch part of the wrapper alone: the filter's VJP on dkhat.
        n = mixer.fft_size(seq_len)
        dkhat = torch.randn(d_model, n // 2 + 1, dtype=torch.complex64, device="cuda")
        tail_ms = time_ms(lambda: mixer._filter_vjp(dkhat, args[4], args[5], n), reps=3)
        plan = mixer.mixer_bwd_plan(batch, d_model, seq_len)
        del dkhat
        nbytes, flops = mixer_bwd_bound(batch, d_model, seq_len, 2)
        bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
        bound = max(bytes_ms, ops_ms)
        for k, v in (("ms", ms), ("plain_ms", plain_ms), ("tail_ms", tail_ms), ("bytes_ms", bytes_ms),
                     ("ops_ms", ops_ms), ("bound_ms", bound)):  # fmt: skip
            totals[k] += v
        print(
            f"  W={seq_len:6d} B={batch:4d} {plan['layout']:4s} (G {plan['G']:2d}, {plan['threads']} threads, "
            f"{plan['groups']} groups) err {err:.2e} ({rel:.1e})  kernel {ms:8.3f} ms (PyTorch tail {tail_ms:.3f})  "
            f"plain {plain_ms:8.3f} ms  bound {bound:.3f} ms ({'bytes' if bytes_ms >= ops_ms else 'operations'}; "
            f"bytes {bytes_ms:.3f}, f32 ops {ops_ms:.3f})  kernel/bound {ms / bound:.1f}x"
        )
        del args
    print(
        f"  ladder total: kernel {totals['ms']:.3f} ms (PyTorch tail {totals['tail_ms']:.3f}), "
        f"plain {totals['plain_ms']:.3f} ms, bound {totals['bound_ms']:.3f} ms"
    )
    return {
        "name": "mixer_bwd",
        "route": "cuda",
        "source": "deepchopper_tpu_torch/csrc/mixer_bwd.cu",
        "replaces": "deepchopper_tpu/ops/pallas_fft.py:1256",
        "launches": None,
        "max_abs_err": worst,
        "ms": totals["ms"],
        "plain_ms": totals["plain_ms"],
        "bound_ms": totals["bound_ms"],
        "bound_by": "bytes" if totals["bytes_ms"] >= totals["ops_ms"] else "operations",
        "library_ms": None,
    }


# -- selective-scan kernels (Caduceus) ----------------------------------------------

SCAN_D_IN, SCAN_N = 512, 16  # Caduceus at d_model 256, expand 2, d_state 16
SFU_PER_SM_CLOCK = 16  # exp2 a clock per SM (CUDA C++ Programming Guide, arithmetic throughput, cc 9.0)


def sfu_rate() -> float:
    """The card's exps per second: 16 a clock per SM at its maximum SM clock."""
    import torch

    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    )  # fmt: skip
    mhz = float(res.stdout.strip().splitlines()[0])
    return SFU_PER_SM_CLOCK * torch.cuda.get_device_properties(0).multi_processor_count * mhz * 1e6


def scan_inputs(batch: int, seq_len: int, seed: int):
    """(u, delta, A, Bp, Cp, D, dy) on the card, float32, shaped and strided
    as the Caduceus mixer makes them: Bp and Cp are slices of one (B, L,
    dt_rank + 2N) projection, delta a softplus, A = -(1..N) as initialised."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")  # noqa: E731
    u = r(batch, seq_len, SCAN_D_IN)
    delta = F.softplus(r(batch, seq_len, SCAN_D_IN))
    A = -torch.arange(1, SCAN_N + 1, device="cuda", dtype=torch.float32).expand(SCAN_D_IN, SCAN_N).contiguous()
    proj = r(batch, seq_len, 16 + 2 * SCAN_N)
    Bp, Cp = proj[..., 16 : 16 + SCAN_N], proj[..., 16 + SCAN_N :]
    return u, delta, A, Bp, Cp, r(SCAN_D_IN), r(batch, seq_len, SCAN_D_IN)


def within(got, ref, tol: float, where: str) -> tuple[float, float]:
    """(max-abs error, of max|ref|); fails above tol * max|ref|."""
    if got.shape != ref.shape or got.dtype != ref.dtype:
        raise SmokeFailure(f"{where}: {tuple(got.shape)}/{got.dtype} vs {tuple(ref.shape)}/{ref.dtype}")
    err = (got.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    if not math.isfinite(err) or err > tol * scale:
        raise SmokeFailure(f"{where}: err {err:.3e} > {tol} * {scale:.3e}")
    return err, err / scale


SCAN_GRADS = (("du", 1e-5), ("ddelta", 1e-5), ("dA", 1e-4), ("dBp", 1e-5), ("dCp", 1e-5), ("dD", 1e-4))


def compare_scan(args, reverse: bool, where: str) -> dict[str, tuple[float, float]]:
    """The three scan kernels against their plain versions on the same
    inputs: {kernel: (max-abs error, worst error of max|ref|)}; each one's
    second call must be bitwise equal to its first."""
    import torch

    from deepchopper_tpu_torch.ops import scan

    u, delta, A, Bp, Cp, D, dy = args
    out = {}
    y = scan.scan_fwd_cuda(u, delta, A, Bp, Cp, D, reverse)
    if not torch.equal(y, scan.scan_fwd_cuda(u, delta, A, Bp, Cp, D, reverse)):
        raise SmokeFailure(f"{where} y: two calls on the same inputs differ")
    torch.cuda.synchronize()
    out["scan_fwd"] = within(y, scan.selective_scan_reference(u, delta, A, Bp, Cp, D, reverse), 1e-5, f"{where} y")
    ckpt = scan.scan_ckpt_cuda(u, delta, A, Bp, reverse)
    if not torch.equal(ckpt, scan.scan_ckpt_cuda(u, delta, A, Bp, reverse)):
        raise SmokeFailure(f"{where} ckpt: two calls on the same inputs differ")
    torch.cuda.synchronize()
    out["scan_ckpt"] = within(ckpt, scan.scan_ckpt_reference(u, delta, A, Bp, reverse), 1e-5, f"{where} ckpt")
    got = scan.scan_bwd_cuda(u, delta, A, Bp, Cp, D, dy, ckpt, reverse)
    again = scan.scan_bwd_cuda(u, delta, A, Bp, Cp, D, dy, ckpt, reverse)
    torch.cuda.synchronize()
    ref = scan.scan_bwd_reference(u, delta, A, Bp, Cp, D, dy, reverse)
    worst = (0.0, 0.0)
    for (name, tol), g, a, r in zip(SCAN_GRADS, got, again, ref):
        if not torch.equal(g, a):
            raise SmokeFailure(f"{where} {name}: two calls on the same inputs differ")
        err, rel = within(g, r, tol, f"{where} {name}")
        worst = (max(worst[0], err), max(worst[1], rel))
    out["scan_bwd"] = worst
    return out


def scan_bound(kind: str, batch: int, seq_len: int, exps_per_s: float) -> tuple[float, float, str]:
    """(bytes ms, operations ms, what bounds the operations) of one call:
    each input read once and each output written once; f32 flops on the CUDA
    cores and, at least, one exp per (token, channel, state) on the
    special-function units."""
    tok, d, n = batch * seq_len, SCAN_D_IN, SCAN_N
    ckpt = batch * -(-seq_len // 32) * n * d
    if kind == "scan_fwd":  # u, delta, Bp, Cp, A, D in; y out
        nbytes, flops = 4 * (3 * tok * d + 2 * tok * n + d * n + d), 6 * tok * d * n
    elif kind == "scan_ckpt":  # u, delta, Bp, A in; ckpt out
        nbytes, flops = 4 * (2 * tok * d + tok * n + d * n + ckpt), 4 * tok * d * n
    else:  # u, delta, dy, Bp, Cp, ckpt, A, D in; du, ddelta, dBp, dCp, dA, dD out
        nbytes, flops = 4 * (5 * tok * d + 4 * tok * n + ckpt + 2 * (d * n + d)), 20 * tok * d * n
    flops_ms, exps_ms = flops / F32_FLOPS_PER_S * 1e3, tok * d * n / exps_per_s * 1e3
    return nbytes / HBM_BYTES_PER_S * 1e3, max(flops_ms, exps_ms), "exps" if exps_ms >= flops_ms else "f32 flops"


def phase_scan_kernels() -> list[dict]:
    """The scan kernels against their plain versions at every ladder width
    (B = 2^17 // W) in both directions, at the ragged L = 1000 and at the
    config's max_seq_len 131072 (B = 1); timed on the ladder in both
    directions, the plain versions in the forward direction."""
    import torch

    from deepchopper_tpu_torch.data.bucketing import default_buckets
    from deepchopper_tpu_torch.ops import scan

    exps_per_s = sfu_rate()
    print(f"selective scan at Din={SCAN_D_IN}, N={SCAN_N}, B = 2^17 // W, f32 (exps at {exps_per_s:.3e}/s); "
          "err = worst max-abs error (of max|ref|)")  # fmt: skip
    names = ("scan_fwd", "scan_ckpt", "scan_bwd")
    rows = {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0, "err": 0.0} for k in names}
    widths = default_buckets(32768)
    for seq_len in [*widths, 1000, 131072]:
        batch = TOKENS_PER_BATCH // seq_len
        args = scan_inputs(batch, seq_len, seed=seq_len)
        u, delta, A, Bp, Cp, D, dy = args
        plan = scan.scan_fwd_plan(batch, seq_len, SCAN_D_IN, SCAN_N)
        ckpt_plan = scan.scan_ckpt_plan(batch, seq_len, SCAN_D_IN, SCAN_N)
        for reverse in (False, True):
            where = (f"W={seq_len:6d} B={batch:3d} {'rev' if reverse else 'fwd'} (scan_fwd plan: {plan.channels} "
                     f"channels a block, {plan.segments} segments of {plan.seg_len}; scan_ckpt plan: "
                     f"{ckpt_plan.segments} segments of {ckpt_plan.seg_len})")  # fmt: skip
            errs = compare_scan(args, reverse, where)
            for k in names:
                rows[k]["err"] = max(rows[k]["err"], errs[k][0])
            line = where + " " + " ".join(f"{k} {e:.1e} ({r:.1e})" for k, (e, r) in errs.items())
            if seq_len not in widths:
                print(line + "  (off the ladder: checked, not timed)")
                continue
            ckpt = scan.scan_ckpt_cuda(u, delta, A, Bp, reverse)
            calls = {
                "scan_fwd": (lambda: scan.scan_fwd_cuda(u, delta, A, Bp, Cp, D, reverse),
                             lambda: scan.selective_scan_reference(u, delta, A, Bp, Cp, D, reverse)),
                "scan_ckpt": (lambda: scan.scan_ckpt_cuda(u, delta, A, Bp, reverse),
                              lambda: scan.scan_ckpt_reference(u, delta, A, Bp, reverse)),
                "scan_bwd": (lambda: scan.scan_bwd_cuda(u, delta, A, Bp, Cp, D, dy, ckpt, reverse),
                             lambda: scan.scan_bwd_reference(u, delta, A, Bp, Cp, D, dy, reverse)),
            }  # fmt: skip
            for k, (kernel, plain) in calls.items():
                ms = time_ms(kernel)
                line += f" | {k} {ms:.3f} ms"
                if reverse:
                    continue
                plain_ms = time_ms(plain, reps=2, warmup=0)
                bytes_ms, ops_ms, ops_by = scan_bound(k, batch, seq_len, exps_per_s)
                bound = max(bytes_ms, ops_ms)
                for key, v in (("ms", ms), ("plain_ms", plain_ms), ("bytes_ms", bytes_ms), ("ops_ms", ops_ms),
                               ("bound_ms", bound)):  # fmt: skip
                    rows[k][key] += v
                line += (f" plain {plain_ms:.3f} bound {bound:.3f} ({'bytes' if bytes_ms >= ops_ms else ops_by}; "
                         f"bytes {bytes_ms:.3f}, ops {ops_ms:.3f}) x{ms / bound:.1f}")  # fmt: skip
            print(line)
            del ckpt
        del args, u, delta, A, Bp, Cp, D, dy
    out = []
    for k, row in rows.items():
        print(f"  {k} ladder total (forward direction): kernel {row['ms']:.3f} ms, plain {row['plain_ms']:.3f} ms, "
              f"bound {row['bound_ms']:.3f} ms")  # fmt: skip
        source = "scan_bwd.cu" if k == "scan_bwd" else "scan_fwd.cu"
        line = {"scan_fwd": 46, "scan_ckpt": 179, "scan_bwd": 200}[k]
        out.append({
            "name": k, "route": "cuda", "source": f"deepchopper_tpu_torch/csrc/{source}",
            "replaces": f"deepchopper_tpu/ops/pallas_scan.py:{line}", "launches": None, "max_abs_err": row["err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": "bytes" if row["bytes_ms"] >= row["ops_ms"] else "operations", "library_ms": None,
        })  # fmt: skip
    return out


# -- predict ---------------------------------------------------------------------------

HYENA = "hyenadna-small-32k-seqlen"
CADUCEUS = "caduceus-ph_seqlen-131k_d_model-256_n_layer-16"


def _shard_read_names(ids) -> list[str]:
    return [bytes(int(c) for c in row[2 : 2 + row[0]]).decode("ascii") for row in ids]


def bench_reads(work: Path, n: int = N_READS) -> Path:
    """n reads with the benchmark's length mix, one forced into each of the
    24576 and 32768 buckets."""
    from deepchopper_tpu_torch.data.synth import read_lengths, synth_fastq

    lengths = read_lengths(n, seed=0)
    if not ((lengths >= 16400) & (lengths <= 24000)).any():
        lengths[0] = 20000
    if not ((lengths >= 24600) & (lengths <= 32000)).any():
        lengths[1] = 30000
    return synth_fastq(work / "reads.fq", lengths, seed=0)


def phase_predict(card: str, model: str, fq: Path, counts: Counts, per_layer: dict[str, int], tag: str = "") -> dict:
    """`predict --random-init` through the CLI on `model` over the reads of
    `fq` into `fq.parent / (model + tag) / "out"`; the shards must hold
    every read with finite logits in the 24576 and 32768 buckets, and each
    kernel k of per_layer must have launched per_layer[k] x n_layer times per
    dispatch, replays of the engine's CUDA graphs included (a capture's eager
    run is its first dispatch's own), plus as many per warm run (none here);
    0 for a kernel the route must not reach. Then the CLI's engine predicts
    the reads once more, every shape captured: the steady state's reads/s,
    with the same launch identity. Returns the first run's launches."""
    import numpy as np
    import torch

    from deepchopper_tpu_torch import cli
    from deepchopper_tpu_torch.models.registry import build_model

    work = fq.parent / (model + tag)
    parser = cli.build_parser()
    base = ["predict", str(fq), "--model", model, "--random-init"]
    cli.predict(parser.parse_args([*base, "-o", str(work / "warm"), "--limit-batches", "1"]))
    torch.cuda.synchronize()

    out = work / "out"
    args = parser.parse_args([*base, "-o", str(out)])
    counts.reset()
    with recorded_engines() as made:
        stats = cli.predict(args)
    torch.cuda.synchronize()
    launches = counts.read()

    n_layer = build_model(model).backbone_config.n_layer
    shards = sorted(out.glob("0/*.npz"))
    names: list[str] = []
    widths = set()
    for p in shards:
        s = np.load(p)
        pred = s["prediction"]
        if pred.dtype != np.float32 or pred.shape != (*s["seq"].shape, 2) or not np.isfinite(pred).all():
            raise SmokeFailure(f"{p.name}: prediction {pred.dtype} {pred.shape} finite={np.isfinite(pred).all()}")
        names += _shard_read_names(s["id"])
        widths.add(s["seq"].shape[1])
    want = {f"bench_read_{i}" for i in range(N_READS)}
    if len(names) != N_READS or set(names) != want:
        raise SmokeFailure(f"{model}: shards hold {len(names)} reads ({len(set(names) & want)} of {N_READS} expected)")
    if not {24576, 32768} <= widths:
        raise SmokeFailure(f"{model}: large buckets missing from the run: widths {sorted(widths)}")
    runs = stats.dispatches + stats.warm_runs  # a lazy capture's eager run is its first dispatch's own
    want = {k: n * n_layer * runs for k, n in per_layer.items()}
    got = {k: launches.get(k) for k in want}
    if got != want or not any(want.values()) or stats.batches != len(shards) or not stats.captures:
        raise SmokeFailure(f"{model}{tag}: launches {got} != {want} ({stats.batches} batches, {stats.dispatches} "
                           f"dispatches, {stats.captures} captures, {len(shards)} shards)")  # fmt: skip
    print(
        f"predict {model}{tag}: {stats.reads} reads, {stats.tokens} tokens, {stats.batches} batches, widths "
        f"{sorted(widths)}; launches {got} = per layer {per_layer} x {n_layer} layers x ({stats.dispatches} "
        f"dispatches + {stats.warm_runs} warm runs; {stats.captures} CUDA graphs captured, each from its first "
        f"dispatch's eager run); padded tokens {stats.padded_tokens} "
        f"({stats.padded_tokens / stats.tokens:.3f} x the tokens)"
    )
    print(
        f"predict {model}{tag} throughput on {card}: {stats.reads / stats.elapsed_s:.1f} reads/s, "
        f"{stats.tokens / stats.elapsed_s:.0f} tokens/s ({stats.elapsed_s:.3f} s, lazy captures included; compile_s "
        f"{stats.compile_s:.3f}, the host's seconds in capturing {stats.captures} CUDA graphs)"
    )

    # `stats` is the engine's own: it grows over the second pass.
    before = (stats.reads, stats.tokens, stats.elapsed_s, stats.dispatches, stats.captures, stats.warm_runs)
    counts.reset()
    made[0].predict_file(fq, work / "again")
    torch.cuda.synchronize()
    again = counts.read()
    reads, tokens, elapsed, dispatches, captures, warm_runs = (
        now - was for now, was in zip((stats.reads, stats.tokens, stats.elapsed_s, stats.dispatches, stats.captures,
                                       stats.warm_runs), before))  # fmt: skip
    want = {k: n * n_layer * (dispatches + warm_runs) for k, n in per_layer.items()}
    if {k: again.get(k) for k in want} != want or reads != N_READS:
        raise SmokeFailure(f"{model}{tag} second pass: launches {again} != {want}, {reads} reads")
    print(f"predict {model}{tag} second pass on the same engine, on {card}: {reads / elapsed:.1f} reads/s, "
          f"{tokens / elapsed:.0f} tokens/s ({elapsed:.3f} s; {dispatches} dispatches, {captures} new captures)")
    return launches


ARGMAX_AGREEMENT = 0.999  # bf16 argmax outside the tie band, kernel vs plain version
# bf16 tie bands, of max|logit|. Hyena: two bf16 ulps at the logit scale (the
# head's logits are bf16 products). Caduceus: its 16 bidirectional layers round
# an f32 stream to bf16 at three projections each, so two correct plain scans
# (default chunk and chunk 7) differ by up to 4.9% of max|logit| (0.172 at
# 3.5) and agree on only 99.950% of the positions beyond 2^-7 (PERF.md):
# a margin above twice that difference, 2^-3, cannot flip under it.
HYENA_TIE_BAND = 2.0**-7
CADUCEUS_TIE_BAND = 2.0**-3


def mixer_at_4l(proj, k_short, b_short, k_long, bias):
    """The plain mixer with its FFT at 4L: a second correct mixer that
    differs from the plain one only in rounding (zeros appended after the
    sequence change nothing before it, the convolutions being causal)."""
    import torch.nn.functional as F

    from deepchopper_tpu_torch.ops import mixer

    seq_len = proj.shape[2]
    out = mixer.mixer_reference(F.pad(proj, (0, seq_len)), k_short, b_short, F.pad(k_long, (0, 0, 0, seq_len)), bias)
    return out[..., :seq_len]


def mixer_taps_reversed(proj, k_short, b_short, k_long, bias):
    """A faulty mixer: the short conv's taps in the wrong order."""
    from deepchopper_tpu_torch.ops import mixer

    return mixer.mixer_reference(proj, k_short.flip(0), b_short, k_long, bias)


def mixer_bf16_io(proj, k_short, b_short, k_long, bias):
    """A lower-precision mixer: input and output rounded to bfloat16."""
    import torch

    from deepchopper_tpu_torch.ops import mixer

    return mixer.mixer_reference(proj.to(torch.bfloat16), k_short, b_short, k_long, bias).to(proj.dtype)


def scan_reverse_run_forward(u, delta, A, Bp, Cp, D, reverse=False):
    """A faulty scan: the reverse direction walks left to right."""
    from deepchopper_tpu_torch.ops import scan

    return scan.selective_scan_reference(u, delta, A, Bp, Cp, D, False)


@contextlib.contextmanager
def swapped(module, attr: str, fn):
    """Route every call the model makes to module.attr through fn."""
    kernel_fn = getattr(module, attr)
    setattr(module, attr, fn)
    try:
        yield
    finally:
        setattr(module, attr, kernel_fn)


def swapped_mixer(fn):
    from deepchopper_tpu_torch.models import hyena

    return swapped(hyena, "mixer_fft_conv_bm", fn)


def swapped_scan(fn):
    from deepchopper_tpu_torch.models import caduceus

    return swapped(caduceus, "selective_scan", fn)


def check_against_plain(fq: Path, shard_dir: Path, model_name: str, swap, plain, second: tuple, bf16_control: tuple,
                        f32_control: tuple, f32_tol: float, tie_band: float,
                        vs_default: bool = False) -> None:  # fmt: skip
    """Re-run the widest and the fullest batch of the main path with the
    plain version of the model's kernel on the card (`swap(fn)` routes the
    model through fn), through the engine's own step, and hold the kernel's
    logits to it. Each rule is also run on a control that must fail it, so
    a rule that cannot see a fault fails the run; `second` = (name, fn), a
    second correct version, is printed beside the kernel.

    bfloat16, the models' dtype, against the shards the main path wrote:
    argmax agrees on >= 99.9% of the valid positions whose logit margin
    exceeds tie_band * max|logit|: a narrower margin is a tie at this
    precision and flips under any change of rounding (the bands and their
    reasons are at HYENA_TIE_BAND and CADUCEUS_TIE_BAND).

    float32, the same weights and batches at compute_dtype float32: logits
    within f32_tol * max|logit| of the plain run. With vs_default (a Hyena
    mixer route other than the default), the default route's kernels run the
    same f32 batches too and are held to the same limit: in float32 the
    routes compute the same function.
    """
    import dataclasses

    import numpy as np
    import torch

    from deepchopper_tpu_torch.data.fastq_module import iter_batches
    from deepchopper_tpu_torch.infer.engine import PredictEngine
    from deepchopper_tpu_torch.models.registry import DeepChopper

    model = DeepChopper.new(model_name, seed=0, device="cuda")
    model32 = type(model)(
        dataclasses.replace(model.backbone_config, compute_dtype="float32"),
        dataclasses.replace(model.head_config, compute_dtype="float32"),
    )
    model32.load_state_dict(model.state_dict())
    engine, engine32 = PredictEngine(model, device="cuda"), PredictEngine(model32, device="cuda")

    # The CLI's batching is deterministic: batch i was written as shard 0_i.
    batches = list(iter_batches(fq))
    n_shards = len(list(shard_dir.glob("*.npz")))
    if len(batches) != n_shards:
        raise SmokeFailure(f"re-batching gave {len(batches)} batches for {n_shards} shards")
    picks = sorted({max(range(n_shards), key=lambda i: batches[i].input_ids.shape[k]) for k in (0, 1)})
    bf16_runs = ("kernel", second[0], bf16_control[0])
    agree = {name: np.zeros(4, dtype=np.int64) for name in bf16_runs}  # valid, agree, decided, decided-agree
    f32_rel = {"kernel": 0.0, second[0]: 0.0, f32_control[0]: 0.0}
    if vs_default:
        f32_rel["default route (kernels)"] = 0.0
    for i in picks:
        batch, shard = batches[i], np.load(shard_dir / f"0_{i}.npz")
        if not np.array_equal(shard["seq"], batch.input_ids):
            raise SmokeFailure(f"batch {i} does not match shard 0_{i}.npz")
        ids = torch.from_numpy(batch.input_ids.astype(np.int8)).cuda()
        quals = torch.from_numpy(batch.quals_raw).cuda()
        valid = batch.labels != -100

        def run(eng, fn):
            with swap(fn):
                return eng.step(ids, quals).cpu().numpy()

        ref = run(engine, plain)
        scale = np.abs(ref).max()
        decided = valid & (np.abs(ref[..., 1] - ref[..., 0]) > tie_band * scale)
        bf16 = {"kernel": shard["prediction"], second[0]: run(engine, second[1]),
                bf16_control[0]: run(engine, bf16_control[1])}  # fmt: skip
        for name, logits in bf16.items():
            same = logits.argmax(-1) == ref.argmax(-1)
            counts = np.array([valid.sum(), same[valid].sum(), decided.sum(), same[decided].sum()])
            agree[name] += counts
            print(
                f"  bf16 batch {i} {batch.input_ids.shape}, {name} vs plain: logits max-abs diff "
                f"{np.abs(logits - ref).max():.3e} (max|logit| {scale:.3e}); argmax agrees on "
                f"{counts[1]}/{counts[0]} valid positions, {counts[3]}/{counts[2]} beyond the tie band"
            )

        ref32 = run(engine32, plain)
        scale32 = np.abs(ref32).max()
        f32 = {"kernel": engine32.step(ids, quals).cpu().numpy(), second[0]: run(engine32, second[1]),
               f32_control[0]: run(engine32, f32_control[1])}  # fmt: skip
        if vs_default:
            with route_env({}):
                f32["default route (kernels)"] = engine32.step(ids, quals).cpu().numpy()
        for name, logits in f32.items():
            err = np.abs(logits - ref32).max()
            f32_rel[name] = max(f32_rel[name], float(err / scale32))
            flips = int((logits.argmax(-1) != ref32.argmax(-1))[valid].sum())
            print(
                f"  f32  batch {i} {batch.input_ids.shape}, {name} vs plain: logits max-abs diff {err:.3e} "
                f"({err / scale32:.3e} of max|logit| {scale32:.3e}); argmax differs at {flips} valid positions"
            )

    shares = {name: (c[1] / c[0], c[3] / c[2]) for name, c in agree.items()}
    for name, (share, decided_share) in shares.items():
        print(f"  bf16 {name}: argmax agrees on {share:.5f} of valid positions, {decided_share:.5f} beyond the tie band")
    f32_line = ", ".join(f"{name} {rel:.3e}" for name, rel in f32_rel.items())
    print(f"  f32 logits vs plain, of max|logit|: {f32_line} (limit {f32_tol})")
    if shares["kernel"][1] < ARGMAX_AGREEMENT:
        raise SmokeFailure(f"bf16 argmax agrees with the plain version on {shares['kernel'][1]:.5f} < {ARGMAX_AGREEMENT}")
    if shares[bf16_control[0]][1] >= ARGMAX_AGREEMENT:
        raise SmokeFailure(f"bf16 argmax rule passes the control ({bf16_control[0]})")
    if not f32_rel["kernel"] <= f32_tol:
        raise SmokeFailure(f"f32 logits differ from the plain version's by {f32_rel['kernel']:.3e} > {f32_tol}")
    if f32_rel[f32_control[0]] <= f32_tol:
        raise SmokeFailure(f"f32 logit limit passes the control ({f32_control[0]})")
    if vs_default and not f32_rel["default route (kernels)"] <= f32_tol:
        rel = f32_rel["default route (kernels)"]
        raise SmokeFailure(f"f32 logits of the default route differ by {rel:.3e} > {f32_tol}")


# f32 logits, Hyena kernel vs plain mixer, of max|logit| (measured: kernel 1.045e-4,
# plain at 4L 1.342e-4, bf16 I/O control 1.340e-2).
HYENA_F32_LOGIT_TOL = 2e-4
# f32 logits, Caduceus kernels vs plain scan, of max|logit|: f32 rounding of the
# scan amplified through 16 bidirectional layers; two correct plain scans
# (default chunk and chunk 7) differ by 1.09e-5, the reverse-run-forward
# control by 0.90 (PERF.md).
CADUCEUS_F32_LOGIT_TOL = 1e-4


def check_hyena_against_plain(fq: Path, shard_dir: Path) -> None:
    """Controls: the short conv's taps reversed (bf16 rule); the plain mixer
    with bf16 input and output (f32 limit). Second correct mixer: the plain
    one with its FFT at 4L."""
    from deepchopper_tpu_torch.ops import mixer

    check_against_plain(fq, shard_dir, "rna002", swapped_mixer, mixer.mixer_reference, ("plain at 4L", mixer_at_4l),
                        ("control: taps reversed", mixer_taps_reversed), ("control: bf16 I/O", mixer_bf16_io),
                        HYENA_F32_LOGIT_TOL, HYENA_TIE_BAND)  # fmt: skip


def check_caduceus_against_plain(fq: Path, shard_dir: Path) -> None:
    """Control for both rules: the reverse direction run forward. Second
    correct scan: the plain one at 7 steps per chunk."""
    from deepchopper_tpu_torch.ops import scan

    control = ("control: reverse run forward", scan_reverse_run_forward)
    second = ("plain at chunk 7", functools.partial(scan.selective_scan_reference, chunk=7))
    check_against_plain(fq, shard_dir, CADUCEUS, swapped_scan, scan.selective_scan_reference, second, control, control,
                        CADUCEUS_F32_LOGIT_TOL, CADUCEUS_TIE_BAND)  # fmt: skip


def check_graph_replay(fq: Path, model_name: str) -> None:
    """Hold the engine's CUDA graphs to its eager `step`, in bfloat16 and
    float32, at every dispatch of the widest and of the fullest batch of the
    main path's batching: each graph's output must equal, bitwise, the eager
    step on the same padded (rows, width) inputs (the same kernels on the
    same inputs). Control: the graph replayed without the copy-in of the next
    inputs (the tokens shifted by one) must fail the rule."""
    import dataclasses

    import numpy as np
    import torch

    from deepchopper_tpu_torch import default
    from deepchopper_tpu_torch.data.fastq_module import iter_batches
    from deepchopper_tpu_torch.infer.engine import PredictEngine, _pad_rows
    from deepchopper_tpu_torch.models.registry import DeepChopper

    batches = list(iter_batches(fq))
    picks = sorted({max(range(len(batches)), key=lambda i: batches[i].input_ids.shape[k]) for k in (0, 1)})
    base = DeepChopper.new(model_name, seed=0, device="cuda")
    for dtype in ("bfloat16", "float32"):
        model = type(base)(dataclasses.replace(base.backbone_config, compute_dtype=dtype),
                           dataclasses.replace(base.head_config, compute_dtype=dtype)).cuda()  # fmt: skip
        model.load_state_dict(base.state_dict())
        engine = PredictEngine(model, device="cuda")
        for i in picks:
            batch = batches[i]
            b, w = batch.input_ids.shape
            for start, rows, target in engine._plan_dispatches(b, w):
                ids = _pad_rows(batch.input_ids[start : start + rows].astype(np.int8), target, default.TOKEN_PAD)
                quals = _pad_rows(batch.quals_raw[start : start + rows], target, 0)
                graph = engine._get_step((target, w))
                got = graph(ids, quals).clone()
                want = engine.step(torch.from_numpy(ids).cuda(), torch.from_numpy(quals).cuda())
                shifted = np.roll(ids, 1, axis=1)
                graph.replay()  # the control: the static inputs still hold `ids`
                stale = graph.out.clone()
                stale_err = (stale - engine.step(torch.from_numpy(shifted).cuda(), torch.from_numpy(quals).cuda())).abs()
                err = (got - want).abs().max().item()
                print(f"  graph replay vs eager step, {model_name} {dtype}, batch {i} ({b}, {w}) rows "
                      f"{start}:{start + rows} of {target}: max-abs diff {err:.3e} (bitwise equal: "
                      f"{torch.equal(got, want)}); control, no copy-in of the next inputs: max-abs diff "
                      f"{stale_err.max().item():.3e}")  # fmt: skip
                if not torch.equal(got, want):
                    raise SmokeFailure(f"{model_name} {dtype}: graph replay at {(target, w)} differs from step by {err:.3e}")
                if not stale_err.any():
                    raise SmokeFailure(f"{model_name} {dtype}: the replay rule passes its control at {(target, w)}")
        del engine, model


# -- train ----------------------------------------------------------------------------

# f32 train step, Hyena kernels vs plain mixer: each leaf's max error, of its max|grad|.
# On the CPU two correct plain mixers (FFT at 2L and at 4L) differ by up to 1.0e-2
# of a leaf's max (median 5e-4 to 7e-4) at (16, 1024) and (1, 8192): ReLU masks
# of the 1024-wide head flip where a pre-activation sits within rounding of 0,
# and the filter-bias gradients are sums that cancel. The convolution control
# is off by 1.6 to 47.
HYENA_GRAD_TOL = 3e-2
# f32 train step, Caduceus kernels vs plain scan: the same rule, the same head
# and its ReLU ties; set from the plain scan at two chunk sizes (PERF.md).
CADUCEUS_GRAD_TOL = 3e-2


def plain_mixer(bwd):
    """A differentiable mixer that runs the plain forward and the given plain
    backward, to swap into every HyenaOperator in place of the kernels."""
    import torch

    from deepchopper_tpu_torch.ops import mixer

    class PlainMixer(torch.autograd.Function):
        @staticmethod
        def forward(ctx, proj, k_short, b_short, k_long, bias):
            ctx.save_for_backward(proj, k_short, b_short, k_long, bias)
            return mixer.mixer_reference(proj, k_short, b_short, k_long, bias)

        @staticmethod
        def backward(ctx, dy):
            proj, *params = ctx.saved_tensors
            return bwd(proj, dy, *params)

    return PlainMixer.apply


def mixer_bwd_convolution(proj, dy, k_short, b_short, k_long, bias):
    """A faulty backward: dw = IDFT(K̂ ⊙ DZ), a convolution with the filter
    where the correlation IDFT(conj(K̂) ⊙ DZ) belongs; otherwise the plain
    version."""
    import torch

    from deepchopper_tpu_torch.ops import mixer

    d_model, seq_len = k_long.shape[1], proj.shape[2]
    n = 2 * seq_len
    gates = mixer._short_conv_gates(proj, k_short, b_short)
    x2, x1, v = gates[:, :d_model], gates[:, d_model : 2 * d_model], gates[:, 2 * d_model :]
    khat = mixer.filter_spectrum(k_long, bias, n)
    w_f = torch.fft.rfft(v * x1, n=n, dim=-1)
    z = torch.fft.irfft(w_f * khat, n=n, dim=-1)[..., :seq_len] * n
    dz_f = torch.fft.rfft(dy.float() * x2, n=n, dim=-1)
    dw = torch.fft.irfft(dz_f * khat, n=n, dim=-1)[..., :seq_len] * n
    dgates = torch.cat([dy.float() * z, dw * v, dw * x1], dim=1)
    dkhat = (w_f.conj() * dz_f).sum(dim=0)
    return mixer._grads_from_cotangents(proj, dgates, dkhat, k_short, b_short, k_long, bias, n)


def plain_scan(bwd, chunk: int | None = None):
    """A differentiable scan that runs the plain forward and the given plain
    backward (both at `chunk`), to swap into every MambaMixer."""
    import torch

    from deepchopper_tpu_torch.ops import scan

    class PlainScan(torch.autograd.Function):
        @staticmethod
        def forward(ctx, u, delta, A, Bp, Cp, D, reverse):
            ctx.save_for_backward(u, delta, A, Bp, Cp, D)
            ctx.reverse = reverse
            return scan.selective_scan_reference(u, delta, A, Bp, Cp, D, reverse, chunk)

        @staticmethod
        def backward(ctx, dy):
            return (*bwd(*ctx.saved_tensors, dy, ctx.reverse, chunk), None)

    def fn(u, delta, A, Bp, Cp, D, reverse=False):
        return PlainScan.apply(u, delta, A, Bp, Cp, D, reverse)

    return fn


def scan_bwd_carry_zeroed(u, delta, A, Bp, Cp, D, dy, reverse=False, chunk=None):
    """A faulty backward: `scan_bwd_reference` with the cotangent carried from
    one chunk into the one before it dropped (each chunk's exit state gets a
    zero cotangent)."""
    import torch

    from deepchopper_tpu_torch.ops import scan

    if reverse:
        u, delta, Bp, Cp, dy = scan._flip_time(u, delta, Bp, Cp, dy)
    batch, seq_len, d_in = u.shape
    chunk = scan._plain_chunk(batch, chunk)
    du, ddelta, dbp, dcp = (torch.empty_like(t) for t in (u, delta, Bp, Cp))
    d_a, d_d = torch.zeros_like(A), torch.zeros_like(D)
    h = u.new_zeros(batch, d_in, A.shape[1])
    for lo in range(0, seq_len, chunk):
        hi = min(seq_len, lo + chunk)
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True) for t in (u[:, lo:hi], delta[:, lo:hi], A, Bp[:, lo:hi],
                                                               Cp[:, lo:hi], D)]  # fmt: skip
            uc, dc, ac, bc, cc, dsk = leaves
            hs = scan._chunk_states(uc, dc, ac, bc, h)
            y = torch.einsum("bldn,bln->bld", hs, cc) + uc * dsk
            g = torch.autograd.grad(y, leaves, dy[:, lo:hi])
        du[:, lo:hi], ddelta[:, lo:hi], dbp[:, lo:hi], dcp[:, lo:hi] = g[0], g[1], g[3], g[4]
        d_a += g[2]
        d_d += g[5]
        h = hs[:, -1].detach()
    if reverse:
        du, ddelta, dbp, dcp = scan._flip_time(du, ddelta, dbp, dcp)
    return du, ddelta, d_a, dbp, dcp, d_d


def training_batch(batch: int, width: int, seed: int) -> dict:
    """A right-padded labelled batch on the card: random bases, 0/1 labels,
    normalized quals; row lengths between width/2 and width."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    ids = rng.integers(7, 11, (batch, width))
    labels = (rng.random((batch, width)) < 0.3).astype(np.int64)
    quals = rng.integers(5, 40, (batch, width)).astype(np.float32)
    for row, n in enumerate(rng.integers(width // 2, width + 1, batch)):
        ids[row, n:], labels[row, n:], quals[row, n:] = 4, -100, 0.0
    quals /= np.sqrt((quals * quals).sum(-1, keepdims=True))
    return {k: torch.from_numpy(v).cuda() for k, v in (("input_ids", ids), ("input_quals", quals), ("labels", labels))}


def train_parity(model_name: str, swap, counts: Counts, kernel_launches: dict, runs: dict, control: str,
                 shapes: tuple, tol: float) -> None:  # fmt: skip
    """One forward and backward of `model_name` at compute_dtype float32,
    same random-init weights, on each batch shape: with the kernels (which
    must launch `kernel_launches`), and with each of `runs` (name -> plain
    function, swapped in by `swap`; "plain" is the yardstick). Every
    parameter's gradient within `tol` of that leaf's max|grad| of the plain
    run; the run named `control` must fail that rule."""
    import torch

    from deepchopper_tpu_torch.train.loss import continuous_interval_loss

    model = f32_model(model_name)
    runs = {"kernel": None, **runs}
    worst = {name: 0.0 for name in runs if name != "plain"}
    for batch_shape, seed in shapes:
        batch = training_batch(*batch_shape, seed=seed)
        grads = {}
        for name, fn in runs.items():
            model.zero_grad(set_to_none=True)
            counts.reset()
            with swap(fn) if fn is not None else contextlib.nullcontext():
                loss = continuous_interval_loss(model(batch["input_ids"], batch["input_quals"]), batch["labels"])
                loss.backward()
            torch.cuda.synchronize()
            launched = counts.read()
            if fn is None and launched != kernel_launches:
                raise SmokeFailure(f"train step {batch_shape}: kernel launches {launched} != {kernel_launches}")
            if fn is not None and any(launched.values()):
                raise SmokeFailure(f"train step {batch_shape}: the plain run {name} launched {launched}")
            grads[name] = ({k: p.grad.detach().clone() for k, p in model.named_parameters()}, loss.item())
        plain, plain_loss = grads["plain"]
        for name in worst:
            got, got_loss = grads[name]
            rel = {k: ((got[k] - g).abs().max() / g.abs().max()).item() for k, g in plain.items() if g.abs().max() > 0}
            leaf = max(rel, key=rel.get)
            worst[name] = max(worst[name], rel[leaf])
            print(
                f"  f32 train step {model_name} {batch_shape}, {name} vs plain: loss {got_loss:.7f} vs "
                f"{plain_loss:.7f}; worst gradient leaf {leaf} at {rel[leaf]:.3e} of its max|grad| ({len(rel)} leaves)"
            )
        del grads
    print(f"  train-step gradients vs plain, worst leaf: " + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
          + f" (limit {tol})")  # fmt: skip
    if not worst["kernel"] <= tol:
        raise SmokeFailure(f"{model_name} train-step gradients differ from the plain version's by {worst['kernel']:.3e}")
    if worst[control] <= tol:
        raise SmokeFailure(f"{model_name} train-step gradient rule passes the {control}")


def phase_train_parity() -> None:
    """Hyena on a (61, 1024) and a (1, 32768) batch: kernels vs the plain
    mixer (mixer_reference + mixer_bwd_reference); printed beside them,
    autograd of the plain mixer at 4L; control: the plain backward with K̂ in
    place of conj(K̂). Caduceus on a (16, 1024) and a (1, 8192) batch:
    kernels vs the plain scan (selective_scan_reference + scan_bwd_reference);
    beside them the plain scan at 7 steps per chunk; control: the plain
    backward with the cotangent carry between its 32-step chunks (the
    kernel's tiles) dropped."""
    from deepchopper_tpu_torch.ops import mixer, scan

    train_parity(HYENA, swapped_mixer, Counts(mixer), {"mixer_fwd": 4, "mixer_bwd": 4},
                 {"plain": plain_mixer(mixer.mixer_bwd_reference), "plain at 4L (autograd)": mixer_at_4l,
                  "control: convolution backward": plain_mixer(mixer_bwd_convolution)},
                 "control: convolution backward", (((61, 1024), 1), ((1, 32768), 2)), HYENA_GRAD_TOL)  # fmt: skip
    train_parity(CADUCEUS, swapped_scan, Counts(scan), {"scan_fwd": 32, "scan_ckpt": 32, "scan_bwd": 32},
                 {"plain": plain_scan(scan.scan_bwd_reference), "plain at chunk 7": plain_scan(scan.scan_bwd_reference, 7),
                  "control: carry dropped": plain_scan(scan_bwd_carry_zeroed, scan.CKPT_CHUNK)},
                 "control: carry dropped", (((16, 1024), 1), ((1, 8192), 2)), CADUCEUS_GRAD_TOL)  # fmt: skip


def phase_train(card: str, model: str, counts: Counts, per_batch: dict, extra: tuple = (),
                tag: str = "") -> dict[str, int]:  # fmt: skip
    """`train` through the CLI's parser and code path on `model` at full
    width (random init, seed 0), one epoch over ~300 labelled reads with the
    benchmark's length mix, two of them forced into the 24576 and 32768
    buckets of the training split; one val pass; test on the best
    checkpoint. per_batch = {kernel: (launches per train batch, per eval
    batch)}, (0, 0) for a kernel the route must not reach. Then `predict
    --checkpoint <best>` on a few reads. Returns the kernels' launches in the
    train run."""
    import csv
    import dataclasses

    import numpy as np
    import torch

    from deepchopper_tpu_torch import cli
    from deepchopper_tpu_torch.data.parquet_module import DataModule, ratio_split
    from deepchopper_tpu_torch.data.synth import read_lengths, synth_labelled_fastq

    work = REPO / "build" / "chip_smoke_train" / (model + tag)
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    lengths = read_lengths(N_READS, seed=0)
    train_rows = ratio_split(N_READS, 0.8, 0.1, seed=0).train
    lengths[train_rows[0]], lengths[train_rows[1]] = 20000, 30000
    fq = synth_labelled_fastq(work / "reads.fq", lengths, seed=0)
    # One rank: the launches are counted in this process (None would start a
    # rank a card on a machine with several).
    argv = ["train", f"data.train_data_path={fq}", f"model.name={model}", "seed=0", "trainer.max_epochs=1",
            "trainer.n_devices=1", f"output_dir={work / 'runs'}", *extra, "--device", "cuda"]  # fmt: skip
    cfg = cli.train_config(cli.build_parser().parse_args(argv))
    dm = DataModule(**dataclasses.asdict(cfg.data))
    train_batches = list(dm.train_batches(0))
    n_train, n_eval = len(train_batches), len(list(dm.val_batches())) + len(list(dm.test_batches()))
    widths = sorted({b.input_ids.shape[1] for b in train_batches})
    tokens = sum(b.input_ids.size for b in train_batches)
    if not {24576, 32768} <= set(widths):
        raise SmokeFailure(f"large buckets missing from the training batches: widths {widths}")

    counts.reset()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rc = cli.main(argv)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = counts.read()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if rc != 0:
        raise SmokeFailure(f"train {model}{tag} exited {rc}")
    want = {k: tr * n_train + ev * n_eval for k, (tr, ev) in per_batch.items()}
    if launches != want or not all(launches[k] for k, n in per_batch.items() if any(n)):
        raise SmokeFailure(f"train {model}{tag} launches {launches} != {want} ({n_train} train, "
                           f"{n_eval} val+test batches)")  # fmt: skip
    out = work / "runs" / "train"
    rows = list(csv.DictReader(open(out / "metrics.csv")))
    if len(rows) != 1 or not all(math.isfinite(float(rows[0][k])) for k in ("train/loss", "val/loss")):
        raise SmokeFailure(f"metrics.csv: {rows}")
    best = sorted((out / "checkpoints").glob("epoch_*.ckpt"))
    if not best or not (out / "checkpoints" / "last.ckpt").exists():
        raise SmokeFailure(f"checkpoints missing: {sorted(p.name for p in (out / 'checkpoints').glob('*'))}")
    test = json.loads((out / "test_metrics.json").read_text())
    if not math.isfinite(test["test/loss"]):
        raise SmokeFailure(f"test on best: {test}")
    print(
        f"train {model}{tag} (CLI): {n_train} steps over widths {widths}, {tokens} padded tokens, {n_eval} val+test "
        f"batches, {elapsed:.1f} s with set-up and test-on-best; train/loss {float(rows[0]['train/loss']):.4f}, "
        f"val/loss {float(rows[0]['val/loss']):.4f}, test {test}"
    )
    print(f"  launches {launches} (per train batch, per eval batch: {per_batch})")
    print(f"  peak device memory of the train run on {card}: {peak_gb:.2f} GB")

    few = synth_labelled_fastq(work / "few.fq", lengths[:8], seed=1)
    stats = cli.predict(cli.build_parser().parse_args(
        ["predict", str(few), "--checkpoint", str(best[-1]), "--model", model, "-o", str(work / "pred")]))  # fmt: skip
    torch.cuda.synchronize()
    shards = sorted((work / "pred" / "0").glob("*.npz"))
    if stats.reads != 8 or not all(np.isfinite(np.load(s)["prediction"]).all() for s in shards):
        raise SmokeFailure(f"predict --checkpoint {best[-1].name}: {stats.reads} reads")
    print(f"  predict --checkpoint {best[-1].name}: {stats.reads} reads, finite logits")
    return launches


def phase_overfit(card: str) -> None:
    """Overfit one full batch (128 reads of 1000 bases, W = 1024, 2^17
    tokens) for at most 100 steps: the loss must fall below half its first
    value."""
    import numpy as np
    import torch

    from deepchopper_tpu_torch.data.synth import synth_labelled_fastq
    from deepchopper_tpu_torch.train.config import load_config
    from deepchopper_tpu_torch.train.loop import Trainer, TrialPruned

    work = REPO / "build" / "chip_smoke_overfit"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    fq = synth_labelled_fastq(work / "reads.fq", np.full(160, 1000), seed=3)
    cfg = load_config(None, [f"data.train_data_path={fq}", "model.name=hyenadna-small-32k-seqlen", "seed=0",
                             "trainer.overfit_batches=1", "trainer.max_epochs=100", "optimizer.lr=0.001",
                             "callbacks.early_stop_patience=100", "callbacks.save_last=false", "test=false",
                             f"output_dir={work / 'runs'}"])  # fmt: skip
    losses: list[float] = []

    def stop_when_halved(row):
        losses.append(row["train/loss"])
        if row["train/loss"] < 0.5 * losses[0]:
            raise TrialPruned

    trainer = Trainer(cfg, epoch_callback=stop_when_halved)
    t0 = time.perf_counter()
    trainer.fit()
    torch.cuda.synchronize()
    if losses != trainer.step_losses:
        raise SmokeFailure("overfit: one train step per epoch expected")
    if not losses or not all(math.isfinite(x) for x in losses) or min(losses) >= 0.5 * losses[0]:
        raise SmokeFailure(f"overfit: loss {losses[:1]} -> {losses[-1:]} in {len(losses)} steps")
    print(
        f"overfit one batch: loss {losses[0]:.4f} -> {losses[-1]:.4f} in {len(losses)} steps "
        f"({time.perf_counter() - t0:.1f} s with a val pass per step)"
    )



def time_train_step(card: str, model_name: str, shapes: tuple, reps: int) -> None:
    """bf16 train steps of `model_name` (random init, Adam) on each batch
    shape after two warm-up steps: ms/step (host clock around `reps` steps
    ending in a synchronise), padded tokens/s and peak device memory."""
    import torch

    from deepchopper_tpu_torch.models.registry import DeepChopper
    from deepchopper_tpu_torch.train.step import make_optimizer, train_step

    model = DeepChopper.new(model_name, seed=0, device="cuda").train()
    opt = make_optimizer(model.parameters(), 2e-4)
    for shape in shapes:
        batch = training_batch(*shape, seed=9)
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
        tokens = shape[0] * shape[1]
        print(
            f"train step {model_name} {shape} bf16 on {card}: {ms:.2f} ms/step, {tokens / ms * 1e3:.0f} tokens/s "
            f"({tokens} padded tokens), peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB"
        )


def print_device_time(prof, wall_ms: float, what: str) -> list[tuple[str, float, int]]:
    """Device time by kernel of a torch.profiler run, and the device's busy
    share of `wall_ms`; returns the (kernel, ms, count) rows."""
    from torch.autograd import DeviceType

    rows = [
        (e.key, e.self_device_time_total / 1e3, e.count)
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
    ]
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    print(f"profiled {what}: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms ({busy_ms / wall_ms:.1%})")
    for key, ms, count in rows[:14]:
        print(f"  {ms:9.3f} ms {ms / busy_ms:6.1%} x{count:5d}  {key[:100]}")
    return rows


def phase_profile(fq: Path) -> None:
    """Profile (torch.profiler, CPU and CUDA activity), for each model, the
    engine over the same reads once more, its CUDA graphs captured by a pass
    before, and three bf16 train steps (Hyena at (128, 1024), Caduceus at
    (64, 1024)): device time by kernel and the device's busy share of the
    wall time (model set-up excluded)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from deepchopper_tpu_torch.chop import ChopOptions
    from deepchopper_tpu_torch.infer.engine import PredictEngine
    from deepchopper_tpu_torch.infer.fused import fused_predict_chop
    from deepchopper_tpu_torch.models.registry import DeepChopper
    from deepchopper_tpu_torch.train.step import make_optimizer, train_step

    # The main path: one `predict --fused-chop` pass of the flagship over the
    # reads, after a warm pass that captured its CUDA graphs, as the CLI runs
    # it (runtime_setup first). The hand-written mixer must show in the
    # device time: the graphs launch it.
    engine = PredictEngine(DeepChopper.new(HYENA, seed=0, device="cuda"), return_labels=True, device="cuda")
    engine.runtime_setup()
    fused_predict_chop(engine, fq, ChopOptions(output_prefix=str(fq.parent / "profiled-warm")))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        stats = fused_predict_chop(engine, fq, ChopOptions(output_prefix=str(fq.parent / "profiled-fused")))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = print_device_time(prof, wall_ms, f"predict --fused-chop {HYENA}")
    print(f"  under the profiler: elapsed_s {stats.elapsed_s:.3f}, device_s {stats.device_s:.3f} (the feed thread's "
          f"wait on the model), encode_s {stats.encode_s:.3f}, {stats.dispatches} dispatches, compile_s "
          f"{stats.compile_s:.3f}")  # fmt: skip
    mixer_rows = [(key, ms, count) for key, ms, count in rows if "mixer_fwd" in key]
    if not mixer_rows or stats.compile_s:
        raise SmokeFailure(f"profiled fused pass: no mixer_fwd kernel in the device time, or it captured "
                           f"({stats.compile_s:.3f} s): {rows[:5]}")  # fmt: skip
    for key, ms, count in mixer_rows:
        print(f"  under graph replay: {key[:80]}: {ms:.3f} ms, {count} launches")
    del engine

    for name, shape in ((HYENA, (128, 1024)), (CADUCEUS, (64, 1024))):
        engine = PredictEngine(DeepChopper.new(name, seed=0, device="cuda"), device="cuda")
        engine.predict_file(fq, fq.parent / "profiled")  # captures the pass's CUDA graphs
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            engine.predict_file(fq, fq.parent / "profiled")
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        print_device_time(prof, wall_ms, f"predict_file {name}")
        del engine

        model = DeepChopper.new(name, seed=0, device="cuda").train()
        opt = make_optimizer(model.parameters(), 2e-4)
        batch = training_batch(*shape, seed=9)
        for _ in range(2):
            train_step(model, opt, batch)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(3):
                out = train_step(model, opt, batch)
            out["loss"].item()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        print_device_time(prof, wall_ms, f"3 train steps {name} at {shape}")
        del model, opt


# -- Hyena's other mixer routes: gated conv, causal conv, in_proj-fused mixer -----------

BF16_TENSOR_FLOPS_PER_S = 989e12  # H100 SXM data sheet, dense bf16 on the tensor cores
ROUTE_KERNELS = ("gated_fwd", "conv_fwd", "mixer_inproj_fwd")
ROUTE_SOURCES = {
    "gated_fwd": ("mixer_fwd.cu", "deepchopper_tpu/ops/pallas_fft.py:428, deepchopper_tpu/ops/pallas_fft.py:1484"),
    "conv_fwd": ("conv_fwd.cu", "deepchopper_tpu/ops/pallas_fft.py:204"),
    "mixer_inproj_fwd": ("mixer_inproj_fwd.cu", "deepchopper_tpu/ops/pallas_fft.py:1014"),
}


# Widths that cross the route kernels' layouts (gated_fwd: mixer_fwd.cu's rows
# kernel, G = 16 batch rows a block to L = 256, 8, 4, 2 to 512, 1024, 2048, 1
# to 16384, the cluster above; conv_fwd: G = 8 channels a block to 512, 4 to
# 1024, 2 to 8192, 1 to 16384, the cluster above) and off-ladder widths, with
# D % 8 != 0, D not a multiple of G and odd batches.
ROUTE_EDGE_WIDTHS = (256, 300, 512, 513, 1000, 1024, 1025, 1280, 2048, 2049, 4096, 8192, 8193, 16384, 24576, 32768)
ROUTE_EDGE_SHAPES = {"gated_fwd": ((3, 12), (1, 20)), "conv_fwd": ((3, 12), (1, 20), (3, 6))}


def route_layout(kind: str, batch: int, d_model: int, seq_len: int) -> str:
    """The layout `kind` runs at this shape: gated_fwd mixer_fwd.cu's (rows of
    G batch rows of one channel, at least 256 threads a block, or the two-CTA
    pair at N = 65536); conv_fwd `ops/conv.conv_fwd_plan`'s (rows of G
    channels of one batch row, or the pair)."""
    from deepchopper_tpu_torch.ops import conv, mixer

    if kind == "conv_fwd":
        plan = conv.conv_fwd_plan(batch, d_model, seq_len)
        return "pair" if plan["layout"] == "pair" else f"rows G{plan['G']}"
    h = mixer.fft_size(seq_len) // 4
    if h == 1 << 14:
        return "pair"
    pair_threads = 2 * h // conv.values_per_thread(h)
    return f"rows G{max(1, 256 // pair_threads)}"


def route_inputs(kind: str, batch: int, d_model: int, seq_len: int, dtype, seed: int) -> tuple:
    """Arguments of one call of `kind` on the card: gated_fwd (uc (B, 3D, L),
    k_long, bias); conv_fwd (v (B, L, D) float32, k, bias); mixer_inproj_fwd
    (x (B, D, L), w_in (3D, D), b_in, k_short, b_short, k_long, bias)."""
    import torch

    proj, k_short, b_short, k_long, bias = mixer_inputs(batch if kind == "gated_fwd" else 1, d_model, seq_len, dtype,
                                                        seed)  # fmt: skip
    if kind == "gated_fwd":
        return proj, k_long, bias
    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    if kind == "conv_fwd":
        return torch.randn(batch, seq_len, d_model, generator=gen, device="cuda"), k_long, bias
    x = torch.randn(batch, d_model, seq_len, generator=gen, device="cuda").to(dtype)
    w_in = torch.randn(3 * d_model, d_model, generator=gen, device="cuda") / math.sqrt(d_model)
    b_in = torch.randn(3 * d_model, generator=gen, device="cuda") * 0.1
    return x, w_in, b_in, k_short, b_short, k_long, bias


def route_calls(kind: str):
    """(kernel wrapper, plain version) of `kind`."""
    from deepchopper_tpu_torch.ops import conv, gated, inproj

    return {
        "gated_fwd": (gated.gated_fwd_cuda, gated.gated_reference),
        "conv_fwd": (conv.conv_fwd_cuda, conv.conv_reference),
        "mixer_inproj_fwd": (inproj.mixer_inproj_fwd_cuda, inproj.inproj_reference),
    }[kind]


def route_bound(kind: str, batch: int, d_model: int, seq_len: int, itemsize: int) -> tuple[float, float]:
    """(bytes ms, operations ms) of one call, as `mixer_bound` reckons the
    mixer: each input read once, each output written once; the FFT conv's
    f32 flops at 67 TFLOP/s. gated_fwd: mixer_bound itself (three gate
    streams in, one out). conv_fwd: one f32 stream in, one out.
    mixer_inproj_fwd: x in and out once plus the weight, and the in_proj
    GEMM's 2 * 3D * D flops a token at the bf16 dense tensor-core peak
    (989 TFLOP/s) added to the FFT's f32 time."""
    nbytes, flops = mixer_bound(batch, d_model, seq_len, itemsize)
    gemm = 0.0
    filt = 4 * (seq_len * d_model + 13 * d_model)
    if kind == "conv_fwd":
        nbytes = batch * 2 * d_model * seq_len * 4 + filt
    elif kind == "mixer_inproj_fwd":
        nbytes = batch * 2 * d_model * seq_len * itemsize + 3 * d_model * d_model * itemsize + filt
        gemm = 2 * 3 * d_model * d_model * batch * seq_len
    return nbytes / HBM_BYTES_PER_S * 1e3, (flops / F32_FLOPS_PER_S + gemm / BF16_TENSOR_FLOPS_PER_S) * 1e3


def conv_library_ms(v, k, bias) -> float:
    """The one PyTorch call that computes conv_fwd's function: F.conv1d on the
    (B, D, L) layout, depthwise (groups = D), padding L - 1, the filter flipped
    with the skip bias folded into tap 0; its first L outputs are the causal
    conv. The transposes and the filter's preparation stay outside the timing.
    Held to the plain version (1e-4 of max|ref|, f32 with TF32 off), then
    timed once after one warm-up call (it is O(L^2) a row)."""
    import torch
    import torch.nn.functional as F

    from deepchopper_tpu_torch.ops import conv

    batch, seq_len, d_model = v.shape
    x = v.transpose(1, 2).contiguous()
    taps = k.float().clone()
    taps[0] += bias.float()
    weight = taps.flip(0).T.contiguous()[:, None, :]  # (D, 1, L)
    got = F.conv1d(x, weight, padding=seq_len - 1, groups=d_model)[..., :seq_len]
    within(got.transpose(1, 2), conv.conv_reference(v, k, bias), 1e-4, f"F.conv1d B={batch} L={seq_len}")
    del got
    return time_ms(lambda: F.conv1d(x, weight, padding=seq_len - 1, groups=d_model), reps=1, warmup=1)


def phase_route_kernels() -> list[dict]:
    """gated_fwd and mixer_inproj_fwd against their plain versions at D = 256,
    B = 2 at every ladder width in float32 (1e-4 of max|ref|) and bfloat16
    (1e-2); conv_fwd in float32 only (its contract). Then gated_fwd and
    conv_fwd at ROUTE_EDGE_WIDTHS with ROUTE_EDGE_SHAPES, each width's
    layout printed. Then each at the
    flagship batch shapes (B = 2^17 // W; gated and in_proj in bf16, conv in
    f32), held again and timed beside its plain version and its bound; the
    in_proj kernel also beside the composed route on the same inputs
    (torch.matmul in_proj, then mixer_fwd.cu): whether the fusion pays."""
    import torch

    from deepchopper_tpu_torch.data.bucketing import default_buckets
    from deepchopper_tpu_torch.ops import inproj, mixer

    d_model = 256
    widths = default_buckets(32768)
    dtypes = {"gated_fwd": ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)), "conv_fwd": ((torch.float32, 1e-4),),
              "mixer_inproj_fwd": ((torch.float32, 1e-4), (torch.bfloat16, 1e-2))}  # fmt: skip
    print("gated_fwd, conv_fwd, mixer_inproj_fwd vs plain at D=256, B=2 (max-abs err, of max|ref|):")
    for seq_len in widths:
        line = f"  L={seq_len:6d}"
        for kind in ROUTE_KERNELS:
            kernel, plain = route_calls(kind)
            for dtype, tol in dtypes[kind]:
                args = route_inputs(kind, 2, d_model, seq_len, dtype, seed=seq_len)
                got = kernel(*args)
                torch.cuda.synchronize()
                err, rel = within(got, plain(*args), tol, f"{kind} B=2 L={seq_len} {dtype}")
                line += f"  {kind} {str(dtype)[6:]} {err:.1e} ({rel:.1e})"
        print(line)

    print("gated_fwd and conv_fwd vs plain across their layouts, at (B, D) with D % 8 != 0 (err of max|ref|):")
    for seq_len in ROUTE_EDGE_WIDTHS:
        line = f"  L={seq_len:6d}"
        for kind, shapes in ROUTE_EDGE_SHAPES.items():
            kernel, plain = route_calls(kind)
            for batch, width in shapes:
                line += f" | {kind} B={batch} D={width} {route_layout(kind, batch, width, seq_len)}"
                for dtype, tol in dtypes[kind]:
                    args = route_inputs(kind, batch, width, seq_len, dtype, seed=seq_len + width)
                    got = kernel(*args)
                    torch.cuda.synchronize()
                    _err, rel = within(got, plain(*args), tol, f"{kind} B={batch} D={width} L={seq_len} {dtype}")
                    line += f" {str(dtype)[6:]} {rel:.1e}"
        print(line)

    print("at flagship batch shapes (B = 2^17 // W, D = 256; gated and in_proj bf16, conv f32):")
    rows = {k: {"ms": 0.0, "plain_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0, "bound_ms": 0.0, "err": 0.0,
                "library_ms": 0.0} for k in ROUTE_KERNELS}  # fmt: skip
    composed_total = 0.0
    for seq_len in widths:
        batch = TOKENS_PER_BATCH // seq_len
        line = f"  W={seq_len:6d} B={batch:4d}"
        for kind in ROUTE_KERNELS:
            kernel, plain = route_calls(kind)
            dtype, tol = (torch.float32, 1e-4) if kind == "conv_fwd" else (torch.bfloat16, 1e-2)
            args = route_inputs(kind, batch, d_model, seq_len, dtype, seed=seq_len + 1)
            got = kernel(*args)
            torch.cuda.synchronize()
            err, _rel = within(got, plain(*args), tol, f"{kind} B={batch} L={seq_len} {dtype}")
            del got
            ms = time_ms(lambda: kernel(*args))
            plain_ms = time_ms(lambda: plain(*args), reps=3)
            bytes_ms, ops_ms = route_bound(kind, batch, d_model, seq_len, 4 if dtype == torch.float32 else 2)
            bound = max(bytes_ms, ops_ms)
            row = rows[kind]
            row["err"] = max(row["err"], err)
            for key, v in (("ms", ms), ("plain_ms", plain_ms), ("bytes_ms", bytes_ms), ("ops_ms", ops_ms),
                           ("bound_ms", bound)):  # fmt: skip
                row[key] += v
            by = "bytes" if bytes_ms >= ops_ms else "ops"
            layout = "" if kind == "mixer_inproj_fwd" else f" [{route_layout(kind, batch, d_model, seq_len)}]"
            line += f" | {kind}{layout} {ms:.3f} plain {plain_ms:.3f} bound {bound:.3f} ({by}) {ms / bound:.1f}x"
            if kind == "mixer_inproj_fwd":
                x, w_in, b_in, *mix = args
                composed = time_ms(lambda: mixer.mixer_fwd_cuda(inproj.projection_composed(x, w_in, b_in), *mix))
                composed_total += composed
                line += f" composed {composed:.3f}"
            if kind == "conv_fwd":
                library_ms = conv_library_ms(*args)
                row["library_ms"] += library_ms
                line += f" F.conv1d {library_ms:.3f}"
            del args
        print(line)
    out = []
    for kind, row in rows.items():
        print(f"  {kind} ladder total: kernel {row['ms']:.3f} ms, plain {row['plain_ms']:.3f} ms, bound "
              f"{row['bound_ms']:.3f} ms (bytes {row['bytes_ms']:.3f}, ops {row['ops_ms']:.3f})")  # fmt: skip
        source, replaces = ROUTE_SOURCES[kind]
        out.append({
            "name": kind, "route": "cuda", "source": f"deepchopper_tpu_torch/csrc/{source}", "replaces": replaces,
            "launches": None, "max_abs_err": row["err"], "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": "bytes" if row["bytes_ms"] >= row["ops_ms"] else "operations",
            "library_ms": row["library_ms"] if kind == "conv_fwd" else None,
        })  # fmt: skip
    library_total = rows["conv_fwd"]["library_ms"]
    print(f"  conv_fwd's library call (F.conv1d, depthwise, (B, D, L)) ladder total: {library_total:.3f} ms")
    print(f"  composed in_proj route (torch.matmul in_proj + mixer_fwd.cu) ladder total: {composed_total:.3f} ms, "
          f"in_proj-fused kernel {rows['mixer_inproj_fwd']['ms']:.3f} ms")  # fmt: skip
    return out


def phase_conv_op() -> int:
    """The causal conv's own path: the public op `models.hyena.causal_conv`
    (no model route reaches it, as in the JAX package) at every ladder width
    at the flagship shapes (B = 2^17 // W, D = 256, float32), counts reset
    just before; finite (B, L, D) float32 outputs, one conv_fwd launch a
    width. Returns the launches."""
    import torch

    from deepchopper_tpu_torch.data.bucketing import default_buckets
    from deepchopper_tpu_torch.models import hyena
    from deepchopper_tpu_torch.ops import conv

    widths = default_buckets(32768)
    inputs = [route_inputs("conv_fwd", TOKENS_PER_BATCH // w, 256, w, torch.float32, seed=w + 5) for w in widths]
    counts = Counts(conv)
    counts.reset()
    outs = [hyena.causal_conv(*args) for args in inputs]
    torch.cuda.synchronize()
    launches = counts.read()["conv_fwd"]
    for args, y in zip(inputs, outs):
        if y.shape != args[0].shape or y.dtype != torch.float32 or not torch.isfinite(y).all():
            raise SmokeFailure(f"causal_conv at {tuple(args[0].shape)}: {tuple(y.shape)} {y.dtype}")
    if launches != len(widths):
        raise SmokeFailure(f"causal_conv: conv_fwd launches {launches} != {len(widths)} widths")
    print(f"causal_conv over the ladder at 2^17 tokens a width: conv_fwd launches {launches}, finite outputs")
    return launches


def gated_at_4l(uc, k_long, bias):
    """The plain gated conv with its FFT at 4L: a second correct version."""
    import torch.nn.functional as F

    from deepchopper_tpu_torch.ops import gated

    seq_len = uc.shape[2]
    return gated.gated_reference(F.pad(uc, (0, seq_len)), F.pad(k_long, (0, 0, 0, seq_len)), bias)[..., :seq_len]


def gated_filter_reversed(uc, k_long, bias):
    """A faulty gated conv: the long filter reversed in time."""
    from deepchopper_tpu_torch.ops import gated

    return gated.gated_reference(uc, k_long.flip(0), bias)


def gated_bf16_io(uc, k_long, bias):
    """A lower-precision gated conv: input and output rounded to bfloat16."""
    import torch

    from deepchopper_tpu_torch.ops import gated

    return gated.gated_reference(uc.to(torch.bfloat16), k_long, bias).to(uc.dtype)


def inproj_at_4l(x, w_in, b_in, k_short, b_short, k_long, bias):
    """The plain in_proj-fused mixer with its FFT at 4L (zeros appended to x
    change nothing before them: every step after in_proj is causal)."""
    import torch.nn.functional as F

    from deepchopper_tpu_torch.ops import inproj

    seq_len = x.shape[2]
    out = inproj.inproj_reference(F.pad(x, (0, seq_len)), w_in, b_in, k_short, b_short,
                                  F.pad(k_long, (0, 0, 0, seq_len)), bias)  # fmt: skip
    return out[..., :seq_len]


def inproj_taps_reversed(x, w_in, b_in, k_short, b_short, k_long, bias):
    """A faulty in_proj-fused mixer: the short conv's taps in the wrong order."""
    from deepchopper_tpu_torch.ops import inproj

    return inproj.inproj_reference(x, w_in, b_in, k_short.flip(0), b_short, k_long, bias)


def inproj_bf16_io(x, w_in, b_in, k_short, b_short, k_long, bias):
    """A lower-precision in_proj-fused mixer: x, w_in and the output in bfloat16."""
    import torch

    from deepchopper_tpu_torch.ops import inproj

    return inproj.inproj_reference(x.to(torch.bfloat16), w_in, b_in, k_short, b_short, k_long, bias).to(x.dtype)


def swapped_gated(fn):
    from deepchopper_tpu_torch.models import hyena

    return swapped(hyena, "gated_fft_conv_bm", fn)


def swapped_inproj(fn):
    from deepchopper_tpu_torch.models import hyena

    return swapped(hyena, "mixer_fft_conv_inproj", fn)


def check_unfused_against_plain(fq: Path, shard_dir: Path) -> None:
    """The unfused route (DEEPCHOPPER_FUSE_SHORT=0): gated_fwd vs the plain
    gated conv. Controls: the long filter reversed (bf16 rule); bf16 input
    and output (f32 limit). Second correct version: the plain one at 4L.
    Also the default route's f32 logits on the same batches."""
    from deepchopper_tpu_torch.ops import gated

    check_against_plain(fq, shard_dir, "rna002", swapped_gated, gated.gated_reference, ("plain at 4L", gated_at_4l),
                        ("control: filter reversed", gated_filter_reversed), ("control: bf16 I/O", gated_bf16_io),
                        HYENA_F32_LOGIT_TOL, HYENA_TIE_BAND, vs_default=True)  # fmt: skip


def check_inproj_against_plain(fq: Path, shard_dir: Path) -> None:
    """The in_proj-fused route (DEEPCHOPPER_FUSE_INPROJ=1):
    mixer_inproj_fwd vs the plain in_proj-fused mixer. Controls: the short
    conv's taps reversed (bf16 rule); bf16 input and output (f32 limit).
    Second correct version: the plain one at 4L. Also the default route's
    f32 logits on the same batches."""
    from deepchopper_tpu_torch.ops import inproj

    check_against_plain(fq, shard_dir, "rna002", swapped_inproj, inproj.inproj_reference, ("plain at 4L", inproj_at_4l),
                        ("control: taps reversed", inproj_taps_reversed), ("control: bf16 I/O", inproj_bf16_io),
                        HYENA_F32_LOGIT_TOL, HYENA_TIE_BAND, vs_default=True)  # fmt: skip


def plain_gated(bwd):
    """A differentiable gated conv that runs the plain forward and the given
    plain backward, to swap into every HyenaOperator on the unfused route."""
    import torch

    from deepchopper_tpu_torch.ops import gated

    class PlainGated(torch.autograd.Function):
        @staticmethod
        def forward(ctx, uc, k_long, bias):
            ctx.save_for_backward(uc, k_long, bias)
            return gated.gated_reference(uc, k_long, bias)

        @staticmethod
        def backward(ctx, dy):
            uc, k_long, bias = ctx.saved_tensors
            return bwd(uc, dy, k_long, bias)

    return PlainGated.apply


def gated_bwd_convolution(uc, dy, k_long, bias):
    """A faulty gated backward: dw convolves dz with the filter where the
    correlation (conj of its spectrum) belongs; otherwise the plain one."""
    import torch

    d_model, seq_len = k_long.shape[1], uc.shape[2]
    n = 2 * seq_len
    x2, x1, v = (uc[:, i * d_model : (i + 1) * d_model].float() for i in range(3))
    dy32, b = dy.float(), bias.float()[:, None]
    w = v * x1
    k_f = torch.fft.rfft(k_long.float().T, n=n, dim=-1)
    w_f = torch.fft.rfft(w, n=n, dim=-1)
    z = torch.fft.irfft(w_f * k_f, n=n, dim=-1)[..., :seq_len] + w * b
    dz = dy32 * x2
    dz_f = torch.fft.rfft(dz, n=n, dim=-1)
    dw = torch.fft.irfft(dz_f * k_f, n=n, dim=-1)[..., :seq_len] + dz * b
    dk = torch.fft.irfft((dz_f * w_f.conj()).sum(dim=0), n=n, dim=-1)[..., :seq_len]
    duc = torch.cat([dy32 * z, dw * v, dw * x1], dim=1).to(uc.dtype)
    return duc, dk.T.to(k_long.dtype), (dz * w).sum(dim=(0, 2)).to(bias.dtype)


def plain_inproj(mixer_bwd):
    """A differentiable in_proj-fused mixer that runs the plain forward and
    the in_proj backward over the given plain mixer backward, to swap into
    every HyenaOperator on the in_proj route."""
    import torch

    from deepchopper_tpu_torch.ops import inproj

    class PlainInproj(torch.autograd.Function):
        @staticmethod
        def forward(ctx, *args):
            ctx.save_for_backward(*args)
            return inproj.inproj_reference(*args)

        @staticmethod
        def backward(ctx, dy):
            x, *params = ctx.saved_tensors
            return inproj.inproj_bwd(x, dy.to(x.dtype), *params, mixer_bwd=mixer_bwd)

    return PlainInproj.apply


def phase_route_train_parity() -> None:
    """Hyena on its unfused and in_proj-fused routes, on a (61, 1024) and a
    (1, 32768) batch, as phase_train_parity: kernels vs the plain versions
    (unfused: gated_reference + gated_bwd_reference; in_proj:
    inproj_reference + the in_proj backward over mixer_bwd_reference);
    printed beside them, autograd of the plain version at 4L; controls: the
    plain backward with the filter's spectrum in place of its conjugate."""
    from deepchopper_tpu_torch.ops import gated, inproj, mixer

    shapes = (((61, 1024), 1), ((1, 32768), 2))
    control = "control: convolution backward"
    with route_env(UNFUSED):
        train_parity(HYENA, swapped_gated, Counts(mixer, gated), {"mixer_fwd": 0, "mixer_bwd": 0, "gated_fwd": 4},
                     {"plain": plain_gated(gated.gated_bwd_reference), "plain at 4L (autograd)": gated_at_4l,
                      control: plain_gated(gated_bwd_convolution)}, control, shapes, HYENA_GRAD_TOL)  # fmt: skip
    with route_env(INPROJ):
        train_parity(HYENA, swapped_inproj, Counts(mixer, inproj), {"mixer_fwd": 0, "mixer_bwd": 4,
                     "mixer_inproj_fwd": 4}, {"plain": plain_inproj(mixer.mixer_bwd_reference),
                     "plain at 4L (autograd)": inproj_at_4l, control: plain_inproj(mixer_bwd_convolution)},
                     control, shapes, HYENA_GRAD_TOL)  # fmt: skip


# -- runtime setup and the fused predict+chop main path -------------------------------

SETUP_REPS = 2000


def host_us(fn, reps: int = SETUP_REPS) -> float:
    """Host µs a call of `fn` over `reps` back-to-back calls, synchronised at
    the end (a launch's device time hides behind the next launch's host side)."""
    import torch

    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e6


def print_launch_split(x) -> None:
    """Each part of the setup kernel's launch path alone, µs a call over
    SETUP_REPS calls: the ctypes call (its launch included), the output
    allocation, the stream lookup and the device guard (the earlier way and the
    launch helper's), the argument checks, and the whole wrapper."""
    import torch

    from deepchopper_tpu_torch.ops import _build, setup

    import ctypes

    lib, out, dev = setup._lib(), torch.empty_like(x), x.device
    xp, op, rows, cols = x.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1]
    stream = torch.cuda.current_stream(dev).cuda_stream
    released = ctypes.CDLL(str(_build._target("setup.cu"))).setup_fwd  # releases the GIL around the call
    released.argtypes, released.restype = lib.setup_fwd.argtypes, lib.setup_fwd.restype

    def guard_old():
        with torch.cuda.device(dev):
            pass

    def checks():
        return not x.is_cuda or x.dtype != torch.float32 or x.dim() != 2 or not 0 < x.shape[1] <= 1024

    parts = {
        "ctypes call (PyDLL, the helper's)": lambda: lib.setup_fwd(xp, op, rows, cols, stream),
        "ctypes call (CDLL)": lambda: released(xp, op, rows, cols, stream),
        "torch.empty_like": lambda: torch.empty_like(x),
        "torch.empty(shape, device)": lambda: torch.empty((rows, cols), device=dev),
        "stream: current_stream().cuda_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "stream: raw (helper)": lambda: _build._raw_stream(x.get_device()),
        "guard: with torch.cuda.device": guard_old,
        "guard: index compare (helper)": lambda: x.get_device() == _build._current_device(),
        "checks": checks,
        "whole setup_tile": lambda: setup.setup_tile(x),
    }
    split = ", ".join(f"{name} {host_us(fn):.3f}" for name, fn in parts.items())
    print(f"setup launch path, host µs a call over {SETUP_REPS} calls: {split}")


def phase_setup() -> dict:
    """`PredictEngine.runtime_setup` on a fresh flagship engine: it builds every
    source of `ops/_build.SOURCES` (all nvcc processes started together),
    loads each library, launches `csrc/setup.cu` once and checks x + 1
    exactly; a second call must return 0.0 and launch nothing. Then the kernel
    against its plain version (equal exactly) and both timed, in µs a launch
    over SETUP_REPS back-to-back launches, beside the library call `torch.add`
    and the bound (8 KB moved: 2.4 ns at 3.35 TB/s)."""
    import torch

    from deepchopper_tpu_torch.infer.engine import PredictEngine
    from deepchopper_tpu_torch.models.registry import DeepChopper
    from deepchopper_tpu_torch.ops import _build, setup

    engine = PredictEngine(DeepChopper.new(HYENA), device="cuda")
    setup.reset_launch_counts()
    seconds = engine.runtime_setup()
    again = engine.runtime_setup()
    launches = setup.launch_counts["setup"]
    if not seconds > 0 or again != 0.0 or launches != 1 or engine.stats.elapsed_s != 0.0:
        raise SmokeFailure(f"runtime_setup: {seconds} s, repeat {again} s, {launches} launches")
    print(f"runtime_setup: setup_s {seconds:.3f} s, of which building {engine.stats.build_s:.3f} s "
          f"({len(_build.SOURCES)} sources: {', '.join(_build.SOURCES)}); one launch; a repeat call returns {again}")  # fmt: skip
    gen = torch.Generator(device="cuda").manual_seed(10)
    x = torch.randn(setup.SHAPE, generator=gen, device="cuda")
    got = setup.setup_tile(x)
    if not torch.equal(got, setup.setup_reference(x)):
        raise SmokeFailure(f"setup kernel: max-abs err {(got - setup.setup_reference(x)).abs().max().item():.3e}")
    print_launch_split(x)
    ms = time_ms(lambda: setup.setup_tile(x), reps=SETUP_REPS, warmup=20)
    plain_ms = time_ms(lambda: setup.setup_reference(x), reps=SETUP_REPS, warmup=20)
    library_ms = time_ms(lambda: torch.add(x, 1.0), reps=SETUP_REPS, warmup=20)
    nbytes = 2 * x.numel() * 4
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, x.numel() / F32_FLOPS_PER_S * 1e3
    print(f"setup kernel (8, 128) f32: equal to x + 1; {ms * 1e3:.3f} µs a launch, plain (x + 1.0) "
          f"{plain_ms * 1e3:.3f} µs, torch.add {library_ms * 1e3:.3f} µs, bound {bytes_ms * 1e6:.3f} ns (bytes); "
          f"launch at or below torch.add: {ms <= library_ms}")  # fmt: skip
    return {
        "name": "setup", "route": "cuda", "source": "deepchopper_tpu_torch/csrc/setup.cu",
        "replaces": "deepchopper_tpu/infer/engine.py:336", "launches": None, "max_abs_err": 0.0, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms,
    }  # fmt: skip


def phase_graph_memory(card: str) -> None:
    """Device memory of the engine's CUDA graphs on the flagship: peak and
    held memory after `warmup()` captures the whole ladder (17 widths x 3 row
    variants into one shared pool), beside the peak of eager `step` runs of
    each width's full batch (what the eager predict needs), each from a reset
    of the peak counter with no other engine alive."""
    import gc

    import torch

    from deepchopper_tpu_torch.infer.engine import PredictEngine
    from deepchopper_tpu_torch.models.registry import DeepChopper

    engine = PredictEngine(DeepChopper.new(HYENA, seed=0, device="cuda"), return_labels=True, device="cuda")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held_before = torch.cuda.memory_allocated()
    for w in engine.buckets:
        rows = engine._bucket_batch_size(w)
        engine.step(torch.full((rows, w), 7, dtype=torch.int8, device="cuda"),
                    torch.full((rows, w), 20, dtype=torch.uint8, device="cuda"))  # fmt: skip
    torch.cuda.synchronize()
    eager_peak = torch.cuda.max_memory_allocated() - held_before
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    seconds = engine.warmup()
    torch.cuda.synchronize()
    peak, held = torch.cuda.max_memory_allocated() - held_before, torch.cuda.memory_allocated() - held_before
    shapes = sum(len(engine._row_variants(w)) for w in engine.buckets)
    if engine.stats.captures != shapes:
        raise SmokeFailure(f"warmup captured {engine.stats.captures} graphs, the ladder has {shapes} shapes")
    print(f"graph memory on {card}: warmup() captured {shapes} (rows, width) graphs in {seconds:.3f} s (compile_s "
          f"{engine.stats.compile_s:.3f}); peak {peak / 1e9:.2f} GB, held after {held / 1e9:.2f} GB (the weights "
          f"excluded); eager step of every full batch: peak {eager_peak / 1e9:.2f} GB")  # fmt: skip
    del engine
    gc.collect()
    torch.cuda.empty_cache()


NATIVE_CALLS = ("fq_index", "encode_spans_batch", "majority_vote_batch", "label_regions", "chop_records",
                "bgzf_compress")  # fmt: skip


def _gunzip(path: Path) -> bytes:
    import gzip

    with gzip.open(path, "rb") as fh:
        return fh.read()


def _chopped(cwd: Path) -> Path:
    found = sorted(cwd.glob("*.chop.fq.gz"))
    if len(found) != 1:
        raise SmokeFailure(f"{cwd}: expected one chopped FASTQ, found {[p.name for p in found]}")
    return found[0]


def one_read_flipped(predicts: dict, name: str) -> dict:
    """Control: the labels of read `name` (untruncated, longer than
    `min_read_len`) set to the opposite outcome: all 0 (a passthrough) if the
    chop cut it, else all 1 (one interval from base 1 to the end: cut). It
    changes that read's output whatever its labels, where a shift of the
    labels by a base changes nothing in a read that smoothing makes one long
    interval."""
    import dataclasses

    import numpy as np

    from deepchopper_tpu_torch.chop import ChopOptions

    p = predicts[name]
    opts = ChopOptions()
    intervals = p.smooth_and_select_intervals(opts.smooth_window_size, opts.min_interval_size,
                                              opts.approved_interval_number)  # fmt: skip
    chopped = 0 < len(intervals) <= opts.max_process_intervals
    flipped = np.full_like(p.prediction, 0 if chopped else 1)
    return {**predicts, name: dataclasses.replace(p, prediction=flipped)}


@contextlib.contextmanager
def recorded_engines():
    """Record every `PredictEngine` made meanwhile (the CLI makes its own)."""
    from deepchopper_tpu_torch.infer import engine as engine_module

    made, cls = [], engine_module.PredictEngine

    class Recorded(cls):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    engine_module.PredictEngine = Recorded
    try:
        yield made
    finally:
        engine_module.PredictEngine = cls


@contextlib.contextmanager
def split_times():
    """Yield a dict of wall seconds, summed by step, of the `predict
    --fused-chop` run meanwhile (host clock; the functions it calls are
    wrapped, and put back after): "model" build, "engine" set-up and
    "runtime_setup", the engine's "dispatch" (lazy graph captures included)
    and "collect" (the wait for the device), "predict_file" whole with its
    "parse" (FASTQ parse and encode, on the prefetch thread, overlapped) and
    "shard_writes", each "barrier <name>", "load_predicts", "chop_part" (the
    rank's chop into its part, which parses the whole FASTQ) inside
    "shard_parallel_chop" (rank 0's merge is the rest), or the one-rank
    "fused_runner"."""
    from deepchopper_tpu_torch import parallel
    from deepchopper_tpu_torch.chop import pipeline
    from deepchopper_tpu_torch.infer import engine, fused
    from deepchopper_tpu_torch.io import predicts
    from deepchopper_tpu_torch.models.registry import DeepChopper

    split: dict[str, float] = {}

    def add(key: str, t0: float) -> None:
        split[key] = split.get(key, 0.0) + time.perf_counter() - t0

    def timer(key, fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                add(key if isinstance(key, str) else key(*args), t0)

        return wrapped

    def parsed(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            it = iter(fn(*args, **kwargs))
            while True:
                t0 = time.perf_counter()
                item = next(it, None)
                add("parse", t0)
                if item is None:
                    return
                yield item

        return wrapped

    def owner(name: str) -> type:  # the class that defines `name` (a subclass may be recording engines)
        return next(c for c in engine.PredictEngine.__mro__ if name in vars(c))

    wraps = [
        (DeepChopper, "from_pretrained", staticmethod(timer("model", DeepChopper.from_pretrained))),
        *((owner(name), name, timer(key, vars(owner(name))[name])) for name, key in (
            ("__init__", "engine"), ("runtime_setup", "runtime_setup"), ("_dispatch", "dispatch"),
            ("_collect", "collect"), ("predict_file", "predict_file"))),
        (engine, "iter_batches", parsed(engine.iter_batches)),
        (engine, "write_prediction_shard", timer("shard_writes", engine.write_prediction_shard)),
        (parallel, "barrier", timer(lambda name: f"barrier {name}", parallel.barrier)),
        (predicts, "load_predicts_from_batch_pts", timer("load_predicts", predicts.load_predicts_from_batch_pts)),
        (pipeline, "_write_chopped", timer("chop_part", pipeline._write_chopped)),
        (pipeline, "multihost_stream_chop", timer("shard_parallel_chop", pipeline.multihost_stream_chop)),
        (fused, "fused_predict_chop", timer("fused_runner", fused.fused_predict_chop)),
    ]  # fmt: skip
    saved = [(owner, name, vars(owner)[name]) for owner, name, _ in wraps]
    for owner, name, fn in wraps:
        setattr(owner, name, fn)
    try:
        yield split
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


def print_split(who: str, wall: float, split: dict[str, float]) -> None:
    steps = ", ".join(f"{k} {v:.3f}" for k, v in split.items())
    print(f"  split, {who}: wall {wall:.3f} s; {steps}")


def print_fused_pass(card: str, what: str, stats) -> None:
    print(
        f"fused throughput, {what}, on {card}: {stats.total_fq_count / stats.elapsed_s:.1f} reads/s, "
        f"{stats.tokens / stats.elapsed_s:.0f} tokens/s (wall {stats.elapsed_s:.3f} s; stages: encode_s "
        f"{stats.encode_s:.3f}, device_s {stats.device_s:.3f}, smooth_s {stats.smooth_s:.3f}, chop_write_s "
        f"{stats.chop_write_s:.3f}, first_write_s {stats.first_write_s:.3f}; compile_s {stats.compile_s:.3f} (graph "
        f"capture, inside device_s), {stats.dispatches} dispatches, padded tokens {stats.padded_tokens} = "
        f"{stats.padded_tokens / stats.tokens:.3f} x the tokens)"
    )


def phase_fused(card: str, fq: Path, counts: Counts) -> int:
    """The north-star main path: `predict --fused-chop --random-init` through
    the CLI on the flagship over the reads of `fq`, writing into the current
    directory (no output prefix); each (rows, width) is captured as a CUDA
    graph at its first dispatch. Checks that the native host plane ran, that
    mixer_fwd launched once a layer per dispatch (graph replays, and each
    capture's eager run, its first dispatch's own), and the setup kernel
    once, and that the chopped
    FASTQ is byte-identical, after decompression and under the same name, to
    the two-phase path on the same weights: `predict --shard-format npz` then
    `chop`, and the same through `--shard-format pt`. Each rule's control
    (the shards' labels with one read's flipped, chopped again) must fail it.
    Then a second `fused_predict_chop` pass on the CLI's engine, whose shapes
    are captured: its output must be byte-identical to the first pass's.
    Prints each pass's reads/s, tokens/s, stage breakdown, capture seconds,
    dispatches and padding. Returns the setup kernel's launches."""
    import numpy as np
    import torch

    from deepchopper_tpu_torch import cli, native
    from deepchopper_tpu_torch.chop import ChopOptions, stream_chop_with_predicts
    from deepchopper_tpu_torch.infer.fused import fused_predict_chop
    from deepchopper_tpu_torch.io.predicts import load_predicts_from_batch_pts
    from deepchopper_tpu_torch.models.registry import build_model

    work = fq.parent / "fused"
    parser = cli.build_parser()
    base = ["predict", str(fq), "--model", HYENA, "--random-init"]
    (work / "one").mkdir(parents=True)
    with contextlib.chdir(work / "one"), recorded_engines() as made:
        native.reset_calls()
        counts.reset()
        stats = cli.predict(parser.parse_args([*base, "--fused-chop"]))
        torch.cuda.synchronize()
        launches = counts.read()
        ran = {k: native.calls[k] for k in NATIVE_CALLS}
    engine = stats.extras["engine"]
    n_layer = build_model(HYENA).backbone_config.n_layer
    if not all(ran.values()):
        raise SmokeFailure(f"fused: the native host plane did not run: calls {ran}")
    want = {"mixer_fwd": n_layer * (engine.dispatches + engine.warm_runs), "mixer_bwd": 0, "setup": 1}
    if launches != want or not engine.batches or not engine.captures:
        raise SmokeFailure(f"fused: launches {launches} != {want} ({engine.batches} batches, {engine.dispatches} "
                           f"dispatches, {engine.captures} captures)")  # fmt: skip
    if (stats.total_fq_count, stats.predicts_loaded, engine.reads) != (N_READS,) * 3:
        raise SmokeFailure(f"fused: {stats.total_fq_count} reads, {stats.predicts_loaded} predicted, of {N_READS}")
    fused_out = _chopped(work / "one")
    fused_bytes = _gunzip(fused_out)
    n_records = fused_bytes.count(b"\n+\n")
    if n_records != stats.total_output_count or stats.total_output_count == stats.total_fq_count:
        raise SmokeFailure(f"fused: {n_records} records written, {stats.total_output_count} counted, "
                           f"{stats.total_fq_count} reads (no read chopped)")  # fmt: skip
    print(f"fused predict+chop {HYENA}: {stats.total_fq_count} reads -> {stats.total_output_count} records "
          f"({fused_out.name}), {engine.batches} batches, {engine.dispatches} dispatches, {engine.captures} CUDA "
          f"graphs captured, each from its first dispatch's eager run; native calls {ran}; launches {launches} = "
          f"mixer_fwd {n_layer} layers x ({engine.dispatches} dispatches + {engine.warm_runs} warm runs)")  # fmt: skip
    print(f"  setup_s {engine.setup_s:.3f} s, off the wall")
    print_fused_pass(card, "first pass (the CLI's, capturing lazily)", stats)

    (work / "two").mkdir()
    first_captures, first_warm = engine.captures, engine.warm_runs
    with contextlib.chdir(work / "two"):
        counts.reset()
        again = fused_predict_chop(made[0], fq, ChopOptions())
        torch.cuda.synchronize()
        launches_again = counts.read()
    print_fused_pass(card, "second pass on the same engine", again)
    new_captures = engine.captures - first_captures  # `engine` is the engine's own stats: they grew
    want = {"mixer_fwd": n_layer * (again.dispatches + engine.warm_runs - first_warm), "mixer_bwd": 0, "setup": 0}
    if launches_again != want or again.dispatches != stats.dispatches:
        raise SmokeFailure(f"fused second pass: launches {launches_again} != {want}, {again.dispatches} dispatches")
    second_out = _chopped(work / "two")
    if second_out.name != fused_out.name or _gunzip(second_out) != fused_bytes:
        raise SmokeFailure(f"fused second pass: {second_out.name} is not byte-identical to the first pass's output")
    print(f"  second pass: {new_captures} new captures, launches {launches_again}; output byte-identical to the "
          f"first pass's ({len(fused_bytes)} bytes)")  # fmt: skip

    for fmt in ("npz", "pt"):
        cwd = work / fmt
        cwd.mkdir()
        with contextlib.chdir(cwd):
            cli.predict(parser.parse_args([*base, "--shard-format", fmt, "-o", "shards"]))
            if cli.main(["chop", "shards/0", str(fq)]) != 0:
                raise SmokeFailure(f"chop over the {fmt} shards exited non-zero")
            two = _chopped(cwd)
            rule = f"fused == predict --shard-format {fmt}, then chop"
            if two.name != fused_out.name or _gunzip(two) != fused_bytes:
                raise SmokeFailure(f"{rule}: {two.name} vs {fused_out.name}, bytes equal: {_gunzip(two) == fused_bytes}")
            predicts = load_predicts_from_batch_pts(cwd / "shards" / "0")
            if not all(p.prediction.dtype == np.int8 and len(p.prediction) == len(p.seq) for p in predicts.values()):
                raise SmokeFailure(f"{fmt} shards: labels of the wrong type or length")
            name = next(f"bench_read_{i}" for i in range(N_READS) if not predicts[f"bench_read_{i}"].is_truncated)
            control = stream_chop_with_predicts(one_read_flipped(predicts, name), fq, ChopOptions(output_prefix="control"))
            if _gunzip(control.output_file) == fused_bytes:
                raise SmokeFailure(f"{rule}: its control ({name}'s labels flipped) passes it")
        print(f"  {rule}: same name, {len(fused_bytes)} bytes equal; control ({name}'s labels flipped) differs")
    return launches["setup"]  # the CLI pass's: its engine launched the setup kernel once


# -- eval-bam, stat, tools and the top-level names --------------------------------------

EVAL_MAPQ = 20  # eval-bam's --min-mapping-quality: the seeded MAPQs fall on both sides
SA_TAG = b"SAZchr1,100,+,50M,60,0;chr2,5,-,40M,60,1;\x00"


def eval_bam_records(fq: Path, seed: int = 0) -> list[tuple]:
    """`encode_bam_record` arguments for every read of `fq`, from a seed:
    mapped, unmapped, secondary and supplementary records, MAPQ 0-60, left
    and right soft clips on either strand, and an SA tag on about one read in
    ten."""
    import numpy as np

    from deepchopper_tpu_torch.io.fastq import StreamingFastqReader

    rng = np.random.default_rng(seed)
    out = []
    for rec in StreamingFastqReader(fq):
        n = len(rec.seq)
        flag = int(rng.choice([0, 0, 0, 0, 0, 16, 16, 4, 256, 2048]))
        left, right = (int(rng.integers(0, n // 4)) if rng.random() < 0.4 else 0 for _ in range(2))
        cigar = [] if flag == 4 else [(k, op) for k, op in ((left, "S"), (n - left - right, "M"), (right, "S")) if k]
        tags = SA_TAG if rng.random() < 0.1 else b""
        out.append((rec.name, flag, int(rng.integers(0, 61)), cigar, n, None, tags))
    return out


def write_bam(path: Path, records: list[tuple], skip: set[int]) -> Path:
    from deepchopper_tpu_torch.io import bam

    with bam.BamWriter(path, bam.make_bam_header()) as writer:
        for i, args in enumerate(records):
            if i not in skip:
                writer.write_raw_block(bam.encode_bam_record(*args))
    return path


def cli_stdout(argv: list[str]) -> str:
    """Run the port's CLI in this process; its stdout, or a SmokeFailure."""
    import io

    from deepchopper_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    if rc != 0:
        raise SmokeFailure(f"{' '.join(argv[:2])} exited {rc}")
    return buf.getvalue()


def read_stat(line: str) -> dict[str, float]:
    """`stat`'s line `<path>: n=.. min=.. p50=.. mean=.. max=..` as numbers."""
    return {k: float(v) for k, v in (part.split("=") for part in line.rsplit(": ", 1)[1].split())}


@contextlib.contextmanager
def pyarrow_blocked():
    """`import pyarrow` raises ImportError meanwhile, as where it is not
    installed; the modules it had loaded are put back after."""
    saved = {m: sys.modules.pop(m) for m in list(sys.modules) if m == "pyarrow" or m.startswith("pyarrow.")}
    sys.modules["pyarrow"] = sys.modules["pyarrow.parquet"] = None
    try:
        yield
    finally:
        del sys.modules["pyarrow"], sys.modules["pyarrow.parquet"]
        sys.modules.update(saved)


def split_without_pyarrow(card: str, work: Path) -> None:
    """A ratio split of one labelled FASTQ where pyarrow cannot be imported:
    it must filter the stream, even where a cache was written before, with
    the batches of the split as this machine runs it (the parquet cache
    where pyarrow imports); `train` runs two steps on it through the CLI,
    and a parquet source raises an ImportError that names pyarrow."""
    import csv

    import numpy as np

    from deepchopper_tpu_torch import cli
    from deepchopper_tpu_torch.data.parquet_module import DataModule
    from deepchopper_tpu_torch.data.synth import read_lengths, synth_labelled_fastq

    fq = synth_labelled_fastq(work / "labelled.fq", read_lengths(64, seed=2), seed=2)
    kw = dict(train_data_path=str(fq), tokens_per_batch=TOKENS_PER_BATCH)
    with_pyarrow = DataModule(**kw)
    route = "the parquet cache" if with_pyarrow._materialize_splits() is not None else "the in-stream split (no pyarrow)"
    want = [(b.read_ids, b.labels) for b in with_pyarrow.train_batches(0)]
    with pyarrow_blocked():
        dm = DataModule(**kw)
        got = [(b.read_ids, b.labels) for b in dm.train_batches(0)]
        if dm._materialize_splits() is not None:
            raise SmokeFailure("split without pyarrow: the split cache was used")
        if len(got) != len(want) or any(a[0] != b[0] or not np.array_equal(a[1], b[1]) for a, b in zip(got, want)):
            raise SmokeFailure(f"split without pyarrow: {len(got)} train batches differ from {route}'s {len(want)}")
        out = work / "train_no_pyarrow"
        argv = ["train", f"data.train_data_path={fq}", f"model.name={HYENA}", "seed=0", "trainer.max_epochs=1",
                "trainer.limit_train_batches=2", "trainer.limit_val_batches=1", "trainer.n_devices=1", "test=false",
                f"output_dir={out}", "--device", "cuda"]  # fmt: skip
        if cli_stdout(argv).count("train done: {") != 1:
            raise SmokeFailure("train without pyarrow: no 'train done' line")
        rows = list(csv.DictReader(open(out / "train" / "metrics.csv")))
        if len(rows) != 1 or not math.isfinite(float(rows[0]["train/loss"])):
            raise SmokeFailure(f"train without pyarrow: metrics.csv {rows}")
        try:
            list(DataModule(train_data_path=str(work / "reads.parquet")).train_batches(0))
        except ImportError as exc:
            if "pyarrow" not in str(exc):
                raise SmokeFailure(f"parquet source without pyarrow: {exc}") from exc
        else:
            raise SmokeFailure("parquet source without pyarrow: no ImportError")
    print(f"ratio split of {fq.name} (64 reads) with pyarrow blocked, on {card}: in-stream, its {len(got)} train "
          f"batches equal to those of {route}; train (CLI, {HYENA}, 2 steps) train/loss "
          f"{float(rows[0]['train/loss']):.4f}; a parquet source raises ImportError naming pyarrow")  # fmt: skip


def phase_eval(card: str, fq: Path) -> float:
    """The host-only commands on what the main path wrote (no kernel runs here,
    and no `encode` or parquet source, so it needs no pyarrow):
    `eval-bam` through the CLI over the flagship's npz shards of
    phase_predict and over phase_fused's pt shards, against a BAM of the
    port's `BamWriter` holding a seeded record for every read but one; the
    two runs' JSON files must be byte-identical, name pd300, hold exactly the
    withheld read under missing_bam_record and only reads of `fq`; a BAM with
    a second read withheld (the control) must change the overlap results.
    Then `stat` on the FASTQ and the BAM (counts, min and max of the lengths
    written), `tools diff` of the reads against the fused chop output and
    `tools select`, and a fresh process that imports deepchopper_tpu_torch
    and resolves its 71 top-level names without importing pyarrow or a
    kernel wrapper, then tries `import pyarrow` to report whether this
    machine has it; and `split_without_pyarrow`. Returns the phase's wall
    seconds."""
    import numpy as np

    from deepchopper_tpu_torch.io.fastq import StreamingFastqReader

    t0 = time.perf_counter()
    work = fq.parent / "eval"
    work.mkdir()
    lengths = {rec.name: len(rec.seq) for rec in StreamingFastqReader(fq)}
    records = eval_bam_records(fq)
    withheld, second = (int(i) for i in np.random.default_rng(1).choice(len(records), 2, replace=False))
    bam_path = write_bam(work / "reads.bam", records, {withheld})
    shards = {"npz": fq.parent / HYENA / "out" / "0", "pt": fq.parent / "fused" / "pt" / "shards" / "0"}
    flags = ["--min-mapping-quality", str(EVAL_MAPQ)]
    outs, printed = {}, {}
    for fmt, shard_dir in shards.items():
        if not any(shard_dir.glob(f"*.{fmt}")):
            raise SmokeFailure(f"eval: no .{fmt} shards in {shard_dir}")
        printed[fmt] = cli_stdout(["eval-bam", str(bam_path), str(shard_dir), "--output-dir", str(work / fmt), *flags])
        outs[fmt] = {p.name: p.read_bytes() for p in sorted((work / fmt).glob("*.json"))}
    if outs["npz"] != outs["pt"] or printed["npz"] != printed["pt"]:
        raise SmokeFailure(f"eval-bam: npz and pt runs differ: {sorted(outs['npz'])} vs {sorted(outs['pt'])}")
    names = sorted(outs["npz"])
    overlap = next((n for n in names if n.startswith("overlap_results_") and n.endswith(f"_pd{N_READS}.json")), None)
    if f"stats_pd{N_READS}_bt0.json" not in names or overlap is None:
        raise SmokeFailure(f"eval-bam: files {names}, expected stats_pd{N_READS}_bt0.json and overlap_results_*_pd{N_READS}")
    results = json.loads(outs["npz"][overlap])
    missing = results.get("missing_bam_record")
    if missing != [records[withheld][0]]:
        raise SmokeFailure(f"eval-bam: missing_bam_record {missing}, expected [{records[withheld][0]}]")
    strays = {rid for ids in results.values() for rid in ids} - set(lengths)
    if strays or len(results) < 4:
        raise SmokeFailure(f"eval-bam: ids not in the reads {sorted(strays)[:5]}; categories {sorted(results)}")
    control = write_bam(work / "control.bam", records, {withheld, second})
    cli_stdout(["eval-bam", str(control), str(shards["npz"]), "--output-dir", str(work / "control"), *flags])
    if (work / "control" / overlap).read_bytes() == outs["npz"][overlap]:
        raise SmokeFailure("eval-bam: its control (a second read withheld from the BAM) gives the same results")
    counts = ", ".join(f"{k} {len(v)}" for k, v in sorted(results.items()))
    print(f"eval-bam over {N_READS} reads (the flagship's shards: phase_predict's npz, phase_fused's pt), "
          f"--min-mapping-quality {EVAL_MAPQ}: {names} byte-identical between npz and pt; missing_bam_record = "
          f"[{records[withheld][0]}]; control ({records[second][0]} also withheld) differs; {counts}")  # fmt: skip

    written = [lengths[args[0]] for i, args in enumerate(records) if i != withheld]
    for path, want in ((fq, list(lengths.values())), (bam_path, written)):
        line = cli_stdout(["stat", str(path)]).strip()
        got = read_stat(line)
        if (got["n"], got["min"], got["max"]) != (len(want), min(want), max(want)):
            raise SmokeFailure(f"stat {path.name}: {line}; expected n={len(want)} min={min(want)} max={max(want)}")
        print(f"stat {path.name}: {line.split(': ', 1)[1]}")

    chopped = _chopped(fq.parent / "fused" / "one")
    diff = cli_stdout(["tools", "diff", str(fq), str(chopped)]).strip()
    if f"total_original={N_READS}," not in diff:
        raise SmokeFailure(f"tools diff: {diff}")
    selected = work / "internal.fq"
    cli_stdout(["tools", "select", str(chopped), "--type", "internal", "-o", str(selected)])
    n_internal = _gunzip(chopped).count(b"|I\n")
    n_selected = selected.read_bytes().count(b"\n+\n")
    if n_selected != n_internal:
        raise SmokeFailure(f"tools select: {n_selected} records, {n_internal} internal ids in {chopped.name}")
    print(f"tools diff {fq.name} {chopped.name}: {diff}")
    print(f"tools select --type internal: {n_selected} records")

    code = ("import sys\n"
            "import deepchopper_tpu_torch as d\n"
            "[getattr(d, n) for n in d.__all__]\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('pyarrow', 'jax')\n"
            "             or m.startswith('deepchopper_tpu_torch.ops.') and m.rsplit('.', 1)[1] not in ('kmer', 'labels', 'qual', 'sequence'))\n"
            "try:\n"
            "    import pyarrow\n"
            "    have = pyarrow.__version__\n"
            "except ImportError:\n"
            "    have = 'absent'\n"
            "print(len(d.__all__), have, bad)\n")  # fmt: skip
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    count, pyarrow, bad = (res.stdout.strip().split(" ", 2) + ["", "", ""])[:3]
    if res.returncode != 0 or count != "71" or bad != "[]":
        raise SmokeFailure(f"top-level names: {res.stdout.strip()!r} (expected 71 names, no pyarrow or kernel wrapper "
                           f"imported): {res.stderr[-2000:]}")  # fmt: skip
    print(f"import deepchopper_tpu_torch in a fresh process: 71 top-level names resolved, neither pyarrow nor a "
          f"kernel wrapper imported; `import pyarrow` afterwards: {pyarrow}")  # fmt: skip
    split_without_pyarrow(card, work)
    wall = time.perf_counter() - t0
    print(f"phase_eval on {card}: wall {wall:.3f} s")
    return wall


RANKS = 2
RANK_BATCH = (64, 1024)  # the DDP step's global rows and width
RANK_STEP_LR = 1e-4
RANK_SHORT = 300  # valid positions of rank 1's rows in the DDP step's batch


def rank_layout() -> tuple[str, str]:
    """(backend, where the ranks run): NCCL with a card a rank where there are
    enough cards, else gloo with every rank on cuda:0."""
    import torch

    if torch.cuda.device_count() >= RANKS:
        return "nccl", "one card a rank"
    return "gloo", "all ranks on cuda:0, sharing it: this checks the plumbing and measures no scaling"


def rank_training_batch() -> dict:
    """`training_batch` at RANK_BATCH, rank 1's rows (the second half) cut to
    RANK_SHORT valid positions: the two row blocks hold unequal valid counts."""
    batch = {k: v.cpu().numpy() for k, v in training_batch(*RANK_BATCH, seed=7).items()}
    half = RANK_BATCH[0] // RANKS
    batch["input_ids"][half:, RANK_SHORT:] = 4
    batch["labels"][half:, RANK_SHORT:] = -100
    batch["input_quals"][half:, RANK_SHORT:] = 0.0
    return batch


def f32_model(model_name: str):
    """`model_name`'s random-init weights (seed 0) in a float32 copy, in train
    mode, on the current card."""
    import dataclasses

    from deepchopper_tpu_torch.models.registry import DeepChopper

    base = DeepChopper.new(model_name, seed=0, device="cuda")
    model = type(base)(
        dataclasses.replace(base.backbone_config, compute_dtype="float32"),
        dataclasses.replace(base.head_config, compute_dtype="float32"),
    ).cuda()
    model.load_state_dict(base.state_dict())
    return model.train()


def ranks_worker(work: Path) -> int:
    """One rank of `phase_ranks` (ranks from DC_COORDINATOR, DC_NUM_PROCESSES,
    DC_PROCESS_ID and DC_BACKEND): (a) `predict --fused-chop` through the CLI
    into `work / "fused"`, twice (the second pass in a warm process, with a
    new engine), (b) `predict` through the CLI into per-rank shards
    under `work / "two_shards"`, (c) one f32 DDP train step of the flagship on
    its rows of `rank_training_batch`, with gradients summed and, as the
    control, DDP's default average of per-rank means. Writes
    `work / "rank{r}.json"`; rank 0 also the gradients of (c)."""
    import os

    import torch

    from deepchopper_tpu_torch import cli, parallel
    from deepchopper_tpu_torch.models.registry import build_model
    from deepchopper_tpu_torch.ops import mixer
    from deepchopper_tpu_torch.train.loop import data_parallel, rank_block
    from deepchopper_tpu_torch.train.loss import loss_counts
    from deepchopper_tpu_torch.train.step import make_optimizer, train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    parallel.initialize_distributed()
    rank, world = parallel.process_shard_info()
    device = parallel.local_device()
    fq = work / "reads.fq"
    n_layer = build_model(HYENA).backbone_config.n_layer
    report: dict = {"rank": rank, "world": world, "device": str(device)}
    fused = ["--fused-chop", "-o", str(work / "fused_shards")]
    for name, argv in (("fused_first", fused), ("fused", fused), ("two", ["-o", str(work / "two_shards")])):
        os.chdir(work / name.removesuffix("_first"))
        parallel.barrier(name)
        mixer.reset_launch_counts()
        t0 = time.perf_counter()
        with split_times() as split, recorded_engines() as made:
            rc = cli.main(["predict", str(fq), "--model", HYENA, "--random-init", *argv])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stats = made[0].stats
        report[name] = {"rc": rc, "wall_s": wall, "launches": dict(mixer.launch_counts), "reads": stats.reads,
                        "runs": stats.dispatches + stats.warm_runs, "n_layer": n_layer,
                        "captures": stats.captures, "split": split}  # fmt: skip

    batch = rank_training_batch()
    counts = loss_counts(batch["labels"])
    fills = {"input_ids": 4, "input_quals": 0.0, "labels": -100}
    block = {k: torch.from_numpy(rank_block(batch[k], fill, rank, world)).to(device) for k, fill in fills.items()}
    report["valid"] = int((block["labels"] != -100).sum())
    for name, summed in (("ddp", True), ("control", False)):
        model = f32_model(HYENA)
        if summed:
            step_model = data_parallel(model, device)
        else:  # DDP's default: each rank's own mean, gradients averaged
            step_model = torch.nn.parallel.DistributedDataParallel(model, device_ids=[device])
        mixer.reset_launch_counts()
        aux = train_step(step_model, make_optimizer(model.parameters(), RANK_STEP_LR), block, 0.0, None,
                         counts if summed else None)  # fmt: skip
        torch.cuda.synchronize()
        launches = dict(mixer.launch_counts)
        loss = aux["loss"] if summed else parallel.all_reduce_sum(aux["loss"].clone()) / world
        report[name] = {"loss": float(loss), "launches": launches}
        if rank == 0:
            torch.save({k: p.grad.detach().cpu() for k, p in model.named_parameters()}, work / f"{name}_grads.pt")
        del step_model, model
    (work / f"rank{rank}.json").write_text(json.dumps(report))
    parallel.barrier("done")
    parallel.shutdown()
    return 0


def _records(path: Path) -> list[bytes]:
    lines = _gunzip(path).splitlines()
    return sorted(b"\n".join(lines[i : i + 4]) for i in range(0, len(lines), 4))


def phase_ranks(card: str, fq: Path) -> None:
    """Data-parallel ranks on the flagship at full width, over the reads of
    `fq`: RANKS worker processes of this script (`--ranks-worker`, ranks
    from the DC_* variables; `rank_layout` picks the backend) run
    `ranks_worker`. Then, against the one-rank runs of `phase_fused` on the
    same weights and reads: (a) the merged `predict --fused-chop` output has
    the one-rank fused output's name and record multiset, each rank launched
    mixer_fwd once a layer per dispatch (replays counted), and a merge
    without rank 1's part fails that rule; (b) `chop` over the ranks'
    `predict` shards is byte-identical to the one-rank `predict` + `chop`;
    (c) the DDP step's loss is within 1e-5 relative of the one-rank step's
    on the same (64, 1024) batch and every gradient leaf within
    HYENA_GRAD_TOL of its max, mixer_fwd and mixer_bwd launched on each
    rank, and DDP's default average of per-rank means fails that rule;
    (d) where there are RANKS cards or more, `train trainer.n_devices=2`
    through the CLI for one epoch. Prints reads/s of one rank and of RANKS
    ranks (each the wall of `predict --fused-chop` through the CLI, model
    build, engine and lazy captures included; the ranks' first pass in fresh
    processes, their second in warm ones, like the one rank's), and each
    pass's wall on each rank split by step (`split_times`)."""
    import csv
    import os
    import socket

    import numpy as np
    import torch

    from deepchopper_tpu_torch import cli
    from deepchopper_tpu_torch.chop import ChopOptions, multihost_stream_chop
    from deepchopper_tpu_torch.io.predicts import load_predicts_from_batch_pts
    from deepchopper_tpu_torch.train.step import make_optimizer, train_step

    t_phase = time.perf_counter()
    backend, where = rank_layout()
    work = fq.parent / "ranks"
    for name in ("one", "fused", "two"):
        (work / name).mkdir(parents=True)
    shutil.copy(fq, work / "reads.fq")

    # The one-rank fused pass through the CLI, timed as the ranks time theirs.
    with contextlib.chdir(work / "one"), split_times() as one_split:
        t0 = time.perf_counter()
        if cli.main(["predict", str(work / "reads.fq"), "--model", HYENA, "--random-init", "--fused-chop"]) != 0:
            raise SmokeFailure("ranks: the one-rank fused pass exited non-zero")
        torch.cuda.synchronize()
        one_wall = time.perf_counter() - t0

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "DC_COORDINATOR": f"127.0.0.1:{port}", "DC_NUM_PROCESSES": str(RANKS), "DC_BACKEND": backend}
    procs = []
    for r in range(RANKS):
        log = open(work / f"rank{r}.log", "w")  # noqa: SIM115 - closed below
        procs.append((subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--ranks-worker", str(work)],
            env={**env, "DC_PROCESS_ID": str(r), "LOCAL_RANK": str(r if backend == "nccl" else 0)},
            stdout=log, stderr=subprocess.STDOUT), log))  # fmt: skip
    try:
        for proc, _log in procs:
            proc.wait(timeout=600)
    finally:
        for proc, log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    for r, (proc, _log) in enumerate(procs):
        if proc.returncode != 0:
            tail = (work / f"rank{r}.log").read_text()[-3000:]
            raise SmokeFailure(f"ranks: rank {r} exited {proc.returncode}:\n{tail}")
    reports = [json.loads((work / f"rank{r}.json").read_text()) for r in range(RANKS)]
    print(f"ranks: {RANKS} ranks, backend {backend}, {where}; devices {[rep['device'] for rep in reports]}")

    # (a) predict --fused-chop over the ranks.
    one = _chopped(work / "one")
    merged = _chopped(work / "fused")
    for rep, part in ((rep, part) for rep in reports for part in ("fused_first", "fused", "two")):
        got = rep[part]
        want = {"mixer_fwd": got["n_layer"] * got["runs"], "mixer_bwd": 0}
        if got["rc"] != 0 or got["launches"] != want or not got["runs"]:
            raise SmokeFailure(f"ranks ({part}), rank {rep['rank']}: rc {got['rc']}, launches {got['launches']} != {want}")
    for part in ("fused", "two"):
        if sum(rep[part]["reads"] for rep in reports) != N_READS:
            raise SmokeFailure(f"ranks ({part}): the ranks predicted {[rep[part]['reads'] for rep in reports]} reads")
    if merged.name != one.name or _records(merged) != _records(one):
        raise SmokeFailure(f"ranks (a): {merged.name} vs {one.name}: record multisets equal: "
                           f"{_records(merged) == _records(one)}")  # fmt: skip
    own = load_predicts_from_batch_pts(work / "fused_shards" / "0", pattern="0_*")
    with contextlib.chdir(work):
        control = multihost_stream_chop(own, work / "reads.fq", ChopOptions(output_prefix="control"), rank=0, nprocs=1)
    if _records(Path(work / control.output_file)) == _records(one):
        raise SmokeFailure("ranks (a): its control (rank 1's part withheld) passes it")
    print(f"  (a) predict --fused-chop: {merged.name}, the one-rank record multiset; launches per rank "
          f"{[rep['fused']['launches'] for rep in reports]} = mixer_fwd {reports[0]['fused']['n_layer']} layers x "
          f"{[rep['fused']['runs'] for rep in reports]} dispatches and warm runs; control (rank 1's part withheld) "
          f"differs")  # fmt: skip

    # (b) predict on the ranks, then chop.
    with contextlib.chdir(work / "two"):
        if cli.main(["chop", str(work / "two_shards" / "0"), str(work / "reads.fq")]) != 0:
            raise SmokeFailure("ranks (b): chop over the ranks' shards exited non-zero")
    two, ref = _chopped(work / "two"), fq.parent / "fused" / "npz" / one.name
    if any(rep["two"]["rc"] != 0 for rep in reports) or two.name != ref.name or _gunzip(two) != _gunzip(ref):
        raise SmokeFailure(f"ranks (b): {two.name} vs {ref.name}, bytes equal: {_gunzip(two) == _gunzip(ref)}")
    print(f"  (b) predict on {RANKS} ranks, then chop: {two.name}, byte-identical to the one-rank predict + chop")

    # (c) the DDP train step against the one-rank step on the same batch.
    batch = {k: torch.from_numpy(v).cuda() for k, v in rank_training_batch().items()}
    model = f32_model(HYENA)
    aux = train_step(model, make_optimizer(model.parameters(), RANK_STEP_LR), batch)
    torch.cuda.synchronize()
    want_loss = float(aux["loss"])
    want = {k: p.grad.detach() for k, p in model.named_parameters()}
    verdicts = {}
    for name in ("ddp", "control"):
        got = torch.load(work / f"{name}_grads.pt")
        rel = {k: float((got[k].cuda() - g).abs().max() / g.abs().max()) for k, g in want.items() if g.abs().max() > 0}
        leaf = max(rel, key=rel.get)
        loss_err = abs(reports[0][name]["loss"] - want_loss) / abs(want_loss)
        verdicts[name] = loss_err <= 1e-5 and rel[leaf] <= HYENA_GRAD_TOL
        print(f"  (c) f32 train step {RANK_BATCH}, {name} on {RANKS} ranks vs one rank: loss "
              f"{reports[0][name]['loss']:.7f} vs {want_loss:.7f} ({loss_err:.3e} relative, limit 1e-5); worst "
              f"gradient leaf {leaf} at {rel[leaf]:.3e} of its max|grad| (limit {HYENA_GRAD_TOL})")  # fmt: skip
    launched = [rep["ddp"]["launches"] for rep in reports]
    n_layer = reports[0]["fused"]["n_layer"]
    if not verdicts["ddp"] or any(x != {"mixer_fwd": n_layer, "mixer_bwd": n_layer} for x in launched):
        raise SmokeFailure(f"ranks (c): the DDP step fails the one-rank rule, or launched {launched}")
    if verdicts["control"]:
        raise SmokeFailure("ranks (c): its control (DDP's average of per-rank means) passes it")
    print(f"  (c) valid labels per rank {[rep['valid'] for rep in reports]}; launches per rank {launched}; control "
          f"(DDP's average of per-rank means) fails")  # fmt: skip

    # (d) train through the CLI over the ranks it spawns.
    if torch.cuda.device_count() >= RANKS:
        from deepchopper_tpu_torch.data.synth import read_lengths, synth_labelled_fastq

        labelled = synth_labelled_fastq(work / "train.fq", np.clip(read_lengths(100, seed=1), 200, 4000), seed=1)
        out = work / "train_runs"
        rc = cli.main(["train", f"data.train_data_path={labelled}", f"model.name={HYENA}", "seed=0",
                       "trainer.max_epochs=1", f"trainer.n_devices={RANKS}", f"output_dir={out}", "--device", "cuda"])  # fmt: skip
        rows = list(csv.DictReader(open(out / "train" / "metrics.csv")))
        if rc != 0 or len(rows) != 1 or not math.isfinite(float(rows[0]["val/loss"])):
            raise SmokeFailure(f"ranks (d): train over {RANKS} ranks exited {rc}, metrics {rows}")
        print(f"  (d) train trainer.n_devices={RANKS}: one epoch, val/loss {float(rows[0]['val/loss']):.4f}")
    else:
        print(f"  (d) train trainer.n_devices={RANKS}: skipped, {torch.cuda.device_count()} card(s) visible and "
              f"the CLI places a rank a card")  # fmt: skip

    print_split("1 rank, a new engine in this warm process", one_wall, one_split)
    for part, what in (("fused_first", "a fresh process"), ("fused", "a new engine in a warm process")):
        for rep in reports:
            print_split(f"rank {rep['rank']} of {RANKS}, {what}", rep[part]["wall_s"], rep[part]["split"])
    first, second = (max(rep[part]["wall_s"] for rep in reports) for part in ("fused_first", "fused"))
    print(f"ranks throughput on {card}, predict --fused-chop through the CLI: 1 rank {N_READS / one_wall:.1f} "
          f"reads/s ({one_wall:.3f} s, a new engine in this warm process); {RANKS} ranks {N_READS / second:.1f} "
          f"reads/s ({second:.3f} s, the slower rank, each a new engine in a warm process), first pass in fresh "
          f"processes {N_READS / first:.1f} reads/s ({first:.3f} s); backend {backend}, {where}; phase_ranks "
          f"{time.perf_counter() - t_phase:.1f} s")  # fmt: skip


BASELINES = ("transformer", "cnn")
# Card vs CPU, the same port model in float32: the card's attention backends
# and cuDNN convolutions sum in other orders than the CPU's.
BASELINE_F32_TOL = 1e-4
SWEEP_READS = 64


def f32_baseline(name: str, device: str):
    """`name`'s random-init weights (seed 0) in a float32 copy, in eval mode,
    on `device` (the CNN computes in float32 at any compute_dtype)."""
    import dataclasses

    from deepchopper_tpu_torch.models.registry import DeepChopper

    model = DeepChopper.new(name, seed=0, device="cpu")
    if name == "transformer":
        f32 = type(model)(dataclasses.replace(model.backbone_config, compute_dtype="float32"),
                          dataclasses.replace(model.head_config, compute_dtype="float32"))  # fmt: skip
        f32.load_state_dict(model.state_dict())
        model = f32
    return model.to(device).eval()


def baseline_against_cpu(name: str, shard_dir: Path) -> None:
    """One narrow batch (<= 16 rows at width <= 1024) and one row of the
    32768 batch of the predict run's shards, through `name` in float32 on
    the card and on the CPU: within BASELINE_F32_TOL of max|logit|. A
    control must fail that rule: the transformer with its position table
    zeroed, the CNN with its BatchNorms in train mode (batch statistics)."""
    import copy

    import numpy as np
    import torch

    shards = [np.load(p) for p in sorted(shard_dir.glob("*.npz"))]
    narrow = next(s for s in shards if s["seq"].shape[1] <= 1024)
    wide = next(s for s in shards if s["seq"].shape[1] == 32768)
    cpu, card = f32_baseline(name, "cpu"), f32_baseline(name, "cuda")
    control = copy.deepcopy(card)
    if name == "transformer":
        control.backbone.positions.zero_()
    else:
        control.train()
    for what, shard, rows in (("narrow", narrow, 16), ("32768", wide, 1)):
        ids = torch.from_numpy(shard["seq"][:rows]).long()
        quals = torch.from_numpy(shard["qual"][:rows].astype(np.float32))
        t0 = time.perf_counter()
        with torch.no_grad():
            want = cpu(ids, quals)
            cpu_s = time.perf_counter() - t0
            got = card(ids.cuda(), quals.cuda()).cpu()
            bad = control(ids.cuda(), quals.cuda()).cpu()
        scale = float(want.abs().max())
        err, ctl = float((got - want).abs().max()), float((bad - want).abs().max())
        print(f"  {name} f32 card vs CPU, {what} batch {tuple(ids.shape)}: max|err| {err:.3e} of max|logit| "
              f"{scale:.3e} (limit {BASELINE_F32_TOL:g} x); control {ctl:.3e}; CPU forward {cpu_s:.1f} s")  # fmt: skip
        if not err <= BASELINE_F32_TOL * scale:
            raise SmokeFailure(f"{name} {what}: card vs CPU {err:.3e} > {BASELINE_F32_TOL} x {scale:.3e}")
        if ctl <= BASELINE_F32_TOL * scale:
            raise SmokeFailure(f"{name} {what}: the control passed the rule ({ctl:.3e})")


def baseline_predict(card: str, name: str, fq: Path) -> Path:
    """`predict --random-init` through the CLI on `name` over the phase-3
    reads: every read present with finite logits, the 24576 and 32768
    buckets run; prints reads/s, tokens/s and the capture seconds. Returns
    the shard directory."""
    import numpy as np
    import torch

    from deepchopper_tpu_torch import cli

    out = fq.parent / name / "out"
    stats = cli.predict(cli.build_parser().parse_args(["predict", str(fq), "--model", name, "--random-init",
                                                       "-o", str(out)]))  # fmt: skip
    torch.cuda.synchronize()
    names, widths = [], set()
    for p in sorted((out / "0").glob("*.npz")):
        s = np.load(p)
        pred = s["prediction"]
        if pred.dtype != np.float32 or pred.shape != (*s["seq"].shape, 2) or not np.isfinite(pred).all():
            raise SmokeFailure(f"{name} {p.name}: prediction {pred.dtype} {pred.shape} "
                               f"finite={np.isfinite(pred).all()}")  # fmt: skip
        names += _shard_read_names(s["id"])
        widths.add(s["seq"].shape[1])
    if sorted(names) != sorted(f"bench_read_{i}" for i in range(N_READS)) or not {24576, 32768} <= widths:
        raise SmokeFailure(f"{name}: shards hold {len(names)} reads, widths {sorted(widths)}")
    print(f"predict {name} on {card}: {stats.reads} reads, {stats.tokens} tokens, {stats.batches} batches, widths "
          f"{sorted(widths)}; {stats.reads / stats.elapsed_s:.1f} reads/s, {stats.tokens / stats.elapsed_s:.0f} "
          f"tokens/s ({stats.elapsed_s:.3f} s, lazy captures included; {stats.captures} CUDA graphs captured in "
          f"{stats.compile_s:.3f} s)")  # fmt: skip
    return out / "0"


LOGGER_FILES = ("metrics.csv", "metrics.jsonl", "wandb/offline-run-*/files/wandb-history.jsonl",
                "mlruns/0/*/metrics/val/f1")  # fmt: skip


def baseline_train(card: str, name: str, fq: Path) -> Path | None:
    """One `train` epoch of `name` from configs/experiment/<name>.yaml
    through the CLI, with all four file loggers: finite losses and each
    logger's file present. Returns the best checkpoint."""
    import csv

    import torch

    from deepchopper_tpu_torch import cli

    runs = fq.parent / f"train_{name}"
    argv = ["train", "--config", str(REPO / "configs" / "experiment" / f"{name}.yaml"), f"data.train_data_path={fq}",
            "trainer.max_epochs=1", "trainer.n_devices=1", "trainer.loggers=csv,jsonl,wandb_offline,mlflow",
            f"output_dir={runs}", "--device", "cuda"]  # fmt: skip
    t0 = time.perf_counter()
    rc = cli.main(argv)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    out = runs / "train"
    if rc != 0:
        raise SmokeFailure(f"train {name} exited {rc}")
    missing = [f for f in LOGGER_FILES if not list(out.glob(f))]
    rows = list(csv.DictReader(open(out / "metrics.csv")))
    if missing or len(rows) != 1 or not all(math.isfinite(float(rows[0][k])) for k in ("train/loss", "val/loss")):
        raise SmokeFailure(f"train {name}: logger files missing {missing}, rows {rows}")
    test = json.loads((out / "test_metrics.json").read_text())
    print(f"train {name} (CLI, configs/experiment/{name}.yaml, 1 epoch) on {card}: {elapsed:.1f} s with set-up and "
          f"test-on-best; train/loss {float(rows[0]['train/loss']):.4f}, val/loss {float(rows[0]['val/loss']):.4f}, "
          f"test/loss {test['test/loss']:.4f}; logger files {list(LOGGER_FILES)} present")  # fmt: skip
    return sorted((out / "checkpoints").glob("epoch_*.ckpt"))[-1]


def cnn_checkpoint_predict(best: Path, fq: Path) -> None:
    """`predict --checkpoint <best> --model cnn` on 8 reads: the logits of the
    model in the checkpoint, BatchNorm running statistics included (the
    checkpoint's state_dict in a fresh CNN, eval mode, on the shards'
    inputs), within BASELINE_F32_TOL of max|logit|."""
    import numpy as np
    import torch

    from deepchopper_tpu_torch import cli
    from deepchopper_tpu_torch.models.registry import build_model

    out = fq.parent / "cnn_ckpt_pred"
    stats = cli.predict(cli.build_parser().parse_args(["predict", str(fq), "--checkpoint", str(best), "--model", "cnn",
                                                       "--max-sample", "8", "-o", str(out)]))  # fmt: skip
    state = torch.load(best, weights_only=True)["state_dict"]
    if torch.equal(state["bn_0.running_var"], torch.ones_like(state["bn_0.running_var"])):
        raise SmokeFailure("cnn checkpoint: running statistics never moved")
    model = build_model("cnn")
    model.load_state_dict(state)
    model = model.cuda().eval()
    worst = 0.0
    for p in sorted((out / "0").glob("*.npz")):
        s = np.load(p)
        with torch.no_grad():
            want = model(torch.from_numpy(s["seq"]).long().cuda(), torch.from_numpy(s["qual"]).cuda()).cpu().numpy()
        err = float(np.abs(s["prediction"] - want).max()) / float(np.abs(want).max())
        worst = max(worst, err)
    if stats.reads != 8 or not worst <= BASELINE_F32_TOL:
        raise SmokeFailure(f"predict --checkpoint {best.name} --model cnn: {stats.reads} reads, error {worst:.3e}")
    print(f"  predict --checkpoint {best.name} --model cnn: {stats.reads} reads, the checkpoint's logits within "
          f"{worst:.3e} of max|logit|")  # fmt: skip


SWEEP_YAML = """\
n_trials: 2
n_startup_trials: 5
params:
  optimizer.lr: interval(0.0001, 0.001)
  model.lin1_size: choice(256, 1024)
"""


def baseline_sweep(card: str, fq: Path) -> None:
    """`train --sweep` through the CLI: 2 trials over optimizer.lr and
    model.lin1_size on the flagship, one epoch each over SWEEP_READS reads:
    results.json holds 2 trials with finite metrics, and mixer_fwd and
    mixer_bwd launched 4 a batch in each trial (4 a train batch for both,
    4 a val or test batch for mixer_fwd)."""
    import dataclasses

    import torch

    from deepchopper_tpu_torch import cli
    from deepchopper_tpu_torch.data.parquet_module import DataModule
    from deepchopper_tpu_torch.ops import mixer

    (fq.parent / "sweep.yaml").write_text(SWEEP_YAML)
    argv = ["train", "--sweep", str(fq.parent / "sweep.yaml"), f"data.train_data_path={fq}", f"model.name={HYENA}",
            "seed=0", "trainer.max_epochs=1", "trainer.n_devices=1", "trainer.loggers=csv",
            f"output_dir={fq.parent / 'sweep_runs'}", "--device", "cuda"]  # fmt: skip
    cfg = cli.train_config(cli.build_parser().parse_args(argv))
    dm = DataModule(**dataclasses.asdict(cfg.data))
    n_train = len(list(dm.train_batches(0)))
    n_eval = len(list(dm.val_batches())) + len(list(dm.test_batches()))
    counts = Counts(mixer)
    counts.reset()
    t0 = time.perf_counter()
    rc = cli.main(argv)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = counts.read()
    trials = json.loads((fq.parent / "sweep_runs" / "sweep" / "results.json").read_text())
    want = {"mixer_fwd": 2 * 4 * (n_train + n_eval), "mixer_bwd": 2 * 4 * n_train}
    if rc != 0 or len(trials) != 2 or not all(math.isfinite(t["metric"]) for t in trials) or launches != want:
        raise SmokeFailure(f"train --sweep: rc {rc}, trials {trials}, launches {launches} != {want}")
    print(f"train --sweep {HYENA} on {card}: 2 trials of 1 epoch ({n_train} train, {n_eval} val+test batches "
          f"each) in {elapsed:.1f} s; launches {launches} = 2 trials x 4 a batch; trials "
          f"{[(t['overrides'], round(t['metric'], 4)) for t in trials]}")  # fmt: skip


def baseline_model_folder(fq: Path) -> None:
    """save_pretrained of the flagship, then from_pretrained_dir: bitwise the
    same logits on one batch; then `predict --model <folder>` on 8 reads."""
    import torch

    from deepchopper_tpu_torch import cli
    from deepchopper_tpu_torch.models.registry import DeepChopper

    model = DeepChopper.new(HYENA, seed=5, device="cuda")
    folder = DeepChopper.save_pretrained(model, fq.parent / "flagship_folder")
    loaded = DeepChopper.from_pretrained_dir(folder, device="cuda")
    batch = training_batch(8, 1024, seed=12)
    with torch.no_grad():
        same = torch.equal(model(batch["input_ids"], batch["input_quals"]),
                           loaded(batch["input_ids"], batch["input_quals"]))  # fmt: skip
    stats = cli.predict(cli.build_parser().parse_args(["predict", str(fq), "--model", str(folder), "--max-sample",
                                                       "8", "-o", str(fq.parent / "folder_pred")]))  # fmt: skip
    if not same or stats.reads != 8:
        raise SmokeFailure(f"model folder: logits bitwise equal {same}, predict --model <folder> {stats.reads} reads")
    print(f"  model folder {sorted(p.name for p in folder.iterdir())}: from_pretrained_dir logits bitwise equal on "
          f"(8, 1024); predict --model <folder>: {stats.reads} reads")  # fmt: skip


def baseline_web_core(work: Path) -> None:
    """predict_record on one record of 24575 bases (24576 tokens, the 24576
    bucket) against the labels the fused path computes for that read
    (`PredictEngine(return_labels=True)`, as `predict --fused-chop` runs it,
    over a FASTQ of that one read, one dispatch of one row: the shapes
    predict_record runs, so bf16 rounding cannot move a near tie): the same
    labels and the same smoothed intervals; mixer_fwd once a layer. The
    interval-count gate is lifted on both sides (random weights label
    hundreds of short runs, and the default gate of 20 would leave both
    lists empty)."""
    import numpy as np

    from deepchopper_tpu_torch.data.synth import synth_fastq
    from deepchopper_tpu_torch.infer.engine import PredictEngine
    from deepchopper_tpu_torch.models.registry import DeepChopper
    from deepchopper_tpu_torch.ops import mixer
    from deepchopper_tpu_torch.ops.labels import smooth_label_region
    from deepchopper_tpu_torch.ui.main import predict_record

    fq = synth_fastq(work / "one_read.fq", np.array([24575]), seed=7)
    model = DeepChopper.new(HYENA, seed=0, device="cuda")
    counts = Counts(mixer)
    counts.reset()
    out = predict_record(fq.read_text(), model, approved_interval_number=1 << 20)
    launches = counts.read()
    engine = PredictEngine(model, return_labels=True, device="cuda")
    (pred,) = engine.predict_to_predicts(fq).values()
    intervals = smooth_label_region(pred.prediction, 21, 13, 1 << 20)
    n_layer = model.backbone_config.n_layer
    if engine.stats.shape_counts != {(1, 24576): 1}:
        raise SmokeFailure(f"predict_record: the fused path dispatched {engine.stats.shape_counts}, not one row")
    if (not np.array_equal(out["labels"], pred.prediction) or out["smooth_intervals"] != intervals or not intervals
            or launches["mixer_fwd"] != n_layer):  # fmt: skip
        raise SmokeFailure(f"predict_record: {int((out['labels'] != pred.prediction).sum())} labels differ, "
                           f"{len(out['smooth_intervals'])} intervals vs the fused path's {len(intervals)}, "
                           f"launches {launches}")  # fmt: skip
    print(f"  predict_record, 24575 bases: labels equal to the fused path's ({int(out['labels'].sum())} adapter), "
          f"{len(intervals)} smoothed intervals equal (first {intervals[:2]}); mixer_fwd {launches['mixer_fwd']} "
          f"launches")  # fmt: skip


def phase_baselines(card: str, fq: Path) -> None:
    """The transformer and CNN baselines, the sweep, the model folder and the
    web core (the header's step 6)."""
    import numpy as np

    from deepchopper_tpu_torch.data.parquet_module import ratio_split
    from deepchopper_tpu_torch.data.synth import read_lengths, synth_labelled_fastq

    work = fq.parent / "baselines"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    for name in BASELINES:
        shards = baseline_predict(card, name, fq)
        baseline_against_cpu(name, shards)
    lengths = read_lengths(N_READS, seed=0)
    train_rows = ratio_split(N_READS, 0.8, 0.1, seed=0).train
    lengths[train_rows[0]], lengths[train_rows[1]] = 20000, 30000
    labelled = synth_labelled_fastq(work / "labelled.fq", lengths, seed=0)
    best = {name: baseline_train(card, name, labelled) for name in BASELINES}
    cnn_checkpoint_predict(best["cnn"], fq)
    baseline_sweep(card, synth_labelled_fastq(work / "sweep.fq", lengths[:SWEEP_READS], seed=1))
    baseline_model_folder(fq)
    baseline_web_core(work)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true", help="Also profile predict and the train step (device time by kernel)")
    parser.add_argument("--ranks-worker", type=Path, default=None, help=argparse.SUPPRESS)
    opts = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke run needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if not (REPO / "deepchopper_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: {REPO} is not a checkout of the repository (no deepchopper_tpu_torch)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    if opts.ranks_worker is not None:
        return ranks_worker(opts.ranks_worker)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    card = gpu_line()
    print(f"gpu: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    try:
        from deepchopper_tpu_torch.ops import gated, inproj, mixer, scan, setup

        setup_row = timed(phase_setup)
        fwd = timed(phase_kernels)
        bwd = timed(phase_bwd_kernel)
        scan_rows = timed(phase_scan_kernels)
        gated_row, conv_row, inproj_row = timed(phase_route_kernels)
        conv_row["launches"] = timed(phase_conv_op)
        work = REPO / "build" / "chip_smoke"
        shutil.rmtree(work, ignore_errors=True)
        work.mkdir(parents=True)
        fq = bench_reads(work)
        timed(phase_predict, card, HYENA, fq, Counts(mixer), {"mixer_fwd": 1})
        timed(check_hyena_against_plain, fq, work / HYENA / "out" / "0")
        setup_row["launches"] = timed(phase_fused, card, fq, Counts(mixer, setup))
        eval_s = timed(phase_eval, card, fq)
        timed(phase_ranks, card, fq)
        with route_env(UNFUSED):
            timed(phase_predict, card, HYENA, fq, Counts(mixer, gated), {"gated_fwd": 1, "mixer_fwd": 0}, "-unfused")
            timed(check_unfused_against_plain, fq, work / f"{HYENA}-unfused" / "out" / "0")
        with route_env(INPROJ):
            timed(phase_predict, card, HYENA, fq, Counts(mixer, inproj), {"mixer_inproj_fwd": 1, "mixer_fwd": 0},
                  "-inproj")  # fmt: skip
            timed(check_inproj_against_plain, fq, work / f"{HYENA}-inproj" / "out" / "0")
        timed(phase_predict, card, CADUCEUS, fq, Counts(scan), {"scan_fwd": 2})
        timed(check_caduceus_against_plain, fq, work / CADUCEUS / "out" / "0")
        timed(check_graph_replay, fq, HYENA)
        timed(check_graph_replay, fq, CADUCEUS)
        timed(phase_graph_memory, card)
        timed(phase_train_parity)
        timed(phase_route_train_parity)
        launches = timed(phase_train, card, HYENA, Counts(mixer), {"mixer_fwd": (4, 4), "mixer_bwd": (4, 0)})
        fwd["launches"], bwd["launches"] = launches["mixer_fwd"], launches["mixer_bwd"]
        with route_env(UNFUSED):
            per_batch = {"gated_fwd": (4, 4), "mixer_fwd": (0, 0), "mixer_bwd": (0, 0)}
            launches = timed(phase_train, card, HYENA, Counts(mixer, gated), per_batch, (), "-unfused")
        gated_row["launches"] = launches["gated_fwd"]
        with route_env(INPROJ):
            per_batch = {"mixer_inproj_fwd": (4, 4), "mixer_bwd": (4, 0), "mixer_fwd": (0, 0)}
            launches = timed(phase_train, card, HYENA, Counts(mixer, inproj), per_batch, (), "-inproj")
        inproj_row["launches"] = launches["mixer_inproj_fwd"]
        per_batch = {"scan_fwd": (32, 32), "scan_ckpt": (32, 0), "scan_bwd": (32, 0)}
        launches = timed(phase_train, card, CADUCEUS, Counts(scan), per_batch,
                         (f"data.tokens_per_batch={CADUCEUS_TRAIN_TOKENS}",))  # fmt: skip
        for row in scan_rows:
            row["launches"] = launches[row["name"]]
        timed(phase_overfit, card)
        timed(time_train_step, card, HYENA, ((128, 1024), (4, 32768)), 10)
        timed(time_train_step, card, CADUCEUS, ((64, 1024), (2, 32768)), 3)
        timed(phase_baselines, card, fq)
        if opts.profile:
            phase_profile(fq)
    except SmokeFailure as exc:
        print(f"chip_smoke FAILED: {exc}", file=sys.stderr)
        return 1
    print(f"chip_smoke wall {time.perf_counter() - t_start:.1f} s on {card}, of which phase_eval {eval_s:.1f} s")
    print(gpu_line())
    print(json.dumps({"kernels": [fwd, bwd, *scan_rows, gated_row, conv_row, inproj_row, setup_row]}))
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
