#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`deepchopper_tpu_torch`) on one GPU.

Run from the repository root:  python3 chip_smoke.py [--profile]

1. Prints the card's name and power limit, builds every CUDA kernel of the
   predict and train paths from `deepchopper_tpu_torch/csrc` with nvcc
   (sm_90a), all nvcc processes started together.
2. Holds each kernel to its plain PyTorch version on the card, at every one
   of the 17 bucket widths, in float32 (<= 1e-4 * max|ref|: f32 FFT rounding
   at N = 65536) and bfloat16 (<= 1e-2 * max|ref| against the plain version
   in the same dtype: bf16 output rounding is about 4e-3): the fused Hyena
   mixer at D = 256, B = 2, and its backward at D = 256, B = 3 (each of the
   five gradients; a second call must be bitwise equal). Then, at the
   flagship batch shapes (forward B = 2^17 // W, backward min(512, 2^17 //
   W)), holds each again in bfloat16 and times it beside the least time the
   card could take (bytes at 3.35 TB/s, f32 flops at 67 TFLOP/s).
3. Drives `predict --random-init` (the CLI's own parser and code path) on
   hyenadna-small-32k-seqlen at full width over ~300 seeded reads with the
   benchmark's length mix, including reads in the 24576 and 32768 buckets.
   Checks that the shards hold every read with finite logits and that the
   mixer kernel ran n_layer times per batch. Re-runs the widest and the
   fullest batch with the plain mixer on the card: in bfloat16 the argmax
   agrees on >= 99.9% of the positions outside the bf16 tie band, in
   float32 the logits agree within 2e-4 * max|logit|; a faulty and a
   lower-precision mixer must fail those rules (see
   check_against_plain_mixer). Reports reads/s and tokens/s after one batch
   of warm-up.
4. Train-step parity: one float32 forward and backward of the flagship with
   the kernels and with the plain mixer swapped in; every gradient leaf
   within TRAIN_GRAD_TOL of its max, and a backward with a convolution in
   place of the correlation must fail that rule (phase_train_parity).
5. Drives `train` (the CLI's parser and code path) on the flagship at full
   width: one epoch over ~300 labelled reads with the benchmark's length
   mix and reads in the 24576 and 32768 buckets, a val pass, test on the
   best checkpoint; checks finite losses, the checkpoints and the launches
   (forward n_layer per train and eval batch, backward n_layer per train
   step), then `predict --checkpoint <best>` on a few reads. Then overfits
   one full batch (loss below half its first value within 100 steps) and
   times the train step: ms/step, tokens/s and peak memory.
6. With `--profile`, profiles one more pass of predict and three train
   steps: device time by kernel and the device's busy share.
7. Prints the kernel table as one JSON line (launches from the train run)
   and, last, the contract line.

Any failed phase exits non-zero without the contract line. Without CUDA, or
outside a checkout of the repository, it exits non-zero at once.
"""

from __future__ import annotations

import argparse
import contextlib
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
N_READS = 300


class SmokeFailure(RuntimeError):
    pass


def gpu_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )  # fmt: skip
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 5) -> float:
    import torch

    fn()
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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
            f"bytes {bytes_ms:.3f}, f32 ops {ops_ms:.3f})  kernel/bound {ms / bound:.1f}x"
        )
        del args
    print(
        f"  ladder total: kernel {totals['ms']:.3f} ms, plain {totals['plain_ms']:.3f} ms, "
        f"bound {totals['bound_ms']:.3f} ms"
    )
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
    held again and timed beside the bound."""
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
        # The PyTorch part of the wrapper alone: short-conv adjoint and filter vjp.
        n = mixer.fft_size(seq_len)
        dgates = torch.randn(batch, 3 * d_model, seq_len, device="cuda")
        dkhat = torch.randn(d_model, n // 2 + 1, dtype=torch.complex64, device="cuda")
        tail_ms = time_ms(lambda: mixer._grads_from_cotangents(args[0], dgates, dkhat, *args[2:], n), reps=3)
        del dgates, dkhat
        nbytes, flops = mixer_bwd_bound(batch, d_model, seq_len, 2)
        bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
        bound = max(bytes_ms, ops_ms)
        for k, v in (("ms", ms), ("plain_ms", plain_ms), ("tail_ms", tail_ms), ("bytes_ms", bytes_ms),
                     ("ops_ms", ops_ms), ("bound_ms", bound)):  # fmt: skip
            totals[k] += v
        print(
            f"  W={seq_len:6d} B={batch:4d} err {err:.2e} ({rel:.1e})  kernel {ms:8.3f} ms (PyTorch tail {tail_ms:.3f})  "
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


def _shard_read_names(ids) -> list[str]:
    return [bytes(int(c) for c in row[2 : 2 + row[0]]).decode("ascii") for row in ids]


def phase_predict(card: str) -> tuple[int, Path]:
    import numpy as np
    import torch

    from deepchopper_tpu_torch import cli
    from deepchopper_tpu_torch.data.synth import read_lengths, synth_fastq
    from deepchopper_tpu_torch.ops import mixer

    work = REPO / "build" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    lengths = read_lengths(N_READS, seed=0)
    # The 24576 and 32768 buckets run the kernel's global-scratch branch.
    if not ((lengths >= 16400) & (lengths <= 24000)).any():
        lengths[0] = 20000
    if not ((lengths >= 24600) & (lengths <= 32000)).any():
        lengths[1] = 30000
    fq = synth_fastq(work / "reads.fq", lengths, seed=0)
    parser = cli.build_parser()

    cli.predict(parser.parse_args(["predict", str(fq), "--random-init", "-o", str(work / "warm"), "--limit-batches", "1"]))
    torch.cuda.synchronize()

    out = work / "out"
    args = parser.parse_args(["predict", str(fq), "--random-init", "-o", str(out)])
    mixer.reset_launch_counts()
    stats = cli.predict(args)
    torch.cuda.synchronize()
    launches = mixer.launch_counts["mixer_fwd"]

    n_layer = 4
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
        raise SmokeFailure(f"shards hold {len(names)} reads ({len(set(names) & want)} of {N_READS} expected)")
    if not {24576, 32768} <= widths:
        raise SmokeFailure(f"large buckets missing from the run: widths {sorted(widths)}")
    if launches <= 0 or launches != n_layer * stats.batches or stats.batches != len(shards):
        raise SmokeFailure(f"mixer launches {launches} != {n_layer} x {stats.batches} batches ({len(shards)} shards)")
    reads_s, tokens_s = stats.reads / stats.elapsed_s, stats.tokens / stats.elapsed_s
    print(
        f"predict: {stats.reads} reads, {stats.tokens} tokens, {stats.batches} batches, widths {sorted(widths)}; "
        f"mixer_fwd launches {launches} = {n_layer} layers x {stats.batches} batches"
    )
    print(
        f"predict throughput on {card}: {reads_s:.1f} reads/s, {tokens_s:.0f} tokens/s "
        f"({stats.elapsed_s:.3f} s, after one warm-up batch)"
    )
    check_against_plain_mixer(fq, out / "0", len(shards))
    return launches, fq


F32_LOGIT_TOL = 2e-4  # f32 logits, kernel vs plain mixer, of max|logit|
ARGMAX_AGREEMENT = 0.999  # bf16 argmax outside the tie band, kernel vs plain mixer
TIE_BAND = 2.0**-7  # of max|logit|: two bf16 ulps at the logit scale


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


@contextlib.contextmanager
def swapped_mixer(fn):
    """Route every HyenaOperator through fn instead of the kernel."""
    from deepchopper_tpu_torch.models import hyena

    kernel_mixer = hyena.mixer_fft_conv_bm
    hyena.mixer_fft_conv_bm = fn
    try:
        yield
    finally:
        hyena.mixer_fft_conv_bm = kernel_mixer


def check_against_plain_mixer(fq: Path, shard_dir: Path, n_shards: int) -> None:
    """Re-run the widest and the fullest batch of the main path with the
    plain mixer on the card, through the engine's own step, and hold the
    kernel's logits to it. Each rule is also run on a control that must fail
    it, so a rule that cannot see a fault fails the run.

    bfloat16, the flagship's dtype, against the shards the main path wrote:
    argmax agrees on >= 99.9% of the valid positions whose logit margin
    exceeds 2^-7 * max|logit|. That is two bf16 ulps at the logit scale: the
    head's logits are bf16 products, so a narrower margin is a tie at this
    precision and flips under any change of rounding. The agreement over all
    valid positions is printed beside it, for the kernel and for the plain
    mixer with its FFT at 4L (two correct mixers). Control: the short conv's
    taps reversed.

    float32, the same weights and batches at compute_dtype float32: logits
    within 2e-4 * max|logit| of the plain run. Printed beside it: the plain
    mixer at 4L. Control: the plain mixer with bf16 input and output.
    """
    import dataclasses

    import numpy as np
    import torch

    from deepchopper_tpu_torch.data.fastq_module import iter_batches
    from deepchopper_tpu_torch.infer.engine import PredictEngine
    from deepchopper_tpu_torch.models.classifier import HyenaTokenClassifier
    from deepchopper_tpu_torch.models.registry import DeepChopper
    from deepchopper_tpu_torch.ops import mixer

    model = DeepChopper.new("rna002", seed=0, device="cuda")
    model32 = HyenaTokenClassifier(
        dataclasses.replace(model.backbone_config, compute_dtype="float32"),
        dataclasses.replace(model.head_config, compute_dtype="float32"),
    )
    model32.load_state_dict(model.state_dict())
    engine, engine32 = PredictEngine(model, device="cuda"), PredictEngine(model32, device="cuda")

    # The CLI's batching is deterministic: batch i was written as shard 0_i.
    batches = list(iter_batches(fq))
    if len(batches) != n_shards:
        raise SmokeFailure(f"re-batching gave {len(batches)} batches for {n_shards} shards")
    picks = sorted({max(range(n_shards), key=lambda i: batches[i].input_ids.shape[k]) for k in (0, 1)})
    bf16_runs = ("kernel", "plain at 4L", "control: taps reversed")
    agree = {name: np.zeros(4, dtype=np.int64) for name in bf16_runs}  # valid, agree, decided, decided-agree
    f32_rel = {"kernel": 0.0, "plain at 4L": 0.0, "control: bf16 I/O": 0.0}
    for i in picks:
        batch, shard = batches[i], np.load(shard_dir / f"0_{i}.npz")
        if not np.array_equal(shard["seq"], batch.input_ids):
            raise SmokeFailure(f"batch {i} does not match shard 0_{i}.npz")
        ids = torch.from_numpy(batch.input_ids.astype(np.int8)).cuda()
        quals = torch.from_numpy(batch.quals_raw).cuda()
        valid = batch.labels != -100

        def run(eng, fn):
            with swapped_mixer(fn):
                return eng.step(ids, quals).cpu().numpy()

        plain = run(engine, mixer.mixer_reference)
        scale = np.abs(plain).max()
        decided = valid & (np.abs(plain[..., 1] - plain[..., 0]) > TIE_BAND * scale)
        bf16 = {"kernel": shard["prediction"], "plain at 4L": run(engine, mixer_at_4l),
                "control: taps reversed": run(engine, mixer_taps_reversed)}  # fmt: skip
        for name, logits in bf16.items():
            same = logits.argmax(-1) == plain.argmax(-1)
            counts = np.array([valid.sum(), same[valid].sum(), decided.sum(), same[decided].sum()])
            agree[name] += counts
            print(
                f"  bf16 batch {i} {batch.input_ids.shape}, {name} vs plain mixer: logits max-abs diff "
                f"{np.abs(logits - plain).max():.3e} (max|logit| {scale:.3e}); argmax agrees on "
                f"{counts[1]}/{counts[0]} valid positions, {counts[3]}/{counts[2]} beyond the tie band"
            )

        plain32 = run(engine32, mixer.mixer_reference)
        scale32 = np.abs(plain32).max()
        f32 = {"kernel": engine32.step(ids, quals).cpu().numpy(), "plain at 4L": run(engine32, mixer_at_4l),
               "control: bf16 I/O": run(engine32, mixer_bf16_io)}  # fmt: skip
        for name, logits in f32.items():
            err = np.abs(logits - plain32).max()
            f32_rel[name] = max(f32_rel[name], float(err / scale32))
            flips = int((logits.argmax(-1) != plain32.argmax(-1))[valid].sum())
            print(
                f"  f32  batch {i} {batch.input_ids.shape}, {name} vs plain mixer: logits max-abs diff {err:.3e} "
                f"({err / scale32:.3e} of max|logit| {scale32:.3e}); argmax differs at {flips} valid positions"
            )

    shares = {name: (c[1] / c[0], c[3] / c[2]) for name, c in agree.items()}
    for name, (share, decided_share) in shares.items():
        print(f"  bf16 {name}: argmax agrees on {share:.5f} of valid positions, {decided_share:.5f} beyond the tie band")
    f32_line = ", ".join(f"{name} {rel:.3e}" for name, rel in f32_rel.items())
    print(f"  f32 logits vs plain mixer, of max|logit|: {f32_line} (limit {F32_LOGIT_TOL})")
    if shares["kernel"][1] < ARGMAX_AGREEMENT:
        raise SmokeFailure(f"bf16 argmax agrees with the plain mixer on {shares['kernel'][1]:.5f} < {ARGMAX_AGREEMENT}")
    if shares["control: taps reversed"][1] >= ARGMAX_AGREEMENT:
        raise SmokeFailure("bf16 argmax rule passes a mixer with its taps reversed")
    if not f32_rel["kernel"] <= F32_LOGIT_TOL:
        raise SmokeFailure(f"f32 logits differ from the plain mixer's by {f32_rel['kernel']:.3e} > {F32_LOGIT_TOL}")
    if f32_rel["control: bf16 I/O"] <= F32_LOGIT_TOL:
        raise SmokeFailure("f32 logit limit passes a mixer with bf16 input and output")


# f32 train step, kernels vs plain mixer: each leaf's max error, of its max|grad|.
# On the CPU two correct plain mixers (FFT at 2L and at 4L) differ by up to 1.0e-2
# of a leaf's max (median 5e-4 to 7e-4) at (16, 1024) and (1, 8192): ReLU masks
# of the 1024-wide head flip where a pre-activation sits within rounding of 0,
# and the filter-bias gradients are sums that cancel. The convolution control
# is off by 1.6 to 47.
TRAIN_GRAD_TOL = 3e-2


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


def phase_train_parity() -> None:
    """One forward and backward of the flagship at compute_dtype float32, same
    random-init weights, on a (61, 1024) and a (1, 32768) batch: with the
    kernels, and with the plain mixer (mixer_reference + mixer_bwd_reference)
    swapped in. Every parameter's gradient within TRAIN_GRAD_TOL of that
    leaf's max|grad| of the plain run. Control that must fail the rule: the
    plain backward with K̂ in place of conj(K̂). Printed beside them: autograd
    of the plain mixer at 4L, a second correct mixer."""
    import dataclasses

    import torch

    from deepchopper_tpu_torch.models.classifier import HyenaTokenClassifier
    from deepchopper_tpu_torch.models.registry import DeepChopper
    from deepchopper_tpu_torch.ops import mixer
    from deepchopper_tpu_torch.train.loss import continuous_interval_loss

    base = DeepChopper.new("hyenadna-small-32k-seqlen", seed=0, device="cuda")
    model = HyenaTokenClassifier(
        dataclasses.replace(base.backbone_config, compute_dtype="float32"),
        dataclasses.replace(base.head_config, compute_dtype="float32"),
    ).cuda()
    model.load_state_dict(base.state_dict())
    model.train()
    n_layer = model.backbone_config.n_layer
    runs = {"kernel": None, "plain": plain_mixer(mixer.mixer_bwd_reference), "plain at 4L (autograd)": mixer_at_4l,
            "control: convolution backward": plain_mixer(mixer_bwd_convolution)}  # fmt: skip
    worst = {name: 0.0 for name in runs if name != "plain"}
    for batch_shape, seed in (((61, 1024), 1), ((1, 32768), 2)):
        batch = training_batch(*batch_shape, seed=seed)
        grads = {}
        for name, fn in runs.items():
            model.zero_grad(set_to_none=True)
            mixer.reset_launch_counts()
            with swapped_mixer(fn) if fn is not None else contextlib.nullcontext():
                loss = continuous_interval_loss(model(batch["input_ids"], batch["input_quals"]), batch["labels"])
                loss.backward()
            torch.cuda.synchronize()
            if fn is None and mixer.launch_counts != {"mixer_fwd": n_layer, "mixer_bwd": n_layer}:
                raise SmokeFailure(f"train step {batch_shape}: kernel launches {mixer.launch_counts}")
            if fn is not None and any(mixer.launch_counts.values()):
                raise SmokeFailure(f"train step {batch_shape}: the plain run launched {mixer.launch_counts}")
            grads[name] = ({k: p.grad.detach().clone() for k, p in model.named_parameters()}, loss.item())
        plain, plain_loss = grads["plain"]
        for name in worst:
            got, got_loss = grads[name]
            rel = {k: ((got[k] - g).abs().max() / g.abs().max()).item() for k, g in plain.items() if g.abs().max() > 0}
            leaf = max(rel, key=rel.get)
            worst[name] = max(worst[name], rel[leaf])
            print(
                f"  f32 train step {batch_shape}, {name} vs plain mixer: loss {got_loss:.7f} vs {plain_loss:.7f}; "
                f"worst gradient leaf {leaf} at {rel[leaf]:.3e} of its max|grad| ({len(rel)} leaves)"
            )
    print(f"  train-step gradients vs plain, worst leaf: " + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
          + f" (limit {TRAIN_GRAD_TOL})")  # fmt: skip
    if not worst["kernel"] <= TRAIN_GRAD_TOL:
        raise SmokeFailure(f"train-step gradients differ from the plain mixer's by {worst['kernel']:.3e}")
    if worst["control: convolution backward"] <= TRAIN_GRAD_TOL:
        raise SmokeFailure("train-step gradient rule passes a backward with a convolution for the correlation")


def phase_train(card: str) -> dict[str, int]:
    """`train` through the CLI's parser and code path on the flagship at full
    width (random init, seed 0), one epoch over ~300 labelled reads with the
    benchmark's length mix, two of them forced into the 24576 and 32768
    buckets of the training split; one val pass; test on the best
    checkpoint. Then `predict --checkpoint <best>` on a few reads. Returns the
    kernels' launches in the train run."""
    import csv
    import dataclasses

    import numpy as np
    import torch

    from deepchopper_tpu_torch import cli
    from deepchopper_tpu_torch.data.parquet_module import DataModule, ratio_split
    from deepchopper_tpu_torch.data.synth import read_lengths, synth_labelled_fastq
    from deepchopper_tpu_torch.ops import mixer

    work = REPO / "build" / "chip_smoke_train"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    lengths = read_lengths(N_READS, seed=0)
    train_rows = ratio_split(N_READS, 0.8, 0.1, seed=0).train
    lengths[train_rows[0]], lengths[train_rows[1]] = 20000, 30000
    fq = synth_labelled_fastq(work / "reads.fq", lengths, seed=0)
    argv = ["train", f"data.train_data_path={fq}", "model.name=hyenadna-small-32k-seqlen", "seed=0",
            "trainer.max_epochs=1", f"output_dir={work / 'runs'}", "--device", "cuda"]  # fmt: skip
    cfg = cli.train_config(cli.build_parser().parse_args(argv))
    dm = DataModule(**dataclasses.asdict(cfg.data))
    train_batches = list(dm.train_batches(0))
    n_train, n_eval = len(train_batches), len(list(dm.val_batches())) + len(list(dm.test_batches()))
    widths = sorted({b.input_ids.shape[1] for b in train_batches})
    tokens = sum(b.input_ids.size for b in train_batches)
    if not {24576, 32768} <= set(widths):
        raise SmokeFailure(f"large buckets missing from the training batches: widths {widths}")

    mixer.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rc = cli.main(argv)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = dict(mixer.launch_counts)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if rc != 0:
        raise SmokeFailure(f"train exited {rc}")
    n_layer = 4
    want = {"mixer_fwd": n_layer * (n_train + n_eval), "mixer_bwd": n_layer * n_train}
    if launches != want or 0 in launches.values():
        raise SmokeFailure(f"train launches {launches} != {want} ({n_train} train, {n_eval} val+test batches)")
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
        f"train (CLI): {n_train} steps over widths {widths}, {tokens} padded tokens, {n_eval} val+test batches, "
        f"{elapsed:.1f} s with set-up and test-on-best; train/loss {float(rows[0]['train/loss']):.4f}, "
        f"val/loss {float(rows[0]['val/loss']):.4f}, test {test}"
    )
    print(f"  launches {launches} = {n_layer} layers x ({n_train} train + {n_eval} eval) / {n_layer} x {n_train}")
    print(f"  peak device memory of the train run on {card}: {peak_gb:.2f} GB")

    few = synth_labelled_fastq(work / "few.fq", lengths[:8], seed=1)
    stats = cli.predict(cli.build_parser().parse_args(
        ["predict", str(few), "--checkpoint", str(best[-1]), "--model", "hyenadna-small-32k-seqlen",
         "-o", str(work / "pred")]))  # fmt: skip
    torch.cuda.synchronize()
    shards = sorted((work / "pred" / "0").glob("*.npz"))
    if stats.reads != 8 or not all(np.isfinite(np.load(s)["prediction"]).all() for s in shards):
        raise SmokeFailure(f"predict --checkpoint {best[-1].name}: {stats.reads} reads")
    print(f"  predict --checkpoint {best[-1].name}: {stats.reads} reads, finite logits")
    return launches


def phase_overfit(card: str) -> None:
    """Overfit one full batch (128 reads of 1000 bases, W = 1024, 2^17
    tokens) for at most 100 steps: the loss must fall below half its first
    value. Then time the train step at (128, 1024) and (4, 32768)."""
    import numpy as np
    import torch

    from deepchopper_tpu_torch.data.synth import synth_labelled_fastq
    from deepchopper_tpu_torch.models.registry import DeepChopper
    from deepchopper_tpu_torch.train.config import load_config
    from deepchopper_tpu_torch.train.loop import Trainer, TrialPruned
    from deepchopper_tpu_torch.train.step import make_optimizer, train_step

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

    model = DeepChopper.new("hyenadna-small-32k-seqlen", seed=0, device="cuda").train()
    opt = make_optimizer(model.parameters(), 2e-4)
    for shape in ((128, 1024), (4, 32768)):
        batch = training_batch(*shape, seed=9)
        for _ in range(2):
            train_step(model, opt, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reps = 10
        t0 = time.perf_counter()
        for _ in range(reps):
            out = train_step(model, opt, batch)
        float(out["loss"])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / reps * 1e3
        tokens = shape[0] * shape[1]
        print(
            f"train step {shape} bf16 on {card}: {ms:.2f} ms/step, {tokens / ms * 1e3:.0f} tokens/s "
            f"({tokens} padded tokens), peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB"
        )


def print_device_time(prof, wall_ms: float, what: str) -> None:
    """Device time by kernel of a torch.profiler run, and the device's busy
    share of `wall_ms`."""
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


def phase_profile(fq: Path) -> None:
    """Profile (torch.profiler, CPU and CUDA activity) the engine over the
    same reads once more, and three bf16 train steps at (128, 1024): device
    time by kernel and the device's busy share of the wall time (model
    set-up excluded)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from deepchopper_tpu_torch.infer.engine import PredictEngine
    from deepchopper_tpu_torch.models.registry import DeepChopper
    from deepchopper_tpu_torch.train.step import make_optimizer, train_step

    engine = PredictEngine(DeepChopper.new("rna002", seed=0, device="cuda"), device="cuda")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.predict_file(fq, fq.parent / "profiled")
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    print_device_time(prof, wall_ms, "predict_file")

    model = DeepChopper.new("hyenadna-small-32k-seqlen", seed=0, device="cuda").train()
    opt = make_optimizer(model.parameters(), 2e-4)
    batch = training_batch(128, 1024, seed=9)
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
    print_device_time(prof, wall_ms, "3 train steps at (128, 1024)")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true", help="Also profile predict and the train step (device time by kernel)")
    opts = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke run needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if not (REPO / "deepchopper_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: {REPO} is not a checkout of the repository (no deepchopper_tpu_torch)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = gpu_line()
    print(f"gpu: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    try:
        from deepchopper_tpu_torch.ops import _build

        t0 = time.perf_counter()
        built = _build.build_all()
        print(f"built {', '.join(sorted(built))} in {time.perf_counter() - t0:.1f} s")
        fwd = phase_kernels()
        bwd = phase_bwd_kernel()
        _predict_launches, fq = phase_predict(card)
        phase_train_parity()
        launches = phase_train(card)
        fwd["launches"], bwd["launches"] = launches["mixer_fwd"], launches["mixer_bwd"]
        phase_overfit(card)
        if opts.profile:
            phase_profile(fq)
    except SmokeFailure as exc:
        print(f"chip_smoke FAILED: {exc}", file=sys.stderr)
        return 1
    print(gpu_line())
    print(json.dumps({"kernels": [fwd, bwd]}))
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
