#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`deepchopper_tpu_torch`) on one GPU.

Run from the repository root:  python3 chip_smoke.py [--profile]

1. Prints the card's name and power limit, builds every CUDA kernel of the
   predict path from `deepchopper_tpu_torch/csrc` with nvcc (sm_90a).
2. Holds each kernel to its plain PyTorch version on the card: the fused
   Hyena mixer at D = 256, B = 2 and every one of the 17 bucket widths, in
   float32 (max-abs error <= 1e-4 * max|ref|: f32 FFT rounding at N = 65536)
   and bfloat16 (<= 1e-2 * max|ref| against the plain version in the same
   dtype: bf16 output rounding is about 4e-3). Then, at the flagship batch
   shapes (B = 2^17 // W), holds the two again in bfloat16 and times them
   beside the least time the card could take (bytes at 3.35 TB/s, f32 flops
   at 67 TFLOP/s).
3. Drives `predict --random-init` (the CLI's own parser and code path) on
   hyenadna-small-32k-seqlen at full width over ~300 seeded reads with the
   benchmark's length mix, including reads in the 24576 and 32768 buckets.
   Checks that the shards hold every read with finite logits and that the
   mixer kernel ran n_layer times per batch. Re-runs the widest and the
   fullest batch with the plain mixer on the card: in bfloat16 the argmax
   agrees on >= 99.9% of the positions outside the bf16 tie band, in
   float32 the logits agree within 2e-4 * max|logit|; a faulty and a
   lower-precision mixer must fail those rules (see
   check_against_plain_mixer).
   Reports reads/s and tokens/s after one batch of warm-up. With
   `--profile`, profiles one more pass over the reads: device time by
   kernel and the device's busy share.
4. Prints the kernel table as one JSON line and, last, the contract line.

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


def phase_profile(fq: Path) -> None:
    """Profile the engine over the same reads once more (torch.profiler, CPU
    and CUDA activity): device time by kernel, and the device's busy share of
    the wall time of `predict_file` (model set-up excluded)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from deepchopper_tpu_torch.infer.engine import PredictEngine
    from deepchopper_tpu_torch.models.registry import DeepChopper

    engine = PredictEngine(DeepChopper.new("rna002", seed=0, device="cuda"), device="cuda")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.predict_file(fq, fq.parent / "profiled")
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [
        (e.key, e.self_device_time_total / 1e3, e.count)
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
    ]
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    print(f"profiled predict_file: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms ({busy_ms / wall_ms:.1%})")
    for key, ms, count in rows[:12]:
        print(f"  {ms:9.3f} ms {ms / busy_ms:6.1%} x{count:5d}  {key[:100]}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true", help="Also profile one predict run (device time by kernel)")
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
        entry = phase_kernels()
        entry["launches"], fq = phase_predict(card)
        if opts.profile:
            phase_profile(fq)
    except SmokeFailure as exc:
        print(f"chip_smoke FAILED: {exc}", file=sys.stderr)
        return 1
    print(gpu_line())
    print(json.dumps({"kernels": [entry]}))
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
