#!/usr/bin/env python3
"""The mixer backward of this checkout beside other checkouts', on one GPU, at
every ladder width.

    python3 scripts/torch_mixer_bwd_ab.py --parent CHECKOUT [--parent ...] [--ptxas] [--train-step] [--out FILE]

Each `--parent` checkout's `csrc/mixer_bwd.cu` is built here with the same
nvcc flags and bound under the C signature that checkout declares. The first
design's (gate cotangents (B, 3D, L) float32 and dkhat out) is followed by
this checkout's `_grads_from_cotangents` (the short-conv adjoint, its sums and
the filter's VJP in PyTorch): exactly that checkout's wrapper. A checkout with
this design's signature (`mixer_bwd_plan`) runs through this checkout's
wrapper. At each of the 17 bucket widths (D = 256, B = min(512, 2^17 // W),
bfloat16, chip_smoke.py's backward inputs at the flagship training shapes):
- this checkout's `mixer_bwd_cuda` and each parent's call, each of the five
  gradients within 1e-2 of its max|ref| against `mixer_bwd_reference`
  (chip_smoke.py's bf16 limit), this checkout's two calls bitwise equal;
- each parent and this checkout timed in turns, parent, this, this, parent
  (CUDA events, 5 calls of the whole wrapper after 2 of warm-up each), beside
  the bound of chip_smoke.py's `mixer_bwd_bound` and the layout the kernel
  runs (`mixer_bwd_plan`);
- this checkout's call split by torch.profiler over 5 calls into the kernel
  with its reduce and the wrapper's other device work (the filter spectrum's
  rfft, the filter VJP's irfft, casts); what the CUDA-event time of a call
  holds beyond both is host time and gaps.
Ladder totals close the run. `--ptxas` first prints nvcc's `-Xptxas -v` report
(registers, spills, shared memory) of every source. `--train-step` then times
chip_smoke.py's bf16 Hyena train step at (128, 1024) and (4, 32768) with each
parent's backward in turns with this checkout's, in one process on one model
(one warm-up step, then the mean of 3), with each one's peak device memory.
Prints the card's name and power limit; `--out` keeps the whole log. Exits
non-zero without a GPU or if a check fails.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "scripts"))

from torch_scan_ab import LOG, nvcc, ptxas_report, say  # noqa: E402

SOURCE = "mixer_bwd.cu"
D_MODEL = 256
NAMES = ("dproj", "dk_short", "db_short", "dk_long", "dbias")


def parent_bwd(checkout: Path, label: str):
    """A checkout's backward call: its kernel bound by its own C signature."""
    import torch

    from deepchopper_tpu_torch.ops import _build, mixer

    src = checkout / "deepchopper_tpu_torch" / "csrc" / SOURCE
    out = _build.BUILD_DIR / f"ab-{label}-mixer_bwd.so"
    nvcc(src, out)
    lib = ctypes.PyDLL(str(out))
    if "mixer_bwd_plan(" in src.read_text():
        mixer.bind_bwd(lib)

        def same_design(*args):
            own = mixer._bwd_lib
            mixer._bwd_lib = lambda: lib
            try:
                return own_call(*args)
            finally:
                mixer._bwd_lib = own

        own_call = mixer.mixer_bwd_cuda
        return same_design
    ptr = ctypes.c_void_p
    lib.mixer_bwd.argtypes = [ptr] * 9 + [ctypes.c_int] * 5 + [ptr]
    lib.mixer_bwd.restype = ctypes.c_int
    lib.mixer_bwd_scratch_bytes.argtypes = [ctypes.c_int] * 3
    lib.mixer_bwd_scratch_bytes.restype = ctypes.c_longlong

    def first_design(proj, dy, k_short, b_short, k_long, bias):
        batch, width, seq_len = proj.shape
        d_model = k_long.shape[1]
        n = mixer.fft_size(seq_len)
        log2n = n.bit_length() - 1
        dev = proj.device
        taps = k_short.float().reshape(3, width).contiguous()
        bsh = b_short.float().contiguous()
        khat = mixer.filter_spectrum(k_long, bias, n)
        tw = mixer._twiddles(n, dev)
        dgates = torch.empty((batch, width, seq_len), dtype=torch.float32, device=dev)
        dkhat = torch.empty((d_model, n // 2 + 1), dtype=torch.complex64, device=dev)
        scratch = torch.empty(lib.mixer_bwd_scratch_bytes(batch, d_model, log2n), dtype=torch.uint8, device=dev)
        _build.launch(
            lib.mixer_bwd, proj,
            proj.data_ptr(), dy.data_ptr(), taps.data_ptr(), bsh.data_ptr(), khat.data_ptr(), tw.data_ptr(),
            scratch.data_ptr(), dgates.data_ptr(), dkhat.data_ptr(),
            batch, d_model, seq_len, log2n, mixer._DTYPE_CODES[proj.dtype], what=f"{label} mixer_bwd",
        )  # fmt: skip
        return mixer._grads_from_cotangents(proj, dgates, dkhat, k_short, b_short, k_long, bias, n)

    return first_design


@contextlib.contextmanager
def backward_of(bwd):
    """`mixer_bwd_cuda`, which `MixerFn`'s backward calls, is `bwd` (None:
    this checkout's)."""
    from deepchopper_tpu_torch.ops import mixer

    own = mixer.mixer_bwd_cuda
    if bwd is not None:
        mixer.mixer_bwd_cuda = bwd
    try:
        yield
    finally:
        mixer.mixer_bwd_cuda = own


def check(got, ref, where: str) -> float:
    """Each gradient within 1e-2 of its max|ref|; the worst error of its max."""
    worst = 0.0
    for name, g, r in zip(NAMES, got, ref):
        if g.shape != r.shape or g.dtype != r.dtype:
            raise SystemExit(f"{where} {name}: {g.shape}/{g.dtype} vs {r.shape}/{r.dtype}")
        rel = ((g.float() - r.float()).abs().max() / r.float().abs().max()).item()
        if not rel <= 1e-2:
            raise SystemExit(f"{where} {name}: err {rel:.2e} of max|ref| > 1e-2")
        worst = max(worst, rel)
    return worst


def call_split(args, reps: int = 5) -> tuple[float, float] | None:
    """(kernel and reduce, the wrapper's other device work) in ms a call, from
    torch.profiler's kernel times; None if the profiler saw no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from deepchopper_tpu_torch.ops import mixer

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            mixer.mixer_bwd_cuda(*args)
        torch.cuda.synchronize()
    kernel = other = 0.0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            if "mixer_bwd" in e.key:
                kernel += e.self_device_time_total / 1e3 / reps
            else:
                other += e.self_device_time_total / 1e3 / reps
    return (kernel, other) if kernel else None


def train_step_turns(parents, reps: int = 3) -> None:
    """The Hyena bf16 train step with each parent's backward in turns with this
    checkout's (parent, this, this, parent): ms a step and peak memory."""
    import time

    import chip_smoke as cs
    import torch

    from deepchopper_tpu_torch.models.registry import DeepChopper
    from deepchopper_tpu_torch.ops import mixer
    from deepchopper_tpu_torch.train.step import make_optimizer, train_step

    model = DeepChopper.new(cs.HYENA, seed=0, device="cuda").train()
    opt = make_optimizer(model.parameters(), 2e-4)

    def run(bwd, batch) -> tuple[float, float]:
        with backward_of(bwd):
            train_step(model, opt, batch)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            for _ in range(reps):
                out = train_step(model, opt, batch)
            float(out["loss"])
            torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3, torch.cuda.max_memory_allocated() / 1e9

    for shape in ((128, 1024), (4, 32768)):
        batch = cs.training_batch(*shape, seed=9)
        mixer.reset_launch_counts()
        run(None, batch)  # first-use costs of this shape
        if mixer.launch_counts["mixer_bwd"] != 4 * (reps + 1):
            raise SystemExit(f"train step: mixer_bwd launched {mixer.launch_counts} times, not 4 a step")
        for label, bwd in parents:
            (p1, pm1), (n1, nm1), (n2, nm2), (p2, pm2) = run(bwd, batch), run(None, batch), run(None, batch), \
                run(bwd, batch)  # fmt: skip
            say(f"train step {cs.HYENA} {shape} bf16: this {(n1 + n2) / 2:.2f} ms ({n1:.2f}, {n2:.2f}), peak "
                f"{max(nm1, nm2):.3f} GB; {label} {(p1 + p2) / 2:.2f} ms ({p1:.2f}, {p2:.2f}), peak "
                f"{max(pm1, pm2):.3f} GB")  # fmt: skip
        del batch


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", type=Path, action="append", required=True,
                        help="a checkout whose mixer_bwd.cu to time beside this one (repeatable)")  # fmt: skip
    parser.add_argument("--ptxas", action="store_true", help="print nvcc's -Xptxas -v report first")
    parser.add_argument("--train-step", action="store_true", help="also time the Hyena train step in turns")
    parser.add_argument("--out", type=Path, help="write the whole log here")
    opts = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_mixer_bwd_ab: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from deepchopper_tpu_torch.data.bucketing import default_buckets
    from deepchopper_tpu_torch.ops import mixer

    say(f"gpu: {cs.gpu_line()}")
    labels = [p.resolve().name for p in opts.parent]
    if opts.ptxas:
        ptxas_report(REPO, SOURCE, "this")
        for label, checkout in zip(labels, opts.parent):
            ptxas_report(checkout, SOURCE, label)
    parents = [(label, parent_bwd(checkout, label)) for label, checkout in zip(labels, opts.parent)]
    tot = {"kernel": 0.0, "other": 0.0, "bound": 0.0, **{label: [0.0, 0.0] for label in labels}}
    for seq_len in default_buckets(32768):
        batch = min(512, cs.TOKENS_PER_BATCH // seq_len)
        args = cs.mixer_bwd_inputs(batch, D_MODEL, seq_len, torch.bfloat16, seed=seq_len + 1)
        where = f"W={seq_len:6d} B={batch:4d}"
        ref = mixer.mixer_bwd_reference(*args)
        got, again = mixer.mixer_bwd_cuda(*args), mixer.mixer_bwd_cuda(*args)
        for name, g, a in zip(NAMES, got, again):
            if not torch.equal(g, a):
                raise SystemExit(f"{where} {name}: two calls differ")
        err = check(got, ref, where)
        del got, again
        plan = mixer.mixer_bwd_plan(batch, D_MODEL, seq_len)
        bytes_ms, ops_ms = (v / r * 1e3 for v, r in zip(cs.mixer_bwd_bound(batch, D_MODEL, seq_len, 2),
                                                          (cs.HBM_BYTES_PER_S, cs.F32_FLOPS_PER_S)))  # fmt: skip
        bound = max(bytes_ms, ops_ms)
        tot["bound"] += bound
        line = (f"{where} {plan['layout']} (G {plan['G']}, {plan['threads']} threads, {plan['smem']} B, groups "
                f"{plan['groups']}) err {err:.2e} | bound {bound:.3f} ms "
                f"({'bytes' if bytes_ms >= ops_ms else 'operations'})")  # fmt: skip
        for label, bwd in parents:
            perr = check(bwd(*args), ref, f"{where} {label}")

            def timed(b):
                with backward_of(b):
                    return cs.time_ms(lambda: mixer.mixer_bwd_cuda(*args))

            p1, n1, n2, p2 = timed(bwd), timed(None), timed(None), timed(bwd)
            new_ms, old_ms = (n1 + n2) / 2, (p1 + p2) / 2
            tot[label][0] += new_ms
            tot[label][1] += old_ms
            line += (f" | {label}: err {perr:.2e}; this {new_ms:.3f} ms ({n1:.3f}, {n2:.3f}), {label} "
                     f"{old_ms:.3f} ms ({p1:.3f}, {p2:.3f}), {label}/this {old_ms / new_ms:.2f}, this/bound "
                     f"{new_ms / bound:.1f}")  # fmt: skip
        split = call_split(args)
        if split is None:
            line += " | split: not measured (the profiler saw no device time)"
        else:
            tot["kernel"] += split[0]
            tot["other"] += split[1]
            line += f" | split: kernel {split[0]:.3f} ms, other device work {split[1]:.3f} ms"
        say(line)
        del args, ref
    for label in labels:
        new_ms, old_ms = tot[label]
        say(f"mixer_bwd ladder total: this {new_ms:.3f} ms, {label} {old_ms:.3f} ms, bound {tot['bound']:.3f} ms; "
            f"{label}/this {old_ms / new_ms:.2f}, this/bound {new_ms / tot['bound']:.2f}")  # fmt: skip
    say(f"mixer_bwd ladder split (profiler): kernel {tot['kernel']:.3f} ms, other device work {tot['other']:.3f} ms")
    if opts.train_step:
        train_step_turns(parents)
    say(f"gpu: {cs.gpu_line()}")
    if opts.out:
        opts.out.parent.mkdir(parents=True, exist_ok=True)
        opts.out.write_text("\n".join(LOG) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
