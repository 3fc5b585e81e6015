#!/usr/bin/env python3
"""A selective-scan kernel of this checkout beside other checkouts', on one
GPU, at every ladder width.

    python3 scripts/torch_scan_ab.py [--kernel fwd|ckpt|bwd] [--parent CHECKOUT]... [--ptxas] [--sweep]
                                     [--train-step] [--out FILE]

At each of the 17 bucket widths (Din 512, N 16, B = 2^17 // W, f32, the
inputs of chip_smoke.py's scan phase), in both directions:
- `--kernel fwd` (the default): this checkout's `scan_fwd_cuda` against
  `selective_scan_reference` (within 1e-5 of max|ref|) and against itself
  (two calls bitwise equal);
- `--kernel ckpt`: this checkout's `scan_ckpt_cuda` against
  `scan_ckpt_reference` (within 1e-5 of max|ref|) and against itself;
- `--kernel bwd`: this checkout's `scan_bwd_cuda`, from `scan_ckpt_cuda`'s
  checkpoints, against `scan_bwd_reference`: the max error of each of the
  six gradients of its max|ref| (du, ddelta, dBp, dCp within 1e-5, dA, dD
  within 1e-4) and two calls bitwise equal;
- each `--parent` checkout's kernel (`--parent` may be given more than
  once), built here with the same nvcc flags and held to the same
  reference: `csrc/scan_fwd.cu` or `csrc/scan_bwd.cu` launched through this
  checkout's wrapper (its C entry has this checkout's signature); for
  `ckpt`, the parent's `scan_ckpt` wherever it lives, bound by its own C
  signature (the planned entry of `scan_fwd.cu`, or the first design's in
  `scan_bwd.cu`, which takes no plan); then it and this checkout's kernel
  timed in turns, parent, this, this, parent (CUDA events, 5 launches after
  2 of warm-up each), beside the bound of chip_smoke.py's `scan_bound`.
  Ladder totals for each direction close the run.
`--ptxas` first prints nvcc's `-Xptxas -v` report (registers, spills, shared
memory) of the kernel's source in this checkout and in each parent.
`--sweep` (fwd only) also times other plans at each width (forward
direction): channels a block, tile length and segment count.
`--train-step` (ckpt or bwd) then times chip_smoke.py's bf16 Caduceus train
step at (64, 1024) and (2, 32768) with each parent's `scan_ckpt` or
`scan_bwd` in turns with this checkout's, in one process on one model: only
that kernel behind `ScanFn`'s backward changes (one warm-up step, then the
mean of 3). Prints the card's name and power limit; `--out` keeps the whole
log. Exits non-zero without a GPU or if a check fails.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import itertools
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

LOG: list[str] = []
SOURCES = {"fwd": "scan_fwd.cu", "ckpt": "scan_fwd.cu", "bwd": "scan_bwd.cu"}
# The C signature of the first design's scan_ckpt (scan_bwd.cu, before the
# checkpoint walk moved onto scan_fwd.cu's): u, delta, A, Bp, ckpt; batch, L,
# Din, N; Bp's strides; reverse; stream.
FIRST_CKPT_ARGTYPES = (
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 2 + [ctypes.c_int, ctypes.c_void_p]
)


def say(line: str) -> None:
    print(line, flush=True)
    LOG.append(line)


def nvcc(src: Path, out: Path, verbose: bool = False) -> str:
    """Build `src` into `out` with the port's flags; the compiler's log."""
    from deepchopper_tpu_torch.ops import _build

    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []), "-o", str(out), str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise SystemExit(f"nvcc failed on {src} (exit {res.returncode}):\n{res.stdout}{res.stderr}")
    return res.stdout + res.stderr


def ptxas_report(checkout: Path, source: str, label: str) -> None:
    from deepchopper_tpu_torch.ops import _build

    log = nvcc(checkout / "deepchopper_tpu_torch" / "csrc" / source, _build.BUILD_DIR / f"ptxas-{label}.so", True)
    say(f"nvcc -Xptxas -v {source} of {label}:")
    for line in log.splitlines():
        if "entry function" in line or "registers" in line or "spill" in line or "error" in line:
            say("  " + line.strip())


def source_of(checkout: Path, kind: str) -> str:
    """The file of `kind`'s kernel in a checkout: scan_ckpt moved from
    scan_bwd.cu into scan_fwd.cu."""
    if kind != "ckpt":
        return SOURCES[kind]
    text = (checkout / "deepchopper_tpu_torch" / "csrc" / "scan_fwd.cu").read_text()
    return "scan_fwd.cu" if 'extern "C" int scan_ckpt(' in text else "scan_bwd.cu"


def parent_lib(checkout: Path, kind: str, label: str):
    """Another checkout's kernel, built with this checkout's flags: for fwd
    and bwd its library, bound as this checkout's wrappers bind their own;
    for ckpt a function of (u, delta, A, Bp, reverse) that launches its
    scan_ckpt by that checkout's own C signature."""
    from deepchopper_tpu_torch.ops import _build, scan

    source = source_of(checkout, kind)
    out = _build.BUILD_DIR / f"ab-{label}-{kind}.so"
    nvcc(checkout / "deepchopper_tpu_torch" / "csrc" / source, out)
    lib = ctypes.PyDLL(str(out))
    if kind != "ckpt":
        return (scan.bind_fwd if kind == "fwd" else scan.bind_bwd)(lib)
    own = scan.scan_ckpt_cuda
    if source == "scan_fwd.cu":
        scan.bind_ckpt(lib)

        def planned(u, delta, A, Bp, reverse=False):
            with behind_wrappers("fwd", lib):
                return own(u, delta, A, Bp, reverse)

        return planned
    lib.scan_ckpt.argtypes = FIRST_CKPT_ARGTYPES
    lib.scan_ckpt.restype = ctypes.c_int

    def first(u, delta, A, Bp, reverse=False):
        import torch

        scan._check_kernel_args(u, delta, A, Bp)
        batch, seq_len, d_in = u.shape
        a = A.contiguous()
        ckpt = torch.empty((batch, scan._nl(seq_len), a.shape[1], d_in), dtype=torch.float32, device=u.device)
        _build.launch(
            lib.scan_ckpt, u,
            u.data_ptr(), delta.data_ptr(), a.data_ptr(), Bp.data_ptr(), ckpt.data_ptr(),
            batch, seq_len, d_in, a.shape[1], Bp.stride(0), Bp.stride(1), int(reverse),
            what=f"{label} scan_ckpt at (B={batch}, L={seq_len}, Din={d_in})",
        )  # fmt: skip
        return ckpt

    return first


@contextlib.contextmanager
def behind_wrappers(kind: str, lib):
    """This checkout's `scan_{kind}_cuda` launching `lib`'s kernel (None: its
    own): the other checkout runs through the same checks, allocation and
    launch path. For ckpt, `lib` (a function) takes the place of
    `scan_ckpt_cuda` itself, which the backward calls by name."""
    from deepchopper_tpu_torch.ops import scan

    name = "scan_ckpt_cuda" if kind == "ckpt" else f"_{kind}_lib"
    own = getattr(scan, name)
    if lib is not None:
        setattr(scan, name, lib if kind == "ckpt" else lambda: lib)
    try:
        yield
    finally:
        setattr(scan, name, own)


def rel_err(got, ref) -> float:
    return ((got - ref).abs().max() / ref.abs().max()).item()


def sweep_plans(seq_len: int) -> list:
    from deepchopper_tpu_torch.ops import scan

    plans = []
    for channels, tile, segments in itertools.product((64, 128), (8, 16, 32), (1, 2, 4, 8, 16, 32, 64)):
        if segments <= max(1, int(seq_len**0.5)):
            plans.append(scan._segment_plan(seq_len, channels, tile, segments, 0))
    return sorted(set(plans))


def check_out(new, plain, where: str):
    """This checkout's forward or checkpoint kernel checked: two calls
    bitwise equal and within 1e-5 of max|ref| of the plain version; (the
    reference, its error)."""
    import torch

    out, again = new(), new()
    if not torch.equal(out, again):
        raise SystemExit(f"{where}: two calls differ")
    ref = plain()
    err = rel_err(out, ref)
    if err > 1e-5:
        raise SystemExit(f"{where}: err {err:.2e} > 1e-5 of max|ref|")
    return ref, f"err {err:.2e}"


def check_bwd(grads, ref, where: str, again=None) -> str:
    """Each gradient against the plain version, within its limit; `again`, a
    second call's, bitwise equal."""
    import chip_smoke as cs
    import torch

    parts = []
    for i, ((name, tol), g, r) in enumerate(zip(cs.SCAN_GRADS, grads, ref)):
        if again is not None and not torch.equal(g, again[i]):
            raise SystemExit(f"{where} {name}: two calls differ")
        err = rel_err(g, r)
        if err > tol:
            raise SystemExit(f"{where} {name}: err {err:.2e} > {tol} of max|ref|")
        parts.append(f"{name} {err:.1e}")
    return " ".join(parts)


def train_step_turns(kind: str, libs, reps: int = 3) -> None:
    """The Caduceus train step with each parent's scan_ckpt or scan_bwd in
    turns with this checkout's (parent, this, this, parent), ms a step."""
    import time

    import chip_smoke as cs
    import torch

    from deepchopper_tpu_torch.models.registry import DeepChopper
    from deepchopper_tpu_torch.train.step import make_optimizer, train_step

    model = DeepChopper.new(cs.CADUCEUS, seed=0, device="cuda").train()
    opt = make_optimizer(model.parameters(), 2e-4)

    def run(lib, batch) -> float:
        with behind_wrappers(kind, lib):
            train_step(model, opt, batch)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                out = train_step(model, opt, batch)
            float(out["loss"])
            torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    for shape in ((64, 1024), (2, 32768)):
        batch = cs.training_batch(*shape, seed=9)
        run(None, batch)  # first-use costs of this shape
        for label, lib in libs:
            p1, n1, n2, p2 = run(lib, batch), run(None, batch), run(None, batch), run(lib, batch)
            say(f"train step {cs.CADUCEUS} {shape} bf16: this {(n1 + n2) / 2:.2f} ms ({n1:.2f}, {n2:.2f}), "
                f"{label} {(p1 + p2) / 2:.2f} ms ({p1:.2f}, {p2:.2f})")  # fmt: skip
        if not libs:
            say(f"train step {cs.CADUCEUS} {shape} bf16: this {run(None, batch):.2f} ms")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernel", choices=("fwd", "ckpt", "bwd"), default="fwd",
                        help="scan_fwd.cu's scan_fwd or scan_ckpt, or scan_bwd.cu's scan_bwd")  # fmt: skip
    parser.add_argument("--parent", type=Path, action="append", default=[],
                        help="another checkout whose kernel to time beside this one (repeatable)")  # fmt: skip
    parser.add_argument("--ptxas", action="store_true", help="print nvcc's -Xptxas -v report first")
    parser.add_argument("--sweep", action="store_true", help="fwd: also time other plans at each width")
    parser.add_argument("--train-step", action="store_true",
                        help="ckpt, bwd: also time the Caduceus train step in turns")  # fmt: skip
    parser.add_argument("--out", type=Path, help="write the whole log here")
    opts = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_scan_ab: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from deepchopper_tpu_torch.data.bucketing import default_buckets
    from deepchopper_tpu_torch.ops import scan

    kind = opts.kernel
    source = SOURCES[kind]
    say(f"gpu: {cs.gpu_line()}")
    labels = [p.resolve().name for p in opts.parent]
    if opts.ptxas:
        ptxas_report(REPO, source, "this")
        for label, checkout in zip(labels, opts.parent):
            ptxas_report(checkout, source_of(checkout, kind), label)
    libs = [(label, parent_lib(checkout, kind, label)) for label, checkout in zip(labels, opts.parent)]
    exps_per_s = cs.sfu_rate()
    totals = {(label, rev): [0.0, 0.0] for label, _lib in libs for rev in (False, True)}  # [new, parent]
    bound_total = 0.0
    for seq_len in default_buckets(32768):
        batch = cs.TOKENS_PER_BATCH // seq_len
        u, delta, A, Bp, Cp, D, dy = cs.scan_inputs(batch, seq_len, seed=seq_len)
        plan = (scan.scan_ckpt_plan if kind == "ckpt" else scan.scan_fwd_plan)(batch, seq_len, cs.SCAN_D_IN, cs.SCAN_N)
        bytes_ms, ops_ms, _ = cs.scan_bound(f"scan_{kind}", batch, seq_len, exps_per_s)
        bound = max(bytes_ms, ops_ms)
        bound_total += bound
        y_fwd = None
        for reverse in (False, True):
            where = f"W={seq_len:6d} B={batch:3d} {'rev' if reverse else 'fwd'}"
            if kind in ("fwd", "ckpt"):
                if kind == "fwd":
                    new = lambda: scan.scan_fwd_cuda(u, delta, A, Bp, Cp, D, reverse)  # noqa: E731
                    plain = lambda: scan.selective_scan_reference(u, delta, A, Bp, Cp, D, reverse)  # noqa: E731
                else:
                    new = lambda: scan.scan_ckpt_cuda(u, delta, A, Bp, reverse)  # noqa: E731
                    plain = lambda: scan.scan_ckpt_reference(u, delta, A, Bp, reverse)  # noqa: E731
                ref, errs = check_out(new, plain, where)
                y_fwd = ref if kind == "fwd" and not reverse else y_fwd
                line = (f"{where} plan channels={plan.channels} tile={plan.tile} segments={plan.segments} "
                        f"seg_len={plan.seg_len}: {errs}")  # fmt: skip
            else:
                ckpt = scan.scan_ckpt_cuda(u, delta, A, Bp, reverse)
                new = lambda: scan.scan_bwd_cuda(u, delta, A, Bp, Cp, D, dy, ckpt, reverse)  # noqa: E731
                got, again = new(), new()
                ref = scan.scan_bwd_reference(u, delta, A, Bp, Cp, D, dy, reverse)
                line = f"{where}: this {check_bwd(got, ref, where, again)}"
                del got, again
            line += f" | bound {bound:.3f} ms"
            for label, lib in libs:
                with behind_wrappers(kind, lib):
                    got = new()
                    errs = f"err {rel_err(got, ref):.2e}" if kind != "bwd" else check_bwd(got, ref, f"{where} {label}")
                del got

                def timed(lib):
                    with behind_wrappers(kind, lib):
                        return cs.time_ms(new)

                p1, n1, n2, p2 = timed(lib), timed(None), timed(None), timed(lib)
                new_ms, old_ms = (n1 + n2) / 2, (p1 + p2) / 2
                line += (f" | {label}: {errs}; this {new_ms:.3f} ms ({n1:.3f}, {n2:.3f}), {label} {old_ms:.3f} ms "
                         f"({p1:.3f}, {p2:.3f}), this/bound {new_ms / bound:.2f}, {label}/this {old_ms / new_ms:.2f}")  # fmt: skip
                totals[(label, reverse)][0] += new_ms
                totals[(label, reverse)][1] += old_ms
            say(line)
            del ref
            if kind == "bwd":
                del ckpt
        if opts.sweep and kind == "fwd":
            timed = []
            for alt in sweep_plans(seq_len):
                y = torch.empty_like(u)
                run = lambda: scan._scan_fwd_launch(u, delta, A, Bp, Cp, D, y, False, alt)  # noqa: E731
                ms = cs.time_ms(run, reps=3, warmup=1)
                if rel_err(y, y_fwd) > 1e-5:
                    raise SystemExit(f"W={seq_len} plan {alt}: err {rel_err(y, y_fwd):.2e} against the wrapper's plan")
                timed.append((ms, alt))
            timed.sort(key=lambda r: r[0])
            say(f"  sweep W={seq_len}: " + "; ".join(f"{ms:.3f} c{p.channels} t{p.tile} s{p.segments}"
                                                      for ms, p in timed[:6]))  # fmt: skip
        del u, delta, A, Bp, Cp, D, dy
    for (label, reverse), (new_ms, old_ms) in totals.items():
        say(f"scan_{kind} ladder total, {'reverse' if reverse else 'forward'} direction: this {new_ms:.3f} ms, {label} "
            f"{old_ms:.3f} ms, bound {bound_total:.3f} ms; this/bound {new_ms / bound_total:.2f}, {label}/this "
            f"{old_ms / new_ms:.2f}")  # fmt: skip
    if opts.train_step and kind != "fwd":
        train_step_turns(kind, libs)
    say(f"gpu: {cs.gpu_line()}")
    if opts.out:
        opts.out.parent.mkdir(parents=True, exist_ok=True)
        opts.out.write_text("\n".join(LOG) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
