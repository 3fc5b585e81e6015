#!/usr/bin/env python3
"""The selective-scan forward kernel (`csrc/scan_fwd.cu`) of this checkout
beside another checkout's, on one GPU, at every ladder width.

    python3 scripts/torch_scan_ab.py [--parent CHECKOUT] [--ptxas] [--sweep] [--out FILE]

At each of the 17 bucket widths (Din 512, N 16, B = 2^17 // W, f32, the
inputs of chip_smoke.py's scan phase), in both directions:
- this checkout's `scan_fwd_cuda` against `selective_scan_reference` (within
  1e-5 of max|ref|) and against itself (two calls bitwise equal);
- with `--parent`, the other checkout's `csrc/scan_fwd.cu`, built here with
  the same nvcc flags and called through its own C entry (the signature
  before the plan arguments), held to the same reference; then both timed in
  turns, parent, this, this, parent (CUDA events, 5 launches after 2 of
  warm-up each), beside the bound of chip_smoke.py's `scan_bound`.
`--ptxas` first prints nvcc's `-Xptxas -v` report (registers, spills, shared
memory) for this checkout's kernels. `--sweep` also times other plans at
each width (forward direction): channels a block, tile length and segment
count. Prints the card's name and power limit; `--out` keeps the whole log.
Exits non-zero without a GPU or if a check fails.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

LOG: list[str] = []


def say(line: str) -> None:
    print(line, flush=True)
    LOG.append(line)


def ptxas_report() -> None:
    from deepchopper_tpu_torch.ops import _build

    out = _build.BUILD_DIR / "ptxas-scan_fwd.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(out), str(_build.CSRC / "scan_fwd.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    say(f"nvcc -Xptxas -v scan_fwd.cu (exit {res.returncode}):")
    for line in (res.stdout + res.stderr).splitlines():
        if "scan_fwd_kernel" in line or "registers" in line or "spill" in line or "error" in line:
            say("  " + line.strip())
    if res.returncode != 0:
        raise SystemExit("nvcc failed on scan_fwd.cu")


def parent_lib(checkout: Path) -> ctypes.CDLL:
    """The other checkout's scan_fwd.cu, built with this checkout's flags."""
    from deepchopper_tpu_torch.ops import _build

    src = checkout / "deepchopper_tpu_torch" / "csrc" / "scan_fwd.cu"
    out = _build.BUILD_DIR / "parent-scan_fwd.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(src)], capture_output=True,
                         text=True, timeout=600)  # fmt: skip
    if res.returncode != 0:
        raise SystemExit(f"nvcc failed on {src}:\n{res.stdout}{res.stderr}")
    lib = ctypes.CDLL(str(out))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.scan_fwd.argtypes = [ptr] * 7 + [i32] * 4 + [i64] * 4 + [i32, ptr]
    lib.scan_fwd.restype = i32
    return lib


def parent_call(lib, u, delta, A, Bp, Cp, D, reverse):
    import torch

    y = torch.empty_like(u)
    batch, seq_len, d_in = u.shape
    err = lib.scan_fwd(u.data_ptr(), delta.data_ptr(), A.data_ptr(), Bp.data_ptr(), Cp.data_ptr(), D.data_ptr(),
                       y.data_ptr(), batch, seq_len, d_in, A.shape[1], Bp.stride(0), Bp.stride(1), Cp.stride(0),
                       Cp.stride(1), int(reverse), torch.cuda.current_stream().cuda_stream)  # fmt: skip
    if err != 0:
        raise SystemExit(f"parent scan_fwd failed: cudaError {err}")
    return y


def rel_err(got, ref) -> float:
    return ((got - ref).abs().max() / ref.abs().max()).item()


def sweep_plans(seq_len: int) -> list:
    from deepchopper_tpu_torch.ops import scan

    plans = []
    for channels, tile, segments in itertools.product((64, 128), (8, 16, 32), (1, 2, 4, 8, 16, 32, 64)):
        if segments <= max(1, int(seq_len**0.5)):
            plans.append(scan._segment_plan(seq_len, channels, tile, segments, 0))
    return sorted(set(plans))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", type=Path, help="another checkout whose scan_fwd.cu to time beside this one")
    parser.add_argument("--ptxas", action="store_true", help="print nvcc's -Xptxas -v report first")
    parser.add_argument("--sweep", action="store_true", help="also time other plans at each width")
    parser.add_argument("--out", type=Path, help="write the whole log here")
    opts = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_scan_ab: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from deepchopper_tpu_torch.data.bucketing import default_buckets
    from deepchopper_tpu_torch.ops import scan

    say(f"gpu: {cs.gpu_line()}")
    if opts.ptxas:
        ptxas_report()
    lib = parent_lib(opts.parent) if opts.parent else None
    exps_per_s = cs.sfu_rate()
    totals = {"new": 0.0, "parent": 0.0, "bound": 0.0}
    for seq_len in default_buckets(32768):
        batch = cs.TOKENS_PER_BATCH // seq_len
        u, delta, A, Bp, Cp, D, _dy = cs.scan_inputs(batch, seq_len, seed=seq_len)
        plan = scan.scan_fwd_plan(batch, seq_len, cs.SCAN_D_IN, cs.SCAN_N)
        bytes_ms, ops_ms, _ = cs.scan_bound("scan_fwd", batch, seq_len, exps_per_s)
        bound = max(bytes_ms, ops_ms)
        y_fwd = None
        for reverse in (False, True):
            new = lambda: scan.scan_fwd_cuda(u, delta, A, Bp, Cp, D, reverse)  # noqa: E731
            y, again = new(), new()
            ref = scan.selective_scan_reference(u, delta, A, Bp, Cp, D, reverse)
            if not torch.equal(y, again):
                raise SystemExit(f"W={seq_len} reverse={reverse}: two calls differ")
            err = rel_err(y, ref)
            line = (f"W={seq_len:6d} B={batch:3d} {'rev' if reverse else 'fwd'} plan channels={plan.channels} "
                    f"tile={plan.tile} segments={plan.segments} seg_len={plan.seg_len}: err {err:.2e}")  # fmt: skip
            if err > 1e-5:
                raise SystemExit(line + " > 1e-5 of max|ref|")
            y_fwd = y if not reverse else y_fwd
            if lib is not None:
                old = lambda: parent_call(lib, u, delta, A, Bp, Cp, D, reverse)  # noqa: E731
                old_err = rel_err(old(), ref)
                p1, n1, n2, p2 = cs.time_ms(old), cs.time_ms(new), cs.time_ms(new), cs.time_ms(old)
                new_ms, old_ms = (n1 + n2) / 2, (p1 + p2) / 2
                line += (f" (parent {old_err:.2e}) | new {new_ms:.3f} ms ({n1:.3f}, {n2:.3f}), parent {old_ms:.3f} ms "
                         f"({p1:.3f}, {p2:.3f}), bound {bound:.3f} ms, new/bound {new_ms / bound:.2f}, "
                         f"parent/new {old_ms / new_ms:.2f}")  # fmt: skip
                if not reverse:
                    totals["new"] += new_ms
                    totals["parent"] += old_ms
                    totals["bound"] += bound
            say(line)
            del ref
        if opts.sweep:
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
        del u, delta, A, Bp, Cp, D, _dy
    if lib is not None:
        say(f"forward ladder total: new {totals['new']:.3f} ms, parent {totals['parent']:.3f} ms, bound "
            f"{totals['bound']:.3f} ms; new/bound {totals['new'] / totals['bound']:.2f}, parent/new "
            f"{totals['parent'] / totals['new']:.2f}")  # fmt: skip
    say(f"gpu: {cs.gpu_line()}")
    if opts.out:
        opts.out.parent.mkdir(parents=True, exist_ok=True)
        opts.out.write_text("\n".join(LOG) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
