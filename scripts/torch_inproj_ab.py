#!/usr/bin/env python3
"""The in_proj-fused mixer kernel of this checkout beside other checkouts', on
one GPU, at every ladder width.

    python3 scripts/torch_inproj_ab.py [--parent CHECKOUT]... [--ptxas] [--train-step] [--out FILE]

At each of the 17 bucket widths (D = 256, B = 2^17 // W, bfloat16, the inputs
of chip_smoke.py's route phase at the flagship shapes):
- this checkout's `mixer_inproj_fwd_cuda` against `inproj_reference` (within
  1e-2 of max|ref|, chip_smoke.py's bf16 limit) and against itself (two calls
  bitwise equal);
- each `--parent` checkout's `csrc/mixer_inproj_fwd.cu` (`--parent` may be
  given more than once), built here with the same nvcc flags and launched
  through this checkout's wrapper (its scratch-size entry bound as that
  checkout declares it), held to the same reference; then it and this
  checkout's kernel timed in turns, parent, this, this, parent (CUDA events,
  5 calls of the whole wrapper after 2 of warm-up each), beside the composed
  route on the same inputs (torch.matmul in_proj, then mixer_fwd.cu) and the
  bound of chip_smoke.py's `route_bound`.
Ladder totals close the run. `--ptxas` first prints nvcc's `-Xptxas -v` report
(registers, spills, shared memory) of the kernel's source in this checkout
and in each parent. `--train-step` then times chip_smoke.py's bf16 Hyena
train step at (128, 1024) on the in_proj route (DEEPCHOPPER_FUSE_INPROJ=1)
with each parent's kernel in turns with this checkout's, in one process on
one model: only the library behind `InprojFn`'s forward changes (one warm-up
step, then the mean of 3). Prints the card's name and power limit; `--out`
keeps the whole log. Exits non-zero without a GPU or if a check fails.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import re
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "scripts"))

from torch_scan_ab import LOG, nvcc, ptxas_report, rel_err, say  # noqa: E402

SOURCE = "mixer_inproj_fwd.cu"
D_MODEL = 256


class CheckoutLib:
    """Another checkout's library seen through this checkout's wrapper: its
    launch entry as it is (the same arguments), its scratch size asked with
    the arguments that checkout's source declares."""

    def __init__(self, lib: ctypes.CDLL, scratch_args: int):
        ptr = ctypes.c_void_p
        lib.mixer_inproj_fwd.argtypes = [ptr] * 9 + [ctypes.c_int] * 5 + [ptr]
        lib.mixer_inproj_fwd.restype = ctypes.c_int
        lib.mixer_inproj_fwd_scratch_bytes.argtypes = [ctypes.c_int] * scratch_args
        lib.mixer_inproj_fwd_scratch_bytes.restype = ctypes.c_longlong
        self.mixer_inproj_fwd = lib.mixer_inproj_fwd
        self._scratch = lib.mixer_inproj_fwd_scratch_bytes
        self._takes_len = scratch_args == 4

    def mixer_inproj_fwd_scratch_bytes(self, batch: int, d_model: int, seq_len: int, log2n: int) -> int:
        if self._takes_len:
            return self._scratch(batch, d_model, seq_len, log2n)
        return self._scratch(batch, d_model, log2n)


def checkout_lib(checkout: Path, label: str) -> CheckoutLib:
    from deepchopper_tpu_torch.ops import _build

    src = checkout / "deepchopper_tpu_torch" / "csrc" / SOURCE
    decl = re.search(r"mixer_inproj_fwd_scratch_bytes\(([^)]*)\)", src.read_text())
    if decl is None:
        raise SystemExit(f"{src}: no mixer_inproj_fwd_scratch_bytes")
    out = _build.BUILD_DIR / f"ab-{label}-inproj.so"
    nvcc(src, out)
    return CheckoutLib(ctypes.PyDLL(str(out)), len(decl.group(1).split(",")))


@contextlib.contextmanager
def behind_wrapper(lib):
    """This checkout's `mixer_inproj_fwd_cuda` launching `lib`'s kernel (None:
    its own): the other checkout runs through the same checks, allocation
    and launch path."""
    from deepchopper_tpu_torch.ops import inproj

    own = inproj._lib
    if lib is not None:
        inproj._lib = lambda: lib
    try:
        yield
    finally:
        inproj._lib = own


def train_step_turns(libs, reps: int = 3) -> None:
    """The Hyena train step on the in_proj route with each parent's kernel in
    turns with this checkout's (parent, this, this, parent), ms a step."""
    import time

    import chip_smoke as cs
    import torch

    from deepchopper_tpu_torch.models.registry import DeepChopper
    from deepchopper_tpu_torch.ops import inproj
    from deepchopper_tpu_torch.train.step import make_optimizer, train_step

    with cs.route_env(cs.INPROJ):
        model = DeepChopper.new(cs.HYENA, seed=0, device="cuda").train()
        opt = make_optimizer(model.parameters(), 2e-4)

        def run(lib, batch) -> float:
            with behind_wrapper(lib):
                train_step(model, opt, batch)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(reps):
                    out = train_step(model, opt, batch)
                float(out["loss"])
                torch.cuda.synchronize()
            return (time.perf_counter() - t0) / reps * 1e3

        shape = (128, 1024)
        batch = cs.training_batch(*shape, seed=9)
        inproj.reset_launch_counts()
        run(None, batch)  # first-use costs of this shape
        if inproj.launch_counts["mixer_inproj_fwd"] != 4 * (reps + 1):
            raise SystemExit(f"train step: mixer_inproj_fwd launched {inproj.launch_counts} times, not 4 a step")
        for label, lib in libs:
            p1, n1, n2, p2 = run(lib, batch), run(None, batch), run(None, batch), run(lib, batch)
            say(f"train step {cs.HYENA} {shape} bf16, in_proj route: this {(n1 + n2) / 2:.2f} ms ({n1:.2f}, "
                f"{n2:.2f}), {label} {(p1 + p2) / 2:.2f} ms ({p1:.2f}, {p2:.2f})")  # fmt: skip
        if not libs:
            say(f"train step {cs.HYENA} {shape} bf16, in_proj route: this {run(None, batch):.2f} ms")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", type=Path, action="append", default=[],
                        help="another checkout whose kernel to time beside this one (repeatable)")  # fmt: skip
    parser.add_argument("--ptxas", action="store_true", help="print nvcc's -Xptxas -v report first")
    parser.add_argument("--train-step", action="store_true", help="also time the in_proj-route train step in turns")
    parser.add_argument("--out", type=Path, help="write the whole log here")
    opts = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_inproj_ab: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from deepchopper_tpu_torch.data.bucketing import default_buckets
    from deepchopper_tpu_torch.ops import inproj, mixer

    say(f"gpu: {cs.gpu_line()}")
    labels = [p.resolve().name for p in opts.parent]
    if opts.ptxas:
        ptxas_report(REPO, SOURCE, "this")
        for label, checkout in zip(labels, opts.parent):
            ptxas_report(checkout, SOURCE, label)
    libs = [(label, checkout_lib(checkout, label)) for label, checkout in zip(labels, opts.parent)]
    totals = {label: [0.0, 0.0] for label, _lib in libs}  # [this, parent]
    this_total = composed_total = bound_total = 0.0
    for seq_len in default_buckets(32768):
        batch = cs.TOKENS_PER_BATCH // seq_len
        args = cs.route_inputs("mixer_inproj_fwd", batch, D_MODEL, seq_len, torch.bfloat16, seed=seq_len + 1)
        x, w_in, b_in, *mix = args
        new = lambda: inproj.mixer_inproj_fwd_cuda(*args)  # noqa: E731
        got, again = new(), new()
        ref = inproj.inproj_reference(*args)
        where = f"W={seq_len:6d} B={batch:4d}"
        if not torch.equal(got, again):
            raise SystemExit(f"{where}: two calls differ")
        err = rel_err(got.float(), ref.float())
        if err > 1e-2:
            raise SystemExit(f"{where}: err {err:.2e} > 1e-2 of max|ref|")
        del got, again
        bytes_ms, ops_ms = cs.route_bound("mixer_inproj_fwd", batch, D_MODEL, seq_len, 2)
        bound = max(bytes_ms, ops_ms)
        composed = cs.time_ms(lambda: mixer.mixer_fwd_cuda(inproj.projection_composed(x, w_in, b_in), *mix))
        line = f"{where}: err {err:.2e} | bound {bound:.3f} ms | composed {composed:.3f} ms"
        if not libs:
            ms = cs.time_ms(new)
            this_total += ms
            line += f" | this {ms:.3f} ms, this/composed {ms / composed:.2f}, this/bound {ms / bound:.2f}"
        for label, lib in libs:
            with behind_wrapper(lib):
                old = new()
            perr = rel_err(old.float(), ref.float())
            del old
            if perr > 1e-2:
                raise SystemExit(f"{where} {label}: err {perr:.2e} > 1e-2 of max|ref|")

            def timed(lib):
                with behind_wrapper(lib):
                    return cs.time_ms(new)

            p1, n1, n2, p2 = timed(lib), timed(None), timed(None), timed(lib)
            new_ms, old_ms = (n1 + n2) / 2, (p1 + p2) / 2
            line += (f" | {label}: err {perr:.2e}; this {new_ms:.3f} ms ({n1:.3f}, {n2:.3f}), {label} {old_ms:.3f} ms "
                     f"({p1:.3f}, {p2:.3f}), {label}/this {old_ms / new_ms:.2f}, "
                     f"this/composed {new_ms / composed:.2f}, this/bound {new_ms / bound:.2f}")  # fmt: skip
            totals[label][0] += new_ms
            totals[label][1] += old_ms
        composed_total += composed
        bound_total += bound
        say(line)
        del args, x, w_in, b_in, mix, ref
    for label, (new_ms, old_ms) in totals.items():
        say(f"mixer_inproj_fwd ladder total: this {new_ms:.3f} ms, {label} {old_ms:.3f} ms, composed route "
            f"{composed_total:.3f} ms, bound {bound_total:.3f} ms; {label}/this {old_ms / new_ms:.2f}, this/composed "
            f"{new_ms / composed_total:.2f}, this/bound {new_ms / bound_total:.2f}")  # fmt: skip
    if not libs:
        say(f"mixer_inproj_fwd ladder total: this {this_total:.3f} ms, composed route {composed_total:.3f} ms, "
            f"bound {bound_total:.3f} ms")  # fmt: skip
    if opts.train_step:
        train_step_turns(libs)
    say(f"gpu: {cs.gpu_line()}")
    if opts.out:
        opts.out.parent.mkdir(parents=True, exist_ok=True)
        opts.out.write_text("\n".join(LOG) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
