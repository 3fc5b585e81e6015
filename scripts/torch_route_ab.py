#!/usr/bin/env python3
"""The gated conv, the causal conv and the fused mixer kernels of this checkout
beside other checkouts', on one GPU, at every ladder width.

    python3 scripts/torch_route_ab.py [--parent CHECKOUT]... [--ptxas] [--kernel NAME]... [--sweep] [--out FILE]

At each of the 17 bucket widths (D = 256, B = 2^17 // W, the inputs of
chip_smoke.py's route and mixer phases at the flagship shapes):
- `gated_fwd` (bfloat16): this checkout's `gated_fwd_cuda` against
  `gated_reference` (within 1e-2 of max|ref|, chip_smoke.py's bf16 limit);
- `conv_fwd` (float32): `conv_fwd_cuda` against `conv_reference` (1e-4);
- `mixer_fwd` (bfloat16): `mixer_fwd_cuda` against `mixer_reference` (1e-2),
  to show that the fused mixer did not move;
each also against itself (two calls bitwise equal). Each `--parent`
checkout's kernel (`--parent` may be given more than once) is built here
with the same nvcc flags from that checkout's sources and held to the same
reference: its `csrc/gated_fwd.cu` or `csrc/conv_fwd.cu` where it has the
first design's (bound by that design's C signature, its global scratch
allocated as that source declares), else the entry of its `mixer_fwd.cu` or
`conv_fwd.cu` launched through this checkout's wrapper. Then it and this
checkout's kernel are timed in turns, parent, this, this, parent (CUDA
events, 5 calls of the whole wrapper after 2 of warm-up each), beside the
layout this checkout runs (chip_smoke.py's `route_layout`) and the bound of
chip_smoke.py's `route_bound` / `mixer_bound`. Ladder totals close the run.
`--kernel` picks some of the three (default all). `--sweep` also times
`conv_fwd` at each width on every rows plan the kernel takes (each G of
1, 2, 4, 8 channels a block whose shared memory and 2G H / V threads fit),
each held to the plain version. `--ptxas` first prints
nvcc's `-Xptxas -v` report (registers, spills, shared memory) of
`mixer_fwd.cu`, `conv_fwd.cu` and `mixer_inproj_fwd.cu` in this checkout and
of the kernels' sources in each parent. Prints the card's name and power
limit; `--out` keeps the whole log. Exits non-zero without a GPU or if a check
fails.
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

from torch_scan_ab import LOG, nvcc, ptxas_report, rel_err, say  # noqa: E402

D_MODEL = 256
KERNELS = ("gated_fwd", "conv_fwd", "mixer_fwd")
# kernel: (dtype name, limit of max|ref|)
CHECKS = {"gated_fwd": ("bfloat16", 1e-2), "conv_fwd": ("float32", 1e-4), "mixer_fwd": ("bfloat16", 1e-2)}
PTR = ctypes.c_void_p
INT = ctypes.c_int


def csrc(checkout: Path) -> Path:
    return checkout / "deepchopper_tpu_torch" / "csrc"


@contextlib.contextmanager
def behind_wrapper(module, lib):
    """`module`'s wrapper launching `lib` (None: its own library)."""
    own = module._lib
    if lib is not None:
        module._lib = lambda: lib
    try:
        yield
    finally:
        module._lib = own


def first_design(lib: ctypes.CDLL, kind: str):
    """A call of (args) -> output for the first design's gated_fwd.cu or
    conv_fwd.cu, by its own C signature: (in, khat, tw, scratch, out, B, D,
    L, log2n[, dtype], stream), scratch sized by its `*_scratch_bytes`."""
    import torch

    from deepchopper_tpu_torch.ops import _build, gated, mixer

    entry = getattr(lib, kind)
    entry.argtypes = [PTR] * 5 + [INT] * (5 if kind == "gated_fwd" else 4) + [PTR]
    entry.restype = INT
    scratch_bytes = getattr(lib, f"{kind}_scratch_bytes")
    scratch_bytes.argtypes = [INT] * 3
    scratch_bytes.restype = ctypes.c_longlong

    def call(x, k_long, bias):
        n = mixer.fft_size(x.shape[2] if kind == "gated_fwd" else x.shape[1])
        log2n = n.bit_length() - 1
        khat = mixer.filter_spectrum(k_long, bias, n)
        tw = mixer._twiddles(n, x.device)
        if kind == "gated_fwd":
            batch, _width, seq_len = x.shape
            d_model = k_long.shape[1]
            out = torch.empty((batch, d_model, seq_len), dtype=x.dtype, device=x.device)
            tail = (batch, d_model, seq_len, log2n, gated._DTYPE_CODES[x.dtype])
        else:
            batch, seq_len, d_model = x.shape
            out = torch.empty_like(x)
            tail = (batch, d_model, seq_len, log2n)
        scratch = torch.empty(max(scratch_bytes(batch, d_model, log2n), 8), dtype=torch.uint8, device=x.device)
        _build.launch(entry, x, x.data_ptr(), khat.data_ptr(), tw.data_ptr(), scratch.data_ptr(), out.data_ptr(),
                      *tail, what=f"first-design {kind}")  # fmt: skip
        return out

    return call


def checkout_call(checkout: Path, kind: str, label: str):
    """(args) -> output running `checkout`'s `kind` kernel, and its source."""
    from deepchopper_tpu_torch.ops import _build, conv, gated, mixer

    src = csrc(checkout)
    if kind == "gated_fwd" and (src / "gated_fwd.cu").exists():
        source = "gated_fwd.cu"
    elif kind == "conv_fwd":
        source = "conv_fwd.cu"
    else:
        source = "mixer_fwd.cu"
    out = _build.BUILD_DIR / f"ab-{label}-{Path(source).stem}.so"
    if not out.exists():
        nvcc(src / source, out)
    lib = ctypes.PyDLL(str(out))
    text = (src / source).read_text()
    if f"{kind}_scratch_bytes" in text:
        return first_design(lib, kind), source
    module, wrapper = {"gated_fwd": (gated, gated.gated_fwd_cuda), "conv_fwd": (conv, conv.conv_fwd_cuda),
                       "mixer_fwd": (mixer, mixer.mixer_fwd_cuda)}[kind]  # fmt: skip
    entry = getattr(lib, kind)
    entry.argtypes = getattr(module._lib(), kind).argtypes
    entry.restype = INT

    def call(*args):
        with behind_wrapper(module, lib):
            return wrapper(*args)

    return call, source


def inputs(kind: str, seq_len: int):
    import chip_smoke as cs
    import torch

    batch = cs.TOKENS_PER_BATCH // seq_len
    dtype = getattr(torch, CHECKS[kind][0])
    if kind == "mixer_fwd":
        return cs.mixer_inputs(batch, D_MODEL, seq_len, dtype, seed=seq_len + 1)
    return cs.route_inputs(kind, batch, D_MODEL, seq_len, dtype, seed=seq_len + 1)


def own_calls(kind: str):
    from deepchopper_tpu_torch.ops import conv, gated, mixer

    return {
        "gated_fwd": (gated.gated_fwd_cuda, gated.gated_reference),
        "conv_fwd": (conv.conv_fwd_cuda, conv.conv_reference),
        "mixer_fwd": (mixer.mixer_fwd_cuda, mixer.mixer_reference),
    }[kind]


def bound_ms(kind: str, batch: int, seq_len: int) -> float:
    import chip_smoke as cs

    itemsize = 4 if CHECKS[kind][0] == "float32" else 2
    if kind == "mixer_fwd":
        nbytes, flops = cs.mixer_bound(batch, D_MODEL, seq_len, itemsize)
        return max(nbytes / cs.HBM_BYTES_PER_S, flops / cs.F32_FLOPS_PER_S) * 1e3
    return max(cs.route_bound(kind, batch, D_MODEL, seq_len, itemsize))


def conv_plans(batch: int, seq_len: int) -> list[dict]:
    """The rows plans `csrc/conv_fwd.cu` takes at this width: every G whose
    shared memory and threads (2G H / V, at most 512) fit."""
    from deepchopper_tpu_torch.ops import conv, mixer

    base = conv.conv_fwd_plan(batch, D_MODEL, seq_len)
    if base["layout"] == "pair":
        return [base]
    h = mixer.fft_size(seq_len) // 4
    plans = []
    for g in (1, 2, 4, 8):
        smem = (g * 2 * conv.padded(h) + conv.quarter(h)) * 8
        threads = 2 * g * (h // base["V"])
        if smem <= conv.SMEM_LIMIT and threads <= 512:
            plans.append({**base, "G": g, "CW": min(g, 4), "threads": threads, "smem": smem})
    return plans


def sweep_conv(seq_len: int) -> None:
    """conv_fwd at every plan of `conv_plans`, each held to the plain version."""
    import chip_smoke as cs

    from deepchopper_tpu_torch.ops import conv

    args = inputs("conv_fwd", seq_len)
    ref = conv.conv_reference(*args)
    parts = []
    for plan in conv_plans(args[0].shape[0], seq_len):
        err = rel_err(conv._conv_fwd_launch(*args, plan), ref)
        if err > CHECKS["conv_fwd"][1]:
            raise SystemExit(f"sweep conv_fwd W={seq_len} {plan}: err {err:.2e}")
        ms = cs.time_ms(lambda plan=plan: conv._conv_fwd_launch(*args, plan))
        parts.append((ms, f"G{plan['G']} t{plan['threads']}"))
    say(f"  sweep conv_fwd W={seq_len}: " + "; ".join(f"{ms:.3f} {name}" for ms, name in parts)
        + f" | best {min(parts)[1]}")  # fmt: skip


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", type=Path, action="append", default=[],
                        help="another checkout whose kernels to time beside this one's (repeatable)")  # fmt: skip
    parser.add_argument("--kernel", action="append", choices=KERNELS, help="time only these (repeatable)")
    parser.add_argument("--ptxas", action="store_true", help="print nvcc's -Xptxas -v report first")
    parser.add_argument("--sweep", action="store_true", help="also time conv_fwd on every rows plan it takes")
    parser.add_argument("--out", type=Path, help="write the whole log here")
    opts = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_route_ab: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from deepchopper_tpu_torch.data.bucketing import default_buckets

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"gpu: {cs.gpu_line()}")
    kinds = opts.kernel or list(KERNELS)
    labels = [p.resolve().name for p in opts.parent]
    if opts.ptxas:
        for source in ("mixer_fwd.cu", "conv_fwd.cu", "mixer_inproj_fwd.cu"):
            ptxas_report(REPO, source, "this")
        for label, checkout in zip(labels, opts.parent):
            for source in ("mixer_fwd.cu", "gated_fwd.cu", "conv_fwd.cu", "mixer_inproj_fwd.cu"):
                if (csrc(checkout) / source).exists():
                    ptxas_report(checkout, source, label)
    parents = {kind: [(label, *checkout_call(checkout, kind, label)) for label, checkout in zip(labels, opts.parent)]
               for kind in kinds}  # fmt: skip
    for kind in kinds:
        for label, _call, source in parents[kind]:
            say(f"{kind} of {label}: {source}")
    totals = {kind: {"this": 0.0, "bound": 0.0, **{label: 0.0 for label in labels}} for kind in kinds}
    for seq_len in default_buckets(32768):
        batch = cs.TOKENS_PER_BATCH // seq_len
        for kind in kinds:
            new, plain = own_calls(kind)
            dtype_name, tol = CHECKS[kind]
            args = inputs(kind, seq_len)
            got, again = new(*args), new(*args)
            where = f"{kind} W={seq_len:6d} B={batch:4d}"
            if not torch.equal(got, again):
                raise SystemExit(f"{where}: two calls differ")
            ref = plain(*args)
            err = rel_err(got.float(), ref.float())
            if err > tol:
                raise SystemExit(f"{where}: err {err:.2e} > {tol} of max|ref|")
            del got, again
            bound = bound_ms(kind, batch, seq_len)
            layout = "" if kind == "mixer_fwd" else f" [{cs.route_layout(kind, batch, D_MODEL, seq_len)}]"
            line = f"{where} {dtype_name}{layout}: err {err:.2e} | bound {bound:.3f} ms"
            totals[kind]["bound"] += bound
            if not parents[kind]:
                ms = cs.time_ms(lambda: new(*args))
                totals[kind]["this"] += ms
                line += f" | this {ms:.3f} ms, this/bound {ms / bound:.2f}"
            for label, call, _source in parents[kind]:
                old = call(*args)
                perr = rel_err(old.float(), ref.float())
                del old
                if perr > tol:
                    raise SystemExit(f"{where} {label}: err {perr:.2e} > {tol} of max|ref|")
                p1, n1, n2, p2 = (cs.time_ms(lambda f=f: f(*args)) for f in (call, new, new, call))
                new_ms, old_ms = (n1 + n2) / 2, (p1 + p2) / 2
                totals[kind]["this"] += new_ms / len(parents[kind])
                totals[kind][label] += old_ms
                line += (f" | {label}: err {perr:.2e}; this {new_ms:.3f} ms ({n1:.3f}, {n2:.3f}), {label} "
                         f"{old_ms:.3f} ms ({p1:.3f}, {p2:.3f}), {label}/this {old_ms / new_ms:.2f}, "
                         f"this/bound {new_ms / bound:.2f}")  # fmt: skip
            say(line)
            del args, ref
            if opts.sweep and kind == "conv_fwd":
                sweep_conv(seq_len)
    for kind, row in totals.items():
        line = f"{kind} ladder total: this {row['this']:.3f} ms, bound {row['bound']:.3f} ms"
        for label in labels:
            line += f", {label} {row[label]:.3f} ms ({label}/this {row[label] / row['this']:.2f})"
        say(line)
    say(f"gpu: {cs.gpu_line()}")
    if opts.out:
        opts.out.parent.mkdir(parents=True, exist_ok=True)
        opts.out.write_text("\n".join(LOG) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
