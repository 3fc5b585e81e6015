"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration, traffic mix, entry point and metrics are
found by name from BENCHMARK.json (`harness/spec.py`). Set-up (kernels,
weights, reads, warm-up of the cell's own shapes) is timed from process
start as `setup_s`; the window then drives the entry point for `--seconds`;
after it the program is released and the plain reference judges what the
window produced. With `--trace 1` the window runs under torch.profiler and
the line carries the per-layer metrics instead of the end-to-end ones.

Exits 2 without a result when there is no CUDA device (or fewer than the
cell asks for), and 3 when a forbidden module (JAX, flax, the JAX package)
is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# Every build and kernel cache lives at a fixed path inside the checkout.
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):  # fmt: skip
    os.environ[var] = str(ROOT / "build" / sub)
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


class Run:
    """What the per-layer readers read: the cell, the path's counts and
    clocks of the window (`layer`) and the trace (None untraced)."""

    def __init__(self, cell, layer: dict, trace):
        self.cell, self.layer, self.trace = cell, layer, trace


def run_cell(cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> int:
    """Set up, run the window, judge it, print the line; returns the exit code."""
    import torch

    from benchmark.harness import result
    from benchmark.harness.spec import forbidden_loaded, metric_reader, path_module
    from benchmark.harness.trace import Trace, Tracer

    cuda = device.type == "cuda"
    tracer = Tracer(trace)
    path = path_module(cell.path)
    with tempfile.TemporaryDirectory(prefix="dcbench-") as tmp:
        state = path.setup(cell, seed, device, Path(tmp), tracer)
        setup_s = time.monotonic() - t_start
        win = path.window(state, seconds, tracer)
        if cuda:
            torch.cuda.synchronize()
        peak = max(torch.cuda.max_memory_allocated(), win.get("setup_peak", 0)) if cuda else 0
        run = Run(cell, path.layer_inputs(cell, state, win), Trace(tracer) if trace else None)
        tracer.prof = None
        path.release(state)
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        numbers = path.check(cell, state, win, device)
        attempted, failed = path.attempted_failed(cell, state, win, numbers)
        if trace:
            found = {m["name"]: (metric_reader(m["name"])(run), m["unit"]) for m in cell.per_layer}
        else:
            values = {**path.end_to_end(cell, state, win), "setup_s": setup_s}
            found = {m["name"]: (values.get(m["name"]), m["unit"]) for m in cell.end_to_end}
    metrics = {k: {"value": v, "unit": u} for k, (v, u) in found.items() if v is not None}
    # The cell's limits name the numbers it compares; the others are readings.
    for k in sorted(set(numbers) - set(cell.limits)):
        print(f"reading {k} {numbers[k]!r} (not compared in {cell.name})", file=sys.stderr)
    compared = {k: (float(numbers[k]), float(lim)) for k, lim in cell.limits.items()}
    device_line = result.device_info(cell.chips) if cuda else {"platform": device.type, "kind": "cpu", "count": 1}
    device_line["memory_peak_bytes"] = peak
    breakdown = None
    if trace:
        device_line["busy_s"] = run.trace.busy_s
        device_line["window_s"] = run.trace.window_s
        breakdown = {"device_ops": run.trace.top_ops(), "idle_gaps": run.trace.idle_gaps()}
    bad = forbidden_loaded(sys.modules)
    if bad:
        print(f"forbidden modules loaded in the run's process: {', '.join(bad)}", file=sys.stderr)
        return 3
    result.emit(correct=result.within_limits(compared), attempted=attempted, failed=failed, metrics=metrics,
                device=device_line, compared=compared, breakdown=breakdown)  # fmt: skip
    return 0


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True, help="a workload name of BENCHMARK.json")
    p.add_argument("--seed", type=int, required=True, help="seed of the weights and the traffic")
    p.add_argument("--seconds", type=float, required=True, help="length of the measured window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0, help="1: trace the window, report per-layer metrics")
    args = p.parse_args(argv)

    from benchmark.harness.spec import load_cell

    cell = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)  # fmt: skip
        return 2
    return run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), T_START)


if __name__ == "__main__":
    sys.exit(main())
