"""Readings of the trace that several per-layer metrics share."""


def torch_ops_share(run, kind: str):
    """Share of the device's kernel time in kernels that are not the port's
    own (PyTorch's elementwise, reductions, cuBLAS, cuFFT), by the names in
    benchmark/kernels.json."""
    if run.trace is None or run.layer["kind"] != kind:
        return None
    own, total = run.trace.own_kernel_s()
    return 100.0 * (total - own) / total if total else None


def device_idle(run, kind: str):
    """Share of the traced window in which nothing ran on the device."""
    if run.trace is None or run.layer["kind"] != kind or not run.trace.busy_s:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def mfu(run, kind: str):
    """The model's operations in the window (benchmark/counts/flops.py) over
    the window's time, as a share of the card's bf16 dense peak."""
    from benchmark.counts.peaks import BF16_FLOPS_PER_S

    if run.layer["kind"] != kind:
        return None
    return 100.0 * run.layer["model_flops"] / run.layer["window_s"] / BF16_FLOPS_PER_S


def roofline(run, kind: str, op: str, bound_s_of_shape):
    """Least time of the op's calls in the window (its dispatched shapes)
    over the device time of its kernels; None where none of them ran."""
    if run.trace is None or run.layer["kind"] != kind:
        return None
    measured = run.trace.time_of(op)
    if not measured:
        return None
    bound = sum(count * bound_s_of_shape(rows, width) for (rows, width), count in run.layer["shapes"].items())
    return 100.0 * bound / measured
