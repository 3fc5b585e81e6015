"""mixer_fwd's share of its roofline in predict: n_layer calls a dispatch
at each dispatched (rows, width), bf16."""

from benchmark.counts.roofline import mixer_fwd_s
from benchmark.metrics._shares import roofline


def read(run):
    bb = run.cell.config["backbone"]
    return roofline(run, "predict", "mixer_fwd", lambda b, w: bb["n_layer"] * mixer_fwd_s(b, bb["d_model"], w))
