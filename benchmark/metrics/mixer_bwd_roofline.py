"""mixer_bwd's share of its roofline in training: n_layer calls a step at
each step's (rows, width), bf16."""

from benchmark.counts.roofline import mixer_bwd_s
from benchmark.metrics._shares import roofline


def read(run):
    bb = run.cell.config["backbone"]
    return roofline(run, "train", "mixer_bwd", lambda b, w: bb["n_layer"] * mixer_bwd_s(b, bb["d_model"], w))
