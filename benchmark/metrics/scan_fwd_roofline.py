"""scan_fwd's share of its roofline in predict: 2 x n_layer calls (both
directions of every block) a dispatch at each dispatched (rows, width),
float32."""

from benchmark.counts.roofline import scan_fwd_s
from benchmark.metrics._shares import roofline


def read(run):
    bb = run.cell.config["backbone"]

    def bound(b, w):
        return 2 * bb["n_layer"] * scan_fwd_s(b, w, bb["d_model"] * bb["expand"], bb["d_state"])

    return roofline(run, "predict", "scan_fwd", bound)
