"""The head bias of a predict cell's random model: the chop cuts the mix's
share of the calibration reads, by the reference's own chop."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.harness.calibrate import read_thresholds, set_adapter_bias
from benchmark.harness.traffic import bucket_widths, make_reads
from benchmark.harness.weights import make_weights
from benchmark.reference import chop as ref_chop
from benchmark.reference import judge

from .conftest import tiny_cell


def test_a_read_is_cut_once_the_bias_lifts_its_threshold_above_zero():
    d = np.full(400, -5.0)
    d[100:130] = 1.0
    d[300:310] = 3.0  # too short a run to survive the vote
    (t,) = read_thresholds({0: d})
    assert t == 1.0
    for b, cut in ((-1.5, False), (-0.5, True)):
        labels = (d + b > 0).astype(int).tolist()
        assert bool(ref_chop.intervals(labels, ref_chop.ChopRules())) == cut


@pytest.mark.parametrize("share", [0.05, 0.3])
def test_the_calibrated_bias_cuts_the_mix_share(share):
    from deepchopper_tpu_torch.data.bucketing import default_buckets
    from deepchopper_tpu_torch.models.registry import build_model

    cell = tiny_cell("hyena", "fused")
    mix = {**cell.traffic, "adapter_read_share": share, "calibration_reads": 200}
    device = torch.device("cpu")
    shapes = {k: tuple(v.shape) for k, v in build_model(cell.config["registry_name"]).state_dict().items()}
    weights = make_weights(shapes, cell.config["init"], 2**31 + 5, device)
    buckets = default_buckets(mix["max_length"])
    b = set_adapter_bias(weights, cell.config, mix, 2**31 + 5, buckets, device)
    bias = weights["head.linear3.bias"]
    assert float(bias[1] - bias[0]) == pytest.approx(b)

    reads = make_reads(mix, mix["calibration_reads"], 2**31 + 5, stream=2, prefix="calibration_read")
    items = list(enumerate(bucket_widths(reads.lengths(), buckets, mix["max_length"])))
    logits = judge.read_logits(weights, cell.config, reads, items, mix["max_length"], device)
    cut = sum(bool(ref_chop.intervals(lg.argmax(1).tolist(), ref_chop.ChopRules())) for lg in logits.values())
    assert abs(cut / len(reads) - share) <= 0.02
