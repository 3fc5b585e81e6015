"""The yardstick's counts reproduce the port's kernel table (PERF.md,
section 6): the bound column of rows 1, 2, 3 and 5, ms summed over the 17
ladder widths at 2^17 tokens a call."""

from __future__ import annotations

import pytest

from benchmark.counts import flops, roofline
from benchmark.harness.spec import BENCH, load_json

LADDER = [256, 512, 768, 1024, 1280, 1536, 2048, 2560, 3072, 4096, 5120, 6144, 8192, 12288, 16384, 24576, 32768]


@pytest.mark.parametrize(
    ("row", "bound_ms", "call"),
    [
        (1, 1.403, lambda w: roofline.mixer_fwd_s(2**17 // w, 256, w)),
        (2, 2.925, lambda w: roofline.mixer_bwd_s(min(512, 2**17 // w), 256, w)),
        (3, 4.315, lambda w: roofline.scan_fwd_s(2**17 // w, w)),
        (5, 7.575, lambda w: roofline.scan_bwd_s(2**17 // w, w)),
    ],
)
def test_bound_column(row, bound_ms, call):
    assert round(sum(call(w) for w in LADDER) * 1e3, 3) == bound_ms, f"kernel table row {row}"


def test_model_operations_a_token():
    hyena = load_json(BENCH / "configs" / "hyenadna-small-32k-seqlen.json")
    caduceus = load_json(BENCH / "configs" / "caduceus-ph_seqlen-131k_d_model-256_n_layer-16.json")
    # Hyena: 4 x (in_proj 2*256*768 + out_proj 2*256^2 + MLP 2*2*256*1024) + head 2*(256k + 1M + 2k)
    # = 6.29 M + 2.63 M dense, plus the FFT conv; Caduceus: 16 layers x 2 directions of ~0.9 M + head.
    assert 9.0e6 < flops.forward_flops(hyena, 1615) / 1615 < 11.0e6
    assert 30e6 < flops.forward_flops(caduceus, 1615) / 1615 < 33e6
    assert flops.forward_flops(hyena, 2000) > 2 * flops.forward_flops(hyena, 1000) * 0.99
