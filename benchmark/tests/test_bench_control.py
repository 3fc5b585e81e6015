"""The control on the card: the reference in the program's place, in the
precision below the configuration's (float8 for its bfloat16 products), and
the half-batch fault (in the whole step, and in the loss alone), each fails
its cell's limits on every seed. The cells' models at their published widths; fewer reads than a run samples, so that a test run
holds it. `benchmark/control.py` reads the same at each cell's own size."""

from __future__ import annotations

import dataclasses

import pytest

from benchmark.harness.spec import load_cell

pytestmark = pytest.mark.cuda


def _fails(numbers: dict, limits: dict) -> bool:
    return any(v > limits[k] for k, v in numbers.items() if k in limits and k != "notes")


SEEDS = (17, 18, 19)


def test_predict_control_fails(cuda_device):
    from benchmark.control import predict_readings

    cell = load_cell("hyena-fused-drna")
    cell = dataclasses.replace(cell, traffic={**cell.traffic, "check_bases": 20000})
    assert all(_fails(predict_readings(cell, 2**31 + s, cuda_device)["fp8"], cell.limits) for s in SEEDS)


def test_train_control_and_half_batch_fail(cuda_device):
    from benchmark.control import train_readings

    cell = load_cell("hyena-train-drna")
    cell = dataclasses.replace(cell, traffic={**cell.traffic, "reads": 2000})
    for s in SEEDS:
        got = train_readings(cell, 2**31 + s, cuda_device)
        assert all(_fails(got[k], cell.limits) for k in ("fp8", "half_batch", "half_batch_loss")), (s, got)
