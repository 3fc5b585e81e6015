"""Tiny cells for the harness's CPU tests: the registry's tiny HyenaDNA and
Caduceus under short reads, built as the benchmark builds its cells."""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.harness.spec import BENCH, Cell, load_cell, load_json  # noqa: E402

TINY = {"hyena": ("hyenadna-tiny-1k-seqlen", "hyenadna-small-32k-seqlen"),
        "caduceus": ("caduceus-tiny", "caduceus-ph_seqlen-131k_d_model-256_n_layer-16")}  # fmt: skip


def tiny_config(family: str) -> dict:
    """A tiny registry model's numbers, with the full configuration's init rules."""
    from deepchopper_tpu_torch.models.registry import build_model

    name, full = TINY[family]
    model = build_model(name)
    cfg = load_json(BENCH / "configs" / f"{full}.json")
    return {**cfg, "registry_name": name, "backbone": dataclasses.asdict(model.backbone_config),
            "head": dataclasses.asdict(model.head_config)}  # fmt: skip


def tiny_traffic(mix: str) -> dict:
    t = load_json(BENCH / "traffic" / f"{mix}.json")
    t["lengths"] = {**t["lengths"], "body": {"median": 300, "sigma": 0.4},
                    "tail": {"share": 0.1, "median": 700, "sigma": 0.3}, "min": 120, "max": 1000}  # fmt: skip
    t.update(max_length=1024, tokens_per_batch=4096, max_batch=64)
    if t["path"] == "fused_predict":
        t.update(reads_per_pass=120, warm_reads=20, calibration_reads=40, check_bases=3000)
    else:
        t.update(reads=600, shuffle_buffer=64)
    return t


def tiny_cell(family: str, kind: str) -> Cell:
    """The tiny counterpart of the benchmark's `hyena-<kind>-drna` cell, on
    the family's tiny model (no Caduceus cell is in BENCHMARK.json: its
    limits are the Hyena cell's)."""
    full = load_cell(f"hyena-{kind}-drna")
    mix = "drna" if kind == "fused" else "drna-labelled"
    return dataclasses.replace(full, config=tiny_config(family), traffic=tiny_traffic(mix))


@pytest.fixture
def cuda_device():
    """The card for tests marked `cuda`; they skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
