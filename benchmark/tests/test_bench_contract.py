"""BENCHMARK.json against the benchmark's contract, and the result line's
schema from a tiny cell run on the CPU."""

from __future__ import annotations

import json
import math
import re

import pytest

from benchmark.harness.spec import BENCH, ROOT, load_cell, load_json

from .conftest import tiny_cell

SPEC = load_json(ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
WIDTH_WORDS = ("hidden", "intermediate", "latent", "state", "proj", "head", "expand")


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_paths():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(SPEC["paths"]) <= 16 and all(PATH.match(p) and ".." not in p for p in SPEC["paths"])
    assert len(SPEC["command"]) <= 32 and all(_line(w) and not w.startswith("/") for w in SPEC["command"])
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 << 10


def test_check_fits_its_time_with_24_cells():
    rs = SPEC["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs():
    assert 1 <= len(SPEC["configs"]) <= 24
    files = set()
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert _line(c["source"]) and _line(c["why"]) and c["source"].startswith("https://")
        assert c["file"].startswith("benchmark/") and c["file"] not in files
        files.add(c["file"])
        cfg = load_json(ROOT / c["file"])
        assert cfg["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert not any(w in k for k in c["reduced"] for w in WIDTH_WORDS) and not any(
            k.endswith(("_dim", "_rank")) for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in SPEC["workloads"])


def test_workloads_and_metrics():
    cells = SPEC["workloads"]
    assert 1 <= len(cells) <= 24 and len({c["name"] for c in cells}) == len(cells)
    assert len({(c["config"], c["traffic"]) for c in cells}) == len(cells)
    assert sum(c["chips"] == 4 for c in cells) <= max(1, len(cells) // 4)
    e2e, layer = SPEC["end_to_end"], SPEC["per_layer"]
    names = [m["name"] for m in e2e + layer]
    assert len(set(names)) == len(names) and all(NAME.match(n) for n in names)
    for m in e2e:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in e2e)
    for m in layer:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock") and _line(m["layer"])
        assert m["moves"] in {x["name"] for x in e2e}
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in e2e + layer:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for c in cells:
        assert set(c) == {"name", "config", "traffic", "chips", "why"} and c["chips"] in (1, 4) and _line(c["why"])
        assert (BENCH / "traffic" / f"{c['traffic']}.json").exists()
        cell = load_cell(c["name"])
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2 and cell.per_layer
        assert all(m["moves"] in reported for m in cell.per_layer)
        assert all((BENCH / "metrics" / f"{m['name']}.py").exists() for m in cell.per_layer)
        assert (BENCH / "paths" / f"{cell.path}.py").exists()


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line(trace, capsys):
    import torch

    from benchmark.run import run_cell

    cell = tiny_cell("hyena", "fused")
    assert run_cell(cell, 2**31 + 3, 0.5, bool(trace), torch.device("cpu"), 0.0) == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"] and list(line)[-1] == "compared"
    assert line["correct"] is True and line["attempted"] > 0 and line["failed"] == 0
    units = {m["name"]: m["unit"] for m in SPEC["end_to_end"] + SPEC["per_layer"]}
    expected = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    assert set(line["metrics"]) <= expected
    for name, m in line["metrics"].items():
        assert m["unit"] == units[name] and math.isfinite(m["value"])
    if not trace:
        assert set(line["metrics"]) == expected
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    assert ("busy_s" in line["device"]) == bool(trace)
    # The compared numbers close standard error, each beside its limit.
    tail = err.strip().splitlines()[-len(line["compared"]) :]
    assert [t.split()[1] for t in tail] == list(line["compared"]) and all(" limit " in t for t in tail)
