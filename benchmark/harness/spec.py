"""A cell's files, found by the names in BENCHMARK.json.

- `benchmark/configs/<config>.json` (the `file` of its `configs` entry):
  the model as it is run;
- `benchmark/traffic/<traffic>.json`: the traffic mix, and the path it
  drives (`benchmark/paths/<path>.py`);
- `benchmark/cells/<workload>.json`, where present: the cell's own
  parameters (they override the mix's) and its correctness limits;
- `benchmark/metrics/<metric>.py`: the reader of each per-layer metric.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
# Top-level module names that no process of the benchmark may hold: the
# JAX stack and the JAX package (compared whole: the port's name starts
# with the JAX package's).
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "deepchopper_tpu")


def forbidden_loaded(module_names) -> list[str]:
    """The forbidden top-level names among `module_names` (e.g. sys.modules)."""
    tops = {name.split(".", 1)[0] for name in module_names}
    return sorted(tops.intersection(FORBIDDEN_MODULES))


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict  # the mix, with the cell's own parameters laid over it
    limits: dict
    end_to_end: list[dict]
    per_layer: list[dict]

    @property
    def path(self) -> str:
        return self.traffic["path"]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, spec_path: Path = ROOT / "BENCHMARK.json") -> Cell:
    spec = load_json(spec_path)
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in {spec_path}")
    cfg_entry = next(c for c in spec["configs"] if c["name"] == entry["config"])
    config = load_json(ROOT / cfg_entry["file"])
    traffic = load_json(BENCH / "traffic" / f"{entry['traffic']}.json")
    own = BENCH / "cells" / f"{name}.json"
    params = load_json(own) if own.exists() else {}
    limits = params.pop("limits", {})
    end_to_end = [m for m in spec["end_to_end"] if _applies(m, name)]
    reported = {m["name"] for m in end_to_end}
    # A per-layer metric without a `workloads` list belongs to every cell
    # that reports the end-to-end metric it moves.
    per_layer = [m for m in spec["per_layer"] if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return Cell(
        name=name,
        chips=int(entry["chips"]),
        config=config,
        traffic={**traffic, **params},
        limits=limits,
        end_to_end=end_to_end,
        per_layer=per_layer,
    )


def _load_file(path: Path, module_name: str):
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def path_module(path: str):
    """The driver of an entry point: `benchmark/paths/<path>.py`."""
    return importlib.import_module(f"benchmark.paths.{path}")


def metric_reader(name: str):
    """The `read(run)` function of a per-layer metric's reader,
    `benchmark/metrics/<name>.py`."""
    return _load_file(BENCH / "metrics" / f"{name}.py", f"benchmark_metric_{name.replace('.', '_')}").read
