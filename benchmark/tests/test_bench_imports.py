"""What a run loads: no JAX, no flax, no JAX package in the harness's
process (top-level names compared whole), nothing of the program in the
reference's; and nothing of the benchmark reads the JAX-era bench files."""

from __future__ import annotations

import json
import subprocess
import sys

from benchmark.harness.spec import BENCH, ROOT, forbidden_loaded


def test_top_level_names_are_compared_whole():
    assert forbidden_loaded(["deepchopper_tpu_torch", "deepchopper_tpu_torch.infer.engine", "torch"]) == []
    assert forbidden_loaded(["deepchopper_tpu.models"]) == ["deepchopper_tpu"]
    assert forbidden_loaded(["jax.numpy", "flax.linen", "jaxlib"]) == ["flax", "jax", "jaxlib"]


def _modules_after(code: str) -> set[str]:
    prog = f"import sys, json\nsys.path.insert(0, {str(ROOT)!r})\n{code}\nprint(json.dumps(sorted(sys.modules)))"
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True, text=True, timeout=600, check=True,
                         cwd=ROOT)  # fmt: skip
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_of_each_path_loads_no_jax():
    code = (
        "import torch\n"
        "sys.path.insert(0, 'benchmark/tests')\n"
        "from benchmark.tests.conftest import tiny_cell\n"
        "from benchmark.run import run_cell\n"
        "import benchmark.control\n"
        "for fam, kind in (('hyena', 'fused'), ('caduceus', 'train')):\n"
        "    assert run_cell(tiny_cell(fam, kind), 7, 0.2, True, torch.device('cpu'), 0.0) == 0\n"
    )
    mods = _modules_after(code)
    assert forbidden_loaded(mods) == []
    assert "deepchopper_tpu_torch" in {m.split(".")[0] for m in mods}


def test_the_reference_loads_nothing_of_the_program():
    code = (
        "import torch, numpy as np\n"
        "from benchmark.reference import chop, encode, judge, models, precision, scan\n"
        "from benchmark.counts import flops, peaks, roofline\n"
        "from benchmark.harness import traffic, weights\n"
    )
    tops = {m.split(".")[0] for m in _modules_after(code)}
    assert "deepchopper_tpu_torch" not in tops and forbidden_loaded(tops) == []


def test_no_file_of_the_benchmark_reads_the_jax_era_bench_files():
    for path in BENCH.rglob("*.py"):
        if path.parent.name == "tests":
            continue
        text = path.read_text()
        assert "bench.py" not in text and "BENCH_" not in text and "MULTICHIP" not in text, path
