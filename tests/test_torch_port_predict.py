"""Port predict path vs the JAX engine, the port CLI, and the import guard.

A seeded FASTQ (40 reads, 100-700 bases) goes through the JAX
`PredictEngine.predict_file` and the port's `predict_file(device="cpu")` on
the same (bridged) weights at float32. Shards must agree: target/seq/qual/id
exactly, prediction logits within 1e-4 * max|ref|.
"""

from __future__ import annotations

import ast
import bz2
import dataclasses
import gzip
import lzma
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from deepchopper_tpu.infer import PredictEngine as JaxPredictEngine
from deepchopper_tpu.io.fastq import StreamingFastqReader as JaxFastqReader
from deepchopper_tpu.models import config as jax_config
from deepchopper_tpu.models.classifier import HyenaTokenClassifier as JaxClassifier
from deepchopper_tpu.models.registry import ModelBundle, init_params
from deepchopper_tpu_torch.infer.engine import PredictEngine
from deepchopper_tpu_torch.io.fastq import StreamingFastqReader
from deepchopper_tpu_torch.models import bridge
from deepchopper_tpu_torch.models.classifier import HyenaTokenClassifier
from deepchopper_tpu_torch.models.config import HeadConfig, HyenaConfig

REPO = Path(__file__).resolve().parent.parent
LOGIT_TOL = 1e-4


def write_fastq(path: Path, n_reads: int = 40, seed: int = 0) -> Path:
    rng = np.random.default_rng(seed)
    with open(path, "wb") as fh:
        for i in range(n_reads):
            n = int(rng.integers(100, 701))
            seq = rng.choice(np.frombuffer(b"ACGTN", np.uint8), n, p=[0.24, 0.24, 0.24, 0.24, 0.04])
            qual = rng.integers(33 + 3, 33 + 41, n).astype(np.uint8)
            rid = f"read_{i}"
            if i % 3 == 0:  # annotated adapter region
                s = int(rng.integers(0, n // 2))
                rid += f"|{s}:{s + int(rng.integers(1, n // 2))}"
            fh.write(b"@" + rid.encode() + b"\n" + seq.tobytes() + b"\n+\n" + qual.tobytes() + b"\n")
    return path


def _port_config(cls, jax_cfg):
    """The port's config with the JAX config's values, field by field."""
    return cls(**{f.name: getattr(jax_cfg, f.name) for f in dataclasses.fields(cls)})


def _narrow_pair():
    backbone = jax_config.HyenaConfig(
        d_model=64, n_layer=2, d_inner=128, max_seq_len=1026, compute_dtype="float32"
    )
    head = jax_config.HeadConfig(input_size=64, lin1_size=128, lin2_size=128, compute_dtype="float32")
    module = JaxClassifier(backbone_config=backbone, head_config=head)
    params = init_params(module, seed=3)
    bundle = ModelBundle(module=module, params=params, name="narrow", config=backbone)
    port = HyenaTokenClassifier(_port_config(HyenaConfig, backbone), _port_config(HeadConfig, head))
    bridge.load_flax_params(port, jax.tree.map(np.asarray, params))
    return bundle, port


def _shards(d: Path) -> list[Path]:
    return sorted(d.glob("0/*.npz"), key=lambda p: int(p.stem.split("_")[1]))


def test_predict_file_matches_jax_engine(tmp_path):
    fq = write_fastq(tmp_path / "reads.fq")
    bundle, port = _narrow_pair()
    kw = dict(max_length=1024, tokens_per_batch=8192, max_batch=16)
    JaxPredictEngine(bundle, **kw).predict_file(fq, tmp_path / "jax")
    stats = PredictEngine(port, device="cpu", **kw).predict_file(fq, tmp_path / "port")
    assert stats.reads == 40
    jax_shards, port_shards = _shards(tmp_path / "jax"), _shards(tmp_path / "port")
    assert [p.name for p in port_shards] == [p.name for p in jax_shards] and port_shards
    for pj, pp in zip(jax_shards, port_shards):
        ref, got = np.load(pj), np.load(pp)
        assert set(got.files) == {"prediction", "target", "seq", "qual", "id"}
        for key in ("target", "seq", "qual", "id"):
            np.testing.assert_array_equal(got[key], ref[key], err_msg=f"{pp.name}:{key}")
        pr, pg = ref["prediction"], got["prediction"]
        assert pg.shape == pr.shape and pg.dtype == np.float32
        assert np.abs(pg - pr).max() <= LOGIT_TOL * np.abs(pr).max(), pp.name


def test_engine_labels_are_argmax_of_logits():
    torch.manual_seed(0)
    _bundle, port = _narrow_pair()
    ids = torch.randint(7, 12, (3, 256), dtype=torch.int8)
    quals = torch.randint(0, 40, (3, 256), dtype=torch.uint8)
    logits = PredictEngine(port, device="cpu").step(ids, quals)
    labels = PredictEngine(port, device="cpu", return_labels=True).step(ids, quals)
    assert logits.shape == (3, 256, 2) and labels.dtype == torch.int8
    assert torch.equal(labels, logits.argmax(-1).to(torch.int8))


@pytest.mark.parametrize("opener", [open, gzip.open, bz2.open, lzma.open])
def test_fastq_reader_matches_jax_reader(tmp_path, opener):
    plain = write_fastq(tmp_path / "reads.fq", n_reads=7)
    packed = tmp_path / "reads.packed"
    with opener(packed, "wb") as fh:
        fh.write(plain.read_bytes())
    got = [(r.id, r.seq, r.qual) for r in StreamingFastqReader(packed)]
    want = [(r.id, bytes(r.seq), bytes(r.qual)) for r in JaxFastqReader(plain)]
    assert len(got) == 7 and got == want


def _cli(*args: str, cwd: Path) -> subprocess.CompletedProcess:
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    return subprocess.run(
        [sys.executable, "-m", "deepchopper_tpu_torch", "predict", *args],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300,
    )  # fmt: skip


def test_cli_predict_random_init_on_cpu(tmp_path):
    fq = write_fastq(tmp_path / "reads.fq", n_reads=12)
    res = _cli(
        str(fq), "--random-init", "--device", "cpu", "-o", "d",
        "--model", "hyenadna-tiny-1k-seqlen", "--max-length", "1024", cwd=tmp_path,
    )  # fmt: skip
    assert res.returncode == 0, res.stderr
    shards = list((tmp_path / "d" / "0").glob("0_*.npz"))
    assert shards
    assert sum(len(np.load(p)["id"]) for p in shards) == 12


def test_cli_predict_without_weights_exits_1(tmp_path):
    fq = write_fastq(tmp_path / "reads.fq", n_reads=2)
    res = _cli(str(fq), "--device", "cpu", "-o", "d", cwd=tmp_path)
    assert res.returncode == 1
    assert "no pretrained weights" in res.stderr
    assert not (tmp_path / "d").exists()


def test_cli_predict_without_cuda_refuses(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is available")
    fq = write_fastq(tmp_path / "reads.fq", n_reads=2)
    res = _cli(str(fq), "--random-init", "-o", "d", cwd=tmp_path)
    assert res.returncode != 0
    assert "CUDA is not available" in res.stderr
    assert not list(tmp_path.glob("d/**/*.npz"))


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    from deepchopper_tpu_torch.device import DeviceUnavailable
    from deepchopper_tpu_torch.models.registry import DeepChopper

    with pytest.raises(DeviceUnavailable):
        DeepChopper.new("hyenadna-tiny-1k-seqlen")
    _bundle, port = _narrow_pair()
    with pytest.raises(DeviceUnavailable):
        PredictEngine(port)


def test_chip_smoke_exits_nonzero_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(REPO / "chip_smoke.py", alone)
    for script in (REPO / "chip_smoke.py", alone):
        res = subprocess.run([sys.executable, str(script)], cwd=tmp_path, capture_output=True, text=True, timeout=120)
        assert res.returncode != 0
        assert '"ok"' not in res.stdout


def test_port_imports_nothing_of_jax():
    files = sorted((REPO / "deepchopper_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    files += sorted((REPO / "scripts").glob("torch_*.py"))
    banned = ("jax", "flax", "optax", "deepchopper_tpu")
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                if name.split(".")[0] in banned:
                    bad.append(f"{path.relative_to(REPO)}:{node.lineno}: {name}")
    assert len(files) > 10
    assert not bad, bad
