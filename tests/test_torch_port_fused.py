"""The port's fused predict+chop vs the JAX package's, on the same weights and reads.

A narrow float32 Hyena (d_model 64, 2 layers) gets JAX random-init params,
bridged to torch as in tests/test_torch_port_predict.py. Both engines run on
the CPU at max_length 256 over the buckets [64, 128, 256], so reads up to 600
bases also exercise the truncation passthrough. First the label matrices of
the two engines must be equal, batch for batch, over the same
`SpanBatchSource` batches; then `fused_predict_chop` must write the same
decompressed bytes under the same `<stem>.<N>pd.<M>record.chop.fq.gz` name, in
the current directory, on plain, gzip, BGZF, zip and zstd input, and under the
chop option variants of tests/test_fused.py. The CLI's `predict --fused-chop`
must give the same bytes as its two-phase path (`predict --shard-format npz`
or `pt`, then `chop`). All comparisons are exact.
"""

from __future__ import annotations

import gzip
import os
import subprocess
import sys
import threading
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_port_predict import _narrow_pair

from deepchopper_tpu import native as jax_native
from deepchopper_tpu.chop import ChopOptions as JaxChopOptions
from deepchopper_tpu.chop.pipeline import stream_chop_with_predicts as jax_stream_chop
from deepchopper_tpu.data.span_batches import SpanBatchSource as JaxSpanBatchSource
from deepchopper_tpu.infer import PredictEngine as JaxPredictEngine
from deepchopper_tpu.infer.fused import fused_predict_chop as jax_fused
from deepchopper_tpu.io import zstd_ctypes as jax_zstd
from deepchopper_tpu.io.chop import ChopType as JaxChopType
from deepchopper_tpu_torch import native
from deepchopper_tpu_torch.chop import ChopOptions, stream_chop_with_predicts
from deepchopper_tpu_torch.data.span_batches import SpanBatchSource
from deepchopper_tpu_torch.infer import fused
from deepchopper_tpu_torch.infer.engine import PredictEngine
from deepchopper_tpu_torch.io.bgzf import open_bgzf_writer
from deepchopper_tpu_torch.io.chop import ChopType
from deepchopper_tpu_torch.ops import setup

pytestmark = pytest.mark.skipif(not jax_native.available(), reason="the JAX package's native host ops are unavailable")

REPO = Path(__file__).resolve().parent.parent
ENGINE_KW = dict(max_length=256, tokens_per_batch=1 << 12, buckets=[64, 128, 256], return_labels=True)
# The chop option variants of tests/test_fused.py other than the default.
VARIANTS = [{"output_chopped_seqs": True}, {"chop_type": "terminal"}, {"chop_type": "internal"}, {"min_read_len": 50}]


def write_fastq(path: Path, n: int = 60, seed: int = 7, min_len: int = 40, max_len: int = 600) -> Path:
    rng = np.random.default_rng(seed)
    with open(path, "wb") as fh:
        for i in range(n):
            length = int(rng.integers(min_len, max_len))
            seq = rng.choice(np.frombuffer(b"ACGTNacgu", np.uint8), length).tobytes()
            qual = rng.integers(33, 74, length).astype(np.uint8).tobytes()
            fh.write(b"@fused_%d some desc\n%s\n+\n%s\n" % (i, seq, qual))
    return path


@pytest.fixture(scope="module")
def engines():
    """(JAX engine, port engine) on the same narrow float32 weights."""
    bundle, port = _narrow_pair()
    return JaxPredictEngine(bundle, **ENGINE_KW), PredictEngine(port, device="cpu", **ENGINE_KW)


def _opts(cls, type_cls, kw: dict, **extra):
    kw = {**kw, **extra}
    if "chop_type" in kw:
        kw["chop_type"] = type_cls(kw["chop_type"])
    return cls(**kw)


def _decompressed(path) -> bytes:
    with gzip.open(path, "rb") as fh:
        return fh.read()


def test_label_matrices_match_jax(engines, tmp_path):
    jax_engine, port_engine = engines
    fq = write_fastq(tmp_path / "in.fq")
    src = dict(max_length=256, tokens_per_batch=1 << 12, buckets=[64, 128, 256], max_batch=512)
    want = list(jax_engine.predict_batches(JaxSpanBatchSource(fq, **src).batches()))
    got = list(port_engine.predict_batches(SpanBatchSource(fq, **src).batches()))
    assert len(got) == len(want) == 5
    ones = 0
    for (jb, jl), (pb, pl) in zip(want, got):
        np.testing.assert_array_equal(pb.input_ids, jb.input_ids)
        np.testing.assert_array_equal(pb.lengths, jb.lengths)
        jl = np.asarray(jl)
        assert pl.dtype == np.int8 and pl.shape == jl.shape
        for i, n in enumerate(pb.lengths):
            np.testing.assert_array_equal(pl[i, : n - 1], jl[i, : n - 1])
            ones += int(pl[i, : n - 1].sum())
    assert 0 < ones < sum(int(n) - 1 for b, _ in got for n in b.lengths)


def _pack(fq: Path, kind: str) -> Path:
    data = fq.read_bytes()
    out = fq.parent / f"in.fq.{kind}"
    if kind == "plain":
        return fq
    if kind == "gzip":
        with gzip.open(out, "wb") as fh:
            fh.write(data)
    elif kind == "bgzf":
        with open_bgzf_writer(out, threads=2) as fh:
            fh.write(data)
    elif kind == "zip":
        with zipfile.ZipFile(out, "w", zipfile.ZIP_DEFLATED) as zf:
            zf.writestr("in.fq", data)
    else:
        if not jax_zstd.available():
            pytest.skip("libzstd is not available")
        out.write_bytes(jax_zstd.compress(data))
    return out


@pytest.mark.parametrize("kind", ["plain", "gzip", "bgzf", "zip", "zstd"])
def test_fused_predict_chop_matches_jax(engines, kind, tmp_path, monkeypatch):
    """Default options, no output prefix: the output lands in the current
    directory under the same name in both packages."""
    jax_engine, port_engine = engines
    fq = _pack(write_fastq(tmp_path / "in.fq"), kind)
    out = {}
    for who, run, engine, opts in (("jax", jax_fused, jax_engine, JaxChopOptions()),
                                   ("port", fused.fused_predict_chop, port_engine, ChopOptions())):  # fmt: skip
        (tmp_path / who).mkdir()
        monkeypatch.chdir(tmp_path / who)
        stats = run(engine, fq, opts)
        out[who] = (stats, Path(stats.output_file))
    (js, jf), (ps, pf) = out["jax"], out["port"]
    assert isinstance(ps, fused.FusedStats) and pf.name == jf.name and pf.parent == Path(".")
    assert (ps.total_fq_count, ps.total_output_count, ps.predicts_loaded) == (
        js.total_fq_count, js.total_output_count, js.predicts_loaded) == (60, ps.total_output_count, 60)
    assert ps.total_output_count != ps.total_fq_count  # reads were chopped
    assert _decompressed(tmp_path / "port" / pf) == _decompressed(tmp_path / "jax" / jf)
    assert not list(fq.parent.glob(".deepchopper_temp_*"))


def test_fused_from_another_directory_keeps_its_temp_file_beside_the_output(engines, tmp_path, monkeypatch):
    """No output prefix, run from a directory on another path than the
    input's: the temporary file is made in the current directory, where the
    output lands, none is left anywhere, and the bytes and name equal the JAX
    package's."""
    jax_engine, port_engine = engines
    (tmp_path / "input").mkdir()
    fq = write_fastq(tmp_path / "input" / "in.fq", seed=13)
    opened: list[Path] = []

    def spy(path, **kw):
        opened.append(Path(path))
        return open_bgzf_writer(path, **kw)

    monkeypatch.setattr(fused, "open_bgzf_writer", spy)
    (tmp_path / "jax").mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    want = jax_fused(jax_engine, fq, JaxChopOptions())
    cwd = tmp_path / "elsewhere" / "port"
    cwd.mkdir(parents=True)
    monkeypatch.chdir(cwd)
    got = fused.fused_predict_chop(port_engine, fq, ChopOptions())
    assert len(opened) == 1 and opened[0].parent == cwd and opened[0].name.startswith(".deepchopper_temp_")
    assert got.output_file == want.output_file and (cwd / got.output_file).exists()
    assert got.total_output_count != got.total_fq_count  # reads were chopped
    assert _decompressed(cwd / got.output_file) == _decompressed(tmp_path / "jax" / want.output_file)
    assert not list(tmp_path.rglob(".deepchopper_temp_*"))


@pytest.mark.parametrize("variant", VARIANTS, ids=["ocq", "terminal", "internal", "min_read_len"])
def test_fused_chop_variants_match_jax(engines, variant, tmp_path):
    jax_engine, port_engine = engines
    fq = write_fastq(tmp_path / "in.fq", seed=11)
    js = jax_fused(jax_engine, fq, _opts(JaxChopOptions, JaxChopType, variant, output_prefix=str(tmp_path / "j")))
    ps = fused.fused_predict_chop(port_engine, fq, _opts(ChopOptions, ChopType, variant,
                                                         output_prefix=str(tmp_path / "p")))  # fmt: skip
    assert Path(ps.output_file).name[1:] == Path(js.output_file).name[1:]
    assert _decompressed(ps.output_file) == _decompressed(js.output_file)


def test_two_phase_in_memory_matches_fused_and_jax(engines, tmp_path):
    """`predict_to_predicts` + `stream_chop_with_predicts` (the CLI's path
    when `--fq` names another file) writes what the fused runner writes, and
    what the JAX package's two-phase path writes."""
    jax_engine, port_engine = engines
    fq = write_fastq(tmp_path / "in.fq", seed=5)
    predicts = port_engine.predict_to_predicts(fq)
    assert len(predicts) == 60
    two = stream_chop_with_predicts(predicts, fq, ChopOptions(output_prefix=str(tmp_path / "two")))
    one = fused.fused_predict_chop(port_engine, fq, ChopOptions(output_prefix=str(tmp_path / "one")))
    ref = jax_stream_chop(jax_engine.predict_to_predicts(fq), fq, JaxChopOptions(output_prefix=str(tmp_path / "jax")))
    assert _decompressed(two.output_file) == _decompressed(one.output_file) == _decompressed(ref.output_file)
    assert (two.total_output_count, two.predicts_loaded) == (one.total_output_count, one.predicts_loaded)


def test_fused_without_the_native_plane_writes_the_same_bytes(engines, tmp_path, monkeypatch):
    """The Python and NumPy fallbacks (the oracle of the native calls) give
    the native plane's output; the native plane ran in the first run only."""
    _jax_engine, port_engine = engines
    fq = write_fastq(tmp_path / "in.fq", seed=3)
    native.reset_calls()
    with_native = fused.fused_predict_chop(port_engine, fq, ChopOptions(output_prefix=str(tmp_path / "n")))
    ran = dict(native.calls)
    assert all(ran[k] for k in ("fq_index", "encode_spans_batch", "majority_vote_batch", "chop_records"))
    monkeypatch.setattr(native, "get_lib", lambda: None)
    native.reset_calls()
    without = fused.fused_predict_chop(port_engine, fq, ChopOptions(output_prefix=str(tmp_path / "p")))
    assert not any(native.calls.values())
    assert _decompressed(without.output_file) == _decompressed(with_native.output_file)


def test_worker_error_surfaces_without_deadlock(engines, tmp_path, monkeypatch):
    _jax_engine, port_engine = engines
    fq = write_fastq(tmp_path / "in.fq", n=200, seed=2, min_len=60, max_len=240)

    def boom(*args):
        raise RuntimeError("chop worker failed")

    monkeypatch.setattr(fused, "_chop_chunk", boom)
    raised: list[BaseException] = []

    def run() -> None:
        try:
            fused.fused_predict_chop(port_engine, fq, ChopOptions(output_prefix=str(tmp_path / "x")), chunk_bytes=4096)
        except BaseException as exc:  # noqa: BLE001 - inspected below
            raised.append(exc)

    caller = threading.Thread(target=run, daemon=True)
    caller.start()
    caller.join(timeout=120)
    assert not caller.is_alive(), "fused_predict_chop deadlocked after its worker failed"
    assert len(raised) == 1 and isinstance(raised[0], RuntimeError) and "chop worker failed" in str(raised[0])
    assert not list(tmp_path.glob(".deepchopper_temp_*")) and not list(tmp_path.glob("x.*"))


def test_runtime_setup_is_a_noop_on_the_cpu(engines):
    _jax_engine, port_engine = engines
    setup.reset_launch_counts()
    assert port_engine.runtime_setup() == 0.0 and port_engine.stats.setup_s == 0.0
    assert setup.launch_counts["setup"] == 0
    x = torch.randn(setup.SHAPE)
    assert torch.equal(setup.setup_tile(x), x + 1) and setup.launch_counts["setup"] == 0
    with pytest.raises(ValueError):
        setup.setup_tile(torch.zeros(setup.SHAPE, device="meta"))


def _cli(*args: str, cwd: Path) -> subprocess.CompletedProcess:
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    res = subprocess.run([sys.executable, "-m", "deepchopper_tpu_torch", *args], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)  # fmt: skip
    assert res.returncode == 0, res.stderr
    return res


def test_cli_fused_chop_matches_the_two_phase_cli(tmp_path):
    """`predict --fused-chop --device cpu` against `predict --shard-format
    {npz,pt}` then `chop`, each in its own directory: the same name and
    bytes."""
    fq = write_fastq(tmp_path / "reads.fq", n=24, seed=9, max_len=1400)
    model = ["--model", "hyenadna-tiny-1k-seqlen", "--random-init", "--device", "cpu", "--max-length", "1024"]
    outputs = {}
    for who in ("fused", "npz", "pt"):
        cwd = tmp_path / who
        cwd.mkdir()
        if who == "fused":
            res = _cli("predict", str(fq), "--fused-chop", *model, cwd=cwd)
        else:
            _cli("predict", str(fq), "--shard-format", who, "-o", "shards", *model, cwd=cwd)
            assert list((cwd / "shards" / "0").glob(f"0_*.{who}"))
            res = _cli("chop", "shards/0", str(fq), cwd=cwd)
        (out,) = cwd.glob("reads.*pd.*record.chop.fq.gz")
        assert out.name in res.stdout
        outputs[who] = (out.name, _decompressed(out))
    assert outputs["fused"][0].startswith("reads.24pd.")
    assert outputs["fused"] == outputs["npz"] == outputs["pt"]
