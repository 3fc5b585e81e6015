"""The port's parquet/JSON encoders and parquet-sourced DataModule vs the JAX
package's, on the CPU.

Labelled reads come from `data/synth.py` with a numpy seed. Every comparison
is exact: parquet tables and schemas equal, JSON and BGZF bytes equal,
batches equal field by field (ids, labels, quals, lengths, read ids), split
caches with the same directory, files and tables. Each side writes into its
own directory, so neither reads the other's cache. Without pyarrow (blocked
in `sys.modules`) the port's FASTQ ratio split filters in-stream and gives
the cache's batches, and a parquet source raises an ImportError that names
pyarrow.
"""

from __future__ import annotations

import contextlib
import io
import os
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest

pa = pytest.importorskip("pyarrow")
pq = pytest.importorskip("pyarrow.parquet")

from deepchopper_tpu import cli as jax_cli  # noqa: E402
from deepchopper_tpu.data.parquet_module import DataModule as JaxDataModule  # noqa: E402
from deepchopper_tpu.io import parquet as jax_parquet  # noqa: E402
from deepchopper_tpu_torch import cli  # noqa: E402
from deepchopper_tpu_torch.data.parquet_module import DataModule  # noqa: E402
from deepchopper_tpu_torch.data.synth import synth_labelled_fastq  # noqa: E402
from deepchopper_tpu_torch.io import parquet  # noqa: E402

BATCH_FIELDS = ("input_ids", "labels", "quals", "ids", "lengths")
DM_KW = dict(max_length=1024, tokens_per_batch=2048, shuffle_buffer=8, seed=5)


@pytest.fixture(scope="module")
def reads(tmp_path_factory) -> Path:
    lengths = np.random.default_rng(11).integers(100, 700, 40)
    return synth_labelled_fastq(tmp_path_factory.mktemp("src") / "reads.fq", lengths, seed=11)


def _sides(tmp_path: Path, src: Path) -> tuple[Path, Path]:
    """A copy of `src` in a directory of each side's own: (port's, JAX's)."""
    out = []
    for side in ("port", "jax"):
        (tmp_path / side).mkdir()
        out.append(Path(shutil.copy2(src, tmp_path / side / src.name)))
    return out[0], out[1]


def _stdout(main, argv: list[str]) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


def _assert_same_batches(got, want, name: str) -> int:
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0, name
    for a, b in zip(got, want):
        assert a.read_ids == b.read_ids, name
        for field in BATCH_FIELDS:
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field), err_msg=f"{name}.{field}")
    return sum(len(b.read_ids) for b in got)


def _assert_same_module_batches(ours, theirs) -> None:
    streams = {
        "train0": (ours.train_batches(0), theirs.train_batches(0)),
        "train1": (ours.train_batches(1), theirs.train_batches(1)),
        "val": (ours.val_batches(), theirs.val_batches()),
        "test": (ours.test_batches(), theirs.test_batches()),
    }
    for name, (got, want) in streams.items():
        _assert_same_batches(got, want, name)


def _tables_equal(a: Path, b: Path) -> None:
    ta, tb = pq.read_table(a), pq.read_table(b)
    assert ta.schema.equals(tb.schema), (a, b)
    assert ta.equals(tb), (a, b)


# -- encoders --------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["single", "chunked"])
def test_encode_cli_tables_equal_jax(tmp_path, reads, mode, monkeypatch):
    ours, theirs = _sides(tmp_path, reads)
    flags = ["--chunk", "--chunk-size", "7"] if mode == "chunked" else []
    printed = []
    for main, fq in ((cli.main, ours), (jax_cli.main, theirs)):
        monkeypatch.chdir(fq.parent)
        printed.append(_stdout(main, ["encode", *flags, fq.name]))
    assert printed[0] == printed[1] and "encoded reads.fq -> " in printed[0]
    out = "reads_chunks" if mode == "chunked" else "reads.parquet"
    if mode == "chunked":
        names = sorted(p.name for p in (ours.parent / out).iterdir())
        assert names == sorted(p.name for p in (theirs.parent / out).iterdir()) and len(names) == 6
        for name in names:
            _tables_equal(ours.parent / out / name, theirs.parent / out / name)
    else:
        _tables_equal(ours.parent / out, theirs.parent / out)
    assert pq.read_table(ours.parent / out).num_rows == 40


def test_json_and_class_encoders_equal_jax(tmp_path, reads):
    ours, theirs = _sides(tmp_path, reads)
    assert parquet.JsonEncoder().encode(ours).read_bytes() == jax_parquet.JsonEncoder().encode(theirs).read_bytes()
    a = parquet.encode_fq_path_to_json(ours, ours.parent / "k.json", kmer_size=3)
    b = jax_parquet.encode_fq_path_to_json(theirs, theirs.parent / "k.json", kmer_size=3)
    assert a.read_bytes() == b.read_bytes() and a.read_bytes().count(b"\n") == 40
    _tables_equal(parquet.ParquetEncoder().encode(ours, ours.parent / "c.parquet"),
                  jax_parquet.ParquetEncoder().encode(theirs, theirs.parent / "c.parquet"))  # fmt: skip
    rows = list(parquet._record_rows(ours))[:5]
    parquet.write_parquet(rows, ours.parent / "w.parquet")
    jax_parquet.write_parquet(rows, theirs.parent / "w.parquet")
    _tables_equal(ours.parent / "w.parquet", theirs.parent / "w.parquet")
    parquet.write_json(rows, ours.parent / "w.json")
    jax_parquet.write_json(rows, theirs.parent / "w.json")
    assert (ours.parent / "w.json").read_bytes() == (theirs.parent / "w.json").read_bytes()
    names = [r["id"] for r in rows[:3]]
    got = parquet.extract_records_by_ids(ours, names)
    assert [r.to_bytes() for r in got] == [r.to_bytes() for r in jax_parquet.extract_records_by_ids(theirs, names)]


def test_write_predicts_equal_jax(tmp_path, reads):
    ours, theirs = _sides(tmp_path, reads)
    parquet.encode_fq_path_to_parquet(ours)
    jax_parquet.encode_fq_path_to_parquet(theirs)
    seqs = pq.read_table(ours.with_suffix(".parquet")).column("seq").to_pylist()
    rng = np.random.default_rng(4)
    labels = []
    for seq in seqs:
        lab = np.zeros(len(seq), np.int8)
        start = int(rng.integers(0, max(len(seq) - 60, 1)))
        lab[start : start + int(rng.integers(0, 60))] = 1
        labels.append(lab)
    parquet.write_predicts(ours.with_suffix(".parquet"), ours.parent / "out.fq.gz", labels, 5, 10, 3)
    jax_parquet.write_predicts(theirs.with_suffix(".parquet"), theirs.parent / "out.fq.gz", labels, 5, 10, 3)
    got = (ours.parent / "out.fq.gz").read_bytes()
    assert got == (theirs.parent / "out.fq.gz").read_bytes() and len(got) > 100


# -- the data module over parquet -------------------------------------------------


@pytest.mark.parametrize("layout", ["file", "chunks"])
def test_datamodule_parquet_batches_and_cache_equal_jax(tmp_path, reads, layout):
    ours, theirs = _sides(tmp_path, reads)
    if layout == "chunks":
        src = [parquet.encode_fq_path_to_parquet_chunk(ours, chunk_size=9),
               jax_parquet.encode_fq_path_to_parquet_chunk(theirs, chunk_size=9)]  # fmt: skip
    else:
        src = [parquet.encode_fq_path_to_parquet(ours), jax_parquet.encode_fq_path_to_parquet(theirs)]
    for p in src:  # the cache's tag holds the source's mtime
        os.utime(p, ns=(1_700_000_000_000_000_000,) * 2)
    port_dm, jax_dm = DataModule(train_data_path=str(src[0]), **DM_KW), JaxDataModule(train_data_path=str(src[1]), **DM_KW)
    _assert_same_module_batches(port_dm, jax_dm)

    caches = [sorted(p.parent.glob(f".{p.name}.splits_*")) for p in src]
    assert [c.name for c in caches[0]] == [c.name for c in caches[1]] and len(caches[0]) == 1
    assert sorted(p.name for p in caches[0][0].iterdir()) == ["test.parquet", "train.parquet", "val.parquet"]
    for name in ("train", "val", "test"):
        _tables_equal(caches[0][0] / f"{name}.parquet", caches[1][0] / f"{name}.parquet")

    # Explicit per-split sources and predict, no ratio split.
    cache = caches[0][0]
    kw = {f"{w}_data_path": str(cache / f"{w}.parquet") for w in ("train", "val", "test")}
    _assert_same_module_batches(DataModule(**kw, **DM_KW), JaxDataModule(**kw, **DM_KW))
    n = _assert_same_batches(DataModule(predict_data_path=str(src[0]), **DM_KW).predict_batches(),
                             JaxDataModule(predict_data_path=str(src[1]), **DM_KW).predict_batches(), "predict")  # fmt: skip
    assert n == 40


def test_split_cache_is_reused_and_invalidated(tmp_path, reads, monkeypatch):
    src = parquet.encode_fq_path_to_parquet(Path(shutil.copy2(reads, tmp_path / "reads.fq")))
    first = [b.read_ids for b in DataModule(train_data_path=str(src), **DM_KW).val_batches()]
    (cache,) = tmp_path.glob(".reads.parquet.splits_*")

    def no_source(self):
        raise AssertionError("the source was read again")

    with monkeypatch.context() as m:
        m.setattr(DataModule, "_iter_source_rows", no_source)
        again = DataModule(train_data_path=str(src), **DM_KW)
        assert [b.read_ids for b in again.val_batches()] == first
        assert again._materialize_splits()["val"].parent == cache

    # Regenerated in place from other reads: the size/mtime tag misses the cache.
    other = synth_labelled_fastq(tmp_path / "other.fq", np.random.default_rng(12).integers(100, 700, 40), seed=12)
    parquet.encode_fq_path_to_parquet(other, src)
    os.utime(src, ns=(src.stat().st_atime_ns, src.stat().st_mtime_ns + 5_000_000))
    regenerated = DataModule(train_data_path=str(src), **DM_KW)
    assert regenerated._materialize_splits()["val"].parent != cache
    assert [b.read_ids for b in regenerated.val_batches()] != first
    assert len(list(tmp_path.glob(".reads.parquet.splits_*"))) == 2


def _block_pyarrow(monkeypatch) -> None:
    for name in [m for m in sys.modules if m == "pyarrow" or m.startswith("pyarrow.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "pyarrow", None)
    monkeypatch.setitem(sys.modules, "pyarrow.parquet", None)


def test_ratio_split_without_pyarrow_filters_in_stream(tmp_path, reads, monkeypatch):
    cached, streamed = _sides(tmp_path, reads)
    with_cache = DataModule(train_data_path=str(cached), **DM_KW)
    want = {"train0": list(with_cache.train_batches(0)), "val": list(with_cache.val_batches())}
    assert list(cached.parent.glob(".reads.fq.splits_*"))
    src = parquet.encode_fq_path_to_parquet(cached, tmp_path / "reads.parquet")

    _block_pyarrow(monkeypatch)
    dm = DataModule(train_data_path=str(streamed), **DM_KW)
    _assert_same_batches(dm.train_batches(0), want["train0"], "train0")
    _assert_same_batches(dm.val_batches(), want["val"], "val")
    assert dm._materialize_splits() is None
    assert not list(streamed.parent.glob(".reads.fq.splits_*"))
    # A cache written where pyarrow imported is passed over where it does not.
    _assert_same_batches(DataModule(train_data_path=str(cached), **DM_KW).val_batches(), want["val"], "cached val")
    with pytest.raises(ImportError, match="pyarrow"):
        list(DataModule(train_data_path=str(src), **DM_KW).train_batches())
    with pytest.raises(ImportError, match="pyarrow"):
        parquet.encode_fq_path_to_parquet(streamed)


def test_cli_train_on_parquet_matches_its_fastq(tmp_path, reads, monkeypatch):
    from deepchopper_tpu_torch.train import loop

    made = []

    class Recorded(loop.Trainer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    monkeypatch.setattr(loop, "Trainer", Recorded)
    fq = Path(shutil.copy2(reads, tmp_path / "reads.fq"))
    src = parquet.encode_fq_path_to_parquet(fq, tmp_path / "reads.parquet")
    losses = []
    for path in (fq, src):
        overrides = [f"data.train_data_path={path}", "data.max_length=512", "data.tokens_per_batch=2048",
                     "model.name=hyenadna-tiny-1k-seqlen", "trainer.max_epochs=1", "trainer.limit_train_batches=2",
                     "trainer.limit_val_batches=1", "test=false", f"output_dir={tmp_path / path.suffix[1:]}"]  # fmt: skip
        assert "train done: {" in _stdout(cli.main, ["train", *overrides, "--device", "cpu"])
        losses.append(made[-1].step_losses)
    assert len(losses[0]) == 2 and np.isfinite(losses[0]).all()
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-6, atol=0)
