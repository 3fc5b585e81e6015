"""The port's chop plane vs the JAX package's, on the same shards and reads.

Reads and label matrices come from a numpy seed: each read has 0-5 planted
60-base adapter runs and ~2% of its labels flipped (noise the majority vote
removes); some reads are shorter than `min_read_len`, some have predictions
cut short (truncated), and some have none (dropped). JAX's own shard writers
write them, and both packages' `run_chop` must give the same decompressed
bytes under the same `<stem>.<N>pd.<M>record.chop.fq.gz` name, in the
current directory. The native host plane is held to JAX's on the same buffers
and to the port's own Python/NumPy fallbacks. All comparisons are exact.
"""

from __future__ import annotations

import gzip
import os
import subprocess
import sys
import zipfile
from pathlib import Path

import numpy as np
import pytest

from deepchopper_tpu import native as jax_native
from deepchopper_tpu.chop import ChopOptions as JaxChopOptions
from deepchopper_tpu.chop import predict_cli as jax_predict_cli
from deepchopper_tpu.chop import run_chop as jax_run_chop
from deepchopper_tpu.io import zstd_ctypes as jax_zstd
from deepchopper_tpu.io.chop import ChopType as JaxChopType
from deepchopper_tpu.io.fastq import StreamingFastqReader as JaxFastqReader
from deepchopper_tpu.io.predicts import load_predicts_from_batch_pt as jax_load_pt
from deepchopper_tpu.io.predicts import pack_read_ids
from deepchopper_tpu.io.predicts import write_prediction_shard as jax_write_npz
from deepchopper_tpu.io.predicts import write_prediction_shard_pt as jax_write_pt
from deepchopper_tpu.ops.labels import majority_voting_batch as jax_vote
from deepchopper_tpu_torch import native
from deepchopper_tpu_torch.chop import ChopOptions, predict_cli, run_chop
from deepchopper_tpu_torch.data.span_batches import FastqChunk, encode_spans_py, fq_index_py
from deepchopper_tpu_torch.infer.fused import FusedStats, _chop_chunk
from deepchopper_tpu_torch.io import predicts as port_predicts
from deepchopper_tpu_torch.io.bgzf import open_bgzf_writer
from deepchopper_tpu_torch.io.chop import ChopType
from deepchopper_tpu_torch.io.fastq import StreamingFastqReader
from deepchopper_tpu_torch.ops import labels as port_labels

pytestmark = pytest.mark.skipif(not jax_native.available(), reason="the JAX package's native host ops are unavailable")

REPO = Path(__file__).resolve().parent.parent
_TOKENS = np.full(256, 11, np.int64)
for _c, _t in zip(b"ACGT", (7, 8, 9, 10)):
    _TOKENS[_c] = _TOKENS[_c + 32] = _t
_TOKENS[ord("U")] = _TOKENS[ord("u")] = 10

# The option variants of tests/test_fused.py.
VARIANTS = [{}, {"output_chopped_seqs": True}, {"chop_type": "terminal"}, {"chop_type": "internal"},
            {"min_read_len": 50}]  # fmt: skip


def _opts(cls, type_cls, kw: dict, **extra):
    kw = {**kw, **extra}
    if "chop_type" in kw:
        kw["chop_type"] = type_cls(kw["chop_type"])
    return cls(**kw)


def make_reads(n: int = 48, seed: int = 0) -> list[tuple[str, bytes, bytes, np.ndarray]]:
    """(header, seq, qual, labels) per read: planted 60-base adapter runs and
    ~2% flipped labels; lowercase and U bases exercise normalization."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGTACGTacgtuN", np.uint8)
    reads = []
    for i in range(n):
        length = int(rng.integers(60, 900))
        seq = rng.choice(bases, length).tobytes()
        qual = rng.integers(33, 75, length).astype(np.uint8).tobytes()
        labels = np.zeros(length, np.int8)
        for _ in range(int(rng.integers(0, 6))):
            if length > 70:
                s = int(rng.integers(0, length - 60))
                labels[s : s + 60] = 1
        flip = rng.random(length) < 0.02
        labels[flip] ^= 1
        header = f"planted_{i}" + (" runid=x ch=7" if i % 3 == 0 else "")
        reads.append((header, seq, qual, labels))
    return reads


def write_fastq(path: Path, reads) -> Path:
    with open(path, "wb") as fh:
        for header, seq, qual, _ in reads:
            fh.write(b"@%s\n%s\n+\n%s\n" % (header.encode(), seq, qual))
    return path


def write_shards(out: Path, reads, writer, batch: int = 8, width: int = 1024) -> None:
    """Shards of the reads' label matrices, as logits, through `writer`. Every
    7th read has no prediction (dropped by chop), every 5th a prediction cut
    to 3/4 of its read (a truncated prediction: passthrough)."""
    kept = [r for i, r in enumerate(reads) if i % 7 != 3]
    for b0 in range(0, len(kept), batch):
        rows = kept[b0 : b0 + batch]
        pred = np.zeros((len(rows), width, 2), np.float32)
        target = np.full((len(rows), width), -100, np.int64)
        seq = np.full((len(rows), width), 4, np.int64)
        names, trunc = [], []
        for j, (header, s, _q, labels) in enumerate(rows):
            name = header.split()[0]
            n = len(s) if int(name.split("_")[1]) % 5 else 3 * len(s) // 4
            pred[j, :n, 1] = np.where(labels[:n] == 1, 1.0, -1.0)
            target[j, :n] = 0
            seq[j, :n] = _TOKENS[np.frombuffer(s[:n], np.uint8)]
            names.append(name)
            trunc.append(n != len(s))
        writer(out / f"0_{b0 // batch}", pred, target, seq, np.zeros(target.shape, np.float32),
               pack_read_ids(names, trunc))  # fmt: skip


@pytest.fixture(scope="module")
def planted(tmp_path_factory):
    """(fq, npz shard dir, pt shard dir) written by the JAX package."""
    root = tmp_path_factory.mktemp("planted")
    reads = make_reads()
    fq = write_fastq(root / "planted.fq", reads)
    npz, pt = root / "npz", root / "pt"
    npz.mkdir()
    pt.mkdir()
    write_shards(npz, reads, lambda p, *a: jax_write_npz(p.with_suffix(".npz"), *a))
    write_shards(pt, reads, lambda p, *a: jax_write_pt(p.with_suffix(".pt"), *a))
    return fq, npz, pt


def _decompressed(path) -> bytes:
    with gzip.open(path, "rb") as fh:
        return fh.read()


@pytest.mark.parametrize("fmt", ["npz", "pt"])
@pytest.mark.parametrize("variant", VARIANTS, ids=lambda v: ",".join(f"{k}={w}" for k, w in v.items()) or "default")
def test_run_chop_matches_jax(planted, variant, fmt, tmp_path, monkeypatch):
    fq, npz, pt = planted
    shards = npz if fmt == "npz" else pt
    outputs = {}
    for who, run, opts in (("jax", jax_run_chop, _opts(JaxChopOptions, JaxChopType, variant)),
                           ("port", run_chop, _opts(ChopOptions, ChopType, variant))):  # fmt: skip
        (tmp_path / who).mkdir()
        monkeypatch.chdir(tmp_path / who)
        stats = run([shards], fq, opts)
        outputs[who] = (stats, Path(stats.output_file))
    (js, jf), (ps, pf) = outputs["jax"], outputs["port"]
    assert pf.name == jf.name and pf.parent == jf.parent == Path(".")
    assert (tmp_path / "port" / pf).exists()
    assert (ps.total_fq_count, ps.total_output_count, ps.predicts_loaded) == (
        js.total_fq_count, js.total_output_count, js.predicts_loaded)
    assert _decompressed(tmp_path / "port" / pf) == _decompressed(tmp_path / "jax" / jf)
    assert ps.total_output_count != ps.total_fq_count or variant  # the default run chops reads


def test_chop_from_another_directory_keeps_its_temp_file_beside_the_output(planted, tmp_path, monkeypatch):
    """No output prefix, run from a directory on another path than the
    input's: the temporary file is made in the current directory, where the
    output lands (so the final rename never crosses filesystems), none is
    left anywhere, and the bytes and name equal the JAX package's."""
    from deepchopper_tpu_torch.chop import pipeline

    fq, npz, _pt = planted
    opened: list[Path] = []

    def spy(path, **kw):
        opened.append(Path(path))
        return open_bgzf_writer(path, **kw)

    monkeypatch.setattr(pipeline, "open_bgzf_writer", spy)
    (tmp_path / "jax").mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    want = jax_run_chop([npz], fq, JaxChopOptions())
    cwd = tmp_path / "elsewhere" / "port"
    cwd.mkdir(parents=True)
    monkeypatch.chdir(cwd)
    got = run_chop([npz], fq, ChopOptions())
    assert fq.parent != cwd and len(opened) == 1
    assert opened[0].parent == cwd and opened[0].name.startswith(".deepchopper_temp_")
    assert got.output_file == want.output_file and (cwd / got.output_file).exists()
    assert _decompressed(cwd / got.output_file) == _decompressed(tmp_path / "jax" / want.output_file)
    assert not list(tmp_path.rglob(".deepchopper_temp_*")) and not list(fq.parent.rglob(".deepchopper_temp_*"))


def test_jax_reads_pt_shards_the_port_wrote(planted, tmp_path):
    """The other direction: `.pt` shards from the port's writer load in the
    JAX package as the port loads them."""
    _fq, npz, _pt = planted
    with np.load(sorted(npz.glob("*.npz"))[0]) as s:
        arrays = [s[k] for k in ("prediction", "target", "seq", "qual", "id")]
    port_predicts.write_prediction_shard_pt(tmp_path / "0_0.pt", *arrays)
    got = jax_load_pt(tmp_path / "0_0.pt")
    want = port_predicts.load_predicts_from_batch_pt(tmp_path / "0_0.pt")
    assert got.keys() == want.keys() and len(got) == 8
    for rid in got:
        a, b = got[rid], want[rid]
        assert (a.seq, a.id, a.is_truncated) == (b.seq, b.id, b.is_truncated)
        np.testing.assert_array_equal(a.prediction, b.prediction)


def _chunk_and_intervals(fq: Path, reads, seed: int):
    buf = np.frombuffer(fq.read_bytes(), np.uint8)
    spans, _ = native.fq_index(buf)
    rng = np.random.default_rng(seed)
    intervals = []
    for (_h, seq, _q, labels) in reads:
        regions = port_labels.smooth_label_region(labels)
        intervals.append((bool(rng.random() < 0.1), regions))
    return buf, spans, intervals


def test_native_plane_matches_jax_and_the_fallbacks(planted):
    fq, _npz, _pt = planted
    reads = make_reads()
    data = fq.read_bytes()
    buf = np.frombuffer(data, np.uint8)
    for cut, final in ((len(data), True), (len(data) // 2, False), (len(data) // 3 + 1, True)):
        part = data[:cut]
        try:
            want = jax_native.fq_index(np.frombuffer(part, np.uint8), final=final)
        except ValueError as exc:
            with pytest.raises(ValueError, match=str(exc)):
                native.fq_index(np.frombuffer(part, np.uint8), final=final)
            continue
        for spans, consumed in (native.fq_index(np.frombuffer(part, np.uint8), final=final), fq_index_py(part, final)):
            assert consumed == want[1]
            np.testing.assert_array_equal(spans, want[0])
    spans, _ = native.fq_index(buf)
    rows = np.array([5, 0, 17, 40, 33, 2, 9], np.int64)
    for width, max_len in ((1024, 32768), (512, 300)):
        outs = [(np.empty((7, width), np.int8), np.empty((7, width), np.uint8), np.empty(7, np.int32)) for _ in range(3)]
        jax_native.encode_spans_batch(buf, spans, rows, width, max_len, 1, 4, out=outs[0])
        native.encode_spans_batch(buf, spans, rows, width, max_len, 1, 4, out=outs[1])
        encode_spans_py(buf, spans, rows, width, max_len, outs[2])
        for got in outs[1:]:
            for a, b in zip(got, outs[0]):
                np.testing.assert_array_equal(a, b)
    labels = np.zeros((len(reads), 900), np.int8)
    lengths = np.array([len(r[3]) for r in reads], np.int64)
    for i, r in enumerate(reads):
        labels[i, : len(r[3])] = r[3]
    want = jax_vote(labels, lengths, 21)
    np.testing.assert_array_equal(native.majority_vote_batch(labels, lengths, 21), want)
    np.testing.assert_array_equal(port_labels.majority_voting_batch(labels.astype(np.int64), lengths, 21), want)
    for row in want[:10]:
        assert native.label_regions(row) == jax_native.label_regions(row) == port_labels.get_label_region(row)
    _buf, spans, intervals = _chunk_and_intervals(fq, reads, seed=1)
    args = [np.asarray([v for _t, iv in intervals for se in iv for v in se], np.int64),
            np.cumsum([0] + [len(iv) for _t, iv in intervals[:-1]]).astype(np.int64),
            np.asarray([len(iv) for _t, iv in intervals], np.int64),
            np.asarray([t for t, _iv in intervals], np.uint8)]  # fmt: skip
    for mode in ((0, 0, 1), (1, 0, 1), (0, 1, 1), (0, 2, 0)):
        ocq, chop_type, annotate = mode
        got = native.chop_records(buf, spans, *args, 150, 4, 20, bool(ocq), chop_type, bool(annotate))
        want = jax_native.chop_records(buf, spans, *args, 150, 4, 20, bool(ocq), chop_type, bool(annotate))
        assert got == want and got[1] > 0


@pytest.mark.parametrize("variant", VARIANTS[:4], ids=["default", "ocq", "terminal", "internal"])
def test_chop_chunk_native_matches_python_loop(planted, variant, monkeypatch):
    """`infer.fused._chop_chunk` through `native.chop_records` and through
    its Python loop (the native call made to decline) write the same bytes."""
    fq, _npz, _pt = planted
    reads = make_reads()
    out = {}
    for path in ("native", "python"):
        if path == "python":
            monkeypatch.setattr(native, "chop_records", lambda *a, **k: None)
        buf, spans, intervals = _chunk_and_intervals(fq, reads, seed=2)
        chunk = FastqChunk(0, buf, spans, 0, intervals)
        sink = _Sink()
        stats = FusedStats()
        _chop_chunk(chunk, _opts(ChopOptions, ChopType, variant), sink, stats)
        out[path] = (bytes(sink.data), stats.total_output_count)
    assert out["native"] == out["python"] and out["native"][1] > 0


class _Sink:
    def __init__(self):
        self.data = bytearray()

    def write(self, b) -> int:
        self.data += b
        return len(b)


@pytest.mark.parametrize("kind", ["zip", "zstd", "bgzf"])
def test_reader_matches_jax_on_zip_zstd_and_bgzf(planted, kind, tmp_path):
    fq, _npz, _pt = planted
    packed = tmp_path / f"reads.{kind}"
    if kind == "zip":
        with zipfile.ZipFile(packed, "w", zipfile.ZIP_DEFLATED) as zf:
            zf.write(fq, "reads.fq")
    elif kind == "zstd":
        if not jax_zstd.available():
            pytest.skip("libzstd is not available")
        packed.write_bytes(jax_zstd.compress(fq.read_bytes()))
    else:
        with open_bgzf_writer(packed, threads=2) as fh:
            fh.write(fq.read_bytes())
    got = [(r.id, r.seq, r.qual) for r in StreamingFastqReader(packed)]
    want = [(r.id, bytes(r.seq), bytes(r.qual)) for r in JaxFastqReader(packed)]
    assert len(got) == 48 and got == want


def test_reader_refuses_truncated_zstd_and_two_member_zip(planted, tmp_path):
    fq, _npz, _pt = planted
    if not jax_zstd.available():
        pytest.skip("libzstd is not available")
    data = jax_zstd.compress(fq.read_bytes())
    cut = tmp_path / "cut.zst"
    cut.write_bytes(data[: len(data) - 40])
    with pytest.raises(OSError, match="truncated zstd stream"):
        list(StreamingFastqReader(cut))
    two = tmp_path / "two.zip"
    with zipfile.ZipFile(two, "w") as zf:
        zf.writestr("a.fq", b"@a\nA\n+\nI\n")
        zf.writestr("b.fq", b"@b\nA\n+\nI\n")
    with pytest.raises(ValueError, match="exactly one file"):
        StreamingFastqReader(two)


def test_bgzf_writer_native_and_python_write_the_same_stream(planted, tmp_path, monkeypatch):
    fq, _npz, _pt = planted
    payload = fq.read_bytes() * 3  # > one 65280-byte block
    with open_bgzf_writer(tmp_path / "n.gz", threads=3) as fh:
        fh.write(payload)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    with open_bgzf_writer(tmp_path / "p.gz", threads=3) as fh:
        fh.write(payload)
    assert (tmp_path / "n.gz").read_bytes() == (tmp_path / "p.gz").read_bytes()
    assert _decompressed(tmp_path / "n.gz") == payload


def test_cli_chop_matches_jax(planted, tmp_path, monkeypatch):
    fq, npz, _pt = planted
    monkeypatch.chdir(tmp_path)
    want = jax_run_chop([npz], fq, JaxChopOptions(output_prefix="jax", chop_type=JaxChopType.TERMINAL))
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    res = subprocess.run(
        [sys.executable, "-m", "deepchopper_tpu_torch", "chop", str(npz), str(fq), "-o", "port", "--ct", "terminal"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300,
    )  # fmt: skip
    assert res.returncode == 0, res.stderr
    got = Path(want.output_file.replace("jax", "port", 1))
    assert got.name in res.stdout and got.exists()
    assert _decompressed(got) == _decompressed(want.output_file)


def test_predict_cli_matches_jax(planted, tmp_path):
    """`predict_cli`, the reference's knobs as arguments, over both shard
    formats at once and with knobs off their defaults."""
    fq, npz, pt = planted
    kw = dict(smooth_window_size=15, min_interval_size=20, max_process_intervals=3, min_read_length_after_chop=40)
    want = jax_predict_cli([npz, pt], fq, chop_type=JaxChopType.INTERNAL, output_prefix=str(tmp_path / "j"), **kw)
    got = predict_cli([npz, pt], fq, chop_type=ChopType.INTERNAL, output_prefix=str(tmp_path / "p"), **kw)
    assert Path(got.output_file).name[1:] == Path(want.output_file).name[1:]
    assert _decompressed(got.output_file) == _decompressed(want.output_file)
