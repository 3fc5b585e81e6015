"""The port's host tools vs the JAX package's, on the CPU: the `tools`
subtools and `stat` through each package's CLI, the tensor encoder, dataset
assembly, the FASTQ writers, the k-mer, quality and sequence helpers, and
the top-level exports.

Inputs come from a numpy seed (`data/synth.py`, hand-made chopped ids, BAMs
from the port's `BamWriter`). Each CLI run works in a copy of the same input
directory of its own, so stdout, stderr and every file left in the directory
are compared byte for byte. Arrays are compared exactly.
"""

from __future__ import annotations

import contextlib
import io
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import deepchopper_tpu as jax_pkg
from deepchopper_tpu import cli as jax_cli
from deepchopper_tpu import errors as jax_errors
from deepchopper_tpu import ops as jax_ops
from deepchopper_tpu.data import assembly as jax_assembly
from deepchopper_tpu.data import tensor_encoder as jax_tensor_encoder
from deepchopper_tpu.io import chop as jax_chop
from deepchopper_tpu.io import fastq as jax_fastq
from deepchopper_tpu_torch import cli, ops
from deepchopper_tpu_torch.data import assembly, tensor_encoder
from deepchopper_tpu_torch.data.synth import synth_fastq, synth_labelled_fastq
from deepchopper_tpu_torch.io import bam, fastq
from deepchopper_tpu_torch.io import chop as port_chop
from deepchopper_tpu_torch.io.predicts import pack_read_ids, write_prediction_shard

REPO = Path(__file__).resolve().parent.parent
SA2 = b"SAZchr1,100,+,50M,60,0;chr2,5,-,40M,60,1;\x00"
SA1 = b"SAZchr3,7,+,30M,60,0;\x00"


def _fq(path: Path, records: list[tuple[str, bytes]]) -> Path:
    with open(path, "wb") as fh:
        for name, seq in records:
            fh.write(b"@" + name.encode() + b"\n" + seq + b"\n+\n" + bytes(33 + (i % 40) for i in range(len(seq))) + b"\n")
    return path


def _bam(path: Path, records: list[tuple]) -> Path:
    with bam.BamWriter(path, bam.make_bam_header()) as writer:
        for args in records:
            writer.write_raw_block(bam.encode_bam_record(*args))
    return path


@pytest.fixture(scope="module")
def inputs(tmp_path_factory) -> Path:
    """One directory holding every subtool's inputs."""
    root = tmp_path_factory.mktemp("inputs")
    rng = np.random.default_rng(21)
    lengths = rng.integers(100, 600, 24)
    orig = synth_fastq(root / "orig.fq", lengths, seed=21)
    reads = [(r.name, r.seq) for r in fastq.StreamingFastqReader(orig)]
    chopped = []
    for i, (name, seq) in enumerate(reads):
        if i % 4 == 0:
            chopped.append((name, seq))
        elif i % 4 == 1:
            chopped.append((f"{name}|0:60|T", seq[:60]))
        elif i % 4 == 2:
            chopped += [(f"{name}|0:40|I", seq[:40]), (f"{name}|70:{len(seq) - 1}|I", seq[70:-1])]
    _fq(root / "chopped.fq", chopped)
    _fq(root / "replacement.fq", [(name, seq[::-1]) for name, seq in reads[::5]])
    (root / "reads.fa").write_bytes(b"".join(b">" + n.encode() + b"\n" + s[:70] + b"\n" + s[70:] + b"\n"
                                             for n, s in reads[:9]))  # fmt: skip

    def record(qname: str, i: int, n: int, clip: int) -> tuple:
        flag = (0, 16, 256, 2048, 4)[i % 5]
        cigar = [] if flag == 4 else [(clip, "S"), (n - clip, "M")] if clip else [(n, "M")]
        tags = (SA2, SA1, b"")[i % 3]
        return (qname, flag, 10 + i, cigar, n, None, tags)

    _bam(root / "orig.bam", [record(n, i, len(s), 5 * (i % 4)) for i, (n, s) in enumerate(reads)])
    _bam(root / "chopped.bam", [record(n, i, len(s), 3 * (i % 3)) for i, (n, s) in enumerate(chopped)])
    psl = ["psLayout version 3", "", "match", "header", "---"]
    for q in range(6):
        for hit in range(q % 3 + 1):
            qsize = 40 + q
            psl.append("\t".join(str(c) for c in (qsize - 3 * hit - q, 0, 0, 0, 0, 0, 0, 0, "+", f"q{q}", qsize, 0,
                                                   qsize, "chr1", 1000, 5, 5 + qsize)))  # fmt: skip
    (root / "hits.psl").write_text("\n".join(psl) + "\n")

    # Shards for blat-predictions: 6 reads, adapters planted in 4 of them.
    width = 200
    logits = np.zeros((6, width, 2), np.float32)
    logits[..., 0] = 1.0
    for i, (s, e) in enumerate(((20, 60), (100, 150), (10, 30), (120, 190))):
        logits[i, s:e, 1] = 2.0
    seq = np.asarray(rng.integers(7, 11, (6, width)), np.int64)
    seq[3, 120:190] = 9  # all G: the stubbed blat aligns it
    names = [reads[i][0] for i in range(6)]
    write_prediction_shard(root / "shards" / "0" / "0_0.npz", logits, np.zeros((6, width), np.int64), seq,
                           np.zeros((6, width)), pack_read_ids(names, [False] * 6))  # fmt: skip
    (root / "selected.txt").write_text(f"{names[0]}\n{names[3]} extra\n{names[5]}\n")
    return root


def _fake_blat(cmd, capture_output=True, text=True):
    """Stands in for the `blat` binary on a FASTA of several queries."""
    fa, psl = Path(cmd[-2]), Path(cmd[-1])
    lines = fa.read_text().splitlines()
    rows = ["psLayout version 3", "", "match", "header", "---"]
    for name, seq in zip(lines[::2], lines[1::2]):
        match = len(seq) if set(seq) == {"G"} else len(seq) // 3
        rows.append("\t".join(str(c) for c in (match, 0, 0, 0, 0, 0, 0, 0, "+", name[1:], len(seq), 0, len(seq),
                                               "chr1", 1000, 1, 1 + len(seq))))  # fmt: skip
    psl.write_text("\n".join(rows) + "\n")
    return subprocess.CompletedProcess(cmd, 0, "", "")


def _run(main, argv: list[str]) -> tuple[int, bytes, str]:
    raw = io.BytesIO()
    out = io.TextIOWrapper(raw, encoding="utf-8", write_through=True)
    err = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    out.flush()
    return rc, raw.getvalue(), err.getvalue()


def _both(tmp_path: Path, inputs: Path, argv: list[str], monkeypatch) -> tuple:
    """Run argv through each CLI in its own copy of `inputs`; returns the two
    (rc, stdout, stderr, {file: bytes}) and the port's directory."""
    results = []
    for side, main in (("port", cli.main), ("jax", jax_cli.main)):
        work = shutil.copytree(inputs, tmp_path / side)
        monkeypatch.chdir(work)
        rc, out, err = _run(main, argv)
        files = {str(p.relative_to(work)): p.read_bytes() for p in sorted(work.rglob("*")) if p.is_file()}
        results.append((rc, out, err, files))
    return results[0], results[1], tmp_path / "port"


SUBTOOLS = {
    "fq2fa": ["fq2fa", "chopped.fq"],
    "fqsearch": ["fqsearch", "orig.fq", "--id", "read_1", "--min-len", "150", "--max-len", "500"],
    "select": ["select", "chopped.fq", "--type", "terminal"],
    "select-to-file": ["select", "chopped.fq", "--type", "internal", "-o", "internal.fq.gz"],
    "diff": ["diff", "orig.fq", "chopped.fq"],
    "chimericstat": ["chimericstat", "orig.bam"],
    "sa": ["sa", "orig.bam"],
    "scdiff": ["scdiff", "orig.bam", "chopped.bam"],
    "replacefq": ["replacefq", "orig.fq", "replacement.fq", "replaced.fq.gz"],
    "replacebam": ["replacebam", "--dcbam", "chopped.bam", "--dobam", "orig.bam", "-o", "replaced.bam", "-t", "2"],
    "psl-top1": ["psl-top1", "hits.psl"],
    "blat-predictions": ["blat-predictions", "shards", "-p", "all_", "-s", "5", "--mis", "10"],
    "blat-predictions-selected": ["blat-predictions", "shards/0", "-p", "sel_", "--sr", "selected.txt", "--fq",
                                  "orig.fq", "--blat-cli", "blat", "--hg38-2bit", "hg38.2bit"],  # fmt: skip
    "encode-smoke": ["encode-smoke", "orig.fq", "--max-reads", "15"],
}


@pytest.mark.parametrize("case", list(SUBTOOLS))
def test_tools_equal_jax(tmp_path, inputs, case, monkeypatch):
    monkeypatch.setattr(subprocess, "run", _fake_blat)
    ours, theirs, work = _both(tmp_path, inputs, ["tools", *SUBTOOLS[case]], monkeypatch)
    assert ours == theirs
    rc, out, err, files = ours
    assert rc == 0 and (out or err)
    made = {"select-to-file": "internal.fq.gz", "replacefq": "replaced.fq.gz", "replacebam": "replaced.bam",
            "blat-predictions": "all_all_predicts_seq.fa", "blat-predictions-selected": "sel_predicts_base_quals.json"}
    assert case not in made or made[case] in files
    if case == "replacebam":
        assert b"replaced 12 internal records" in out and len(bam.read_bam_records(work / "replaced.bam")) == 30
    if case == "blat-predictions-selected":
        assert b"'n_aligned': 2" in out and "sel_all_predicts_blat_identities.json" in files


@pytest.mark.parametrize("name", ["orig.fq", "orig.fq.gz", "reads.fa", "orig.bam"])
def test_stat_equal_jax(tmp_path, inputs, name, monkeypatch):
    if name.endswith(".gz"):
        inputs = shutil.copytree(inputs, tmp_path / "in")
        fastq.write_fq_parallel(fastq.StreamingFastqReader(inputs / "orig.fq"), inputs / name)
    ours, theirs, _ = _both(tmp_path, inputs, ["stat", name], monkeypatch)
    assert ours == theirs
    lens = {"orig.fq": 24, "orig.fq.gz": 24, "reads.fa": 9, "orig.bam": 24}[name]
    assert ours[1].startswith(f"{name}: n={lens} min=".encode())
    from deepchopper_tpu.utils import stat as jax_stat
    from deepchopper_tpu_torch.utils import stat

    assert stat.summary_record_len(inputs / name) == jax_stat.summary_record_len(inputs / name)


# -- tensor encoder and assembly -------------------------------------------------


@pytest.fixture(scope="module")
def encoder_fqs(tmp_path_factory) -> list[Path]:
    """Reads with a target region in their ids or none (one region row each:
    the encoder stacks every read's rows), lowercase and N bases, and one
    read shorter than k."""
    root = tmp_path_factory.mktemp("enc")
    rng = np.random.default_rng(31)
    out = []
    for f, n_reads in enumerate((12, 7)):
        records = []
        for i in range(n_reads):
            n = int(rng.integers(40, 160 + 80 * f))
            seq = bytearray(rng.choice(list(b"ACGTacgtN"), n).astype(np.uint8).tobytes())
            spans = sorted(int(v) for v in rng.integers(0, n - 3, 2 * (i % 2)))
            name = f"r{f}_{i}" + ("|" + "-".join(f"{a}:{b + 3}" for a, b in zip(spans[::2], spans[1::2])) if spans else "")
            records.append((name, bytes(seq)))
        records.append((f"short{f}", b"AC"))
        out.append(_fq(root / f"e{f}.fq", records))
    return out


@pytest.mark.parametrize("vectorized", [True, False])
@pytest.mark.parametrize("multi", [False, True])
def test_tensor_encoder_arrays_equal_jax(encoder_fqs, vectorized, multi):
    kw = dict(kmer_size=3, vectorized_target=vectorized)
    if multi:
        got = tensor_encoder.encode_fq_paths_to_tensor(encoder_fqs, parallel=True, **kw)
        want = jax_tensor_encoder.encode_fq_paths_to_tensor(encoder_fqs, parallel=True, **kw)
    else:
        got = tensor_encoder.encode_fq_path_to_tensor(encoder_fqs[0], max_width=200, **kw)
        want = jax_tensor_encoder.encode_fq_path_to_tensor(encoder_fqs[0], max_width=200, **kw)
    for a, b in zip(got[:3], want[:3]):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert got[3] == want[3] and len(got[3]) == 125
    assert got[0].shape[0] == (19 if multi else 12)


def test_tensor_encoder_class_equal_jax(encoder_fqs):
    ours = tensor_encoder.TensorEncoder(tensor_encoder.FqEncoderOption(kmer_size=4, bases="ACGTN", threads=3))
    theirs = jax_tensor_encoder.TensorEncoder(jax_tensor_encoder.FqEncoderOption(kmer_size=4, bases="ACGTN", threads=3))
    for path in encoder_fqs:  # the second, longer file widens the outputs
        (gi, gt), gq = ours.encode(path)
        (wi, wt), wq = theirs.encode(path)
        for a, b in ((gi, wi), (gt, wt), (gq, wq)):
            np.testing.assert_array_equal(a, b)
        assert (ours.tensor_max_width, ours.tensor_max_seq_len) == (theirs.tensor_max_width, theirs.tensor_max_seq_len)
    rec = tensor_encoder.RecordData.new("r|2:9", "acgtnACGT", "IIIIIIIII")
    assert rec == tensor_encoder.RecordData(**vars(jax_tensor_encoder.RecordData.new("r|2:9", "acgtnACGT", "IIIIIIIII")))
    np.testing.assert_array_equal(ours.kmer_ids(rec.seq), theirs.kmer_ids(rec.seq))


ASSEMBLY = {
    "collect_and_split_dataset": ("internal", "terminal", "negative"),
    "collect_and_split_dataset_with_natural_terminal_adapters": ("internal", "terminal", "natural", "negative"),
    "collect_and_split_dataset_with_natural_terminal_adapters_and_both_adapters": (
        "internal", "terminal", "natural", "both", "negative"),
}  # fmt: skip


@pytest.fixture(scope="module")
def pools(tmp_path_factory) -> dict[str, Path]:
    root = tmp_path_factory.mktemp("pools")
    lengths = np.random.default_rng(41).integers(100, 300, 30)
    return {name: synth_labelled_fastq(root / f"{name}.fq", lengths, seed=41 + i)
            for i, name in enumerate(("internal", "terminal", "natural", "both", "negative"))}  # fmt: skip


@pytest.mark.parametrize("skip_quirk", [False, True])
@pytest.mark.parametrize("fn", list(ASSEMBLY))
def test_assembly_files_equal_jax(tmp_path, pools, fn, skip_quirk):
    paths = [pools[name] for name in ASSEMBLY[fn]]
    outs = []
    for side, module in (("port", assembly), ("jax", jax_assembly)):
        got = getattr(module, fn)(*paths, 45, prefix="_s", output_dir=tmp_path / side, skip_quirk=skip_quirk)
        outs.append([(p.name, p.read_bytes()) for p in got])
    assert outs[0] == outs[1]
    assert [name for name, _ in outs[0]] == ["train_s.fq", "val_s.fq", "test_s.fq"] and outs[0][0][1].count(b"\n+\n") > 20


# -- FASTQ writers and helpers ---------------------------------------------------


@pytest.mark.parametrize("writer", ["write_fq", "write_fq_parallel", "write_fq_auto_gz", "write_fq_auto_plain",
                                    "convert_multiple_fqs_to_one_fq", "read_fastq_records"])  # fmt: skip
def test_fastq_writers_equal_jax(tmp_path, inputs, writer):
    outs = []
    for side, module in (("port", fastq), ("jax", jax_fastq)):
        out = tmp_path / side / ("out.fq.gz" if writer in ("write_fq_parallel", "write_fq_auto_gz",
                                                          "convert_multiple_fqs_to_one_fq") else "out.fq")  # fmt: skip
        out.parent.mkdir()
        records = module.read_fastq_records(inputs / "chopped.fq")
        if writer == "read_fastq_records":
            outs.append(b"".join(r.to_bytes() for r in records))
            continue
        if writer == "convert_multiple_fqs_to_one_fq":
            module.convert_multiple_fqs_to_one_fq([inputs / "orig.fq", inputs / "chopped.fq"], out)
        else:
            getattr(module, writer.replace("_gz", "").replace("_plain", ""))(records, out)
        outs.append(out.read_bytes())
    assert outs[0] == outs[1] and len(outs[0]) > 100


def test_split_records_by_remove_interval_equals_jax():
    rng = np.random.default_rng(51)
    for i in range(60):
        n = int(rng.integers(30, 300))
        seq = rng.choice(list(b"ACGT"), n).astype(np.uint8).tobytes()
        qual = rng.integers(33, 75, n).astype(np.uint8).tobytes()
        cuts = sorted(int(v) for v in rng.integers(0, n, 2 * int(rng.integers(0, 4))))
        intervals = [(a, b) for a, b in zip(cuts[::2], cuts[1::2])]
        args = (seq.decode() if i % 2 else seq, f"r{i}", qual, intervals, int(rng.integers(1, 30)), bool(i % 3))
        got = port_chop.split_records_by_remove_interval(*args)
        assert [r.to_bytes() for r in got] == [r.to_bytes() for r in jax_chop.split_records_by_remove_interval(*args)]


def _same(got_fn, want_fn, *args, **kwargs):
    """Both calls' results equal, or both raise the same error type by name
    and message."""
    try:
        want = want_fn(*args, **kwargs)
    except Exception as exc:  # noqa: BLE001 - the port must raise the same
        with pytest.raises(Exception) as info:
            got_fn(*args, **kwargs)
        assert (type(info.value).__name__, str(info.value)) == (type(exc).__name__, str(exc))
        return None
    got = got_fn(*args, **kwargs)
    if isinstance(want, tuple) and any(isinstance(w, np.ndarray) for w in want):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
            assert np.asarray(a).dtype == np.asarray(b).dtype
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    elif isinstance(want, tuple) and want and isinstance(want[0], list):  # summary_predict
        for ga, wa in zip(got, want):
            for a, b in zip(ga, wa):
                np.testing.assert_array_equal(a, b)
    else:
        assert got == want
    return want


HELPERS = ["seq_to_kmers", "kmers_to_seq", "seq_to_kmers_and_offset", "generate_kmers", "kmerids_to_seq",
           "to_kmer_target_region", "to_original_targtet_region", "encode_qual_kmer", "splite_qual_by_offsets",
           "reverse_complement", "id_list2seq", "normalize_seq", "summary_predict", "vectorize_target"]  # fmt: skip


@pytest.mark.parametrize("helper", HELPERS)
def test_host_helpers_equal_jax(helper):
    rng = np.random.default_rng(abs(hash(helper)) % 1000)
    got_fn, want_fn = getattr(ops, helper), getattr(jax_ops, helper)
    results = []
    for trial in range(25):
        n = int(rng.integers(0, 40))
        seq = "".join(rng.choice(list("ACGTNacgtuURYKM"), n))
        k = int(rng.integers(0, 6))
        if helper in ("seq_to_kmers", "seq_to_kmers_and_offset"):
            args = (seq, k, bool(trial % 2))
        elif helper == "kmers_to_seq":
            args = ([seq[i : i + 3] for i in range(max(n - 2, 0))] + ([""] if trial % 5 == 4 else []),)
        elif helper == "generate_kmers":
            args = ("ACGTN"[: 2 + trial % 4], trial % 4)
        elif helper == "kmerids_to_seq":
            table = {i: km for i, km in enumerate(jax_ops.generate_kmers("ACG", 2))}
            args = (rng.integers(0, 9 + trial % 3, n), table)
        elif helper in ("to_kmer_target_region", "to_original_targtet_region"):
            s, e = (int(v) for v in rng.integers(0, 50, 2))
            args = ((s, e), k) if helper == "to_original_targtet_region" else ((s, e), k, 40 if trial % 3 else None)
        elif helper == "encode_qual_kmer":
            args = (rng.integers(33, 127, n).astype(np.uint8).tobytes(), k, 33 + trial % 2)
        elif helper == "splite_qual_by_offsets":
            cuts = sorted(int(v) for v in rng.integers(0, n + 1, 8))
            args = (rng.integers(0, 60, n), list(zip(cuts[::2], cuts[1::2])))
        elif helper in ("reverse_complement",):
            args = (seq,)
        elif helper == "normalize_seq":
            args = (seq, bool(trial % 2))
        elif helper == "id_list2seq":
            args = (rng.integers(-3, 15, n),)
        elif helper == "summary_predict":
            labels = [np.where(rng.random(n) < 0.3, -100, rng.integers(0, 2, n)) for _ in range(3)]
            args = ([rng.integers(0, 2, n) for _ in range(3)], labels)
        else:  # vectorize_target
            s, e = (int(v) for v in rng.integers(0, 50, 2))
            args = (s, e, 40)
        results.append(_same(got_fn, want_fn, *args))
    assert any(r is not None for r in results)


def test_error_types_match_jax():
    for name in ("EncodingError", "TargetRegionInvalid", "SeqShorterThanKmer", "InvalidInterval", "InvalidKmerId",
                 "QualSeqLengthMismatch"):  # fmt: skip
        from deepchopper_tpu_torch import errors

        ours, theirs = getattr(errors, name), getattr(jax_errors, name)
        assert [c.__name__ for c in ours.__mro__] == [c.__name__ for c in theirs.__mro__]


# -- top-level exports -----------------------------------------------------------


def test_top_level_all_equals_jax_and_resolves():
    import deepchopper_tpu_torch as port

    assert set(port.__all__) == set(jax_pkg.__all__) and len(port.__all__) == 71
    for name in port.__all__:
        value = getattr(port, name)
        assert type(value).__name__ == type(getattr(jax_pkg, name)).__name__, name
        assert getattr(value, "__name__", name).split(".")[-1] == getattr(getattr(jax_pkg, name), "__name__", name).split(".")[-1]
    with pytest.raises(AttributeError):
        port.no_such_name  # noqa: B018


@pytest.mark.parametrize("package", ["ops", "io", "data", "eval", "utils"])
def test_subpackage_exports_equal_jax(package):
    import importlib

    ours = importlib.import_module(f"deepchopper_tpu_torch.{package}")
    theirs = importlib.import_module(f"deepchopper_tpu.{package}")
    # The JAX compilation cache has no counterpart in a PyTorch package.
    assert set(ours.__all__) == set(theirs.__all__) - {"enable_compilation_cache"}
    for name in ours.__all__:
        assert type(getattr(ours, name)).__name__ == type(getattr(theirs, name)).__name__, name


def test_import_pulls_in_no_kernel_wrapper_nor_pyarrow():
    code = (
        "import sys\n"
        "import deepchopper_tpu_torch as d\n"
        "banned = lambda: sorted(m for m in sys.modules if m == 'pyarrow' or m.startswith(('pyarrow.', 'jax'))\n"
        "                       or m.startswith('deepchopper_tpu_torch.ops.') and m.split('.')[-1] not in\n"
        "                       ('kmer', 'labels', 'qual', 'sequence'))\n"
        "assert not banned() and 'torch' not in sys.modules, banned()\n"
        "[getattr(d, n) for n in d.__all__]\n"
        "assert not banned(), banned()\n"
        "print('ok', len(d.__all__))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok 71", res.stderr
