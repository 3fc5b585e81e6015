"""The port's BAM IO and evaluation (`io/bam.py`, `eval/`, `eval-bam`) vs the
JAX package's, on the CPU.

BAMs are written by each package's own `BamWriter` from records encoded by
`encode_bam_record`; every comparison is exact (record fields, file bytes,
JSON bytes). The `eval-bam` case plants adapter intervals in hand-made
prediction shards so that every category of the overlap strategy is reached,
the BLAT ones through a stubbed `subprocess.run` that writes the PSL a real
`blat` would (no machine running these tests has the binary).
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import struct
import subprocess
from pathlib import Path

import numpy as np
import pytest

from deepchopper_tpu import cli as jax_cli
from deepchopper_tpu.eval import collect_statistics_for_predicts as jax_collect_statistics
from deepchopper_tpu.io import bam as jax_bam
from deepchopper_tpu.io.predicts import Predict as JaxPredict
from deepchopper_tpu_torch import cli, native
from deepchopper_tpu_torch.eval import collect_statistics_for_predicts
from deepchopper_tpu_torch.io import bam
from deepchopper_tpu_torch.io.predicts import Predict, pack_read_ids, write_prediction_shard, write_prediction_shard_pt

SA = b"SAZchr1,100,+,50M,60,0;chr2,5,-,40M,60,1;\x00"
OTHER_TAGS = b"NMi" + struct.pack("<i", 5) + b"ZBBs" + struct.pack("<I3h", 3, 1, 2, 3) + b"XZZhello\x00"


def _records(n: int, seed: int) -> list[tuple]:
    """Seeded encode_bam_record arguments: mapped and unmapped, both strands,
    secondary and supplementary flags, soft and hard clips, qualities or
    none, other tags before an SA tag on some."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        length = int(rng.integers(50, 400))
        flag = int(rng.choice([0, 4, 16, 256, 2048, 16 | 256]))
        left, right = (int(v) for v in rng.integers(0, 20, 2))
        cigar = [(left, "S"), (length - left - right, "M"), (right, "S")]
        if i % 7 == 3:
            cigar = [(5, "H"), *cigar, (3, "H")]
        cigar = [(k, op) for k, op in cigar if k] if flag != 4 else []
        qual = rng.integers(0, 60, length).astype(np.uint8).tobytes() if i % 5 else None
        tags = OTHER_TAGS * (i % 2) + (SA if i % 3 == 0 else b"")
        out.append((f"read_{i}", flag, int(rng.integers(0, 61)), cigar, length, qual, tags))
    return out


def _write(module, path: Path, records: list[tuple]) -> Path:
    with module.BamWriter(path, module.make_bam_header()) as writer:
        for args in records:
            writer.write_raw_block(module.encode_bam_record(*args))
    return path


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_bam_round_trip_between_packages(tmp_path, writer):
    records = _records(60, seed=1)
    w, r = (bam, jax_bam) if writer == "port" else (jax_bam, bam)
    path = _write(w, tmp_path / "a.bam", records)
    got = [dataclasses.asdict(rec) for rec in r.iter_bam_records(path)]
    want = [dataclasses.asdict(rec) for rec in w.iter_bam_records(path)]
    assert got == want and len(got) == 60
    assert sum(rec["sa_tag"] is not None for rec in got) == 20
    assert r.read_bam_header(path) == w.make_bam_header()
    other = _write(r, tmp_path / "b.bam", records)
    assert other.read_bytes() == path.read_bytes()


def test_soft_clips_and_sa_tag_equal_jax(tmp_path):
    for cigar in ("10S80M5S", "5H12S80M", "80M7S3H", "3H4S10M2I5D6S2H", "100M", "", "1D5M10S"):
        assert bam.left_right_soft_clip(cigar) == jax_bam.left_right_soft_clip(cigar)
    assert bam.left_right_soft_clip("3H4S10M6S2H") == (4, 6)
    # The reference's vectors (its bam.rs test_cigar_soft_clip).
    assert [bam.left_right_soft_clip(c) for c in ("5S10M5S", "5H10S5S", "10S5M1D")] == [(5, 5), (10, 5), (10, 0)]
    for bad in ("1D5M10S5A", "10S5"):
        with pytest.raises(ValueError):
            jax_bam.left_right_soft_clip(bad)
        with pytest.raises(ValueError):
            bam.left_right_soft_clip(bad)
    records = [
        ("fwd", 0, 60, [(10, "S"), (80, "M"), (5, "S")], 95, None, OTHER_TAGS + SA),
        ("rev", 16, 60, [(10, "S"), (80, "M"), (5, "S")], 95, None, SA + OTHER_TAGS),
        ("no_sa", 16, 60, [(5, "H"), (9, "S"), (86, "M")], 95, None, OTHER_TAGS),
    ]
    path = _write(bam, tmp_path / "c.bam", records)
    got = bam.read_bam_records(path)
    assert got == {k: bam.BamRecord(**dataclasses.asdict(v)) for k, v in jax_bam.read_bam_records(path).items()}
    assert (got["fwd"].left_softclip, got["fwd"].right_softclip) == (10, 5)
    assert (got["rev"].left_softclip, got["rev"].right_softclip) == (5, 10)  # swapped on the reverse strand
    assert got["fwd"].sa_tag == got["rev"].sa_tag == SA[3:-1].decode() and got["no_sa"].sa_tag is None
    assert (got["no_sa"].left_softclip, got["no_sa"].right_softclip) == (0, 9)


def test_native_reader_equals_gzip(tmp_path, monkeypatch):
    if not native.available():
        pytest.skip("the native host library is unavailable")
    path = _write(bam, tmp_path / "big.bam", _records(3000, seed=2))
    assert path.stat().st_size > 1 << 18  # several BGZF blocks
    via_native = list(bam.iter_bam_raw_blocks(path, threads=3))
    monkeypatch.setattr(native, "available", lambda: False)
    via_gzip = list(bam.iter_bam_raw_blocks(path))
    assert via_native == via_gzip and len(via_gzip) == 3000
    assert bam.read_bam_records_parallel(path) == bam.read_bam_records(path)


# -- statistics ------------------------------------------------------------------


def _predicts(seed: int) -> list[tuple[str, np.ndarray, str, bool]]:
    """(id, labels, seq, truncated) with 0-5 planted adapter runs, ~2% of
    labels flipped, some reads below MIN_READ_LEN, some truncated."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(80):
        n = int(rng.integers(60, 900))
        labels = np.zeros(n, np.int8)
        for _ in range(int(rng.integers(0, 6))):
            s = int(rng.integers(0, n))
            labels[s : s + int(rng.integers(5, 80))] = 1
        flip = rng.random(n) < 0.02
        labels[flip] = 1 - labels[flip]
        seq = "".join(rng.choice(list("ACGTA"), n))
        out.append((f"r{i}", labels, seq, bool(rng.random() < 0.2)))
    return out


@pytest.mark.parametrize("threads", [None, 4])
def test_collect_statistics_json_equals_jax(threads):
    rows = _predicts(seed=3) * 2  # 160 predicts: above the 64 that starts the thread pool
    ours = collect_statistics_for_predicts([Predict(lab, seq, rid, tr) for rid, lab, seq, tr in rows], threads=threads)
    theirs = jax_collect_statistics([JaxPredict(lab, seq, rid, tr) for rid, lab, seq, tr in rows], threads=threads)
    assert ours.to_json() == theirs.to_json()
    assert repr(ours) == repr(theirs) and ours.total_predicts > 0 and ours.smooth_only_one_with_ploya
    for q in ("length_predicts_with_chop", "number_smooth_predicts_with_chop"):
        assert getattr(ours, q)() == getattr(theirs, q)()
    assert ours.selected_predict_by_intervals(2) == theirs.selected_predict_by_intervals(2)


# -- eval-bam --------------------------------------------------------------------

N = 300
MIN_MAPQ = 10
# (read id, adapter intervals, base of the adapter, BAM record (flag, mapq,
# cigar) or None for a read the BAM lacks). The stubbed BLAT answers by the
# adapter's base: G aligns (identity 1.0), T aligns poorly (0.3), C fails.
PLAN = [
    ("unmapped", [(100, 140)], "G", (4, 0, [])),
    ("secondary", [(100, 140)], "G", (256, 60, [(N, "M")])),
    ("supplementary", [(100, 140)], "G", (2048, 60, [(N, "M")])),
    ("low_mapq", [(100, 140)], "G", (0, 5, [(N, "M")])),
    ("sc_no_chop", [], "G", (0, 60, [(30, "S"), (N - 30, "M")])),
    ("no_sc_no_chop", [], "G", (0, 60, [(N, "M")])),
    ("terminal_sc", [(280, 300)], "G", (0, 60, [(N - 25, "M"), (25, "S")])),
    ("terminal_short", [(285, 300)], "G", (0, 60, [(N, "M")])),
    ("terminal_fail", [(270, 300)], "C", (0, 60, [(N, "M")])),
    ("terminal_poor", [(270, 300)], "T", (0, 60, [(N, "M")])),
    ("terminal_aligned", [(270, 300)], "G", (0, 60, [(N, "M")])),
    ("internal_left_sa", [(10, 50)], "G", (0, 60, [(45, "S"), (N - 45, "M")])),
    ("internal_right_rev", [(200, 260)], "G", (16, 60, [(110, "S"), (N - 110, "M")])),
    ("internal_short", [(100, 115)], "G", (0, 60, [(N, "M")])),
    ("internal_fail", [(100, 140)], "C", (0, 60, [(N, "M")])),
    ("internal_poor", [(100, 140)], "T", (0, 60, [(N, "M")])),
    ("internal_aligned", [(100, 140)], "G", (0, 60, [(N, "M")])),
    ("two_kinds", [(40, 80), (275, 300)], "T", (0, 60, [(N, "M")])),
    ("no_process", [(20, 35), (60, 75), (100, 115), (140, 155), (180, 195)], "G", (0, 60, [(N, "M")])),
    ("missing", [(100, 140)], "G", None),
]
CATEGORIES = {
    "unmapped_read", "secondary_or_supp_read", "low_mp_read", "sc_without_chop", "terminal_chop_sc",
    "terminal_chop_nosc", "terminal_chop_nosc_cannot_blat", "terminal_chop_nosc_blat_fail",
    "terminal_chop_nosc_noblat", "internal_chop_sc", "internal_chop_sc_sa", "internal_chop_nosc",
    "internal_chop_nosc_cannot_blat", "internal_chop_nosc_blat_fail", "internal_chop_nosc_noblat", "no_process",
    "missing_bam_record",
}  # fmt: skip
TOKEN = {"A": 7, "C": 8, "G": 9, "T": 10}


def _eval_inputs(root: Path) -> tuple[Path, Path, Path]:
    """The planned BAM, and the same shards as npz and as pt (two batches, the
    second one wider and one read short of the first's padding)."""
    rows = []
    for rid, intervals, base, _ in PLAN:
        seq = np.full(N, TOKEN["A"], np.int64)
        logits = np.zeros((N, 2), np.float32)
        logits[:, 0] = 1.0
        for s, e in intervals:
            seq[s:e] = TOKEN[base]
            logits[s:e, 1] = 2.0
        rows.append((rid, seq, logits))
    records = [(rid, flag, mapq, cigar, N, None, SA if rid == "internal_left_sa" else b"")
               for (rid, _i, _b, rec) in PLAN if rec is not None for flag, mapq, cigar in [rec]]  # fmt: skip
    bam_path = _write(bam, root / "reads.bam", records)
    for fmt, write in (("npz", write_prediction_shard), ("pt", write_prediction_shard_pt)):
        for b, (lo, hi, width) in enumerate(((0, 10, N), (10, len(rows), N + 24))):
            part = rows[lo:hi]
            logits = np.zeros((len(part), width, 2), np.float32)
            seq = np.full((len(part), width), 4, np.int64)
            target = np.full((len(part), width), -100, np.int64)
            for i, (_rid, s, lg) in enumerate(part):
                logits[i, :N], seq[i, :N], target[i, :N] = lg, s, 0
            ids = pack_read_ids([r[0] for r in part], [r[0] == "terminal_aligned" for r in part])
            write(root / fmt / "0" / f"0_{b}.{fmt}", logits, target, seq, np.zeros(target.shape), ids)
    return bam_path, root / "npz", root / "pt"


def _fake_blat(cmd, capture_output=True, text=True):
    """Stands in for the `blat` binary: reads the query FASTA, writes a PSL."""
    fa, psl = Path(cmd[-2]), Path(cmd[-1])
    seq = fa.read_text().splitlines()[1]
    if seq[0] == "C":
        return subprocess.CompletedProcess(cmd, 1, "", "blat: cannot open genome")
    match = len(seq) if seq[0] == "G" else int(0.3 * len(seq))
    header = "psLayout version 3\n\nmatch\tmis-\n \tmatch\n---------\n"
    cols = [match, 0, 0, 0, 0, 0, 0, 0, "+", "seq", len(seq), 0, len(seq), "chr1", 1000, 10, 10 + len(seq)]
    psl.write_text(header + "\t".join(str(c) for c in cols) + "\n")
    return subprocess.CompletedProcess(cmd, 0, "", "")


def _run(main, argv: list[str]) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


def _outputs(out: Path) -> dict[str, bytes]:
    return {p.name: p.read_bytes() for p in sorted(out.glob("*.json"))}


def test_eval_bam_equals_jax_over_npz_and_pt(tmp_path, monkeypatch):
    bam_path, npz, pt = _eval_inputs(tmp_path)
    monkeypatch.setattr(subprocess, "run", _fake_blat)
    flags = ["--blat-cli", "blat", "--hg38-2bit", "hg38.2bit", "--min-mapping-quality", str(MIN_MAPQ)]
    got = {}
    for side, main in (("port", cli.main), ("jax", jax_cli.main)):
        for fmt, shards in (("npz", npz), ("pt", pt)):
            out = tmp_path / f"{side}_{fmt}"
            printed = _run(main, ["eval-bam", str(bam_path), str(shards), "--output-dir", str(out), *flags])
            got[side, fmt] = (printed, _outputs(out))
    want = got["jax", "npz"]
    assert got["port", "npz"] == got["port", "pt"] == got["jax", "pt"] == want
    names = sorted(want[1])
    assert names == [f"overlap_results_spd18_pd{len(PLAN)}.json", f"stats_pd{len(PLAN)}_bt0.json"], names
    results = json.loads(want[1][names[0]])
    assert set(results) == CATEGORIES
    assert results["missing_bam_record"] == ["missing"] and results["no_process"] == ["no_process"]
    assert results["internal_chop_sc"] == ["internal_left_sa", "internal_right_rev"]
    assert results["internal_chop_sc_sa"] == ["internal_left_sa"]
    assert results["terminal_chop_nosc_noblat"] == ["terminal_poor", "two_kinds"]
    assert "terminal_aligned" in results["terminal_chop_nosc"] and "sc_without_chop" in printed
    assert json.loads(want[1][names[1]])["total_truncated"] == 1

    # Control: the same run over a BAM that also lacks `sc_no_chop` differs.
    monkeypatch.setattr(subprocess, "run", _fake_blat)
    fewer = [(rid, flag, mapq, cigar, N, None, SA if rid == "internal_left_sa" else b"")
             for (rid, _i, _b, rec) in PLAN if rec is not None and rid != "sc_no_chop"
             for flag, mapq, cigar in [rec]]  # fmt: skip
    control = _write(bam, tmp_path / "fewer.bam", fewer)
    _run(cli.main, ["eval-bam", str(control), str(npz), "--output-dir", str(tmp_path / "control"), *flags])
    assert _outputs(tmp_path / "control")[names[0]] != want[1][names[0]]


def test_eval_bam_without_blat_equals_jax(tmp_path):
    bam_path, npz, _ = _eval_inputs(tmp_path)
    outs = []
    for side, main in (("port", cli.main), ("jax", jax_cli.main)):
        printed = _run(main, ["eval-bam", str(bam_path), str(npz), "--output-dir", str(tmp_path / side)])
        outs.append((printed, _outputs(tmp_path / side)))
    assert outs[0] == outs[1]
    results = json.loads(next(v for k, v in outs[0][1].items() if k.startswith("overlap")))
    assert "terminal_chop_nosc_blat_fail" in results and "low_mp_read" not in results
