"""The traffic generator: repeatable by seed, one length set for every seed,
the mix's distribution, planted adapters where the ids say."""

from __future__ import annotations

import numpy as np

from benchmark.harness.spec import BENCH, load_json
from benchmark.harness.traffic import length_set, make_reads, widths_reached

DRNA = load_json(BENCH / "traffic" / "drna.json")
LABELLED = load_json(BENCH / "traffic" / "drna-labelled.json")
BIG_SEED = 2**31 + 977


def test_same_seed_same_reads(tmp_path):
    a, b = make_reads(DRNA, 300, BIG_SEED), make_reads(DRNA, 300, BIG_SEED)
    assert a.write_fastq(tmp_path / "a.fq").read_bytes() == b.write_fastq(tmp_path / "b.fq").read_bytes()
    c = make_reads(DRNA, 300, BIG_SEED + 1)
    assert not np.array_equal(a.seq[:1000], c.seq[:1000])


def test_every_seed_gets_the_same_lengths_in_its_own_order():
    a, b = make_reads(DRNA, 500, 1), make_reads(DRNA, 500, 2)
    assert np.array_equal(np.sort(a.lengths()), np.sort(b.lengths()))
    assert not np.array_equal(a.lengths(), b.lengths())


def test_length_histogram_matches_the_mix():
    n = 20000
    lengths = length_set(DRNA, n)
    assert lengths.min() >= 200 and lengths.max() <= 32000
    # The body's median is 1200; the 4% tail around 7000 lifts the mean to about 1614.
    assert 1150 < np.median(lengths) < 1300
    assert 1500 < lengths.mean() < 1750
    # Reads above 8192 bases come from the tail alone: 4% x P(lognormal(7000, 0.7) > 8192) ~ 1.6%.
    assert 0.011 < (lengths > 8192).mean() < 0.022
    # The body alone: about half below 1200, few below 400.
    body = lengths[lengths < 4000]
    assert abs((body < 1200).mean() - 0.5) < 0.03


def test_reads_are_acgt_with_phred_in_range(tmp_path):
    reads = make_reads(DRNA, 200, 5)
    assert set(np.unique(reads.seq).tolist()) <= set(b"ACGT")
    lo, hi = DRNA["phred"]
    assert reads.qual.min() >= 33 + lo and reads.qual.max() <= 33 + hi
    text = reads.write_fastq(tmp_path / "r.fq").read_bytes().split(b"\n")
    assert text[0] == b"@bench_read_0" and text[2] == b"+" and len(text[1]) == len(text[3]) == reads.lengths()[0]


def test_labelled_reads_carry_their_adapter():
    reads = make_reads(LABELLED, 300, BIG_SEED)
    size = LABELLED["adapter"]["length"]
    for i in range(len(reads)):
        name, seq, _ = reads.record(i)
        s, e = (int(v) for v in name.split("|")[1].split(":"))
        assert (s, e) == tuple(reads.spans[i]) and e - s == size and s >= 10 and e < len(seq)
        assert seq[s:e] == b"A" * size and seq[s - 1 : s] != b"A" and seq[e : e + 1] != b"A"


def test_widths_reached():
    ladder = [256, 512, 1024, 32768]
    assert widths_reached(np.array([200, 255, 256, 600, 40000]), ladder, 32768) == [256, 512, 1024, 32768]
