"""Developer utilities: the reference's dev binaries, in Python.

Copy of `deepchopper_tpu/tools.py`. Each function mirrors one of the
reference's `src/bin/` tools: fq2fa, fqsearch, select, diff, chimericstat,
sa, scdiff, replacefq, replacebam, psl_top1 (its tmp.rs) and the encode
smoke; `blat-predictions` lives in `eval/blat.py`. All are exposed under the
CLI's `tools <name>` group (`python -m deepchopper_tpu_torch tools --help`).
"""

from __future__ import annotations

import dataclasses
import sys
from collections import Counter
from pathlib import Path
from typing import Iterator, TextIO

from .io.chop import FastqRecord
from .io.fastq import StreamingFastqReader, write_fq_auto


# ---------------------------------------------------------------------------
# fq2fa (reference: src/bin/fq2fa.rs)
# ---------------------------------------------------------------------------


def fq2fa(fq_path: str | Path, out: TextIO | None = None) -> int:
    """FASTQ (incl. bgzf) -> FASTA on stdout; returns record count."""
    out = out or sys.stdout
    n = 0
    for rec in StreamingFastqReader(fq_path):
        out.write(f">{rec.name}\n{rec.seq.decode('ascii')}\n")
        n += 1
    return n


# ---------------------------------------------------------------------------
# fqsearch (reference: src/bin/fqsearch.rs)
# ---------------------------------------------------------------------------


def fqsearch(
    fq_path: str | Path,
    id_substring: str | None = None,
    min_len: int | None = None,
    max_len: int | None = None,
) -> Iterator[FastqRecord]:
    """Search reads by id substring and/or length window."""
    for rec in StreamingFastqReader(fq_path):
        if id_substring is not None and id_substring not in rec.name:
            continue
        n = len(rec.seq)
        if min_len is not None and n < min_len:
            continue
        if max_len is not None and n > max_len:
            continue
        yield rec


# ---------------------------------------------------------------------------
# select (reference: src/bin/select.rs — chop-type annotations |T / |I)
# ---------------------------------------------------------------------------


def select_by_chop_type(
    fq_path: str | Path, chop_type: str, output: str | Path | None = None
) -> list[FastqRecord]:
    """Select chopped reads whose id carries the given annotation.

    The chop stage appends `|start:end|T` (terminal) or `|start:end|I`
    (internal) to record ids (reference: src/output/split.rs:203-222)."""
    suffix = {"terminal": "|T", "internal": "|I"}.get(chop_type.lower(), chop_type)
    hits = [r for r in StreamingFastqReader(fq_path) if r.name.endswith(suffix)]
    if output is not None:
        write_fq_auto(hits, output)
    return hits


# ---------------------------------------------------------------------------
# diff (reference: src/bin/diff.rs — original vs chopped read lengths)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DiffResult:
    total_original: int = 0
    total_chopped: int = 0
    unchanged: int = 0
    shortened: int = 0
    removed: int = 0
    added_parts: int = 0
    bases_removed: int = 0


def diff_fq(original: str | Path, chopped: str | Path) -> DiffResult:
    """Compare read lengths between the original and chopped FASTQ."""
    orig_lens: dict[str, int] = {}
    for rec in StreamingFastqReader(original):
        orig_lens[rec.name.split()[0]] = len(rec.seq)

    res = DiffResult(total_original=len(orig_lens))
    seen: set[str] = set()
    for rec in StreamingFastqReader(chopped):
        res.total_chopped += 1
        # Chopped ids are `<orig>|start:end|T/I` or unchanged on passthrough.
        base = rec.name.split()[0].split("|")[0]
        n_orig = orig_lens.get(base)
        if n_orig is None:
            continue
        if base in seen:
            res.added_parts += 1
        seen.add(base)
        if len(rec.seq) == n_orig:
            res.unchanged += 1
        else:
            res.shortened += 1
            res.bases_removed += max(n_orig - len(rec.seq), 0)
    res.removed = len(set(orig_lens) - seen)
    return res


# ---------------------------------------------------------------------------
# chimericstat (reference: src/bin/chimericstat.rs)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ChimericStat:
    total: int = 0
    primary_mapped: int = 0
    with_sa: int = 0

    @property
    def ratio(self) -> float:
        return self.with_sa / self.primary_mapped if self.primary_mapped else 0.0


def chimericstat(bam_path: str | Path) -> ChimericStat:
    """Count primary mapped reads carrying an SA tag (chimeric alignments)."""
    from .io.bam import iter_bam_records

    stat = ChimericStat()
    for rec in iter_bam_records(bam_path):
        stat.total += 1
        if rec.is_mapped and not rec.is_secondary and not rec.is_supplementary:
            stat.primary_mapped += 1
            if rec.sa_tag is not None:
                stat.with_sa += 1
    return stat


# ---------------------------------------------------------------------------
# sa (reference: src/bin/sa.rs — SA-tag supplementary alignment summary)
# ---------------------------------------------------------------------------


def sa_summary(bam_path: str | Path) -> dict[str, int]:
    """Histogram of supplementary-alignment counts per SA-tagged read."""
    from .io.bam import iter_bam_records

    counts: Counter[int] = Counter()
    for rec in iter_bam_records(bam_path):
        if rec.sa_tag and rec.is_mapped and not rec.is_secondary and not rec.is_supplementary:
            n = sum(1 for part in rec.sa_tag.split(";") if part.strip())
            counts[n] += 1
    return {str(k): v for k, v in sorted(counts.items())}


# ---------------------------------------------------------------------------
# scdiff (reference: src/bin/scdiff.rs — softclip comparison)
# ---------------------------------------------------------------------------


def scdiff(original_bam: str | Path, chopped_bam: str | Path) -> dict[str, float]:
    """Compare per-read softclip totals between two BAMs (means + deltas)."""
    from .io.bam import read_bam_records

    orig = read_bam_records(original_bam)
    chop = read_bam_records(chopped_bam)
    shared = [k for k in chop if k.split("|")[0] in orig or k in orig]

    def sc(rec) -> int:
        return rec.left_softclip + rec.right_softclip

    deltas = []
    for k in shared:
        base = k if k in orig else k.split("|")[0]
        deltas.append(sc(orig[base]) - sc(chop[k]))
    n = len(deltas)
    return {
        "shared_reads": float(n),
        "mean_softclip_reduction": sum(deltas) / n if n else 0.0,
        "improved": float(sum(1 for d in deltas if d > 0)),
        "worsened": float(sum(1 for d in deltas if d < 0)),
    }


# ---------------------------------------------------------------------------
# replacefq (reference: src/bin/replacefq.rs)
# ---------------------------------------------------------------------------


def replacefq(
    target_fq: str | Path,
    replacement_fq: str | Path,
    output: str | Path,
) -> int:
    """Replace records in `target_fq` by id with versions from
    `replacement_fq`; returns number replaced."""
    repl = {r.name.split()[0]: r for r in StreamingFastqReader(replacement_fq)}
    replaced = 0

    def merged() -> Iterator[FastqRecord]:
        nonlocal replaced
        for rec in StreamingFastqReader(target_fq):
            r = repl.get(rec.name.split()[0])
            if r is not None:
                replaced += 1
                yield r
            else:
                yield rec

    write_fq_auto(merged(), output)
    return replaced


# ---------------------------------------------------------------------------
# psl top-1 (reference: src/bin/tmp.rs)
# ---------------------------------------------------------------------------


def psl_top1_summary(psl_path: str | Path) -> dict[str, float]:
    """Top-1 identity summary over a PSL file."""
    from .eval.blat import parse_psl_by_qname

    best = [als[0].identity for als in parse_psl_by_qname(psl_path).values() if als]
    if not best:
        return {"queries": 0.0, "mean_top1_identity": 0.0}
    return {
        "queries": float(len(best)),
        "mean_top1_identity": sum(best) / len(best),
        "min_top1_identity": min(best),
        "max_top1_identity": max(best),
    }


# ---------------------------------------------------------------------------
# encode smoke (reference: src/bin/encode.rs)
# ---------------------------------------------------------------------------


def encode_smoke(fq_path: str | Path, max_reads: int = 100) -> dict[str, tuple]:
    """Tensor-encode a FASTQ and report shapes (dev sanity check)."""
    from .data.fastq_module import iter_batches

    shapes = Counter()
    reads = 0
    for batch in iter_batches(fq_path, max_samples=max_reads):
        shapes[batch.input_ids.shape] += 1
        reads += batch.input_ids.shape[0]
    return {"reads": (reads,), "batch_shapes": tuple(sorted(str(s) for s in shapes))}


# ---------------------------------------------------------------------------
# replacebam (reference: src/bin/replacebam.rs:1-131)
# ---------------------------------------------------------------------------


def replacebam(dcbam: str | Path, dobam: str | Path, output: str | Path, threads: int = 4) -> int:
    """Swap internal-chopped records from a DeepChopper-processed BAM back
    into the original BAM.

    Semantics (reference: src/bin/replacebam.rs:33-104): collect records from
    `dcbam` whose qname contains the character 'I' (internal-chop annotation —
    the reference matches ANY 'I', a deliberate quirk reproduced here); drop
    every record in `dobam` whose qname equals one of their base names
    (text before the first '|'); append the collected records. Output uses
    `dobam`'s header; record blocks pass through byte-identical. Returns the
    number of replaced records.
    """
    from .io.bam import BamWriter, iter_bam_raw_blocks, read_bam_header

    internal: dict[str, bytes] = {}
    for qname, _flag, block in iter_bam_raw_blocks(dcbam, threads):
        if "I" in qname:
            internal[qname] = block
    base_names = {q.split("|", 1)[0] for q in internal}

    header = read_bam_header(dobam, threads)
    with BamWriter(output, header, threads=threads) as writer:
        for qname, _flag, block in iter_bam_raw_blocks(dobam, threads):
            if qname not in base_names:
                writer.write_raw_block(block)
        for block in internal.values():
            writer.write_raw_block(block)
    return len(internal)
