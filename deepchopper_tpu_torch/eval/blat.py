"""BLAT subprocess wrapper and PSL parsing.

Copy of `deepchopper_tpu/eval/blat.py`: run the external `blat` binary on a
candidate adapter sequence against a 2bit genome and parse its PSL output.
The binary is not part of the package: callers pass its path, and without it
`blat_predictions` still writes its FASTA and skips the alignment.
"""

from __future__ import annotations

import dataclasses
import subprocess
import tempfile
from pathlib import Path

# Sequences shorter than this cannot be blatted (reference: src/smooth/blat.rs:19).
MIN_SEQ_SIZE = 20

# The flags the reference passes to blat (reference: src/smooth/blat.rs:166-173).
BLAT_ARGS = ["-stepSize=5", "-repMatch=2253", "-minScore=20", "-minIdentity=0"]


@dataclasses.dataclass
class PslAlignment:
    """One PSL line (reference: src/smooth/blat.rs:27-50)."""

    qname: str = ""
    qsize: int = 0
    qstart: int = 0
    qend: int = 0
    qmatch: int = 0
    tname: str = ""
    tsize: int = 0
    tstart: int = 0
    tend: int = 0
    identity: float = 0.0


def parse_psl(path: str | Path) -> list[PslAlignment]:
    """Parse a PSL file, skipping the 5 header lines; identity = match/qsize
    (reference: src/smooth/blat.rs:72-118)."""
    out: list[PslAlignment] = []
    with open(path) as fh:
        for i, line in enumerate(fh):
            if i < 5:
                continue
            cols = line.rstrip("\n").split("\t")
            if len(cols) < 17:
                continue
            match = int(cols[0])
            qsize = int(cols[10])
            out.append(
                PslAlignment(
                    qname=cols[9],
                    qsize=qsize,
                    qstart=int(cols[11]),
                    qend=int(cols[12]),
                    qmatch=match,
                    tname=cols[13],
                    tsize=int(cols[14]),
                    tstart=int(cols[15]),
                    tend=int(cols[16]),
                    identity=match / qsize if qsize else 0.0,
                )
            )
    # Best alignment first (reference sorts by identity implicitly by taking [0]).
    out.sort(key=lambda a: a.identity, reverse=True)
    return out


def parse_psl_by_qname(path: str | Path) -> dict[str, list[PslAlignment]]:
    """Group PSL alignments by query name (reference: src/smooth/blat.rs:62-70)."""
    grouped: dict[str, list[PslAlignment]] = {}
    for al in parse_psl(path):
        grouped.setdefault(al.qname, []).append(al)
    return grouped


def blat(
    seq: str,
    blat_cli: str | Path,
    two_bit: str | Path,
    qname: str | None = None,
) -> list[PslAlignment]:
    """BLAT one sequence against a 2bit genome
    (reference: src/smooth/blat.rs:120-184). Raises on subprocess failure."""
    if len(seq) < MIN_SEQ_SIZE:
        raise ValueError(f"sequence shorter than MIN_SEQ_SIZE={MIN_SEQ_SIZE}")
    with tempfile.TemporaryDirectory() as tmp:
        fa = Path(tmp) / "query.fa"
        psl = Path(tmp) / "out.psl"
        fa.write_text(f">{qname or 'seq'}\n{seq}\n")
        cmd = [str(blat_cli), *BLAT_ARGS, str(two_bit), str(fa), str(psl)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"blat failed ({proc.returncode}): {proc.stderr[:500]}")
        return parse_psl(psl)


def blat_for_seq_file(
    fa_path: str | Path,
    blat_cli: str | Path,
    two_bit: str | Path,
    psl_path: str | Path,
) -> list[PslAlignment]:
    """BLAT a whole FASTA file (reference: src/smooth/blat.rs `blat_for_seq`)."""
    cmd = [str(blat_cli), *BLAT_ARGS, str(two_bit), str(fa_path), str(psl_path)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"blat failed ({proc.returncode}): {proc.stderr[:500]}")
    return parse_psl(psl_path)


def blat_predictions(
    predicts: list[str | Path],
    prefix: str = "",
    selected_reads: str | Path | None = None,
    fastq: str | Path | None = None,
    smooth_window_size: int = 21,
    min_interval_size: int = 13,
    approved_interval_number: int = 20,
    max_process_intervals: int = 4,
    blat_cli: str | Path | None = None,
    hg38_2bit: str | Path | None = None,
    max_batch_size: int | None = None,
) -> dict:
    """Batch BLAT of predicted adapter sequences (reference: src/bin/blat.rs:1-276).

    Extracts every smoothed adapter interval from the prediction shards,
    writes `{prefix}all_predicts_seq.fa`, BLATs it against the genome, and
    saves top-1 identities to `{prefix}all_predicts_blat_identities.json`.
    With `selected_reads` (+ `fastq` for qualities), restricts to those read
    ids and additionally saves per-interval mean base qualities to
    `{prefix}predicts_base_quals.json`. When `blat_cli`/`hg38_2bit` are not
    provided (external binary, as in the reference), the FASTA is still
    written and identities are skipped.
    """
    import json
    import logging

    from .. import default
    from ..io.predicts import load_predicts_from_batch_pts

    log = logging.getLogger(__name__)
    all_predicts: dict = {}
    for p in predicts:
        all_predicts.update(
            load_predicts_from_batch_pts(p, default.IGNORE_LABEL, max_batch_size)
        )
    log.info("collected %d predicts", len(all_predicts))

    selected_quals: list[float] = []
    predict_seqs: list[str] = []

    def intervals_for(p) -> list[tuple[int, int]]:
        iv = p.smooth_and_select_intervals(
            smooth_window_size, min_interval_size, approved_interval_number
        )
        if len(iv) > max_process_intervals or not iv:
            return []
        return iv

    if selected_reads is not None:
        with open(selected_reads) as fh:
            selected = {line.split()[0] for line in fh if line.strip()}
        fq_quals: dict[str, bytes] = {}
        if fastq is not None:
            from ..io.fastq import StreamingFastqReader

            for rec in StreamingFastqReader(fastq):
                if rec.name in selected:
                    fq_quals[rec.name] = rec.qual
        for rid in selected:
            p = all_predicts.get(rid)
            if p is None:
                continue
            qual = fq_quals.get(rid)
            for s, e in intervals_for(p):
                predict_seqs.append(p.seq[s:e])
                if qual is not None:
                    span = qual[s:e]
                    selected_quals.append(
                        float(sum(span) / len(span)) if len(span) else 0.0
                    )
    else:
        for p in all_predicts.values():
            for s, e in intervals_for(p):
                predict_seqs.append(p.seq[s:e])

    log.info("collected %d predict seqs", len(predict_seqs))
    fa_path = Path(f"{prefix}all_predicts_seq.fa")
    with open(fa_path, "w") as fh:
        for idx, seq in enumerate(predict_seqs):
            fh.write(f">{idx}\n{seq}\n")

    result = {"n_predicts": len(all_predicts), "n_seqs": len(predict_seqs), "fa": str(fa_path)}

    if selected_quals:
        quals_path = Path(f"{prefix}predicts_base_quals.json")
        quals_path.write_text(json.dumps(selected_quals))
        result["quals"] = str(quals_path)

    if blat_cli is None or hg38_2bit is None:
        log.warning("blat_cli/hg38_2bit not provided; skipping alignment step")
        return result

    psl_path = Path(f"{prefix}blat_res.psl")
    alignments = blat_for_seq_file(fa_path, blat_cli, hg38_2bit, psl_path)
    by_qname: dict[str, list[PslAlignment]] = {}
    for al in alignments:
        by_qname.setdefault(al.qname, []).append(al)
    identities = [als[0].identity for als in by_qname.values()]
    ids_path = Path(f"{prefix}all_predicts_blat_identities.json")
    ids_path.write_text(json.dumps(identities))
    result.update({"psl": str(psl_path), "identities": str(ids_path), "n_aligned": len(identities)})
    return result
