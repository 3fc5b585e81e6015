"""Record-length summaries of FASTQ, FASTA and BAM files.

Copy of `deepchopper_tpu/utils/stat.py`.
"""

from __future__ import annotations

from pathlib import Path


def summary_fx_record_len(path: str | Path) -> list[int]:
    """Lengths of FASTQ/FASTA records."""
    path = Path(path)
    from ..io.fastq import StreamingFastqReader, open_compressed_reader

    head = open_compressed_reader(path)
    first = head.read(1)
    head.close()
    if first == b">":  # FASTA
        lens: list[int] = []
        cur = 0
        with open_compressed_reader(path) as fh:
            for line in fh:
                line = line.strip()
                if line.startswith(b">"):
                    if cur:
                        lens.append(cur)
                    cur = 0
                else:
                    cur += len(line)
        if cur:
            lens.append(cur)
        return lens
    return [len(rec.seq) for rec in StreamingFastqReader(path)]


def summary_bam_record_len(path: str | Path) -> list[int]:
    """Lengths of BAM records (reference: src/stat.rs:22-35)."""
    from ..io.bam import iter_bam_records

    return [rec.read_len for rec in iter_bam_records(path)]


def summary_record_len(path: str | Path) -> list[int]:
    path = Path(path)
    if path.suffix == ".bam":
        return summary_bam_record_len(path)
    return summary_fx_record_len(path)
