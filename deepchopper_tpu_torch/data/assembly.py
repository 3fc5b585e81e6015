"""Training-dataset assembly from labelled FASTQ pools.

Copy of `deepchopper_tpu/data/assembly.py`: draw sequentially from
per-category FASTQ pools (internal adapter, simulated terminal adapter,
natural terminal adapter, both adapters, negative) at configured ratios and
write `train{prefix}.fq` / `val{prefix}.fq` / `test{prefix}.fq`.

`skip_quirk=True` reproduces the reference's re-entry of each pool with
`.skip(n_taken_so_far)` after those records were already consumed: between
consecutive splits each pool silently discards as many reads as the previous
splits took. The default, False, gives the declared semantics.
"""

from __future__ import annotations

import logging
from pathlib import Path

from ..io.chop import FastqRecord
from ..io.fastq import StreamingFastqReader

log = logging.getLogger(__name__)


class _Pool:
    """Sequential FASTQ draw with optional reference skip quirk."""

    def __init__(self, path: str | Path, skip_quirk: bool):
        self._it = iter(StreamingFastqReader(path))
        self._skip_quirk = skip_quirk
        self._taken = 0

    def take(self, n: int) -> list[FastqRecord]:
        # Reference quirk: each later split first skips as many records as ALL
        # previous splits took (skip-after-take on a consumed reader).
        if self._skip_quirk and self._taken:
            for _ in range(self._taken):
                if next(self._it, None) is None:
                    break
        out: list[FastqRecord] = []
        for _ in range(n):
            rec = next(self._it, None)
            if rec is None:
                break
            out.append(rec)
        self._taken += len(out)
        return out


def _check_ratios(train_ratio: float, val_ratio: float, test_ratio: float) -> None:
    if abs(train_ratio + val_ratio + test_ratio - 1.0) > 1e-6:
        raise ValueError("train_ratio + val_ratio + test_ratio must equal 1.0")


def _write_split(records: list[FastqRecord], path: Path) -> None:
    with open(path, "wb") as fh:
        for rec in records:
            fh.write(rec.to_bytes())


def collect_and_split_dataset_multi(
    sources: dict[str, str | Path],
    counts: dict[str, tuple[int, int, int]],
    prefix: str = "",
    output_dir: str | Path = ".",
    skip_quirk: bool = False,
) -> tuple[Path, Path, Path]:
    """Generalized splitter: `sources[name]` is a FASTQ pool; `counts[name]`
    is (train, val, test) record counts drawn sequentially from that pool."""
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    pools = {name: _Pool(path, skip_quirk) for name, path in sources.items()}
    paths = tuple(output_dir / f"{split}{prefix}.fq" for split in ("train", "val", "test"))
    for i, split_path in enumerate(paths):
        records: list[FastqRecord] = []
        for name, pool in pools.items():
            want = counts[name][i]
            got = pool.take(want)
            if len(got) < want:
                log.warning("pool %r exhausted: wanted %d, got %d", name, want, len(got))
            records.extend(got)
        _write_split(records, split_path)
        log.info("wrote %d records to %s", len(records), split_path)
    return paths


def collect_and_split_dataset(
    internal_fq_path: str | Path,
    terminal_fq_path: str | Path,
    negative_fq_path: str | Path,
    total_reads: float,
    train_ratio: float = 0.8,
    val_ratio: float = 0.1,
    test_ratio: float = 0.1,
    internal_adapter_ratio: float = 0.5,
    positive_ratio: float = 0.8,
    prefix: str = "",
    output_dir: str | Path = ".",
    skip_quirk: bool = False,
) -> tuple[Path, Path, Path]:
    """Three-pool split (reference: src/utils.rs:58-217)."""
    _check_ratios(train_ratio, val_ratio, test_ratio)
    terminal_ratio = 1.0 - internal_adapter_ratio
    negative_ratio = 1.0 - positive_ratio

    def per_split(ratio: float) -> tuple[int, int, int]:
        return (
            int(total_reads * train_ratio * ratio),
            int(total_reads * val_ratio * ratio),
            int(total_reads * test_ratio * ratio),
        )

    counts = {
        "internal": per_split(positive_ratio * internal_adapter_ratio),
        "terminal": per_split(positive_ratio * terminal_ratio),
        "negative": per_split(negative_ratio),
    }
    return collect_and_split_dataset_multi(
        {
            "internal": internal_fq_path,
            "terminal": terminal_fq_path,
            "negative": negative_fq_path,
        },
        counts,
        prefix,
        output_dir,
        skip_quirk,
    )


def collect_and_split_dataset_with_natural_terminal_adapters(
    internal_fq_path: str | Path,
    terminal_fq_path: str | Path,
    natural_terminal_fq_path: str | Path,
    negative_fq_path: str | Path,
    total_reads: float,
    train_ratio: float = 0.8,
    val_ratio: float = 0.1,
    test_ratio: float = 0.1,
    internal_adapter_ratio: float = 0.5,
    natural_terminal_adapter_ratio: float = 0.5,
    positive_ratio: float = 0.8,
    prefix: str = "",
    output_dir: str | Path = ".",
    skip_quirk: bool = False,
) -> tuple[Path, Path, Path]:
    """Four-pool split where the terminal share is further divided between
    simulated and natural terminal adapters (reference: src/utils.rs:219-418)."""
    _check_ratios(train_ratio, val_ratio, test_ratio)
    terminal_ratio = 1.0 - internal_adapter_ratio
    negative_ratio = 1.0 - positive_ratio

    def per_split(ratio: float) -> tuple[int, int, int]:
        return (
            int(total_reads * train_ratio * ratio),
            int(total_reads * val_ratio * ratio),
            int(total_reads * test_ratio * ratio),
        )

    counts = {
        "internal": per_split(positive_ratio * internal_adapter_ratio),
        "terminal": per_split(
            positive_ratio * terminal_ratio * (1.0 - natural_terminal_adapter_ratio)
        ),
        "natural_terminal": per_split(
            positive_ratio * terminal_ratio * natural_terminal_adapter_ratio
        ),
        "negative": per_split(negative_ratio),
    }
    return collect_and_split_dataset_multi(
        {
            "internal": internal_fq_path,
            "terminal": terminal_fq_path,
            "natural_terminal": natural_terminal_fq_path,
            "negative": negative_fq_path,
        },
        counts,
        prefix,
        output_dir,
        skip_quirk,
    )


def collect_and_split_dataset_with_natural_terminal_adapters_and_both_adapters(
    internal_fq_path: str | Path,
    terminal_fq_path: str | Path,
    natural_terminal_fq_path: str | Path,
    both_adapter_fq_path: str | Path,
    negative_fq_path: str | Path,
    total_reads: float,
    train_ratio: float = 0.8,
    val_ratio: float = 0.1,
    test_ratio: float = 0.1,
    internal_adapter_ratio: float = 0.4,
    natural_terminal_adapter_ratio: float = 0.5,
    both_adapter_ratio: float = 0.2,
    positive_ratio: float = 0.8,
    prefix: str = "",
    output_dir: str | Path = ".",
    skip_quirk: bool = False,
) -> tuple[Path, Path, Path]:
    """Five-pool split adding reads carrying both adapter kinds
    (reference: src/utils.rs:420-654)."""
    _check_ratios(train_ratio, val_ratio, test_ratio)
    terminal_ratio = 1.0 - internal_adapter_ratio - both_adapter_ratio
    negative_ratio = 1.0 - positive_ratio

    def per_split(ratio: float) -> tuple[int, int, int]:
        return (
            int(total_reads * train_ratio * ratio),
            int(total_reads * val_ratio * ratio),
            int(total_reads * test_ratio * ratio),
        )

    counts = {
        "internal": per_split(positive_ratio * internal_adapter_ratio),
        "both": per_split(positive_ratio * both_adapter_ratio),
        "terminal": per_split(
            positive_ratio * terminal_ratio * (1.0 - natural_terminal_adapter_ratio)
        ),
        "natural_terminal": per_split(
            positive_ratio * terminal_ratio * natural_terminal_adapter_ratio
        ),
        "negative": per_split(negative_ratio),
    }
    return collect_and_split_dataset_multi(
        {
            "internal": internal_fq_path,
            "both": both_adapter_fq_path,
            "terminal": terminal_fq_path,
            "natural_terminal": natural_terminal_fq_path,
            "negative": negative_fq_path,
        },
        counts,
        prefix,
        output_dir,
        skip_quirk,
    )
