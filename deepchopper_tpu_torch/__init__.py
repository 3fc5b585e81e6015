"""deepchopper_tpu_torch — DeepChopper in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper (H100).

A port of `deepchopper_tpu` (JAX/Pallas) that keeps its module names, its
file contracts and its numerics. It imports nothing of the JAX package: the
host-side pieces it needs are its own copies. It covers every command of the
JAX package (`predict`, `chop`, `train`, `eval`, `web`, `encode`, `stat`,
`eval-bam`, `tools`) and its top-level names, which mirror the reference's
Python bridge.

Importing the package starts nothing and builds nothing: each top-level name
is imported on its first use (PEP 562), and CUDA kernels are compiled with
`nvcc` on their first launch (see `ops/_build.py`).
"""

from __future__ import annotations

import importlib

__version__ = "0.1.0"

# Top-level name -> the module that defines it; a module's own name maps to
# the module itself.
_EXPORTS: dict[str, tuple[str, ...]] = {
    ".default": ("default",),
    ".errors": ("errors",),
    ".ops": (
        "ops",
        "ascii_list2str",
        "encode_qual",
        "encode_qual_kmer",
        "generate_kmers",
        "generate_kmers_table",
        "get_label_region",
        "id_list2seq",
        "kmerids_to_seq",
        "kmers_to_seq",
        "majority_voting",
        "normalize_seq",
        "parse_target_from_id",
        "reverse_complement",
        "seq_to_kmers",
        "seq_to_kmers_and_offset",
        "smooth_label_region",
        "splite_qual_by_offsets",
        "summary_predict",
        "to_kmer_target_region",
        "to_original_target_region",
        "to_original_targtet_region",
        "vectorize_target",
        "vectorize_targets",
    ),
    ".chop.pipeline": ("predict_cli",),
    ".data.assembly": (
        "collect_and_split_dataset",
        "collect_and_split_dataset_with_natural_terminal_adapters",
        "collect_and_split_dataset_with_natural_terminal_adapters_and_both_adapters",
    ),
    ".data.tensor_encoder": (
        "FqEncoderOption",
        "RecordData",
        "TensorEncoder",
        "encode_fq_path_to_tensor",
        "encode_fq_paths_to_tensor",
    ),
    ".io.parquet": (
        "JsonEncoder",
        "ParquetEncoder",
        "encode_fq_path_to_json",
        "encode_fq_path_to_parquet",
        "encode_fq_path_to_parquet_chunk",
        "encode_fq_paths_to_parquet",
        "extract_records_by_ids",
        "write_json",
        "write_parquet",
        "write_predicts",
    ),
    ".io.bam": ("BamRecord", "BamWriter", "left_right_soft_clip", "read_bam_records", "read_bam_records_parallel"),
    ".io.chop": (
        "ChopType",
        "FastqRecord",
        "generate_unmaped_intervals",
        "remove_intervals_and_keep_left",
        "split_records_by_intervals",
        "split_records_by_remove_interval",
        "split_records_by_remove_intervals",
    ),
    ".io.fastq": ("convert_multiple_fqs_to_one_fq", "write_fq", "write_fq_parallel"),
    ".io.predicts": ("Predict", "load_predicts_from_batch_pt", "load_predicts_from_batch_pts"),
    ".eval.blat": ("PslAlignment", "blat_predictions", "parse_psl_by_qname"),
    ".eval.stat": ("StatResult", "collect_statistics_for_predicts"),
    ".utils.stat": ("summary_bam_record_len", "summary_fx_record_len"),
    ".utils.vis": ("highlight_targets",),
}
_WHERE = {name: module for module, names in _EXPORTS.items() for name in names}

__all__ = sorted(_WHERE)


def __getattr__(name: str):
    module = _WHERE.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = importlib.import_module(module, __name__)
    if module.rsplit(".", 1)[-1] != name:
        value = getattr(value, name)
    globals()[name] = value
    return value


def __dir__() -> list[str]:
    return sorted(set(globals()) | set(__all__))
