"""Host IO: FASTQ streaming and writing, the chop kernel, BAM, parquet/JSON
datasets, prediction shards."""

from .bam import BamRecord, read_bam_records
from .chop import (
    ChopType,
    FastqRecord,
    generate_unmaped_intervals,
    remove_intervals_and_keep_left,
    split_records_by_intervals,
    split_records_by_remove_interval,
    split_records_by_remove_intervals,
)
from .fastq import (
    StreamingFastqReader,
    convert_multiple_fqs_to_one_fq,
    iter_fastq_chunks,
    open_bgzf_writer,
    write_fq,
    write_fq_auto,
    write_fq_parallel,
)
from .parquet import (
    JsonEncoder,
    ParquetEncoder,
    encode_fq_path_to_json,
    encode_fq_path_to_parquet,
    encode_fq_path_to_parquet_chunk,
    encode_fq_paths_to_parquet,
    extract_records_by_ids,
    write_json,
    write_parquet,
    write_predicts,
)
from .predicts import (
    Predict,
    load_predicts_from_batch_npz,
    load_predicts_from_batch_pt,
    load_predicts_from_batch_pts,
    pack_read_ids,
    write_prediction_shard,
)

__all__ = [
    "BamRecord",
    "ChopType",
    "FastqRecord",
    "JsonEncoder",
    "ParquetEncoder",
    "Predict",
    "StreamingFastqReader",
    "convert_multiple_fqs_to_one_fq",
    "encode_fq_path_to_json",
    "encode_fq_path_to_parquet",
    "encode_fq_path_to_parquet_chunk",
    "encode_fq_paths_to_parquet",
    "extract_records_by_ids",
    "generate_unmaped_intervals",
    "iter_fastq_chunks",
    "load_predicts_from_batch_npz",
    "load_predicts_from_batch_pt",
    "load_predicts_from_batch_pts",
    "open_bgzf_writer",
    "pack_read_ids",
    "read_bam_records",
    "remove_intervals_and_keep_left",
    "split_records_by_intervals",
    "split_records_by_remove_interval",
    "split_records_by_remove_intervals",
    "write_fq",
    "write_fq_auto",
    "write_fq_parallel",
    "write_json",
    "write_parquet",
    "write_prediction_shard",
    "write_predicts",
]
