"""Host data pipeline: FASTQ parsing, tokenizer-contract encoding, bucketing,
dense tensor encoding, dataset assembly."""

from .assembly import (
    collect_and_split_dataset,
    collect_and_split_dataset_multi,
    collect_and_split_dataset_with_natural_terminal_adapters,
    collect_and_split_dataset_with_natural_terminal_adapters_and_both_adapters,
)
from .bucketing import (
    Batch,
    EncodedRead,
    bucketed_batches,
    default_buckets,
    encode_read,
    pad_batch,
    pick_bucket,
)
from .fastq_module import iter_batches, iter_encoded_reads, parse_fastq_file
from .tensor_encoder import (
    FqEncoderOption,
    RecordData,
    TensorEncoder,
    encode_fq_path_to_tensor,
    encode_fq_paths_to_tensor,
)

__all__ = [
    "collect_and_split_dataset",
    "collect_and_split_dataset_multi",
    "collect_and_split_dataset_with_natural_terminal_adapters",
    "collect_and_split_dataset_with_natural_terminal_adapters_and_both_adapters",
    "FqEncoderOption",
    "RecordData",
    "TensorEncoder",
    "encode_fq_path_to_tensor",
    "encode_fq_paths_to_tensor",
    "Batch",
    "EncodedRead",
    "bucketed_batches",
    "default_buckets",
    "encode_read",
    "iter_batches",
    "iter_encoded_reads",
    "pad_batch",
    "parse_fastq_file",
    "pick_bucket",
]
