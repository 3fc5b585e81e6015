"""Host-side sequence, quality, label and k-mer ops, and (in their own
modules, not re-exported here) the device kernels' wrappers."""

from .kmer import (
    generate_kmers,
    generate_kmers_table,
    kmerids_to_seq,
    kmers_to_seq,
    seq_to_kmers,
    seq_to_kmers_and_offset,
    to_kmer_target_region,
    to_original_target_region,
    to_original_targtet_region,
)
from .labels import (
    get_label_region,
    majority_voting,
    majority_voting_batch,
    parse_target_from_id,
    smooth_label_region,
    summary_predict,
    vectorize_target,
    vectorize_targets,
)
from .qual import encode_qual, encode_qual_kmer, normalize_quals, splite_qual_by_offsets
from .sequence import (
    ascii_list2str,
    detokenize_bases,
    id_list2seq,
    normalize_seq,
    normalize_seq_bytes,
    reverse_complement,
    seq_to_bytes,
    tokenize_bases,
)

__all__ = [
    "ascii_list2str",
    "detokenize_bases",
    "encode_qual",
    "encode_qual_kmer",
    "generate_kmers",
    "generate_kmers_table",
    "get_label_region",
    "id_list2seq",
    "kmerids_to_seq",
    "kmers_to_seq",
    "majority_voting",
    "majority_voting_batch",
    "normalize_quals",
    "normalize_seq",
    "normalize_seq_bytes",
    "parse_target_from_id",
    "reverse_complement",
    "seq_to_bytes",
    "seq_to_kmers",
    "seq_to_kmers_and_offset",
    "smooth_label_region",
    "splite_qual_by_offsets",
    "summary_predict",
    "to_kmer_target_region",
    "to_original_target_region",
    "to_original_targtet_region",
    "tokenize_bases",
    "vectorize_target",
    "vectorize_targets",
]
