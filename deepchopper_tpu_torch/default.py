"""Global constants: encoding, the tokenizer vocabulary, the shard contract.

Copy of `deepchopper_tpu/default.py`.
"""

from __future__ import annotations

# FASTQ and dataset encoding.
QUAL_OFFSET: int = 33
BASES: str = "ATCGN"
KMER_SIZE: int = 3
VECTORIZED_TARGET: bool = True
MIN_READ_LEN: int = 150
MIN_CHOPED_SEQ_LEN: int = 20
IGNORE_LABEL: int = -100

# Character-level tokenizer vocabulary (HyenaDNA id layout: 0-6 are special
# tokens, 7-11 the bases ACGTN).
TOKEN_CLS: int = 0
TOKEN_SEP: int = 1  # appended at the end of every tokenized read
TOKEN_BOS: int = 2
TOKEN_MASK: int = 3
TOKEN_PAD: int = 4
TOKEN_RESERVED: int = 5
TOKEN_UNK: int = 6
TOKEN_A: int = 7
TOKEN_C: int = 8
TOKEN_G: int = 9
TOKEN_T: int = 10
TOKEN_N: int = 11
VOCAB_SIZE: int = 12

# Max sequence lengths per HyenaDNA backbone.
HYENA_MAX_LENGTHS: dict[str, int] = {
    "hyenadna-tiny-1k-seqlen": 1024,
    "hyenadna-small-32k-seqlen": 32768,
    "hyenadna-medium-160k-seqlen": 160_000,
    "hyenadna-medium-450k-seqlen": 450_000,
    "hyenadna-large-1m-seqlen": 1_000_000,
}

# Chop-stage tuned defaults (the reference's `deepchopper-chop` defaults).
SMOOTH_WINDOW_SIZE: int = 21
MIN_INTERVAL_SIZE: int = 13
APPROVED_INTERVAL_NUMBER: int = 20
MAX_PROCESS_INTERVALS: int = 4
MIN_READ_LENGTH_AFTER_CHOP: int = 20
CHOP_CHUNK_SIZE: int = 10_000

# Packed-ascii read-id width in prediction shards.
MAX_ID_LENGTH: int = 256
