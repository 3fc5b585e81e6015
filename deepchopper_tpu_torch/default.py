"""Global constants: the tokenizer vocabulary and the shard contract.

Trimmed copy of `deepchopper_tpu/default.py` (what the predict and chop
paths read).
"""

from __future__ import annotations

QUAL_OFFSET: int = 33
MIN_READ_LEN: int = 150
IGNORE_LABEL: int = -100

# Character-level tokenizer vocabulary (HyenaDNA id layout: 0-6 are special
# tokens, 7-11 the bases ACGTN); the ids the predict path writes.
TOKEN_SEP: int = 1  # appended at the end of every tokenized read
TOKEN_PAD: int = 4
TOKEN_UNK: int = 6
TOKEN_A: int = 7
TOKEN_C: int = 8
TOKEN_G: int = 9
TOKEN_T: int = 10
TOKEN_N: int = 11

# Packed-ascii read-id width in prediction shards.
MAX_ID_LENGTH: int = 256

# Chop-stage tuned defaults (the reference's `deepchopper-chop` defaults).
SMOOTH_WINDOW_SIZE: int = 21
MIN_INTERVAL_SIZE: int = 13
APPROVED_INTERVAL_NUMBER: int = 20
MAX_PROCESS_INTERVALS: int = 4
MIN_READ_LENGTH_AFTER_CHOP: int = 20
CHOP_CHUNK_SIZE: int = 10_000
