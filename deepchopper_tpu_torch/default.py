"""Global constants: the tokenizer vocabulary and the shard contract.

Trimmed copy of `deepchopper_tpu/default.py` (what the predict path reads).
"""

from __future__ import annotations

QUAL_OFFSET: int = 33
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
