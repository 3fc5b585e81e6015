"""Target parsing and vectorization from read ids.

Trimmed copy of `deepchopper_tpu/ops/labels.py` (the predict path's part).
`parse_target_from_id` degrades to [(0, 0)] on malformed ids instead of
raising, as the reference tokenizer does.
"""

from __future__ import annotations

import re

import numpy as np

from ..errors import TargetRegionInvalid

_TARGET_PART = re.compile(rb"^(\d+):(\d+)$")


def parse_target_from_id(src: str | bytes) -> list[tuple[int, int]]:
    """Parse `...|start:end-start2:end2` adapter annotations from a read id.

    * empty input -> []
    * no '|' in the id -> [(0, 0)]
    * otherwise the last '|'-separated field is split on '-' into
      `start:end` pairs; ANY parse failure degrades to [(0, 0)].
    """
    if isinstance(src, str):
        src = src.encode("ascii", errors="replace")
    if not src:
        return []
    if b"|" not in src:
        return [(0, 0)]
    number_part = src.rsplit(b"|", 1)[-1]
    result: list[tuple[int, int]] = []
    for part in number_part.split(b"-"):
        m = _TARGET_PART.match(part)
        if m is None:
            return [(0, 0)]
        result.append((int(m.group(1)), int(m.group(2))))
    return result


def vectorize_targets(targets, length: int) -> np.ndarray:
    """Flat [s1, e1, s2, e2, ...] or [(s,e), ...] -> binary label vector."""
    flat = np.asarray(targets, dtype=np.int64).reshape(-1)
    if flat.size == 0:
        return np.zeros(length, dtype=np.int64)
    if flat.size % 2 != 0:
        raise TargetRegionInvalid("targets must contain an even number of values")
    out = np.zeros(length, dtype=np.int64)
    for start, end in flat.reshape(-1, 2):
        if start > end or end > length:
            raise TargetRegionInvalid(f"invalid target region {start}:{end} for length {length}")
        out[start:end] = 1
    return out
