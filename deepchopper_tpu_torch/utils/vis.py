"""ANSI interval highlighting.

Copy of `deepchopper_tpu/utils/vis.py`.
"""

from __future__ import annotations

import textwrap

_RED = "\x1b[31m"
_RESET = "\x1b[0m"


def highlight_targets(
    seq: str, targets: list[tuple[int, int]], text_width: int | None = None, color: bool = True
) -> str:
    """Render `seq` with target intervals highlighted (ANSI red, or
    [brackets] without color), wrapped at `text_width`."""
    parts: list[str] = []
    cursor = 0
    for start, end in sorted(targets, key=lambda t: t[0]):
        start, end = int(start), int(end)
        parts.append(seq[cursor:start])
        chunk = seq[start:end]
        parts.append(f"{_RED}{chunk}{_RESET}" if color else f"[{chunk}]")
        cursor = end
    parts.append(seq[cursor:])
    joined = "".join(parts)
    if text_width:
        return "\n".join(textwrap.wrap(joined, text_width, drop_whitespace=False))
    return joined
