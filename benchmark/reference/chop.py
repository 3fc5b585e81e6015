"""DeepChopper's chop of one read from its per-base labels, plain Python:
a majority vote over a 21-base window, the runs of 1 as adapter intervals,
and the read cut around them (the rules of `deepchopper-chop`, whose
defaults the CLI's `predict --fused-chop` uses)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ChopRules:
    smooth_window: int = 21
    min_interval_size: int = 13
    approved_intervals: int = 20
    max_process_intervals: int = 4
    min_read_len: int = 150
    min_part_len: int = 20


def majority_vote(labels: list[int], window: int) -> list[int]:
    """Each position takes the majority of its window (odd width, clipped at
    the read's start, moved left to full width at its end); a tie keeps the
    position's own label."""
    w = window + 1 if window % 2 == 0 else window
    half, n = w // 2, len(labels)
    prefix = [0]
    for v in labels:
        prefix.append(prefix[-1] + (v == 1))
    out = []
    for i, v in enumerate(labels):
        start, end = max(i - half, 0), min(i + half + 1, n)
        if end == n and end - start < w:
            start = max(end - w, 0)
        twice, size = 2 * (prefix[end] - prefix[start]), end - start
        out.append(1 if twice > size else 0 if twice < size else v)
    return out


def intervals(labels: list[int], rules: ChopRules) -> list[tuple[int, int]]:
    """[start, end) runs of 1 in the smoothed labels, at least
    `min_interval_size` long; a run at index 0 starts at 1; none at all when
    more than `approved_intervals` remain."""
    sm = majority_vote(labels, rules.smooth_window)
    runs, start = [], None
    for i, v in enumerate([*sm, 0]):
        if v == 1 and start is None:
            start = i
        elif v != 1 and start is not None:
            runs.append((max(start, 1), i))
            start = None
    kept = [(s, e) for s, e in runs if e > s and e - s >= rules.min_interval_size]
    return [] if len(kept) > rules.approved_intervals else kept


def chop(name: str, seq: bytes, qual: bytes, labels: list[int], truncated: bool, rules: ChopRules) -> list[bytes]:
    """The FASTQ records the read becomes."""
    whole = [b"@%s\n%s\n+\n%s\n" % (name.encode(), seq, qual)]
    cut = intervals(labels, rules)
    if len(seq) < rules.min_read_len or not cut or len(cut) > rules.max_process_intervals or truncated:
        return whole
    parts, cur = [], 0
    for s, e in sorted(cut):
        if cur < s:
            parts.append((cur, s))
        cur = e
    if cur < len(seq) - 1:  # the part after the last interval loses the read's last base
        parts.append((cur, len(seq) - 1))
    kind = b"T" if len(parts) == 1 else b"I"
    kept = [(s, e) for s, e in parts if e - s >= rules.min_part_len]
    if kept and kept[0][1] - kept[0][0] == len(seq):
        return whole
    return [b"@%s|%d:%d|%s\n%s\n+\n%s\n" % (name.encode(), s, e, kind, seq[s:e], qual[s:e]) for s, e in kept]
