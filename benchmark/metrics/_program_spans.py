"""Readings of the program's own spans (`deepchopper_tpu_torch.utils.trace`)
in the traced window, which several per-layer metrics share.

The program stamps its spans in ns since the epoch, the clock of the
profiler's device events, so a span lines up with the device's busy
intervals (`run.trace.busy`). Each reading is a share of the window, in
percent, of the spans clipped to it. A checkout whose program records no
spans reads None, as does a run outside the metric's kind.
"""

from __future__ import annotations

from benchmark.harness.trace import _union


def window_spans(run, kind: str):
    """(name, parent, start, end) in seconds of every program span that
    overlaps the window, clipped to it; None where there are none to read."""
    if run.trace is None or run.layer["kind"] != kind:
        return None
    try:
        from deepchopper_tpu_torch.utils import trace
    except ImportError:
        return None
    t0, t1 = run.trace.t0, run.trace.t1
    out = []
    for r in trace.spans():
        start, end = max(r.start_ns * 1e-9, t0), min(r.end_ns * 1e-9, t1)
        if end > start:
            out.append((r.name, r.parent, start, end))
    return out or None


def _share(run, seconds: float) -> float:
    return 100.0 * seconds / run.trace.window_s


def span_share(run, kind: str, name: str, parent: str | None = None):
    """Share of the window inside spans `name` (only those opened inside a
    span `parent`, where given), summed."""
    spans = window_spans(run, kind)
    if spans is None:
        return None
    return _share(run, sum(e - s for n, p, s, e in spans if n == name and (parent is None or p == parent)))


def self_share(run, kind: str, name: str):
    """Share of the window inside spans `name` and none of their children."""
    spans = window_spans(run, kind)
    if spans is None:
        return None
    own = sum(e - s for n, _p, s, e in spans if n == name)
    children = sum(e - s for _n, p, s, e in spans if p == name)
    return _share(run, own - children)


def idle_share(run, kind: str, inside):
    """Share of the window with nothing on the device while the host was in
    a span whose name passes `inside`; None where the trace holds no device
    activity (a run without a card)."""
    spans = window_spans(run, kind)
    if spans is None or not run.trace.busy_s:
        return None
    host = _union([(s, e) for n, _p, s, e in spans if inside(n)])
    busy, overlap, j = run.trace.busy, 0.0, 0
    for s, e in host:
        while j < len(busy) and busy[j][1] <= s:
            j += 1
        k = j
        while k < len(busy) and busy[k][0] < e:
            overlap += min(e, busy[k][1]) - max(s, busy[k][0])
            k += 1
    return _share(run, sum(e - s for s, e in host) - overlap)
