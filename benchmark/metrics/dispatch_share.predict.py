"""Share of the traced window that the feed thread spent dispatching batches to
the card (`engine.dispatch`: plan, pad, copy in, graph replay or eager run)."""

from benchmark.metrics._program_spans import span_share


def read(run):
    return span_share(run, "predict", "engine.dispatch")
