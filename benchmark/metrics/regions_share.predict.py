"""Share of the traced window that the chop worker spent in its per-read loop
of adapter regions (`chop.regions`)."""

from benchmark.metrics._program_spans import span_share


def read(run):
    return span_share(run, "predict", "chop.regions")
