"""Share of the traced window that the chop worker spent in the majority vote
of its batches (`chop.vote`)."""

from benchmark.metrics._program_spans import span_share


def read(run):
    return span_share(run, "predict", "chop.vote")
