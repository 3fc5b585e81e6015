"""Share of the traced window that the chop worker spent waiting for a batch
(`fused.worker_wait`)."""

from benchmark.metrics._program_spans import span_share


def read(run):
    return span_share(run, "predict", "fused.worker_wait")
