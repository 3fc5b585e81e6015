"""Share of the traced window that the engine's feed thread waited on the
encode thread for its next batch (`engine.prefetch_wait`)."""

from benchmark.metrics._program_spans import span_share


def read(run):
    return span_share(run, "predict", "engine.prefetch_wait")
