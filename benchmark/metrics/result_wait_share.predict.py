"""Share of the traced window that the engine's feed thread waited for a
batch's labels to reach the host (`engine.result_wait`)."""

from benchmark.metrics._program_spans import span_share


def read(run):
    return span_share(run, "predict", "engine.result_wait")
