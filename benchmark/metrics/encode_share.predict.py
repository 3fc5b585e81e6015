"""Share of the traced window that the encode thread spent encoding reads into
padded batches (`source.encode`)."""

from benchmark.metrics._program_spans import span_share


def read(run):
    return span_share(run, "predict", "source.encode")
