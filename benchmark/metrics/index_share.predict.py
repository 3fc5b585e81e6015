"""Share of the traced window that the encode thread spent reading and indexing
FASTQ chunks (`source.index`)."""

from benchmark.metrics._program_spans import span_share


def read(run):
    return span_share(run, "predict", "source.index")
