"""Share of the traced window that the DataModule spent padding train batches
(`data.pad` inside `data.batch`)."""

from benchmark.metrics._program_spans import span_share


def read(run):
    return span_share(run, "train", "data.pad", parent="data.batch")
