"""Share of the traced window that the DataModule spent producing train batches
(`data.batch`: read, encode, shuffle, bucket), padding (`data.pad`) left out."""

from benchmark.metrics._program_spans import self_share


def read(run):
    return self_share(run, "train", "data.batch")
