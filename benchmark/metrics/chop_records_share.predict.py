"""Share of the traced window that the chop worker spent splitting records of
completed chunks (`chop.records`), its BGZF writes (`chop.bgzf`) left out."""

from benchmark.metrics._program_spans import self_share


def read(run):
    return self_share(run, "predict", "chop.records")
