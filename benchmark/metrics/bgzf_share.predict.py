"""Share of the traced window spent in BGZF deflate and writes of the chopped
output (`chop.bgzf`), on the chop worker and at the writer's close."""

from benchmark.metrics._program_spans import span_share


def read(run):
    return span_share(run, "predict", "chop.bgzf")
