"""Share of the traced window that the fused runner's feed thread spent handing
batches to the chop worker (`fused.handoff`), blocked on its full queue included."""

from benchmark.metrics._program_spans import span_share


def read(run):
    return span_share(run, "predict", "fused.handoff")
