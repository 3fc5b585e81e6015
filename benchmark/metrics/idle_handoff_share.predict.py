"""Share of the traced window with nothing on the device while the feed thread
was handing a batch to the chop worker (`fused.handoff`)."""

from benchmark.metrics._program_spans import idle_share


def read(run):
    return idle_share(run, "predict", lambda name: name == "fused.handoff")
