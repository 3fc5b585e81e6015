"""Share of the traced window with nothing on the device while the host was in
the train step (any `train.*` span: forward, backward, optimizer, stats)."""

from benchmark.metrics._program_spans import idle_share


def read(run):
    return idle_share(run, "train", lambda name: name.startswith("train."))
