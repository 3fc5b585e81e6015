"""Share of the window the train loop spent waiting for its next batch:
the DataModule's iterator and the copy of the batch to the card, timed by
the harness around those calls."""


def read(run):
    layer = run.layer
    if layer["kind"] != "train":
        return None
    return 100.0 * layer["wait_s"] / layer["window_s"]
