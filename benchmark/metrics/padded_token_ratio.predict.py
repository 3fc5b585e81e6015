"""Tokens the device computed (rows x width of every dispatch) over the
reads' own tokens, in the window: the engine's `PredictStats` counters."""


def read(run):
    layer = run.layer
    if layer["kind"] != "predict" or not layer["tokens"]:
        return None
    return layer["padded_tokens"] / layer["tokens"]
