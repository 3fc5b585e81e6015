"""Share of the fused runner's wall time that its feed thread spent not
blocked on the model (`FusedStats.encode_s`, which holds encode, dispatch
and Python alike), summed over the window's passes."""


def read(run):
    layer = run.layer
    if layer["kind"] != "predict" or not layer["elapsed_s"]:
        return None
    return 100.0 * layer["feed_s"] / layer["elapsed_s"]
