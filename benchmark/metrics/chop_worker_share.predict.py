"""Share of the fused runner's wall time that its chop worker was busy:
majority vote and regions, then record split and BGZF write
(`FusedStats.smooth_s + chop_write_s`), summed over the window's passes."""


def read(run):
    layer = run.layer
    if layer["kind"] != "predict" or not layer["elapsed_s"]:
        return None
    return 100.0 * layer["chop_s"] / layer["elapsed_s"]
