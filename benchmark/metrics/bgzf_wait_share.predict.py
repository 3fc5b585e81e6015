"""Share of the traced window the chop worker waited on the BGZF writer's full
queue (`chop.bgzf_wait`, inside `chop.records`); the deflate itself runs on
the writer's own thread (`bgzf_share.predict`). None for a program whose
writer has no queue (`io.bgzf.BACKLOG_BYTES`): it deflates on its caller's
thread and never waits."""

from benchmark.metrics._program_spans import span_share


def read(run):
    try:
        from deepchopper_tpu_torch.io import bgzf
    except ImportError:
        return None
    if not hasattr(bgzf, "BACKLOG_BYTES"):
        return None
    return span_share(run, "predict", "chop.bgzf_wait")
