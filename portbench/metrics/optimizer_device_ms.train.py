"""Device time of the optimizer's foreach / multi-tensor kernels (AdamW and
the clip) a traced step."""

from portbench.readings import span_seconds, traced_spans


def read(rec):
    steps = traced_spans(rec, "step")
    if not steps:
        return None
    return 1000.0 * span_seconds(rec, "step", "optim_s") / len(steps)
