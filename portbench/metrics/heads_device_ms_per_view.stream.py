"""Device time of the kernels launched inside the program's
`model.camera_head` and `model.dpt_head` spans, per traced step of the
stream (one frame each)."""

from portbench.readings import span_seconds, traced_spans


def read(rec):
    steps = traced_spans(rec, "model.stream_step")
    if not steps:
        return None
    heads = span_seconds(rec, "model.camera_head") + span_seconds(rec, "model.dpt_head")
    return 1000.0 * heads / len(steps)
