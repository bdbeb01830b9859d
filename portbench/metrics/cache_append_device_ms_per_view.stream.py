"""Device time of the kernels launched inside the program's
`stream.cache_append` spans (the keys and values of a frame written into
the stream's cache), per traced step (one frame each)."""

from portbench.readings import span_seconds, traced_spans


def read(rec):
    steps = traced_spans(rec, "model.stream_step")
    if not steps:
        return None
    return 1000.0 * span_seconds(rec, "stream.cache_append") / len(steps)
