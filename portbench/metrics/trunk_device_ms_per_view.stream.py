"""Device time of the kernels launched inside the program's `model.trunk`
spans (DINOv2, the frame blocks, the global blocks and their attention over
the cache), per traced step of the stream (one frame each)."""

from portbench.readings import span_seconds, traced_spans


def read(rec):
    steps = traced_spans(rec, "model.stream_step")
    return 1000.0 * span_seconds(rec, "model.trunk") / len(steps) if steps else None
