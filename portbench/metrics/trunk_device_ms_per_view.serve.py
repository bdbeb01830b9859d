"""Device time of the kernels launched inside the aggregator's span
(DINOv2 and the frame / global blocks), per requested view, over the
forwards inside the trace."""

from portbench.readings import span_seconds, traced_views


def read(rec):
    views = traced_views(rec)
    return 1000.0 * span_seconds(rec, "trunk") / views if views else None
