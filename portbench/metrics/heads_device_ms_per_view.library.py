"""Device time of the kernels launched inside the camera head's and the
DPT heads' spans, per requested view, over the forwards inside the trace."""

from portbench.readings import span_seconds, traced_views


def read(rec):
    views = traced_views(rec)
    if not views:
        return None
    return 1000.0 * (span_seconds(rec, "camera_head") + span_seconds(rec, "dpt_head")) / views
