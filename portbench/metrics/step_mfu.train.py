"""Analytic FLOPs of the training steps asked for after the profiler
stopped (3 x the forward's, recomputation not counted), over the time from
the first of them to the end of the last, as a share of the card's bf16
peak."""

from portbench.readings import untraced_mfu


def read(rec):
    return untraced_mfu(rec)
