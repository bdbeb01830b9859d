"""Analytic FLOPs (flops.forward_flops of the requested frames) of the
forwards that began after the profiler stopped, over the time from the
first of them to the last answer, as a share of the card's bf16 peak."""

from portbench.readings import untraced_mfu


def read(rec):
    return untraced_mfu(rec)
