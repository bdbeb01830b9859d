"""Analytic operations (flops_stream.step_flops, each frame's step with the
frames cached before it) of the steps that began after the profiler
stopped, over the time from the first of them to the last answer, as a
share of the card's bf16 peak."""

from portbench.flops import PEAK_BF16_FLOPS
from portbench.readings import answered


def read(rec):
    if rec.get("trace") is None:
        return None
    steps = [r for r in answered(rec) if r["submit"] >= rec["trace_stopped"]]
    if not steps:
        return None
    span = (max(r["done"] for r in steps) - min(r["submit"] for r in steps)) / 1e9
    return 100.0 * sum(r["flops"] for r in steps) / span / PEAK_BF16_FLOPS
