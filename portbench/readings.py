"""Helpers the metric readers (metrics/<name>.py) share: the window's
requests or steps, and the traced part of a traced run.

A record holds: `kind` (infer or train), `requests` (each with views,
submit and done times in ns, ok, flops, attn_bound_s; a training step also
data_wait_s), `window` (t0, t_end), `spans` (name, t0, t1; the forward
spans also batch, frames, requested, bound_s and flops), `trace`
(harness.read_trace's reduction, None untraced), `trace_window` (the
profiler's interval), `trace_stopped` (when it had handed its events
over), `setup_s` and `peak_window_bytes`.
"""

from __future__ import annotations

from portbench.flops import PEAK_BF16_FLOPS


def answered(rec):
    return [r for r in rec["requests"] if r["ok"]]


def views_per_s(rec):
    done = answered(rec)
    if not done:
        return None
    span = (max(r["done"] for r in done) - rec["window"]["t0"]) / 1e9
    return sum(r["views"] for r in done) / span


def traced_spans(rec, name):
    """Spans of `name` that ran wholly inside the profiler's interval."""
    if rec.get("trace") is None:
        return []
    t0, t1 = rec["trace_window"]
    return [s for s in rec["spans"] if s["name"] == name and s["t0"] >= t0 and s["t1"] <= t1]


def traced_views(rec):
    """Requested frames of the forwards inside the traced interval."""
    return sum(s["requested"] for s in traced_spans(rec, "forward"))


def span_seconds(rec, name, field="dev_s"):
    """Device seconds (dev_s, attn_s or optim_s) of the kernels launched
    inside the traced spans `name`."""
    return sum(s[field] for s in traced_spans(rec, name))


def idle_pct(rec):
    t = rec.get("trace")
    if t is None or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def untraced_mfu(rec):
    """Analytic FLOPs of the work that started after the profiler had
    stopped (its events handed over), over the time from that work's start
    to the last answer, as a share of the bf16 peak. Served scenes count
    the forwards that began after the stop (the forward spans, one at a
    time on the device; the serving layer answers a forward's requests
    before it starts the next), so a request already in flight at the stop
    adds nothing; training counts the steps asked for after it."""
    if rec.get("trace") is None:
        return None
    t1 = rec["trace_stopped"]
    if rec["kind"] == "train":
        units = [(r["submit"], r["flops"]) for r in answered(rec) if r["submit"] >= t1]
    else:
        units = [(s["t0"], s["flops"]) for s in rec["spans"]
                 if s["name"] == "forward" and s["t0"] >= t1]
    done = [r["done"] for r in answered(rec)]
    if not units or not done:
        return None
    span = (max(done) - min(t for t, _ in units)) / 1e9
    if span <= 0:
        return None
    return 100.0 * sum(f for _, f in units) / span / PEAK_BF16_FLOPS


def attention_roofline(rec, span_name):
    """Least time of the attention work in the traced spans over the
    attention kernels' device time in them."""
    spans = traced_spans(rec, span_name)
    device = sum(s["attn_s"] for s in spans)
    if not spans or device <= 0:
        return None
    if span_name == "forward":
        bound = sum(s["bound_s"] for s in spans)
    else:  # training steps: each step's own bound, forward and backward
        bound = len(spans) * rec["requests"][0]["attn_bound_s"]
    return 100.0 * bound / device
