"""The program's own spans read against a device trace.

The program records spans of its own work (`omnivggt_tpu_torch.utils.
profiling.span`, switched on by `profiling.recording()`): each a dict of
name, t0 and t1 (time.time_ns, the clock of torch.profiler's events),
thread (threading.get_native_id; None for a span recorded after the fact,
such as a request's wait in the queue), parent and counts. A run that
records them over its window keeps them as `record["program_spans"]`.

The spans: `serve.queue` (a request, enqueue to the Batcher taking it;
count `request`), `serve.batch_wait`, `serve.stage_in`, `serve.forward`
(counts `scenes`, `frames_run`, `frames_requested`), `serve.copy_out`,
`model.trunk` (count `frames`), `model.camera_head`, `model.dpt_head`,
`data.wait`, `train.h2d`, and `train.step` with `train.forward`,
`train.backward` and `train.optimizer` inside it.

`run.py` does not record them, so no cell reports what they feed;
`span_report.py` runs a cell as `run.py` does with them recorded.

`attribute` reads a traced window's raw events against spans (the
program's, and the harness's where they carry a thread) and:

  - gives each span the device seconds (`dev_s`) and the count
    (`launches`) of the device operations launched inside it;
  - names each idle gap of the device by the innermost span open at the
    gap's midpoint on the thread that launched the operation ending the
    gap; where that thread has none open (autograd's worker thread in the
    backward), or the launching thread is not known, by the innermost span
    open then on any thread. A span without a thread is a wait, not host
    work, and names nothing (`serve.queue`).

A launch's thread is known when the profiler saw the op it was made in:
its `linked_correlation_id()` is that op's, and its `device_resource_id()`
the thread's native id. Ops are seen on the thread that started the
profiler and on autograd's threads; launches from other threads are not
linked (torch.profiler's `profile_all_threads` would link them).

The per-layer numbers that read them are the functions at the end, each
over such a record (`readings.py` says what else a record holds).
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional

from portbench.harness import _gpu_event

# the spans of the serving layer's own host work between forwards
SERVING_HOST = ("serve.batch_wait", "serve.stage_in", "serve.copy_out")


class _Open:
    """Which spans are open at a time, on a thread or on any thread."""

    def __init__(self, spans: List[dict]):
        self.spans = sorted((s for s in spans if s.get("thread") is not None),
                            key=lambda s: s["t0"])
        self.starts = [s["t0"] for s in self.spans]
        self.longest = max((s["t1"] - s["t0"] for s in self.spans), default=0)

    def at(self, t: int, thread=None) -> List[dict]:
        """The spans open at t on `thread`, or on any thread where that one
        has none open or is not known."""
        i = bisect.bisect_right(self.starts, t)
        j = bisect.bisect_left(self.starts, t - self.longest)
        held = [s for s in self.spans[j:i] if s["t1"] >= t]
        own = [s for s in held if s["thread"] == thread]
        return own if own else held

    def innermost(self, t: int, thread=None) -> str:
        held = self.at(t, thread)
        return min(held, key=lambda s: s["t1"] - s["t0"])["name"] if held else "no span"


def attribute(events, t0: int, t1: int, spans: List[dict]) -> dict:
    """Device time and launches into `spans` (in place: dev_s, launches),
    and the traced window's idle time by the name of its gaps: returns
    {"device_ops": the count, "idle_by_name": {name: s}, "idle_gaps": the
    ten longest, [name, s], "idle_gaps_at_s": where each of those began,
    seconds after t0}."""
    launches, gpu = {}, []
    for e in events:
        if _gpu_event(e):
            if e.duration_ns() > 0:
                gpu.append(e)
        elif e.name().startswith("cu"):
            thread = e.device_resource_id() if e.linked_correlation_id() else None
            launches[e.correlation_id()] = (e.start_ns(), thread)
    opened = _Open(spans)
    for s in spans:
        s["dev_s"], s["launches"] = 0.0, 0

    def launch_of(e):
        return launches.get(e.correlation_id()) or launches.get(e.linked_correlation_id())

    for e in gpu:
        at = launch_of(e)
        if at is None:
            continue
        for s in opened.at(*at):
            s["dev_s"] += e.duration_ns() / 1e9
            s["launches"] += 1
    gpu.sort(key=lambda e: e.start_ns())
    idle: Dict[str, float] = defaultdict(float)
    gaps = []
    busy_to = t0
    for e in gpu:
        start = e.start_ns()
        if start > busy_to:
            at = launch_of(e)
            name = opened.innermost((busy_to + start) // 2, at[1] if at else None)
            idle[name] += (start - busy_to) / 1e9
            gaps.append((name, (start - busy_to) / 1e9, busy_to))
        busy_to = max(busy_to, start + e.duration_ns())
    if t1 > busy_to:
        name = opened.innermost((busy_to + t1) // 2)
        idle[name] += (t1 - busy_to) / 1e9
        gaps.append((name, (t1 - busy_to) / 1e9, busy_to))
    gaps.sort(key=lambda g: -g[1])
    return {"device_ops": len(gpu), "idle_by_name": dict(idle),
            "idle_gaps": [[f"idle while host in {n}", s] for n, s, _ in gaps[:10]],
            "idle_gaps_at_s": [(at - t0) / 1e9 for _, _, at in gaps[:10]]}


# ---------------------------------------------------------------------------
# readings of a record with program_spans (and, traced, program_idle:
# attribute's idle_by_name)
# ---------------------------------------------------------------------------


def window_spans(rec, name) -> List[dict]:
    """The program's spans of `name` begun in the window."""
    t0 = rec["window"]["t0"]
    return [s for s in rec.get("program_spans") or () if s["name"] == name and s["t0"] >= t0]


def traced_program_spans(rec, name) -> List[dict]:
    """The program's spans of `name` that ran wholly inside the profiler's
    interval."""
    if rec.get("trace") is None:
        return []
    t0, t1 = rec["trace_window"]
    return [s for s in rec.get("program_spans") or ()
            if s["name"] == name and s["t0"] >= t0 and s["t1"] <= t1]


def mean_ms(rec, name) -> Optional[float]:
    """Mean host milliseconds of the window's spans `name`."""
    spans = window_spans(rec, name)
    return sum(s["t1"] - s["t0"] for s in spans) / len(spans) / 1e6 if spans else None


def queue_wait_ms(rec) -> Optional[float]:
    """Mean wait of the window's requests, from the enqueue to the Batcher
    taking their group (a request is recorded when taken)."""
    return mean_ms(rec, "serve.queue")


def batch_scenes(rec) -> Optional[float]:
    """Mean scenes a served forward."""
    fwd = window_spans(rec, "serve.forward")
    return sum(s["counts"]["scenes"] for s in fwd) / len(fwd) if fwd else None


def copy_out_ms(rec) -> Optional[float]:
    """Mean host milliseconds of a served forward's copy-out (cast, copy to
    the host, the split by scene)."""
    return mean_ms(rec, "serve.copy_out")


def serving_idle_pct(rec) -> Optional[float]:
    """The device's idle time named by the serving layer's own host work
    between forwards, as a share of the traced window."""
    idle = rec.get("program_idle")
    if idle is None or not window_spans(rec, "serve.forward"):
        return None
    t0, t1 = rec["trace_window"]
    return 100.0 * sum(idle.get(n, 0.0) for n in SERVING_HOST) / ((t1 - t0) / 1e9)


def h2d_ms(rec) -> Optional[float]:
    """Mean host milliseconds of a step's copy of its batch to the device."""
    return mean_ms(rec, "train.h2d")


def launches_per_step(rec) -> Optional[float]:
    """Device operations launched inside a traced step."""
    steps = traced_program_spans(rec, "train.step")
    return sum(s["launches"] for s in steps) / len(steps) if steps else None
