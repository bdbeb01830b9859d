"""A cell's run with the program's own spans recorded, and what they show.

    python3 -m portbench.span_report --workload <name> --seed <n> --seconds <s> --trace <0|1>

The run is `portbench.run`'s (set-up, the window, the check, the result
line), with the program's spans recorded over the whole window
(`omnivggt_tpu_torch.utils.profiling.recording`) and the harness's spans
carrying their thread. In a traced run the profiler's raw events are kept
and read against both (`program_spans.attribute`). Standard output: one
line {"program_spans": ...} with the readings, then the run's own result
line, last. Untraced, it measures what recording costs: compare its
end-to-end metrics with `portbench.run`'s.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time
from collections import defaultdict

from portbench import harness
from portbench import program_spans as PS
from portbench import run

harness.prepare_environment()


class _ThreadedSpans(harness.Spans):
    """The harness's spans, each with the native id of its thread."""

    def add(self, name: str, t0: int, t1: int, **info) -> None:
        super().add(name, t0, t1, thread=threading.get_native_id(), **info)


class RecordedWindow(run.WindowControl):
    """run.WindowControl that also records the program's spans from the
    window's start to its stop, and keeps the last window for reading."""

    last = None

    def __init__(self, traced: bool, trace_seconds: float):
        super().__init__(traced, trace_seconds)
        self.spans = _ThreadedSpans()
        self._recording = None

    def start(self):
        from omnivggt_tpu_torch.utils import profiling

        self.t_start = time.time_ns()
        self._recording = profiling.recording()
        self.recorder = self._recording.__enter__()
        super().start()

    def stop(self):
        super().stop()
        if self._recording is not None:
            self._recording.__exit__(None, None, None)
            self._recording = None
        RecordedWindow.last = self


def readings(ctl: RecordedWindow) -> dict:
    """The record of the window's spans, read: the six metrics, and in a
    traced run the idle time by span and each span's device time."""
    from portbench import readings as R

    rec = {"window": {"t0": ctl.t_start}, "program_spans": ctl.recorder.spans,
           "spans": ctl.spans.items, "trace": None}
    traced = "events" in ctl.trace
    if traced:
        t0, t1 = ctl.trace["t0"], ctl.trace["t1"]
        named = PS.attribute(ctl.trace["events"], t0, t1,
                             rec["program_spans"] + [dict(s) for s in rec["spans"]])
        traced = named["device_ops"] > 0  # else nothing ran on a device
    if traced:
        rec.update(trace={}, trace_window=(t0, t1), program_idle=named["idle_by_name"])
    out = {"metrics": {
        "queue_wait_ms.serve": PS.queue_wait_ms(rec), "batch_scenes.serve": PS.batch_scenes(rec),
        "copy_out_ms.serve": PS.copy_out_ms(rec),
        "serving_idle_pct.serve": PS.serving_idle_pct(rec), "h2d_ms.train": PS.h2d_ms(rec),
        "launches_per_step.train": PS.launches_per_step(rec)}}
    counts = defaultdict(int)
    for s in rec["program_spans"]:
        counts[s["name"]] += 1
    out["spans_in_window"] = dict(counts)
    out["self_ms"] = self_ms(rec["program_spans"])
    if not traced:
        return out
    idle = named["idle_by_name"]
    total = sum(idle.values())
    window_s = (t1 - t0) / 1e9
    out["idle_s"] = total
    out["window_s"] = window_s
    out["idle_by_span_s"] = dict(sorted(idle.items(), key=lambda kv: -kv[1]))
    out["idle_named_share"] = 1.0 - idle.get("no span", 0.0) / total if total else None
    out["idle_gaps"] = named["idle_gaps"]
    out["idle_gaps_at_s"] = named["idle_gaps_at_s"]
    by_span = defaultdict(lambda: [0, 0.0, 0])
    for name in counts:
        for s in PS.traced_program_spans(rec, name):
            b = by_span[name]
            b[0] += 1
            b[1] += s["dev_s"]
            b[2] += s["launches"]
    out["traced_by_span"] = {k: {"spans": v[0], "device_s": v[1], "launches": v[2]}
                             for k, v in by_span.items()}
    views = R.traced_views(rec)
    if views:
        trunk = by_span["model.trunk"][1]
        heads = by_span["model.camera_head"][1] + by_span["model.dpt_head"][1]
        out["device_ms_per_view"] = {"model.trunk": 1000.0 * trunk / views,
                                     "model.camera_head+model.dpt_head": 1000.0 * heads / views}
    return out


def self_ms(spans) -> dict:
    """Mean host milliseconds of each span name outside the spans opened
    inside it on its thread."""
    inner = defaultdict(int)
    for c in spans:
        if c["parent"] is None:
            continue
        for p in spans:
            if (p["name"] == c["parent"] and p["thread"] == c["thread"]
                    and p["t0"] <= c["t0"] and c["t1"] <= p["t1"]):
                inner[id(p)] += c["t1"] - c["t0"]
                break
    total, n = defaultdict(int), defaultdict(int)
    for s in spans:
        total[s["name"]] += s["t1"] - s["t0"] - inner[id(s)]
        n[s["name"]] += 1
    return {k: total[k] / n[k] / 1e6 for k in total}


def report(workload: str, seed: int, seconds: float, trace: bool, device=None,
           cell=None) -> tuple:
    """portbench.run.execute under RecordedWindow: (result, compared, the
    readings of the program's spans)."""
    saved = run.WindowControl
    run.WindowControl = RecordedWindow
    try:
        result, compared = run.execute(workload, seed, seconds, trace, device=device,
                                       cell=cell, setup_from_call=cell is not None)
    finally:
        run.WindowControl = saved
    return result, compared, readings(RecordedWindow.last)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch  # noqa: F401 - after the environment is set

    from portbench import config as C

    harness.require_devices(C.cell(args.workload)["chips"])
    print(f"portbench: card {harness.card_line()}", file=sys.stderr)
    result, compared, read = report(args.workload, args.seed, args.seconds, bool(args.trace))
    print(json.dumps({"program_spans": read}))
    return harness.emit(result, compared)


if __name__ == "__main__":
    sys.exit(main())
