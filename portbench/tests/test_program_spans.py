"""The reading of the program's own spans (program_spans.py) on synthetic
records and traces: device time into the spans a launch lies in, the rule
that names an idle gap (the launching thread's innermost span, else any
thread's; a wait never), each metric's number, and the span report driven
end to end on the CPU at the tiny test configuration."""

import pytest
import torch

from portbench import program_spans as PS

MS = 1_000_000  # ns


class Event:
    """The few methods of torch's _KinetoEvent that the readers call."""

    def __init__(self, name, start_ms, dur_ms, device="CPU", corr=0, linked=0, resource=0):
        self._name, self._start, self._dur = name, int(start_ms * MS), int(dur_ms * MS)
        self._device, self._corr, self._linked, self._resource = device, corr, linked, resource

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur

    def device_type(self):
        return f"DeviceType.{self._device}"

    def correlation_id(self):
        return self._corr

    def linked_correlation_id(self):
        return self._linked

    def device_resource_id(self):
        return self._resource

    def is_user_annotation(self):
        return False


def launch(corr, at_ms, thread=None):
    """A runtime launch at at_ms, made inside a profiled op on `thread` (a
    native id), or outside any (thread None)."""
    return Event("cudaLaunchKernel", at_ms, 0.01, corr=corr, linked=7 if thread else 0,
                 resource=thread or 99)


def kernel(corr, start_ms, dur_ms):
    return Event(f"kernel{corr}", start_ms, dur_ms, device="CUDA", corr=corr)


def span(name, t0_ms, t1_ms, thread, **counts):
    return {"name": name, "t0": int(t0_ms * MS), "t1": int(t1_ms * MS), "thread": thread,
            "parent": None, "counts": counts}


def names(out):
    return [g[0].removeprefix("idle while host in ") for g in out["idle_gaps"]]


@pytest.mark.parametrize("thread,want", [(11, "serve.copy_out"), (22, "other.work"),
                                         (33, "other.work"), (None, "other.work")])
def test_a_gap_is_named_by_the_launching_thread(thread, want):
    """Two threads in spans at the gap's midpoint: the launching thread's
    names it; a thread with none open (33), or an unknown one, gives the
    innermost of any thread (other.work is the shorter)."""
    spans = [span("serve.copy_out", 10, 40, 11), span("other.work", 15, 35, 22)]
    events = [launch(1, 1, 11), kernel(1, 2, 8), launch(2, 30, thread), kernel(2, 30, 10)]
    out = PS.attribute(events, 0, int(40 * MS), spans)
    assert names(out) == [want, "no span"]  # 10-30 ms, then 0-2
    assert out["idle_gaps_at_s"] == [0.010, 0.0]
    assert out["idle_by_name"][want] == pytest.approx(0.020)
    assert out["device_ops"] == 2


def test_the_backward_falls_back_to_the_step_and_a_wait_names_nothing():
    """Kernels launched by autograd's thread (33, no span of its own) go to
    the main thread's open spans; a queue span (no thread) is never a name
    and gets no device time."""
    spans = [span("train.step", 0, 100, 11), span("train.backward", 20, 90, 11),
             span("serve.queue", 45, 55, None)]
    events = [launch(1, 21, 33), kernel(1, 21, 19), launch(2, 50, 33), kernel(2, 60, 30),
              launch(3, 95, 11), kernel(3, 95, 5)]
    out = PS.attribute(events, 0, int(100 * MS), spans)
    step, backward, queue = spans
    assert names(out) == ["train.step", "train.backward", "train.step"]  # 0-21, 40-60, 90-95
    assert (step["launches"], step["dev_s"]) == (3, pytest.approx(0.054))
    assert (backward["launches"], backward["dev_s"]) == (2, pytest.approx(0.049))
    assert (queue["launches"], queue["dev_s"]) == (0, 0.0)
    only_queue = PS.attribute(events, 0, int(100 * MS), [span("serve.queue", 0, 100, None)])
    assert set(names(only_queue)) == {"no span"}


def _record(**extra):
    spans = [span("serve.queue", 1, 5, None, request=0), span("serve.queue", 2, 12, None,
                                                             request=1),
             span("serve.batch_wait", 0, 4, 11), span("serve.stage_in", 4, 6, 11),
             span("serve.forward", 6, 40, 11, scenes=2, frames_run=8, frames_requested=7),
             span("serve.copy_out", 40, 48, 11),
             span("serve.forward", 50, 80, 11, scenes=1, frames_run=4, frames_requested=4),
             span("serve.copy_out", 80, 84, 11),
             span("train.h2d", 100, 103, 12), span("train.h2d", 200, 205, 12),
             dict(span("train.step", 103, 190, 12), launches=300),
             dict(span("train.step", 205, 290, 12), launches=500),
             dict(span("train.step", 295, 400, 12), launches=1)]  # ends after the trace
    rec = {"window": {"t0": 0}, "program_spans": spans, "trace": {},
           "trace_window": (0, int(300 * MS)),
           "program_idle": {"serve.batch_wait": 0.006, "serve.stage_in": 0.001,
                            "serve.copy_out": 0.008, "serve.forward": 0.5, "no span": 0.1}}
    rec.update(extra)
    return rec


def test_each_metric_reads_its_number():
    rec = _record()
    assert PS.queue_wait_ms(rec) == pytest.approx(7.0)  # (4 + 10) / 2
    assert PS.batch_scenes(rec) == pytest.approx(1.5)
    assert PS.copy_out_ms(rec) == pytest.approx(6.0)
    assert PS.serving_idle_pct(rec) == pytest.approx(100 * 0.015 / 0.3)
    assert PS.h2d_ms(rec) == pytest.approx(4.0)
    assert PS.launches_per_step(rec) == pytest.approx(400.0)  # the traced two


def test_a_metric_without_its_spans_reads_nothing():
    bare = {"window": {"t0": 0}, "program_spans": [], "trace": None}
    for read in (PS.queue_wait_ms, PS.batch_scenes, PS.copy_out_ms, PS.serving_idle_pct,
                 PS.h2d_ms, PS.launches_per_step):
        assert read(bare) is None and read({"window": {"t0": 0}, "trace": None}) is None
    untraced = _record(trace=None)
    del untraced["program_idle"]
    assert PS.serving_idle_pct(untraced) is None and PS.launches_per_step(untraced) is None
    assert PS.batch_scenes(untraced) == pytest.approx(1.5)  # host spans read untraced too
    late = _record(window={"t0": int(500 * MS)})  # every span before the window
    assert PS.queue_wait_ms(late) is None and PS.h2d_ms(late) is None


def test_self_time_leaves_out_the_spans_inside():
    from portbench.span_report import self_ms

    spans = [dict(span("train.step", 0, 100, 11)), dict(span("train.forward", 10, 40, 11)),
             dict(span("train.backward", 40, 90, 11)), dict(span("train.step", 100, 150, 11)),
             dict(span("model.trunk", 12, 30, 11))]
    for s in spans[1:3]:
        s["parent"] = "train.step"
    spans[4]["parent"] = "train.forward"
    got = self_ms(spans)
    assert got["train.step"] == pytest.approx((20 + 50) / 2)
    assert got["train.forward"] == pytest.approx(12) and got["model.trunk"] == pytest.approx(18)


@pytest.mark.parametrize("workload,read", [
    ("serve-mixed", ("queue_wait_ms.serve", "batch_scenes.serve", "copy_out_ms.serve")),
    ("train-b2s4", ("h2d_ms.train",)),
])
def test_the_span_report_reads_a_rehearsal(workload, read):
    """The report's run on the CPU at the tiny configuration: correct, and
    the host readings are numbers (the device ones need a card)."""
    from portbench import span_report
    from portbench.rehearse import tiny_cell

    torch.set_num_threads(2)
    result, _, out = span_report.report(workload, 1, 1.5, False, device=torch.device("cpu"),
                                        cell=tiny_cell(workload))
    assert result["correct"], result
    got = out["metrics"]
    assert all(got[k] is not None and got[k] > 0 for k in read), got
    assert got["serving_idle_pct.serve"] is None and got["launches_per_step.train"] is None
