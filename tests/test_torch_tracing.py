"""The program's own spans (utils/profiling.span / recording) on the CPU:
nothing recorded while off, nesting, threads and counts, the profiler's
clock and ranges, and the spans of the serving path and of a train step
fed by the shard stream's batches.
"""

import threading
import time

import numpy as np
import pytest
import torch

from omnivggt_tpu_torch import config as TC
from omnivggt_tpu_torch import serving as TS
from omnivggt_tpu_torch.data.streaming import batch_stream
from omnivggt_tpu_torch.models.omnivggt import OmniVGGT
from omnivggt_tpu_torch.train import step as TTS
from omnivggt_tpu_torch.utils import profiling as P

HW = 28


@pytest.fixture(scope="module")
def model():
    return OmniVGGT(TC.tiny_test_config(), device="cpu", seed=0)


def _by_name(spans):
    """The spans by name; none starts with "cu", which a trace reader takes
    for the CUDA runtime's launches."""
    out = {}
    for s in spans:
        assert not s["name"].startswith("cu"), s["name"]
        out.setdefault(s["name"], []).append(s)
    return out


def _inside(inner, outer):
    return outer["t0"] <= inner["t0"] and inner["t1"] <= outer["t1"]


def test_span_off_records_nothing():
    off = P.span("a", n=1)
    assert off is P._OFF and P.span("b") is off
    with off:
        P.record_since("c", time.time_ns())
    with P.recording() as rec:
        with P.span("d"):
            pass
        with pytest.raises(RuntimeError):
            with P.recording():
                pass
    with P.span("e"):
        pass
    assert [s["name"] for s in rec.spans] == ["d"]
    assert P.span("f") is P._OFF


def test_spans_nest_across_threads_with_counts():
    def worker():
        with P.span("w.outer"):
            with P.span("w.inner", items=3):
                time.sleep(0.001)

    t_wait = time.time_ns()
    with P.recording() as rec:
        with P.span("m.outer", scenes=2, frames=8):
            th = threading.Thread(target=worker)
            th.start()
            with P.span("m.inner"):
                time.sleep(0.001)
            th.join(timeout=30)
        P.record_since("m.queue", t_wait, request=7)
    assert not th.is_alive()
    got = {s["name"]: s for s in rec.spans}
    assert set(got) == {"m.outer", "m.inner", "w.outer", "w.inner", "m.queue"}
    main, other = threading.get_native_id(), th.native_id
    assert got["m.outer"]["thread"] == got["m.inner"]["thread"] == main
    assert got["w.outer"]["thread"] == got["w.inner"]["thread"] == other != main
    # the parent is the span open around it on its own thread
    assert got["m.inner"]["parent"] == "m.outer" and got["m.outer"]["parent"] is None
    assert got["w.inner"]["parent"] == "w.outer" and got["w.outer"]["parent"] is None
    assert got["m.outer"]["counts"] == {"scenes": 2, "frames": 8}
    assert got["w.inner"]["counts"] == {"items": 3} and got["m.inner"]["counts"] == {}
    assert got["m.queue"] == {"name": "m.queue", "t0": t_wait, "t1": got["m.queue"]["t1"],
                              "thread": None, "parent": None, "counts": {"request": 7}}
    for inner, outer in (("m.inner", "m.outer"), ("w.inner", "w.outer"),
                         ("w.outer", "m.outer")):
        assert _inside(got[inner], got[outer]), (inner, outer)
    assert all(s["t1"] > s["t0"] for s in rec.spans)


def test_span_under_the_profiler_holds_its_ops():
    """time.time_ns is the profiler's clock: an op inside a span has its
    event inside the span's interval, and the span is a record_function
    range of its name."""
    x = torch.randn(64, 64)
    with P.recording() as rec:
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
        prof.start()
        with P.span("tracing.mm"):
            (x @ x).sum()
        prof.stop()
    (s,) = rec.spans
    events = prof.profiler.kineto_results.events()
    (mm,) = [e for e in events if e.name() == "aten::mm"]
    (ranged,) = [e for e in events if e.name() == "tracing.mm"]
    for e in (mm, ranged):
        assert s["t0"] <= e.start_ns() and e.start_ns() + e.duration_ns() <= s["t1"]
    assert ranged.start_ns() <= mm.start_ns()
    assert ranged.start_thread_id() == mm.start_thread_id()


def test_batcher_spans_count_the_requests_and_their_frames(model):
    """Concurrent requests of two keys (S 2 exact in bucket 2, S 3 padded
    to bucket 4) through the Batcher: one queue span a request, and the
    forward spans' counts add up to the requests' scenes and frames."""
    session = TS.InferenceSession(model, buckets=(2, 4), pad_mode="bucket")
    sizes = [2, 2, 3, 3]
    rng = np.random.default_rng(0)
    images = [rng.uniform(size=(S, HW, HW, 3)).astype(np.float32) for S in sizes]
    results = {}
    with P.recording() as rec:
        batcher = TS.Batcher(session, max_batch=4, window_ms=200.0)

        def submit(i):
            results[i] = batcher.submit(timeout=120.0, images=images[i])

        threads = [threading.Thread(target=submit, args=(i,)) for i in range(len(sizes))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        batcher.close()
    assert not any(th.is_alive() for th in threads) and len(results) == len(sizes)
    got = _by_name(rec.spans)
    queued = got["serve.queue"]
    assert sorted(s["counts"]["request"] for s in queued) == [0, 1, 2, 3]
    forwards = got["serve.forward"]
    assert sum(s["counts"]["scenes"] for s in forwards) == len(sizes)
    assert sum(s["counts"]["frames_requested"] for s in forwards) == sum(sizes)
    assert sum(s["counts"]["frames_run"] for s in forwards) == 2 * 2 + 2 * 4
    n = len(forwards)
    assert 2 <= n <= 4
    for name in ("serve.stage_in", "serve.copy_out", "model.trunk", "model.camera_head"):
        assert len(got[name]) == n, name
    assert len(got["model.dpt_head"]) == 2 * n
    batcher_thread = batcher._thread.native_id
    for name in ("serve.batch_wait", "serve.stage_in", "serve.forward", "serve.copy_out"):
        assert all(s["thread"] == batcher_thread and s["parent"] is None for s in got[name])
    for name in ("model.trunk", "model.camera_head", "model.dpt_head"):
        assert all(s["parent"] == "serve.forward" for s in got[name]), name
    assert sum(s["counts"]["frames"] for s in got["model.trunk"]) == 2 * 2 + 2 * 4
    # each request waited from its submit until the Batcher took its group,
    # before the forward that ran it
    assert all(q["t1"] <= max(f["t0"] for f in forwards) for q in queued)


def test_train_step_spans_from_the_batch_stream():
    """One step fed by batch_stream: the consumer's wait, the copy to the
    device, and the step enclosing its forward, backward and update."""
    cfg = TC.tiny_test_config()
    model = OmniVGGT(cfg, device="cpu", seed=0)
    samples = [{k: v.numpy() for k, v in TTS.synthetic_batch(2, HW, "cpu", seed=i).items()}
               for i in range(2)]
    opt = TTS.make_optimizer(model, learning_rate=1e-4, warmup_steps=1, total_steps=10)
    step = TTS.make_train_step(cfg, opt, use_aux_inputs=True)
    state = TTS.init_state(model, opt)
    with P.recording() as rec:
        batches = batch_stream(iter(samples), 2)
        batch = next(batches)
        state, metrics = step(state, TTS.batch_to_device(batch, torch.device("cpu")))
        batches.close()
    assert np.isfinite(metrics["total"].item())
    got = _by_name(rec.spans)
    assert len(got["data.wait"]) == 1 and len(got["train.h2d"]) == 1
    (whole,) = got["train.step"]
    assert whole["parent"] is None
    for name in ("train.forward", "train.backward", "train.optimizer"):
        (s,) = got[name]
        assert s["parent"] == "train.step" and _inside(s, whole), name
    assert got["train.forward"][0]["t1"] <= got["train.backward"][0]["t0"]
    assert got["train.backward"][0]["t1"] <= got["train.optimizer"][0]["t0"]
    (trunk,) = got["model.trunk"]
    assert trunk["parent"] == "train.forward" and trunk["counts"] == {"frames": 4}
    assert got["data.wait"][0]["t1"] <= got["train.h2d"][0]["t0"] <= whole["t0"]
