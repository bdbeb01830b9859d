"""The cell stream-s256 driven end to end on the CPU at the tiny test
configuration, frame-causal: a sound run compares and is correct, each of
the stream's planted faults and the lower-precision control read far above
it, a traced run records the program's spans, and `flops_stream` counts what
was worked by hand."""

import dataclasses
import math

import pytest
import torch

from omnivggt_tpu_torch.config import tiny_test_config
from portbench import config as C
from portbench import controls_stream, flops, flops_stream, run

torch.set_num_threads(2)
ARCH = C.config("streamvggt-1b")["architecture"]
P = 1 + 4 + 37 * 37  # 1374 tokens a frame at 518 px
# the cell's limits are set for the published widths, where the bf16 trunk
# reads far above float32 rounding; at the tiny size the program computes
# in float32 like the reference (readings ~1e-6), so each compared number
# is held here to 100x that
TINY_LIMIT = 1e-4


@pytest.fixture(autouse=True)
def tiny_limits(monkeypatch):
    committed = run.limits_file

    def limits_file(workload):
        out = committed(workload)
        return dict(out, limits={k: TINY_LIMIT for k in out["limits"]})

    monkeypatch.setattr(run, "limits_file", limits_file)


def tiny_stream_cell() -> dict:
    """stream-s256 at the tiny configuration: 28 px frames, clips of 6 in a
    cache of 8, the check at a frame in 2..4, the trace from frame 1."""
    cell = C.cell("stream-s256")
    cfg = dataclasses.replace(tiny_test_config(), global_attention="frame_causal")
    cell["program_cfg"] = cfg
    cell["config_data"] = dict(cell["config_data"], architecture=C.arch_of(cfg),
                               stream=dict(cell["config_data"]["stream"], capacity=8))
    cell["traffic_data"] = dict(cell["traffic_data"], image_size=28, clip_frames=6,
                                pool_frames=4, warmup_frames=2, check={"frame_range": [2, 4]},
                                trace_from_frame=1, trace_seconds=0.3)
    return cell


def _run(variant, seed=5):
    return controls_stream.run_variant(variant, seed, 0.5, device=torch.device("cpu"),
                                       cell=tiny_stream_cell())


def test_a_sound_run_compares_and_is_correct():
    out = _run("program")
    assert out["correct"], out
    assert out["checked"]["answers"] == 1 and out["checked"]["views"] >= 3
    assert out["attempted"] % 6 == 0 and out["failed"] == 0  # whole clips only
    assert all(v < TINY_LIMIT / 10 for v in out["readings"].values()), out["readings"]


@pytest.mark.parametrize("fault", ["own_keys", "oldest_dropped", "slot0_everywhere"])
def test_a_planted_fault_is_not_correct(fault):
    sound = _run("program")["readings"]
    out = _run(fault)
    assert not out["correct"], out
    assert max(out["readings"].values()) >= 100 * max(sound.values())


def test_the_control_reads_far_above_the_program():
    sound = _run("program")["readings"]
    control = _run("control")["readings"]
    assert max(control.values()) >= 10 * max(max(sound.values()), 1e-7), (sound, control)


def test_a_traced_run_is_correct():
    result, _ = run.execute("stream-s256", 7, 0.5, True, device=torch.device("cpu"),
                            setup_from_call=True, cell=tiny_stream_cell())
    assert result["correct"]
    # the CPU's trace holds no device time: no attention to set against its bound
    assert "attn_roofline.stream" not in result["metrics"]
    assert result["metrics"]["frame_p90_ms.stream"]["value"] > 0  # read on the host clock


def test_the_stream_readers_by_hand():
    """The .stream metrics over a record built by hand: two traced steps
    (frames 3 and 4 of 518 px), their program spans' device seconds."""
    from portbench.harness import read_metric

    def span(name, t0, t1, dev=0.0, attn=0.0, **counts):
        return {"name": name, "t0": t0, "t1": t1, "dev_s": dev, "attn_s": attn,
                "optim_s": 0.0, "counts": counts, "hw": (518, 518)}

    spans = [span("model.stream_step", 10, 20, 0.1, 0.04, frame=3, cached_frames=3),
             span("model.stream_step", 20, 30, 0.1, 0.05, frame=4, cached_frames=4),
             span("model.stream_step", 40, 50, 0.1, 0.05, frame=5, cached_frames=5),  # untraced
             span("model.trunk", 10, 18, 0.07), span("model.trunk", 20, 28, 0.08),
             span("model.camera_head", 18, 19, 0.002), span("model.dpt_head", 19, 20, 0.01),
             span("stream.cache_append", 11, 12, 0.0002), span("stream.cache_append", 21, 22, 0.0004)]
    requests = [{"ok": True, "views": 1, "submit": 10 + 10 * i, "done": 20 + 10 * i,
                 "flops": flops_stream.step_flops(ARCH, 3 + i, 518, 518)} for i in range(4)]
    rec = {"arch": ARCH, "spans": spans, "requests": requests, "trace_window": (5, 35),
           "trace_stopped": 36, "trace": {"busy_s": 27e-9, "window_s": 30e-9}}
    bound = sum(flops_stream.attention_bound_s(ARCH, t, 518, 518) for t in (3, 4))
    assert read_metric("attn_roofline.stream", rec) == pytest.approx(100 * bound / 0.09)
    assert read_metric("trunk_device_ms_per_view.stream", rec) == pytest.approx(75.0)
    assert read_metric("heads_device_ms_per_view.stream", rec) == pytest.approx(6.0)
    assert read_metric("cache_append_device_ms_per_view.stream", rec) == pytest.approx(0.3)
    assert read_metric("device_idle_pct.stream", rec) == pytest.approx(10.0)
    # the steps submitted after the profiler stopped: the one at 40, done at 50
    mfu = 100 * requests[3]["flops"] / 10e-9 / flops.PEAK_BF16_FLOPS
    assert read_metric("step_mfu.stream", rec) == pytest.approx(mfu)


def test_frame_p90_reads_every_frame_of_the_window():
    """frame_p90_ms.stream: numpy's 90th percentile of every answered
    frame's submit-to-done time, over all the window's clips."""
    from portbench.harness import read_metric

    def frames(clip, start, latencies_ms):
        out, t = [], start
        for lat in latencies_ms:
            out.append({"ok": True, "views": 1, "clip": clip, "submit": t,
                        "done": t + int(lat * 1e6)})
            t += int(lat * 1e6) + 1
        return out

    first = frames(0, 0, [float(ms) for ms in range(1, 11)])
    second = frames(1, 10**10, [float(ms) for ms in range(11, 21)])
    rec = {"requests": first + second, "trace": None}
    assert read_metric("frame_p90_ms.stream", rec) == pytest.approx(18.1)
    assert read_metric("frame_p90_ms.stream", dict(rec, requests=first)) == pytest.approx(9.1)
    assert read_metric("frame_p90_ms.stream", dict(rec, requests=[])) is None


def test_a_short_cell_holds_the_check_frames():
    cell = controls_stream.short_cell(96)
    assert cell["traffic_data"]["clip_frames"] == 96
    assert cell["traffic_data"]["trace_from_frame"] <= 95
    assert cell["traffic_data"]["check"] == C.cell("stream-s256")["traffic_data"]["check"]
    with pytest.raises(SystemExit, match="do not hold"):
        controls_stream.short_cell(95)


def test_the_window_holds_the_program_spans():
    from portbench import harness
    from portbench.drivers.stream import Driver

    cell = tiny_stream_cell()
    driver = Driver(cell, 3, torch.device("cpu"))
    driver.setup()
    ctl = run.WindowControl(True, 0.3)
    window = driver.window(0.2, ctl)
    names = [s["name"] for s in window["program_spans"]]
    steps = [s for s in window["program_spans"] if s["name"] == "model.stream_step"]
    assert len(steps) == len(window["requests"]) == 6 * window["clips"]
    assert [s["counts"]["frame"] for s in steps[:6]] == list(range(6))
    assert steps[5]["counts"]["keys"] == 2 * 6 * 9  # depth 2, frames 0..5, 9 tokens
    # a global layer and a camera-trunk layer a step each append: 2 + 4 x 2
    assert names.count("stream.cache_append") == 10 * len(steps)
    assert names.count("stream.reset") == window["clips"]
    appends = [s for s in window["program_spans"] if s["name"] == "stream.cache_append"]
    assert appends[0]["counts"]["bytes"] == 2 * 9 * 64 * 4  # k and v, 9 tokens of 64, fp32
    assert {s["name"] for s in ctl.spans.items} >= {
        "model.stream_step", "stream.cache_append", "model.trunk", "model.camera_head",
        "model.dpt_head", "forward", "trunk"}
    assert names.count("model.dpt_head") == 2 * len(steps)
    harness.read_trace(ctl.trace, ctl.spans.items)  # the CPU trace holds no device event


def test_step_counts_by_hand():
    own = flops.forward_flops(ARCH, 1, 518, 518)
    global_own = 24 * 4 * P * P * 1024
    camera_own = 4 * 4 * 4 * 1 * 1 * 2048
    assert flops_stream.step_flops(ARCH, 0, 518, 518) == pytest.approx(own, rel=1e-12)
    assert own - global_own - camera_own == pytest.approx(3.4613e12, rel=1e-4)
    # frame 255 attends to 256 frames: 24 x 4 P (256 P) C more than its own
    grown = flops_stream.step_flops(ARCH, 255, 518, 518) - own
    assert grown == pytest.approx(24 * 4 * P * 255 * P * 1024 + 4 * 4 * 4 * 255 * 2048,
                                  rel=1e-12)
    clip = flops_stream.clip_flops(ARCH, 256, 518, 518)
    cache = sum(24 * 4 * P * (t + 1) * P * 1024 for t in range(256))
    assert cache / clip == pytest.approx(0.873, abs=1e-3)  # attention over the cache: 87%


def test_step_attention_bound_by_hand():
    # frame 255's global call: 4 P (256 P) C operations, 1.98 TFLOP / 989
    # TFLOP/s = 2.00 ms, bytes 2 C (2 P + 2 x 256 P) = 1.45 GB, 0.43 ms:
    # bound by the operations; frame and DINOv2 calls as a scene's
    glob = max(4 * P * 256 * P * 1024 / flops.PEAK_BF16_FLOPS,
               2 * 1024 * (2 * P + 2 * 256 * P) / flops.PEAK_HBM_BYTES)
    assert glob == pytest.approx(2.0025e-3, rel=1e-3)
    frame = 4 * P * P * 1024 / flops.PEAK_BF16_FLOPS
    assert flops_stream.attention_bound_s(ARCH, 255, 518, 518) == pytest.approx(
        24 * glob + 2 * 24 * frame, rel=1e-12)
    assert flops_stream.attention_bound_s(ARCH, 0, 518, 518) == pytest.approx(
        flops.attention_bound_s(ARCH, 1, 518, 518), rel=1e-12)
    assert not math.isnan(flops_stream.attention_bound_s(ARCH, 3, 518, 518))
