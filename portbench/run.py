"""Run one cell of the benchmark once.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Loads the cell named in BENCHMARK.json (its configuration file and traffic
mix), builds the program's model from weights drawn from the seed, warms up
the cell's own shapes (set-up), measures for --seconds, then frees the
program's state and runs the plain reference over the answers due for the
check. The last line of standard output is one JSON object: correct,
attempted, failed, metrics (the cell's end-to-end metrics with --trace 0,
its per-layer metrics with --trace 1), device and, traced, breakdown; the
numbers compared with their limits are printed last on standard error and
under "compared" in the line.

Without as many CUDA devices as the cell asks for, it exits 2 and prints no
result.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib
import json
import math
import os
import sys
import time

from portbench import harness

harness.prepare_environment()


class WindowControl:
    """The trace inside a window: in a traced run the profiler runs from
    the window's start for the traffic's `trace_seconds` (stopped at a step
    boundary, or by the main thread while clients run), and the rest of the
    window runs without it."""

    def __init__(self, traced: bool, trace_seconds: float):
        self.traced = traced
        self.trace_seconds = trace_seconds
        self.spans = harness.Spans()
        self.trace = {}
        self._cm = None

    def start(self):
        if self.traced:
            self.spans.wrap_program()
            self._cm = harness.profiled(self.trace)
            self._cm.__enter__()
            self._t_stop = time.time_ns() + int(self.trace_seconds * 1e9)

    def _stop_profiler(self):
        if self._cm is not None:
            self._cm.__exit__(None, None, None)
            self._cm = None
            self.trace["stopped"] = time.time_ns()

    def between_steps(self):
        if self._cm is not None and time.time_ns() >= self._t_stop:
            self._stop_profiler()

    def run_until(self, t_end: int):
        """The main thread's part while client threads run."""
        if self._cm is not None:
            time.sleep(max(0.0, (self._t_stop - time.time_ns()) / 1e9))
            self._stop_profiler()
        time.sleep(max(0.0, (t_end - time.time_ns()) / 1e9))

    def stop(self):
        self._stop_profiler()
        self.spans.unwrap()


def limits_file(workload: str) -> dict:
    """limits/<workload>.json: the compared numbers' limits ("limits"), the
    control's configuration ("control") and the readings they were set
    from."""
    with open(os.path.join(harness.ROOT, "limits", f"{workload}.json")) as f:
        return json.load(f)


def execute(workload: str, seed: int, seconds: float, trace: bool, device=None,
            program_overrides=None, fault=None, setup_from_call=False, cell=None,
            with_readings=False) -> tuple:
    """One run of a cell in this process. Returns (result, compared).
    program_overrides and fault are for the controls and the tests (a
    lower-precision program, a planted fault); setup_from_call times set-up
    from this call instead of the process's start; cell replaces the cell read
    from BENCHMARK.json (the CPU rehearsal's)."""
    import torch

    from portbench import config as C
    from portbench.reference.model import exact_float32

    t_begin = time.perf_counter()
    cell = cell or C.cell(workload)
    device = device or harness.require_devices(cell["chips"])
    driver_mod = importlib.import_module(f"portbench.drivers.{cell['traffic_data']['driver']}")
    driver = driver_mod.Driver(cell, seed, device, program_overrides=program_overrides,
                               fault=fault)
    on_card = device.type == "cuda"
    if on_card:
        harness.build_kernels()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    driver.setup()
    if on_card:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_begin if setup_from_call else harness.process_age_s()
    ctl = WindowControl(trace, cell["traffic_data"]["trace_seconds"])
    window = driver.window(seconds, ctl)
    window_peak = torch.cuda.max_memory_allocated() if on_card else 0
    record = {
        "cell": workload, "kind": driver.kind, "arch": driver.arch, "setup_s": setup_s,
        "window": window, "requests": window["requests"], "peak_window_bytes": window_peak,
        "spans": ctl.spans.items, "trace": None, "traced": trace,
    }
    if trace:
        record["trace"] = harness.read_trace(ctl.trace, ctl.spans.items)
        record["trace_window"] = (ctl.trace["t0"], ctl.trace["t1"])
        record["trace_stopped"] = ctl.trace["stopped"]
        _resolve_valid_frames(ctl.spans.items, driver.arch)
    driver.free()
    del ctl
    gc.collect()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    with exact_float32(), torch.no_grad() if driver.kind != "train" else contextlib.nullcontext():
        checked = driver.check(window)
    limits = limits_file(workload)["limits"]
    compared = [{"name": k, "value": checked["readings"].get(k, math.inf), "limit": v}
                for k, v in limits.items()]
    correct = (checked["checked"] > 0 and checked["failed"] == 0
               and all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in compared))
    metrics = {}
    for m in (cell["per_layer"] if trace else cell["end_to_end"]):
        value = harness.read_metric(m["name"], record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": checked["attempted"],
              "failed": checked["failed"], "metrics": metrics}
    if on_card:
        result["device"] = harness.device_info(device, cell["chips"],
                                               max(setup_peak, window_peak))
    else:
        result["device"] = {"platform": "cpu", "kind": "cpu rehearsal", "count": 0,
                            "memory_peak_bytes": 0}
    if trace and record["trace"] is not None:
        result["device"]["busy_s"] = record["trace"]["busy_s"]
        result["device"]["window_s"] = record["trace"]["window_s"]
        result["breakdown"] = harness.breakdown(record["trace"])
    result["checked"] = {"answers": checked["checked"], "views": checked["views_checked"]}
    if with_readings:
        return result, compared, checked["readings"]
    return result, compared


def _resolve_valid_frames(spans, arch) -> None:
    """The forward spans' requested frames, B x num_valid_frames where the
    call was given one (read once the window has closed) else all, the
    least time of their attention (flops.attention_bound_s) and their
    analytic FLOPs (flops.forward_flops; the GT depth's patch embedding,
    under 0.1% of a frame's, is not counted)."""
    from portbench.flops import attention_bound_s, forward_flops

    for s in spans:
        if s["name"] != "forward":
            continue
        nv = s.pop("nv", None)
        S = int(nv) if nv is not None else s["frames"] // s["batch"]
        s["requested"] = s["batch"] * S
        s["bound_s"] = s["batch"] * attention_bound_s(arch, S, *s["hw"])
        s["flops"] = s["batch"] * forward_flops(arch, S, *s["hw"])


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
    result, compared = execute(args.workload, args.seed, args.seconds, bool(args.trace))
    return harness.emit(result, compared)


if __name__ == "__main__":
    sys.exit(main())
