"""What every run shares: the environment, the device check, the program's
model from seeded weights, spans around the program's layer entry points,
the device trace and its reading, the per-layer metric readers, and the
result line.

Spans are recorded here, around calls into the program (the program has
none of its own yet): in traced runs the entry points in SPAN_TABLE are
wrapped by name, each call recording its host interval (time.time_ns,
the profiler's clock) and what the harness needs to know of it. Device
work is attributed to a span by where its launch lies: the launch's host
time inside the span's interval.
"""

from __future__ import annotations

import bisect
import contextlib
import importlib
import importlib.util
import json
import os
import sys
import threading
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional

from portbench.config import REPO, ROOT

# the program's layer entry points that traced runs wrap: span name ->
# (module, attribute)
SPAN_TABLE = {
    "forward": ("omnivggt_tpu_torch.models.omnivggt", "apply"),
    "trunk": ("omnivggt_tpu_torch.models.aggregator", "apply"),
    "camera_head": ("omnivggt_tpu_torch.models.camera_head", "apply"),
    "dpt_head": ("omnivggt_tpu_torch.models.dpt_head", "apply"),
}
# kernel names of the attention family (forward and backward)
ATTENTION_KERNELS = ("flash_fwd_head_major", "flash_fwd_token_major", "flash_bwd_dq",
                     "flash_bwd_dkv", "ring_step_tma", "ring_stage")
# kernel names of the optimizer family (torch's foreach / multi-tensor
# kernels: AdamW and the gradient clip)
OPTIMIZER_KERNELS = ("multi_tensor", "foreach")
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "omnivggt_tpu")
CACHE_DIR = os.path.join(REPO, ".portbench_cache")


def prepare_environment() -> None:
    """Before torch is imported: no library may pull JAX in, and every
    cache a library could fill lives at a fixed path in the checkout."""
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ["USE_TF"] = "0"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = os.path.join(CACHE_DIR, sub)


def process_age_s() -> float:
    """Seconds since this process started (Linux: /proc)."""
    with open("/proc/self/stat") as f:
        start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_loaded() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN_MODULES))


def require_devices(n: int):
    """Exit without a result unless CUDA shows at least n devices."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: this cell needs {n} CUDA device(s); found {found}", file=sys.stderr)
        raise SystemExit(2)
    return torch.device("cuda")


def sync(device) -> None:
    """Wait for the device's work (nothing to wait for on the CPU)."""
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_info(device, count: int, peak_bytes: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": count,
            "memory_peak_bytes": int(peak_bytes)}


def card_line() -> str:
    """The card's name and power limit (nvidia-smi), or 'not read'."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0]
    except Exception:  # noqa: BLE001 - a reading, not a requirement
        return "not read"


def build_model(cfg, arch: dict, seed: int, device):
    """The program's OmniVGGT with the benchmark's seeded weights, loaded
    strictly, and the fixed-max softmax checked against them as the
    program's checkpoint loaders do. Returns (model, config)."""
    import dataclasses

    from omnivggt_tpu_torch.models.omnivggt import OmniVGGT
    from omnivggt_tpu_torch.utils.validation import check_bounded_logits_safe
    from portbench.weights import make_state_dict

    model = OmniVGGT(cfg, device=device, seed=None)
    sd = make_state_dict(arch, seed, device)
    model.load_state_dict(sd, strict=True)
    del sd
    head_dim = cfg.embed_dim // cfg.aggregator.num_heads
    if cfg.bounded_attn_logits and not check_bounded_logits_safe(model, head_dim):
        cfg = dataclasses.replace(cfg, bounded_attn_logits=False)
    model.config = cfg
    return model, cfg


def build_kernels() -> None:
    """Build (or find built in the checkout) the CUDA sources the forward
    and the training step launch, at once."""
    from omnivggt_tpu_torch.ops.kernels import build
    from omnivggt_tpu_torch.ops.kernels import flash_attention as FK

    build.build_all(tuple(FK.SOURCES))


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------


class Spans:
    """Host intervals of named spans, from any thread."""

    def __init__(self):
        self.items: List[dict] = []
        self._lock = threading.Lock()
        self._saved = []

    def add(self, name: str, t0: int, t1: int, **info) -> None:
        with self._lock:
            self.items.append({"name": name, "t0": t0, "t1": t1, **info})

    @contextlib.contextmanager
    def span(self, name: str, **info):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.add(name, t0, time.time_ns(), **info)

    def wrap_program(self) -> None:
        """Wrap the entry points of SPAN_TABLE (undone by `unwrap`). The
        forward span records the frames it runs, B x S of its images."""
        for name, (mod_name, attr) in SPAN_TABLE.items():
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, attr)
            self._saved.append((mod, attr, fn))
            setattr(mod, attr, self._wrapped(name, fn))

    def _wrapped(self, name: str, fn: Callable) -> Callable:
        spans = self

        def wrapped(*args, **kwargs):
            info = {}
            if name == "forward":
                shape = args[1].shape
                info["batch"] = int(shape[0]) if len(shape) == 5 else 1
                info["frames"] = info["batch"] * int(shape[-4])
                # a device scalar is read only once the window has closed
                info["nv"] = kwargs.get("num_valid_frames")
                info["hw"] = (int(shape[-3]), int(shape[-2]))
            t0 = time.time_ns()
            try:
                return fn(*args, **kwargs)
            finally:
                spans.add(name, t0, time.time_ns(), **info)

        return wrapped

    def unwrap(self) -> None:
        for mod, attr, fn in reversed(self._saved):
            setattr(mod, attr, fn)
        self._saved = []


# ---------------------------------------------------------------------------
# the device trace
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def profiled(out: dict):
    """torch.profiler over the block; on exit, `out` gets the raw events
    and the traced interval (time.time_ns)."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    card = torch.cuda.is_available()
    if card:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    out["t0"] = time.time_ns()
    try:
        yield
    finally:
        if card:
            torch.cuda.synchronize()
        out["t1"] = time.time_ns()
        prof.stop()
        out["events"] = prof.profiler.kineto_results.events()


def _gpu_event(e) -> bool:
    """A kernel, copy or set on the device (not a range the profiler draws
    on the device's timeline for a host annotation, such as the optimizer's
    step, which spans the gaps between its kernels)."""
    if not str(e.device_type()).endswith("CUDA"):
        return False
    marked = getattr(e, "is_user_annotation", None)
    kind = getattr(e, "activity_type", None)
    return not ((marked is not None and marked())
                or (kind is not None and "annotation" in str(kind()).lower()))


def read_trace(traced: dict, spans: List[dict]) -> dict:
    """Reduce the traced events: device busy time (the union of the
    intervals of every kernel, copy and set), the traced window, device
    time by kernel name, and the longest idle gaps with the span the host
    was in. Each span gets the device seconds of the kernels launched
    inside it (dev_s), of the attention family (attn_s) and of the
    optimizer family (optim_s)."""
    t0, t1 = traced["t0"], traced["t1"]
    launches, gpu = {}, []
    for e in traced["events"]:
        if _gpu_event(e):
            gpu.append(e)
        elif e.name().startswith("cuda") or e.name().startswith("cu"):
            launches[e.correlation_id()] = e.start_ns()
    if not gpu:
        print(f"portbench: the trace holds no device event ({len(traced['events'])} events)",
              file=sys.stderr)
    intervals = sorted((e.start_ns(), e.start_ns() + e.duration_ns()) for e in gpu
                       if e.duration_ns() > 0)
    busy, gaps, cur_s, cur_e = 0, [], None, None
    last_end = t0
    for s, e in intervals:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            gaps.append((s - max(last_end, t0), max(last_end, t0), s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
        last_end = max(last_end, e)
    if cur_e is not None:
        busy += cur_e - cur_s
        gaps.append((t1 - cur_e, cur_e, t1))
    by_kernel: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    spans = sorted(spans, key=lambda s: s["t0"])
    for s in spans:
        s["dev_s"], s["attn_s"], s["optim_s"] = 0.0, 0.0, 0.0
    starts = [s["t0"] for s in spans]
    longest = max((s["t1"] - s["t0"] for s in spans), default=0)
    for e in gpu:
        d = e.duration_ns() / 1e9
        name = e.name()
        by_kernel[name][0] += d
        by_kernel[name][1] += 1
        at = launches.get(e.correlation_id()) or launches.get(e.linked_correlation_id())
        if at is None:
            continue
        attn = any(a in name for a in ATTENTION_KERNELS)
        optim = any(o in name for o in OPTIMIZER_KERNELS)
        # every span whose interval holds the launch (spans nest)
        i = bisect.bisect_right(starts, at)
        j = bisect.bisect_left(starts, at - longest)
        for s in spans[j:i]:
            if s["t1"] >= at:
                s["dev_s"] += d
                s["attn_s"] += d * attn
                s["optim_s"] += d * optim

    def host_at(t_mid):
        inside = [s for s in spans if s["t0"] <= t_mid <= s["t1"]]
        return min(inside, key=lambda s: s["t1"] - s["t0"])["name"] if inside else "no span"

    gaps.sort(reverse=True)
    idle = [[f"idle while host in {host_at((a + b) // 2)}", g / 1e9] for g, a, b in gaps[:10]]
    return {
        "busy_s": busy / 1e9, "window_s": (t1 - t0) / 1e9,
        "by_kernel": {k: v[0] for k, v in by_kernel.items()},
        "launches": sum(v[1] for v in by_kernel.values()),
        "idle_gaps": idle,
    }


def breakdown(trace: dict) -> dict:
    top = sorted(trace["by_kernel"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in top], "idle_gaps": trace["idle_gaps"]}


# ---------------------------------------------------------------------------
# metrics and the result
# ---------------------------------------------------------------------------


def read_metric(name: str, record: dict) -> Optional[float]:
    """metrics/<name>.py's `read(record)`: a number, or None where the run
    holds nothing for it to read."""
    path = os.path.join(ROOT, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(record)


def emit(result: dict, compared: List[dict]) -> int:
    """Print the compared numbers (stderr, last lines) and the result line
    (stdout, last line). Refuses to print a result when JAX or the JAX
    package has been imported into this process."""
    found = forbidden_loaded()
    if found:
        print(f"portbench: modules that must not load were imported: {found}", file=sys.stderr)
        return 3
    result["compared"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                          for c in compared}
    for c in compared:
        print(f"compared {c['name']}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    sys.stdout.flush()
    return 0
