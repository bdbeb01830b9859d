"""Tracing and profiling (counterpart of omnivggt_tpu/utils/profiling.py).

  - `span(name, **counts)` / `recording()`: the program's own spans. Off
    (the default) a span is one check and a shared null context; inside
    `recording()` each span records its name, start and end on
    time.time_ns (the clock of torch.profiler's events), its thread, the
    span open around it on that thread and its counts, and under an
    active torch.profiler it is also a record_function of its name;
  - `trace(logdir)`: torch.profiler over a block, CPU and (where there is
    one) CUDA activity, written to `logdir` as a Chrome / Perfetto trace;
    yields the profiler, whose `key_averages()` hold the device times;
  - `force(tree)`: every tensor of a tree copied to host numpy, a true
    completion barrier;
  - `Timer`: wall-clock sections whose `.set(out)` forces the block's
    outputs before the clock stops;
  - `flops_estimate(cfg, S, H, W)`: the JAX package's analytic forward
    FLOPs of the model, the same arithmetic in the same order;
  - `sharded_attention_roofline`: the JAX package's allgather-vs-ring model
    of one sequence-sharded global attention layer. Its rates have no
    defaults: the JAX package's are a TPU's, and the caller states the
    machine it models;
  - `FAMILIES` / `family` / `profile_breakdown`: one iteration under
    torch.profiler, its device time by kernel family and the device's idle
    share (chip_smoke.py and tools/profile_forward.py print it).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch

from omnivggt_tpu_torch.utils.pytree import to_numpy


class Recorder:
    """The spans recorded while `recording()` is on, in the order they
    ended: dicts of name, t0 and t1 (ns, time.time_ns), thread
    (threading.get_native_id, which torch.profiler's events of that thread
    carry as their device_resource_id; None for a span recorded after the
    fact), parent (the name of the span open around it on its thread, or
    None) and counts."""

    def __init__(self):
        self.spans: List[dict] = []
        self._lock = threading.Lock()

    def add(self, name: str, t0: int, t1: int, thread=None, parent=None, counts=None) -> None:
        item = {"name": name, "t0": t0, "t1": t1, "thread": thread, "parent": parent,
                "counts": counts or {}}
        with self._lock:
            self.spans.append(item)


_recorder: Optional[Recorder] = None
_open = threading.local()  # .names: the names of this thread's open spans


class _Off:
    """What `span` gives while nothing records: one shared null context
    whose `count` does nothing."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def count(self, **counts) -> None:
        pass


_OFF = _Off()


@contextlib.contextmanager
def recording():
    """Record every span of the process, from any thread, while the block
    runs; yields the Recorder. One recording at a time."""
    global _recorder
    if _recorder is not None:
        raise RuntimeError("spans are already being recorded")
    _recorder = rec = Recorder()
    try:
        yield rec
    finally:
        _recorder = None


class _Span:
    __slots__ = ("rec", "name", "counts", "t0", "parent", "names", "ranged")

    def __init__(self, rec: Recorder, name: str, counts: dict):
        self.rec, self.name, self.counts = rec, name, counts

    def __enter__(self):
        names = getattr(_open, "names", None)
        if names is None:
            names = _open.names = []
        self.parent = names[-1] if names else None
        names.append(self.name)
        self.names = names
        self.t0 = time.time_ns()
        # the record_function lies inside [t0, t1], so its events (and the
        # launches made under it) fall inside the span's interval
        self.ranged = None
        if torch.autograd.profiler._is_profiler_enabled:
            self.ranged = torch.profiler.record_function(self.name)
            self.ranged.__enter__()
        return self

    def count(self, **counts) -> None:
        """Add counts known only once the block has run."""
        self.counts.update(counts)

    def __exit__(self, *exc):
        if self.ranged is not None:
            self.ranged.__exit__(*exc)
        t1 = time.time_ns()
        self.names.pop()
        self.rec.add(self.name, self.t0, t1, threading.get_native_id(), self.parent, self.counts)
        return False


def span(name: str, **counts):
    """A named span of the program around the block, with counts of the
    work it does (ints known on the host; `with span(...) as s:
    s.count(...)` adds those known only after the block). While nothing
    records, a shared null context. No name starts with "cu": a trace
    reader takes CPU events so named for the CUDA runtime's launches."""
    rec = _recorder
    if rec is None:
        return _OFF
    return _Span(rec, name, counts)


def record_since(name: str, t0: int, **counts) -> None:
    """Record a span that began at t0 (time.time_ns) somewhere else, such
    as a request's wait from its enqueue on a caller's thread to the
    worker taking it: no thread, no parent. Nothing while nothing
    records."""
    rec = _recorder
    if rec is not None:
        rec.add(name, t0, time.time_ns(), counts=counts)


@contextlib.contextmanager
def trace(logdir: str, filename: str = "trace.json"):
    """Profile the block (CPU, and CUDA when available) and write its
    Chrome / Perfetto trace to logdir/filename; yields the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, filename))


def force(tree):
    """Copy every tensor of a tree to host numpy (bf16 as fp32): the copy
    waits for the work that made it."""
    return to_numpy(tree)


class _Section:
    """Yielded by Timer.section: .set(out) hands over the block's
    outputs, which are forced before the clock stops (the work is
    asynchronous; stopping at the end of the block would time the launches
    only)."""

    def __init__(self):
        self.value = None

    def set(self, value):
        self.value = value
        return value


class Timer:
    """Accumulating named wall-clock timers.

        t = Timer()
        with t.section("fwd") as s:
            s.set(model(images))   # forced before the clock stops
        print(t.report())
    """

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        handle = _Section()
        try:
            yield handle
        finally:
            if handle.value is not None:
                force(handle.value)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name}: {total*1000:.1f} ms total, {total/n*1000:.2f} ms/call x{n}")
        return "\n".join(lines)


def flops_estimate(cfg, S: int, H: Optional[int] = None, W: Optional[int] = None) -> float:
    """Analytic forward FLOPs (a multiply-add is 2) of the model: DINOv2
    embedder, alternating aggregator, camera head, and the DPT heads'
    projections and fusion convolutions (approximated)."""
    H = H or cfg.img_size
    W = W or cfg.img_size
    a = cfg.aggregator
    p = a.patch_size
    n_patch = (H // p) * (W // p)
    P = a.patch_start_idx + n_patch
    C = a.embed_dim

    def block_flops(n_tokens, dim, mlp_ratio=4.0):
        attn_proj = 2 * n_tokens * dim * dim * 4  # qkv (3) + out (1)
        attn_sdpa = 2 * 2 * n_tokens * n_tokens * dim
        mlp = 2 * n_tokens * dim * dim * mlp_ratio * 2
        return attn_proj + attn_sdpa + mlp

    b = a.backbone if a.patch_embed != "conv" else None
    vit = 0.0
    if b is not None:
        vit_tokens = 1 + b.num_register_tokens + n_patch
        vit = b.depth * block_flops(vit_tokens, b.embed_dim, b.mlp_ratio) * S
        vit += 2 * n_patch * (p * p * 3) * b.embed_dim * S  # patchify

    frame = a.depth * block_flops(P, C, a.mlp_ratio) * S
    glob = a.depth * block_flops(S * P, C, a.mlp_ratio)

    # DPT heads (two): per-level projections + fusion convs, rough
    dpt = 2 * S * (
        2 * n_patch * 2 * C * sum(cfg.depth_head.out_channels)
        + 2 * (H * W) * cfg.depth_head.features * cfg.depth_head.features * 9 * 2
    )
    camera = cfg.camera_head.num_iterations * cfg.camera_head.trunk_depth * block_flops(
        S, cfg.camera_head.dim_in
    )
    return float(vit + frame + glob + dpt + camera)


def sharded_attention_roofline(
    n_dev: int = 8,
    views=(64, 128, 167, 256),
    tokens_per_frame: int = 1374,
    num_heads: int = 16,
    head_dim: int = 64,
    embed_dim: int = 1024,
    *,
    ici_bytes_per_s: float,
    flash_flops_per_s: float,
    flash_int8_flops_per_s: float,
    matmul_flops_per_s: float,
    bytes_per_elem: int = 2,
):
    """Allgather against ring for one sequence-sharded global attention
    layer, per rank, from the rates given: the link between ranks
    (`ici_bytes_per_s`, the JAX package's name), the attention kernel's
    bf16 and int8-score rates and the dense layers' matmul rate. The
    model and its output keys are the JAX package's:

      - allgather: each rank receives (n_dev - 1) / n_dev of the whole K and
        V once a layer; the figure of merit is comm time / compute time;
      - ring: K and V rotate in n_dev - 1 steps; the rotation hides when a
        step's transfer fits under the step's attention (int8: half the
        bytes against the int8 rate);
      - hbm_ring_ok: whether a rank's shard fits ring_flash_attention_hbm
        (ops/kernels/ring_attention.fits_hbm_ring).
    """
    import math

    from omnivggt_tpu_torch.ops.kernels.ring_attention import (
        DEFAULT_BLOCK_K,
        DEFAULT_BLOCK_Q,
        MAX_LOCAL_SEQ_HBM,
        fits_hbm_ring,
    )

    step = math.lcm(DEFAULT_BLOCK_Q, DEFAULT_BLOCK_K)
    out = {
        "assumptions": {
            "n_dev": n_dev,
            "ici_bytes_per_s": ici_bytes_per_s,
            "flash_flops_per_s": flash_flops_per_s,
            "flash_int8_flops_per_s": flash_int8_flops_per_s,
            "matmul_flops_per_s": matmul_flops_per_s,
        },
        # largest view count the HBM-staged ring kernel covers on this mesh
        "hbm_ring_max_views": (MAX_LOCAL_SEQ_HBM // step * step) * n_dev // tokens_per_frame,
        "per_layer": {},
    }
    HD = num_heads * head_dim
    for S in views:
        N = S * tokens_per_frame
        nl = -(-N // n_dev)
        kv_bytes = 2 * N * HD * bytes_per_elem
        t_allgather = kv_bytes * (n_dev - 1) / n_dev / ici_bytes_per_s
        t_attn = 4 * nl * N * HD / flash_flops_per_s
        t_dense = 24 * nl * embed_dim * embed_dim / matmul_flops_per_s
        ring_step_comm = 2 * nl * HD * bytes_per_elem / ici_bytes_per_s
        ring_step_attn = 4 * nl * nl * HD / flash_flops_per_s
        out["per_layer"][S] = {
            "tokens_per_device": nl,
            "allgather_ms": round(t_allgather * 1e3, 3),
            "attn_ms": round(t_attn * 1e3, 3),
            "attn_int8_ms": round(4 * nl * N * HD / flash_int8_flops_per_s * 1e3, 3),
            "dense_ms": round(t_dense * 1e3, 3),
            "allgather_comm_fraction": round(t_allgather / (t_attn + t_dense), 3),
            "ring_step_comm_ms": round(ring_step_comm * 1e3, 3),
            "ring_step_attn_ms": round(ring_step_attn * 1e3, 3),
            "ring_comm_hidden": ring_step_comm <= ring_step_attn,
            "ring_step_comm_int8_ms": round(ring_step_comm / 2 * 1e3, 3),
            "ring_comm_hidden_int8": (
                ring_step_comm / 2 <= 4 * nl * nl * HD / flash_int8_flops_per_s
            ),
            "hbm_ring_ok": fits_hbm_ring(nl),
        }
    return out


# kernel families of the profiled device time, first match wins
FAMILIES = (
    ("flash_fwd_head_major", ("flash_fwd_head_major",)),
    ("flash_fwd_token_major", ("flash_fwd_token_major",)),
    ("ring_step_tma int8 (int8 ring, TMA + wgmma)",
     tuple(f"ring_step_tma<{d}, {b}, 4>" for d in (64, 128) for b in ("true", "false"))),
    ("ring_step_tma bf16 (bf16 ring, TMA + wgmma)", ("ring_step_tma",)),
    ("ring_stage (the rings' staging copy)", ("ring_stage",)),
    ("conv3x3 kernel", ("conv3x3_bf16", "conv3x3_fp32")),
    ("flash_bwd_dq", ("flash_bwd_dq",)),
    ("flash_bwd_dkv", ("flash_bwd_dkv",)),
    ("cuDNN convolutions (fwd, dgrad, wgrad)",
     ("conv", "cudnn", "xmma", "implicit", "dgrad", "wgrad", "fprop")),
    ("GEMMs (cuBLAS)", ("gemm", "cutlass", "nvjet", "sm90_", "sm80_", "ampere")),
    ("LayerNorm", ("layer_norm", "layernorm")),
    ("optimizer and clip (foreach)", ("multi_tensor", "foreach")),
    ("upsample / interpolate", ("upsample", "interp")),
    ("cat", ("cat",)),
    ("copies and casts", ("copy", "cast")),
    ("reductions", ("reduce",)),
)


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other elementwise"


def profile_breakdown(label, run):
    """One iteration of run() under torch.profiler: its wall time, the
    summed kernel time (and so the device's idle share) and a table of
    device time by kernel family. A measurement, not a check: a profiler
    that records no device time is reported as such."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    fams, counts = defaultdict(float), defaultdict(int)
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA or evt.self_device_time_total <= 0:
            continue
        fams[family(evt.key)] += evt.self_device_time_total / 1e3
        counts[family(evt.key)] += evt.count
    total = sum(fams.values())
    if total <= 0:
        print(f"profile {label}: the profiler recorded no device time (not measured)")
        return
    print(f"profile {label}: wall {wall_ms:.2f} ms, summed kernel time {total:.2f} ms, "
          f"device idle {max(0.0, 1 - total / wall_ms) * 100:.1f}%, "
          f"{sum(counts.values())} kernel launches")
    for fam, ms in sorted(fams.items(), key=lambda kv: -kv[1]):
        print(f"  | {fam} | {counts[fam]} | {ms:.2f} ms | {ms / total * 100:.1f}% |")
