"""Chip smoke test of the PyTorch port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):
  1. card: prints the card's name and power limit; there must be a CUDA
     device (there is no CPU path here);
  2. build: compiles the Hopper kernels from csrc/ with nvcc; prints each
     kernel's registers and shared memory from ptxas' report, and fails if
     a backward kernel (dq, dk/dv, D 64 and 128) or a ring kernel
     (ring_step_tma bf16 and int8, ring_stage) or a conv kernel
     (conv3x3_bf16_tma, conv3x3_fp32_tma) spills a register, or if the
     ring step's or the conv kernel's launch shape differs from
     RK.ring_launch_shape's or CK.conv_launch_shape's;
  3. kernels: each kernel against its plain PyTorch version at the shapes
     the flagship's 518 px, 8-view forward gives it, bf16 inputs, the plain
     version in fp32 from the same inputs; prints errors beside the stated
     tolerance and the median times of both (CUDA events); then the bf16
     forward kernel (TMA + wgmma) in each form the main path and training
     run, and at head dim 128: 21 launches on the same inputs bitwise
     equal (o and LSE), and two planted faults that must leave the
     tolerance (the last key tile left out; K and V of the next head,
     through the kernel's test hook);
  4. backward kernels, at the shapes the flagship's S=4 training step
     gives them (global bounded, frame bounded, DINOv2 running-max), plus
     a dynamic kv_valid and a clamp-saturation case: the forward kernel's
     o and LSE against attention_plain's (the LSE row by row within
     lse_tolerance, from fp32 rounding); 21 launches of the dq and the
     dk/dv kernel (TMA + wgmma) on the same inputs bitwise equal (dq,
     delta, dk, dv); then the dq and dk/dv kernels
     against attention_backward_plain given the plain LSE, entry by entry
     within backward_tolerance (bf16 rounding of ds / p and of the
     outputs, fp32 rounding of p and ds), printed beside max |ref| and
     mean |ref|; on the training
     shapes two planted faults (delta = 0, the last key tile skipped)
     must fail those tolerances; times beside the plain version's and
     F.scaled_dot_product_attention's backward alone (the gradient of one
     saved forward; the library time of the same function) and its
     forward+backward (yardsticks only);
  5. flagship forward: the 1.2B OmniVGGTConfig() at S=8, 518x518, seeded
     random weights (trunk stored in bf16), synthetic images with GT
     cameras and depth for some frames, through model(...) with the kernels
     ("auto") and with attn_impl="plain"; checks shapes, finiteness, the
     kernels' launch counts per forward, the pose decoding and depth
     unprojection, and the kernel path against the plain path under the
     serving gate (pose_enc max-abs and median relative errors <= 2e-2);
     then one forward under torch.profiler: device time by kernel family
     and the device's idle share;
  6. flagship training: the same model with fp32 master weights, S=4 at
     518 px, remat on, a synthetic batch built on the device, through
     make_train_step with the layer-decay optimizer: one warm-up step and
     four timed steps, every loss and grad_norm finite, grad_norm > 0, the
     loss descending, the exact kernel launches per step; one profiled
     step as in 5; then one step's loss and trunk gradients (aggregator and
     DINOv2, whose gradients pass through the attention backward) with the
     kernels against attn_impl="plain": loss relative difference <= 1e-2
     and trunk gradient cosine >= 1 - 1e-5, a limit that the same step
     with either planted fault in the backward must break.
  7. serving kernels (run before 5): the head-major kernel's int8 form and
     the streaming kernel (bf16 and int8) at the global-attention shape
     with a static key axis and a dynamic valid prefix, the 3x3 convolution
     kernel at the DPT heads' shape (fp32 and bf16, ReLU on and off, one
     ragged case, each in NCHW and in channels_last: NCHW copied once by
     the wrapper and channels_last read in place, counted on
     conv3x3_folded.relayouts; 21 launches bitwise equal), each against its
     plain version with planted faults that must fail (the int8 forms, on
     the TMA + wgmma tile with s8 scores: 21 launches bitwise equal, and
     three faults: one head's dequantising scalar for all heads, the last
     key tile left out, K and V of the next head; the conv: the left halo
     column of every unit left out); the q grid the stream kernel makes
     equal to quant_token_major's; every quantiser's int8 grid on the card
     equal to the CPU's; the layout probes and which descriptor starts
     read right;
  8. serving, after 5 on the same model: a bucketed InferenceSession
     (buckets 4 and 8) under attn_quant = trunk_quant = int8, bf16 heads,
     tanh GELU and the head-conv kernel answers requests of 3, 5 and 8
     frames (exact launch counts, no conv relayout copy; the padded
     request against an exact-mode session under the serving gate; the
     quantisers' grids unmoved by the padded rows); the same with the stream flag on; the Batcher (two
     scenes in one B=2 forward) and POST /infer on a local port, each held
     to the single request's answer (same_answer: a limit that the other
     scene's answer breaks); (e) the scene outputs of the S=8 request:
     POST /infer_glb in both prediction modes (the kernels' launch counts,
     the GLB's header, chunks, point count and frusta, and its bytes equal
     to _glb_from_preds on the host of the /infer answer), the viewer's page
     and /data (bytes equal to _scene_payload's), the trajectory metrics
     against the request's GT cameras and a TUM round trip, with the
     latencies of /infer_glb and /infer and the host times of the GLB and
     the payload; request latencies under each config, the quantisation
     passes' share, one profiled request;
  9. ladder: certify_fast_modes on the same weights, every rung's readings,
     the config returned, and what the ladder without the quantising rungs
     (from_safetensors' default) returns.
 10. ring kernels (run with the other kernel phases): the two ring wrappers
     over 4 logical ranks at the flagship's global-attention shape
     (1, 10992, 16, 64), nl = 2748, ragged (ring_flash_attention_hbm:
     bounded and running-max, bf16 and int8), at (1, 16384, 16, 64), two
     query chunks a rank, and at the S=4 224 px shape (1, 1044, 16, 64)
     that the main path gives it (ring_flash_attention: bounded bf16 and
     int8), and one 8-rank case; each against ring_attention_plain within
     2^-7 max|v|, the bounded bf16 ones also against the head-major kernel
     within RK.reorder_tolerance (the order of the fp32 sums only); every
     rank's last-read slot must hold its right neighbour's shard exactly;
     quant_ring's grids on the card equal to the CPU's; with the last
     rotation left out the output must leave the tolerance; both forms
     (ring_step_tma, the TMA + wgmma tile; int8: s8 scores, int8 V
     converted to bf16 in shared memory) 21 launches bitwise equal, and
     the tile's planted faults (the last key tile of every shard left out;
     K and V of the next head; int8: head 0's v scale for every head) must
     leave the tolerance in every case; times beside the plain version's
     (int8: the wrapper, quant_ring in it, and _ring_run alone on grids
     made once), SDPA over the whole sequence, and the bound, whose bytes
     include the rotation ((n - 1) shards of K and V read and written once
     each, int8 in the int8 form);
 11. sharded flagship forward, after 5 on the same model: S=8 at 518 px on
     make_mesh(data=1, seq=4) under "ring_fused", "ring" and "allgather",
     then under attn_quant="int8" "ring_fused" (the int8 ring) and
     "allgather" (K quantised per shard on the max over the ranks, gathered
     as int8 and handed over as k_quant: the gathered grid must equal the
     whole K's), the last also with the stream flag on; exact launch counts
     worked out from the rank count, no unfused fallback; each against the
     single-device forward under the serving gate and, for the bf16
     strategies, the same-answer gate; one S=4 224 px forward under
     "ring_fused", whose shards (nl = 261) meet ring_flash_attention's own
     contract; latencies beside the single-device forward's;
 12. sharded serving: a bucketed InferenceSession under "allgather" answers
     requests of 5 and 8 frames, the padded one against an exact-mode
     session; under "ring_fused" the constructor refuses bucket mode and
     serves exact mode.
Bounds (bound_ms) are the larger of the bytes each kernel must move over
3.35 TB/s and its matrix-product operations over the H100 SXM's published
peak for their type: 989 TFLOP/s bf16 dense, 1,979 TOP/s int8, 67 TFLOP/s
fp32 outside the tensor cores. The line before the last is the kernels' JSON
summary; the last line is {"ok": true, "device": {...}}.

Matmul precision: the heads run fp32, and both TF32 switches are off
(torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 =
False), so fp32 convolutions and matmuls keep full fp32 as in the JAX
package's reference-parity heads.
"""

from __future__ import annotations

import dataclasses
import io
import json
import re
import socket
import statistics
import struct
import subprocess
import sys
import threading
import time
import urllib.request
from collections import defaultdict

import numpy as np
import torch

S, IMG = 8, 518
S_TRAIN = 4
POSE_TOL = REL_TOL = 2e-2  # the JAX package's serving gate (_probe_failures)
# training, kernel path vs plain path: the loss, and the cosine of the trunk's
# gradients. 1 - cosine read 1.4e-6 sound, 1.3e-4 with the last key tile
# skipped in every backward and 1.3e-2 with delta = 0 (H100 runs of this
# script): the limit 1e-5 sits between the sound reading and the faults
LOSS_REL_TOL, GRAD_COS_MIN = 1e-2, 1 - 1e-5
PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12  # H100 SXM: bf16 dense, HBM
PEAK_INT8, PEAK_FP32 = 1979e12, 67e12  # int8 dense; fp32 outside the tensor cores
P_TOKENS = 1374  # tokens per frame at 518 px: 37 * 37 patches + 5 special tokens
REPLACES = {
    "flash_attention": "omnivggt_tpu/ops/pallas/flash_attention.py:60",
    "flash_attention_packed": "omnivggt_tpu/ops/pallas/flash_attention.py:764",
    "flash_attention_bwd_dq": "omnivggt_tpu/ops/pallas/flash_attention.py:461",
    "flash_attention_bwd_dkv": "omnivggt_tpu/ops/pallas/flash_attention.py:493",
    "flash_attention_int8": "omnivggt_tpu/ops/pallas/flash_attention.py:60",
    "flash_attention_packed_stream": "omnivggt_tpu/ops/pallas/flash_attention.py:1034",
    "conv3x3_folded": "omnivggt_tpu/ops/pallas/conv3x3.py:99",
    "layout_probes": "tools/probe_mosaic_layouts.py:37",
    "ring_flash_attention": "omnivggt_tpu/ops/pallas/ring_attention.py:91",
    "ring_flash_attention_hbm": "omnivggt_tpu/ops/pallas/ring_attention.py:260",
}
SOURCES = {
    "flash_attention": "omnivggt_tpu_torch/csrc/flash_attention.cu",
    "flash_attention_packed": "omnivggt_tpu_torch/csrc/flash_attention.cu",
    "flash_attention_bwd_dq": "omnivggt_tpu_torch/csrc/flash_attention_bwd.cu",
    "flash_attention_bwd_dkv": "omnivggt_tpu_torch/csrc/flash_attention_bwd.cu",
    "flash_attention_int8": "omnivggt_tpu_torch/csrc/flash_attention.cu",
    "flash_attention_packed_stream": "omnivggt_tpu_torch/csrc/flash_attention.cu",
    "conv3x3_folded": "omnivggt_tpu_torch/csrc/conv3x3.cu",
    "layout_probes": "omnivggt_tpu_torch/csrc/layout_probes.cu",
    "ring_flash_attention": "omnivggt_tpu_torch/csrc/ring_attention.cu",
    "ring_flash_attention_hbm": "omnivggt_tpu_torch/csrc/ring_attention.cu",
}
N_RANKS = 4  # logical ranks of the sharded phases
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


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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


def bound(flops, nbytes, int8_ops=0, fp32_flops=0):
    """(least ms the card could take, "operations" or "bytes"): bf16
    matrix-product flops, int8 matrix-product operations and fp32 flops,
    each over its own peak and added, against the bytes over the memory
    rate."""
    by_ops = (flops / PEAK_FLOPS + int8_ops / PEAK_INT8 + fp32_flops / PEAK_FP32) * 1e3
    by_bytes = nbytes / PEAK_BYTES * 1e3
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")


def sdpa_ms(q, k, v, kv, do=None):
    """F.scaled_dot_product_attention on the same inputs (keys cut to the
    valid prefix), forward only, or forward + backward given do: the
    library yardstick, never called by the port."""
    F = torch.nn.functional
    n = k.shape[1] if kv is None else int(kv)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k[:, :n], v[:, :n]))
    if do is None:
        return median_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), 10)
    for x in (qt, kt, vt):
        x.requires_grad_(True)
    dot = do.transpose(1, 2).contiguous()
    return median_ms(
        lambda: torch.autograd.grad(F.scaled_dot_product_attention(qt, kt, vt), (qt, kt, vt), dot),
        10,
    )


def sdpa_backward_ms(q, k, v, kv, do, reps=20):
    """The backward alone of F.scaled_dot_product_attention on the same
    inputs (keys cut to the valid prefix): each rep runs one SDPA forward
    untimed, then CUDA events around its backward (the gradient of q, k
    and v), after a warm-up; the median. The library time of the same
    function as the two backward kernels together; a yardstick only, never
    called by the port."""
    F = torch.nn.functional
    n = k.shape[1] if kv is None else int(kv)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                  for x in (q, k[:, :n], v[:, :n]))
    dot = do.transpose(1, 2).contiguous()
    times = []
    for rep in range(reps + 1):
        out = F.scaled_dot_product_attention(qt, kt, vt)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        torch.autograd.grad(out, (qt, kt, vt), dot)
        end.record()
        torch.cuda.synchronize()
        if rep:
            times.append(start.elapsed_time(end))
    return statistics.median(times)


def ptxas_entries(log, pattern):
    """{key: {"registers": n, "spills": [stores, loads]}} for every entry
    function of ptxas' report whose mangled name matches `pattern`, keyed by
    the pattern's groups."""
    entries, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            found = re.search(pattern, line)
            name = found.groups() if found else None
            if name:
                entries[name] = {}
        elif name and "spill stores" in line:
            entries[name]["spills"] = [int(n) for n in re.findall(r"(\d+) bytes spill", line)]
        elif name and "Used" in line:
            entries[name]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
    return entries


def backward_build_report(FK, log):
    """Each backward kernel's registers, spills and shared memory, from
    ptxas' report of csrc/flash_attention_bwd.cu; a spill fails the run.
    An empty log (the library was built before) has no report."""
    if not log:
        print("  backward kernels: library built before this run, no ptxas report")
        return
    entries = ptxas_entries(log, r"(flash_bwd_(?:dq|dkv))ILi(\d+)ELb([01])E")
    shapes = {d: FK.bwd_launch_shape(d) for d in FK.HEAD_DIMS}
    for (kernel, d, bounded), e in sorted(entries.items()):
        smem = shapes[int(d)][1 if kernel == "flash_bwd_dq" else 2]
        print(f"  backward kernel {kernel} D={d} bounded={bounded}: {e.get('registers')} "
              f"registers at launch, spill stores/loads {e.get('spills')} bytes, {smem} bytes of "
              f"dynamic shared memory, {shapes[int(d)][0]} threads a block")
    if len(entries) != 8 or any(e.get("spills") != [0, 0] for e in entries.values()):
        raise AssertionError(f"a backward kernel spills or is missing from ptxas' report: {entries}")


def ring_build_report(RK, log):
    """The ring kernels' registers, spills and shared memory, from ptxas'
    report of csrc/ring_attention.cu (ring_step_tma in both forms, bounded
    and running-max, at D 64 and 128; ring_stage at both); a spill fails
    the run, and so does a shared-memory count that differs from
    RK.ring_launch_shape's."""
    if not log:
        print("  ring kernels: library built before this run, no ptxas report")
        return
    steps = ptxas_entries(log, r"(ring_step_tma)ILi(\d+)ELb([01])ELi(\d+)E")
    stages = ptxas_entries(log, r"(ring_stage)ILi(\d+)E()()")
    for (kernel, d, bounded, form), e in sorted({**steps, **stages}.items()):
        if kernel == "ring_stage":
            print(f"  ring kernel ring_stage D={d}: {e.get('registers')} registers, spill "
                  f"stores/loads {e.get('spills')} bytes, 128 threads a block")
            continue
        int8 = form == "4"
        threads, smem = RK.built_launch_shape(int(d), int8)
        if (threads, smem) != RK.ring_launch_shape(int(d), int8):
            raise AssertionError(f"ring_launch_shape({d}, {int8}) is not the source's "
                                 f"{(threads, smem)}")
        print(f"  ring kernel ring_step_tma {'int8' if int8 else 'bf16'} D={d} "
              f"bounded={bounded}: {e.get('registers')} registers at launch, spill stores/loads "
              f"{e.get('spills')} bytes, {smem} bytes of dynamic shared memory, {threads} "
              f"threads a block")
    if (len(steps), len(stages)) != (8, 2) or any(
            e.get("spills") != [0, 0] for e in {**steps, **stages}.values()):
        raise AssertionError(f"a ring kernel spills or is missing from ptxas' report: "
                             f"{steps} {stages}")


def conv_build_report(CK, log, probe_log):
    """The conv kernels' registers and spills, from ptxas' report of
    csrc/conv3x3.cu (bf16 and fp32, each at N 16, 32, 64) and the layout
    probe's; a spill fails the run, and so
    does a launch shape the built library reports that differs from
    CK.conv_launch_shape's at the flagship's and the card tests' shapes."""
    for cin, cout in ((128, 32), (128, 64), (16, 8), (20, 24), (33, 48), (64, 32)):
        for dtype in (torch.bfloat16, torch.float32):
            built, shape = CK.built_launch_shape(cin, cout, dtype), CK.conv_launch_shape(cin, cout, dtype)
            if built != shape:
                raise AssertionError(f"conv_launch_shape({cin}, {cout}, {dtype}) {shape} is not "
                                     f"the source's {built}")
    threads, smem = CK.conv_launch_shape(128, 32, torch.bfloat16)
    print(f"  conv kernel at the flagship's 128 -> 32: bf16 {threads} threads, {smem} bytes of "
          f"dynamic shared memory; fp32 {CK.conv_launch_shape(128, 32, torch.float32)[1]} bytes")
    if not log:
        print("  conv kernels: library built before this run, no ptxas report")
        return
    bf16 = ptxas_entries(log, r"(conv3x3_bf16_tma)ILi(\d+)E()")
    fp32 = ptxas_entries(log, r"(conv3x3_fp32_tma)ILi(\d+)E()")
    probe = ptxas_entries(probe_log, r"(layout_probe)()()") if probe_log else {}
    for (kernel, n, _), e in sorted({**bf16, **fp32, **probe}.items()):
        print(f"  {kernel}{f' N={n}' if n else ''}: {e.get('registers')} registers, spill "
              f"stores/loads {e.get('spills')} bytes")
    entries = {**bf16, **fp32, **probe}
    if (len(bf16), len(fp32)) != (3, 3) or any(e.get("spills") != [0, 0] for e in entries.values()):
        raise AssertionError(f"a conv kernel spills or is missing from ptxas' report: {entries}")


def check_kernels(FK, dev):
    """Each kernel vs its plain version at the main path's shapes."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    # (kernel, label, q shape, kv_valid, bounded): the flagship runs the
    # bounded head-major variant (global attention, qk-norm), the bounded
    # packed variant (frame attention) and the masked running-max packed
    # variant (DINOv2, valid prefix 1374 of 1376); the head-major
    # running-max variant serves weights that fail the logit bound
    cases = [
        ("flash_attention", "global bounded", (1, S * 1374, 16, 64), None, True),
        ("flash_attention", "global running-max", (1, S * 1374, 16, 64), None, False),
        ("flash_attention_packed", "frame bounded", (S, 1374, 16, 64), None, True),
        ("flash_attention_packed", "dino running-max kv 1374", (S, 1376, 16, 64), 1374, False),
    ]
    on_path = {"global bounded", "frame bounded", "dino running-max kv 1374"}
    results = {name: {"errs": [], "ms": [], "plain_ms": [], "bound": [], "library_ms": []}
               for name in ("flash_attention", "flash_attention_packed")}
    for name, label, shape, kv, bounded in cases:
        kernel = getattr(FK, name)
        q, k, v = (
            torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16) for _ in range(3)
        )
        out = kernel(q, k, v, kv_valid=kv, bounded_logits=bounded)
        torch.cuda.synchronize()
        ref = FK.attention_plain(q.float(), k.float(), v.float(), kv, bounded)
        err = (out.float() - ref).abs()
        # the kernel rounds P to bf16 before P @ V (each weight within 2^-8
        # of itself, so o within 2^-8 max|v|) and o to bf16 (within 2^-8 |o|,
        # |o| <= max|v| as a convex mix of v rows): 2^-7 max|v| bounds both
        tol = 2.0**-7 * v.float().abs().max().item()
        max_err, mean_err = err.max().item(), err.mean().item()
        del ref, err
        ms = median_ms(lambda: kernel(q, k, v, kv_valid=kv, bounded_logits=bounded), 20)
        plain_ms = median_ms(lambda: FK.attention_plain(q, k, v, kv, bounded), 5)
        lib_ms = sdpa_ms(q, k, v, kv)
        B, N, H, D = shape
        nk = N if kv is None else kv
        # two products of 2*N*nk*D per head; q, k, v read and o written once
        bnd = bound(4 * B * H * N * nk * D, 2 * B * H * D * (2 * N + 2 * nk))
        print(
            f"kernel {name} [{label}] q{shape} kv_valid={kv}: max_abs_err {max_err:.3e} "
            f"mean_abs_err {mean_err:.3e} tol {tol:.3e} (2^-7 max|v|: bf16 rounding of P "
            f"and of the output) | kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
            f"bound {bnd[0]:.4f} ms ({bnd[1]}), sdpa {lib_ms:.3f} ms"
        )
        if not (np.isfinite(max_err) and max_err <= tol):
            raise AssertionError(f"{name} [{label}] disagrees with its plain version")
        results[name]["errs"].append(max_err)
        if label in on_path:
            results[name]["ms"].append(ms)
            results[name]["plain_ms"].append(plain_ms)
            results[name]["bound"].append(bnd)
            results[name]["library_ms"].append(lib_ms)
        del q, k, v, out
        torch.cuda.empty_cache()
    return results


def check_tma_forms(FK, dev):
    """The bf16 kernel (TMA + wgmma) in each form the main path and
    training run, plus head dim 128: launched 20 times on the same inputs,
    o and the LSE must stay bitwise the same (a race in the stage ring
    would not show as a wrong mean); two planted faults must leave the
    2^-7 max|v| tolerance: the last key tile left out, and K and V loaded
    from the next head (the kernel's test hook). q is scaled by 4 so the
    softmax is peaked and a missing or wrong key shows in o."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    kv_dyn = torch.tensor(1374, dtype=torch.int32, device=dev)
    # (label, q shape, kv_valid, bounded, packed)
    cases = [
        ("global bounded", (1, S * P_TOKENS, 16, 64), None, True, False),
        ("global running-max", (1, S * P_TOKENS, 16, 64), None, False, False),
        ("frame bounded", (S, P_TOKENS, 16, 64), None, True, True),
        ("dino running-max kv 1374", (S, 1376, 16, 64), 1374, False, True),
        ("dynamic kv_valid 1374", (S, 1376, 16, 64), kv_dyn, True, True),
        ("head dim 128, running-max", (2, 3000, 8, 128), 2900, False, False),
    ]
    for label, shape, kv, bounded, packed in cases:
        q = (torch.randn(shape, generator=gen, device=dev) * 4).to(torch.bfloat16)
        k, v = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16) for _ in range(2))
        o0, lse0 = FK._launch(q, k, v, kv, bounded, packed, with_lse=True)
        same = True
        for _ in range(20):
            o, lse = FK._launch(q, k, v, kv, bounded, packed, with_lse=True)
            same = same and torch.equal(o, o0) and torch.equal(lse, lse0)
        nk = shape[1] if kv is None else int(kv)
        mode = FK.MODE_TOKEN_MAJOR if packed else FK.MODE_HEAD_MAJOR
        cut = FK._launch(q, k, v, (nk - 1) // 128 * 128, bounded, packed)
        wrong_head = FK._launch_fwd(FK.flash_attention, q, k, v, kv, bounded, mode, kv_head_shift=1)
        torch.cuda.synchronize()
        ref = FK.attention_plain(q.float(), k.float(), v.float(), kv, bounded)
        tol = 2.0**-7 * v.float().abs().max().item()
        errs = [(x.float() - ref).abs().max().item() for x in (o0, cut, wrong_head)]
        print(f"tma kernel [{label}] q{shape}: 21 launches bitwise equal (o and LSE): {same}; "
              f"max_abs_err {errs[0]:.3e} tol {tol:.3e}; planted faults (must exceed tol): last "
              f"key tile left out {errs[1]:.3e}, K/V of the next head {errs[2]:.3e}")
        if not same:
            raise AssertionError(f"tma kernel [{label}]: launches on the same inputs differ")
        if not (np.isfinite(errs[0]) and errs[0] <= tol):
            raise AssertionError(f"tma kernel [{label}] disagrees with its plain version")
        if not (errs[1] > tol and errs[2] > tol):
            raise AssertionError(f"tma kernel [{label}]: a planted fault passes the check")
        del q, k, v, o0, lse0, o, lse, cut, wrong_head, ref
        torch.cuda.empty_cache()


def ratios(grads, ref, tols):
    """Per gradient: (max abs error, largest error / tolerance over the
    entries, max |ref|, mean |ref|); an entry with tolerance 0 (a masked
    key's dk, dv) must be exact."""
    out = []
    for g, r, t in zip(grads, ref, tols):
        err = (g.float() - r).abs()
        out.append((err.max().item(), (err / t.clamp_min(1e-30)).max().item(),
                    r.abs().max().item(), r.abs().mean().item()))
    return out


# which of (LSE, dq, dk, dv) each planted fault must push past its tolerance
MUST_FAIL = {"delta=0": (1, 2), "last key tile skipped": (0, 1, 2, 3)}


def backward_faults(FK, q, k, v, o, do, lse, kv, bounded, ref, tols, lse_ref, lse_tol):
    """Plants two faults in the kernels' inputs: delta = 0 (o zeroed for
    the dq kernel, a zero delta for dk/dv) and the last key tile skipped
    (kv_valid cut to a multiple of 64, for the forward's LSE and the
    backward). Returns {fault: [largest err/tol of LSE, dq, dk, dv]}."""
    n = k.shape[1] if kv is None else int(kv)
    cut = (n - 1) // 64 * 64
    zero_o = torch.zeros_like(o)
    dq0, _ = FK.flash_attention_bwd_dq(q, k, v, zero_o, do, lse, kv, bounded)
    dk0, dv0 = FK.flash_attention_bwd_dkv(q, k, v, do, lse, torch.zeros_like(lse), kv, bounded)
    _, lse_cut = FK._launch(q, k, v, cut, bounded, packed=q.shape[1] <= FK.PACKED_MAX_KEYS,
                            with_lse=True)
    dq1, dk1, dv1 = FK.flash_attention_backward(q, k, v, o, do, lse, cut, bounded)
    torch.cuda.synchronize()
    lse_ratio = ((lse_cut - lse_ref).abs() / lse_tol).max().item()
    return {
        "delta=0": [float("nan")] + [r[1] for r in ratios((dq0, dk0, dv0), ref, tols)],
        "last key tile skipped": [lse_ratio] + [r[1] for r in ratios((dq1, dk1, dv1), ref, tols)],
    }


def check_backward(FK, dev):
    """The forward kernel's LSE against attention_plain's and the two
    backward kernels against attention_backward_plain (given the kernel's
    o and the plain LSE) at the training shapes, with per-entry
    tolerances; on the training path, two planted faults must fail them."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    n_tok = S_TRAIN * 1374
    kv_dyn = torch.tensor(1374, device=dev)
    # (label, q shape, kv_valid, bounded, q scale, on the training path)
    cases = [
        ("global bounded", (1, n_tok, 16, 64), None, True, 1.0, True),
        ("frame bounded", (S_TRAIN, 1374, 16, 64), None, True, 1.0, True),
        ("dino running-max", (S_TRAIN, 1374, 16, 64), None, False, 1.0, True),
        ("dynamic kv_valid 1374", (S_TRAIN, 1376, 16, 64), kv_dyn, False, 1.0, False),
        ("clamp saturation q x 40", (S_TRAIN, 1374, 16, 64), None, True, 40.0, False),
    ]
    names = ("flash_attention_bwd_dq", "flash_attention_bwd_dkv")
    results = {n: {"errs": [], "ms": [], "plain_ms": [], "bound": [], "library_ms": []}
               for n in names}
    for label, shape, kv, bounded, q_scale, on_path in cases:
        B, N, H, D = shape
        q, k, v, do = (
            torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16) for _ in range(4)
        )
        q = q * q_scale
        o, lse = FK._launch(q, k, v, kv, bounded, packed=N <= FK.PACKED_MAX_KEYS, with_lse=True)
        dq, delta = FK.flash_attention_bwd_dq(q, k, v, o, do, lse, kv, bounded)
        dk, dv = FK.flash_attention_bwd_dkv(q, k, v, do, lse, delta, kv, bounded)
        same = True
        for _ in range(20):  # a race in a stage ring would not show as a wrong mean
            again = FK.flash_attention_bwd_dq(q, k, v, o, do, lse, kv, bounded)
            again += FK.flash_attention_bwd_dkv(q, k, v, do, lse, again[1], kv, bounded)
            same = same and all(torch.equal(a, b) for a, b in zip(again, (dq, delta, dk, dv)))
        del again
        torch.cuda.synchronize()
        print(f"backward kernels [{label}]: 21 launches of each bitwise equal (dq, delta, dk, "
              f"dv): {same}")
        if not same:
            raise AssertionError(f"backward kernels [{label}]: launches on the same inputs differ")
        f = [x.float() for x in (q, k, v)]
        o_ref, lse_ref = FK.attention_plain(*f, kv, bounded, return_lse=True)
        o_err = (o.float() - o_ref).abs().max().item()
        o_tol = 2.0**-7 * v.float().abs().max().item()
        lse_tol = FK.lse_tolerance(q, k, lse_ref, kv)
        lse_diff = (lse - lse_ref).abs()
        lse_err, lse_ratio = lse_diff.max().item(), (lse_diff / lse_tol).max().item()
        print(f"kernel forward [{label}] q{shape}: o max_abs_err {o_err:.3e} tol {o_tol:.3e}; "
              f"lse max_abs_err {lse_err:.3e}, worst err/tol {lse_ratio:.3f} (tol per row "
              f"{lse_tol.min().item():.3e}-{lse_tol.max().item():.3e}, fp32 rounding of the "
              f"row sum and the exponents: FK.lse_tolerance), |lse| <= "
              f"{lse_ref.abs().max().item():.2f}")
        if not (o_err <= o_tol and lse_ratio <= 1.0):
            raise AssertionError(f"forward kernel [{label}]: o or LSE disagrees with attention_plain")
        f += [o.float(), do.float()]
        ref = FK.attention_backward_plain(*f, lse_ref, kv, bounded)
        tols = FK.backward_tolerance(*f, lse_ref, kv, bounded, lse_err=lse_err)
        checked = ratios((dq, dk, dv), ref, tols)
        faults = (backward_faults(FK, q, k, v, o, do, lse, kv, bounded, ref, tols, lse_ref, lse_tol)
                  if on_path else {})
        errs = [c[0] for c in checked]
        del f, ref, tols, o_ref, lse_ref, lse_tol, lse_diff
        torch.cuda.empty_cache()
        dq_ms = median_ms(lambda: FK.flash_attention_bwd_dq(q, k, v, o, do, lse, kv, bounded), 20)
        dkv_ms = median_ms(
            lambda: FK.flash_attention_bwd_dkv(q, k, v, do, lse, delta, kv, bounded), 20)
        plain_ms = median_ms(lambda: FK.attention_backward_plain(q, k, v, o, do, lse, kv, bounded), 5)
        lib_ms = sdpa_ms(q, k, v, kv, do)
        lib_bwd_ms = sdpa_backward_ms(q, k, v, kv, do)
        nk = N if kv is None else int(kv)
        tile = 2 * B * H * D  # bytes of one bf16 token row over all heads, per token
        rows = 4 * B * H * N  # bytes of one fp32 (B, H, N) row vector
        # dq: S, dP, dQ products; reads q, k, v, o, dO, lse; writes dq, delta
        bnd_dq = bound(6 * B * H * N * nk * D, tile * (3 * N + 2 * nk) + 2 * rows)
        # dkv: S, dP, dV, dK products; reads q, k, v, dO, lse, delta; writes dk, dv
        bnd_dkv = bound(8 * B * H * N * nk * D, tile * (2 * N + 4 * nk) + 2 * rows)
        print(
            f"kernel backward [{label}] q{shape} kv_valid={kv if kv is None else int(kv)}: "
            + ", ".join(f"{n} max_abs_err {e:.3e} worst err/tol {r:.3f} max|ref| {m:.3e} "
                        f"mean|ref| {a:.3e}"
                        for n, (e, r, m, a) in zip(("dq", "dk", "dv"), checked))
            + f" (tol per entry: 2^-8 (|ref| + {FK.BWD_SIGMAS:g} sqrt(sum t^2)) for the bf16"
            " rounding of ds / p and of the output, plus the fp32 rounding of p and ds and"
            " the LSE difference summed over the terms: FK.backward_tolerance)"
            f" | dq {dq_ms:.3f} ms (bound {bnd_dq[0]:.4f}, {bnd_dq[1]}), "
            f"dkv {dkv_ms:.3f} ms (bound {bnd_dkv[0]:.4f}, {bnd_dkv[1]}), "
            f"plain backward {plain_ms:.3f} ms, sdpa backward alone {lib_bwd_ms:.3f} ms "
            f"(fwd+bwd {lib_ms:.3f} ms)"
        )
        for fault, r in faults.items():
            print(f"  planted fault [{label}] {fault}: err/tol lse {r[0]:.3g}, dq {r[1]:.3g}, "
                  f"dk {r[2]:.3g}, dv {r[3]:.3g} (rejected where > 1)")
        if not all(np.isfinite(e) and r <= 1.0 for e, r, _, _ in checked):
            raise AssertionError(f"backward kernels [{label}] disagree with the plain backward")
        for fault, r in faults.items():
            if not all(r[i] > 1.0 for i in MUST_FAIL[fault]):
                raise AssertionError(f"the tolerances do not reject a planted fault ({fault})")
        results[names[0]]["errs"].append(errs[0])
        results[names[1]]["errs"].append(max(errs[1:]))
        if on_path:
            for n, ms, bnd in ((names[0], dq_ms, bnd_dq), (names[1], dkv_ms, bnd_dkv)):
                results[n]["ms"].append(ms)
                results[n]["plain_ms"].append(plain_ms)
                results[n]["bound"].append(bnd)
                results[n]["library_ms"].append(lib_bwd_ms)
        del q, k, v, do, o, lse, dq, dk, dv, delta
        torch.cuda.empty_cache()
    return results


def train_phase(FK, cfg, dev, card):
    """The flagship train step: timing, launches, descent, and one step's
    loss and gradients against the plain-attention path."""
    from omnivggt_tpu_torch.models.omnivggt import OmniVGGT
    from omnivggt_tpu_torch.train.optim import make_finetune_optimizer
    from omnivggt_tpu_torch.train.step import init_state, make_train_step, synthetic_batch

    t0 = time.perf_counter()
    model = OmniVGGT(cfg, device=dev, seed=0).train()
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    with torch.no_grad():  # unit-scale camera token, as in the forward phase
        model.aggregator.camera_token.normal_(generator=gen)
    optimizer = make_finetune_optimizer(model, learning_rate=1e-4, warmup_steps=1, total_steps=100)
    step_fn = make_train_step(cfg, optimizer, use_aux_inputs=True, remat=True)
    state = init_state(model, optimizer)
    batch = synthetic_batch(S_TRAIN, IMG, dev, seed=3)
    torch.cuda.synchronize()
    print(f"train: model and optimizer built in {time.perf_counter() - t0:.2f} s; "
          f"S={S_TRAIN} {IMG}px, remat on, fp32 master weights, bf16 trunk")

    state, metrics = step_fn(state, batch)  # warm-up (learning rate 0)
    history = [{k: v.item() for k, v in metrics.items()}]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, launches = [], None
    for i in range(4):
        if i == 0:
            FK.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            launches = FK.launches()
        history.append({k: v.item() for k, v in metrics.items()})
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for i, m in enumerate(history):
        print(f"train step {i}: " + ", ".join(f"{k} {v:.6f}" for k, v in sorted(m.items())))
    if not all(np.isfinite(v) for m in history for v in m.values()):
        raise AssertionError("a training loss or grad_norm is not finite")
    if not all(m["grad_norm"] > 0 for m in history):
        raise AssertionError("grad_norm is 0")
    if not history[-1]["total"] < history[0]["total"]:
        raise AssertionError("the training loss does not descend on the fixed batch")
    depth, dino = cfg.aggregator.depth, cfg.aggregator.backbone.depth
    # remat runs each frame/global attention forward twice (the pass and
    # its recomputation); DINOv2 is not rematted; every attention has one
    # backward (dq then dk/dv)
    expect = {
        "flash_attention": 2 * depth,
        "flash_attention_packed": 2 * depth + dino,
        "flash_attention_bwd_dq": 2 * depth + dino,
        "flash_attention_bwd_dkv": 2 * depth + dino,
        "flash_attention_int8": 0,
        "flash_attention_packed_stream": 0,
    }
    print(f"main path launches per train step: {launches} (expected {expect})")
    if launches != expect:
        raise AssertionError(f"train-step kernel launches {launches}, expected {expect}")
    step_ms = statistics.median(times)
    print(
        f"flagship train step S={S_TRAIN} {IMG}px: {step_ms:.2f} ms median of {len(times)} "
        f"({', '.join(f'{t:.2f}' for t in times)}), {S_TRAIN / step_ms * 1e3:.3f} views/s, "
        f"peak memory {peak_gb:.3f} GB; card {card}"
    )

    profile_breakdown(f"train step S={S_TRAIN}", lambda: step_fn(state, batch))

    # one step's loss and gradients: kernels vs plain attention, same
    # weights, over the trunk (aggregator and DINOv2: every parameter whose
    # gradient passes through an attention backward); then the same with a
    # planted fault in the backward, which the limits must reject
    del optimizer, state
    torch.cuda.empty_cache()
    trunk = [name for name, _ in model.named_parameters() if name.startswith("aggregator.")]
    params = dict(model.named_parameters())

    def loss_and_trunk_grads(impl):
        fn = make_train_step(cfg, None, use_aux_inputs=True, remat=True, attn_impl=impl)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = fn.loss_and_grads(model, batch, 0)
        torch.cuda.synchronize()
        print(f"loss and gradients, attention {impl}: {(time.perf_counter() - t0) * 1e3:.2f} ms, "
              f"total loss {losses['total'].item():.6f}")
        grads = {n: params[n].grad.detach().clone() for n in trunk if params[n].grad is not None}
        model.zero_grad(set_to_none=True)
        return losses["total"].item(), grads

    loss_p, g_p = loss_and_trunk_grads("plain")
    n_p = sum((b.double() ** 2).sum() for b in g_p.values()).item() ** 0.5

    def gate(label, loss_k, g_k):
        dot = sum((g_k[n].double() * b.double()).sum() for n, b in g_p.items()).item()
        n_k = sum((a.double() ** 2).sum() for a in g_k.values()).item() ** 0.5
        leaves = sorted((((g_k[n] - b).double().norm() / b.double().norm()).item(), n)
                        for n, b in g_p.items() if b.abs().max() > 0)
        loss_rel, cos = abs(loss_k - loss_p) / abs(loss_p), dot / (n_k * n_p)
        print(f"train gate [{label}] vs plain path: loss rel {loss_rel:.3e} (limit "
              f"{LOSS_REL_TOL:g}), trunk gradient 1 - cosine {1 - cos:.3e} (limit "
              f"{1 - GRAD_COS_MIN:.0e}), trunk grad norms {n_k:.4f} / {n_p:.4f} over "
              f"{len(g_p)} leaves; leaf relative errors: median "
              f"{leaves[len(leaves) // 2][0]:.3e}, worst {leaves[-1][1]} {leaves[-1][0]:.3e}")
        return loss_rel <= LOSS_REL_TOL and cos >= GRAD_COS_MIN

    if not gate("kernels", *loss_and_trunk_grads("auto")):
        raise AssertionError("the kernel path's train step disagrees with the plain path")
    sound_backward = FK.flash_attention_backward

    def delta_zero(q, k, v, o, do, lse, kv, bounded):
        dq, _ = FK.flash_attention_bwd_dq(q, k, v, torch.zeros_like(o), do, lse, kv, bounded)
        return (dq, *FK.flash_attention_bwd_dkv(q, k, v, do, lse, torch.zeros_like(lse), kv,
                                                bounded))

    def last_tile_skipped(q, k, v, o, do, lse, kv, bounded):
        n = k.shape[1] if kv is None else int(kv)
        return sound_backward(q, k, v, o, do, lse, (n - 1) // 64 * 64, bounded)

    passed = {}
    try:
        for label, fault in (("fault delta=0", delta_zero),
                             ("fault last key tile skipped", last_tile_skipped)):
            FK.flash_attention_backward = fault
            passed[label] = gate(label, *loss_and_trunk_grads("auto"))
    finally:
        FK.flash_attention_backward = sound_backward
    if any(passed.values()):
        raise AssertionError(f"the train gate does not reject a planted fault: {passed}")
    return launches


def new_results():
    return {"errs": [], "ms": [], "plain_ms": [], "bound": [], "library_ms": []}


def check_serving_attention(FK, dev):
    """The head-major kernel's int8 form and the streaming kernel (bf16 and
    int8 forms) at the global-attention shape, a static key axis and a
    dynamic valid prefix, each against its plain version; the quantisers'
    int8 grids; one planted fault per form."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    B, N, H, D = shape = (1, S * P_TOKENS, 16, 64)
    # q scaled per head from 2 to 8: the softmax is peaked (the output is of
    # v's size, so a wrong score shows) and the heads' dequantising scalars
    # differ (so one head's scalar used for all shows)
    head_scale = torch.linspace(2.0, 8.0, H, device=dev)[None, None, :, None]
    q = (torch.randn(shape, generator=gen, device=dev) * head_scale).to(torch.bfloat16)
    k, v = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16) for _ in range(2))
    kv_dyn = torch.tensor(5 * P_TOKENS, dtype=torch.int32, device=dev)
    # as for the bf16 kernels: P rounded to bf16 and the output rounded to
    # bf16, each within 2^-8 max|v|; the int8 forms share their plain
    # version's integer scores exactly, so nothing is added
    tol = 2.0**-7 * v.float().abs().max().item()
    results = {"flash_attention_int8": new_results(),
               "flash_attention_packed_stream": new_results()}

    for valid in (None, kv_dyn):
        for fn in (FK.quant_per_head, FK.quant_token_major):
            on_card = fn(q, valid)
            on_cpu = fn(q.cpu(), None if valid is None else valid.cpu())
            same = all(torch.equal(a.cpu(), b) for a, b in zip(on_card, on_cpu))
            print(f"quantiser {fn.__name__} valid={None if valid is None else int(valid)}: "
                  f"int8 values and scales on the card equal to the CPU's: {same}")
            if not same:
                raise AssertionError(f"{fn.__name__} gives another int8 grid on the card")
    k_card, k_cpu = FK.quant_k_token_major(k), FK.quant_k_token_major(k.cpu())
    if not all(torch.equal(a.cpu(), b) for a, b in zip(k_card, k_cpu)):
        raise AssertionError("quant_k_token_major gives another int8 grid on the card")
    print("quantiser quant_k_token_major: int8 values and scales equal to the CPU's: True")
    from omnivggt_tpu_torch.ops import layers as TL

    rows, weight = q.reshape(-1, H * D)[:4096], k.reshape(-1, H * D)[:1024]
    for fn, x in ((TL._quantise_rows, rows), (TL._quantise_weight, weight)):
        same = all(torch.equal(a.cpu(), b) for a, b in zip(fn(x), fn(x.cpu())))
        print(f"quantiser {fn.__name__} {tuple(x.shape)}: equal to the CPU's: {same}")
        if not same:
            raise AssertionError(f"{fn.__name__} gives another int8 grid on the card")

    def err_to(out, ref):
        return (out.float() - ref).abs().max().item()

    for label, kv in (("static", None), ("dynamic kv_valid 5 of 8 frames", kv_dyn)):
        nk = N if kv is None else int(kv)
        f = [x.float() for x in (q, k, v)]
        exact = FK.attention_plain(*f, kv, True)
        ref_hm = FK.attention_plain_int8(*f, kv, True)
        ref_st = FK.attention_stream_plain(*f, kv, True)
        del f

        # the int8 forms (the TMA + wgmma tile, s8 scores), each through its
        # wrapper, then launched 21 times on its grid (bitwise the same o),
        # and with three planted faults on the same grid: c of head 0 for
        # every head, the last key tile left out, K and V of the next head
        cut = (nk - 1) // 128 * 128
        q8, q_scale = FK.quant_per_head(q, kv)
        k8, k_scale = FK.quant_per_head(k, kv)
        c = q_scale * k_scale * D**-0.5
        q8_plain, qt_scale, q_inv = FK.quant_token_major(q, kv)
        kt8, kt_scale, _ = FK.quant_token_major(k, kv)
        ct = qt_scale * kt_scale * D**-0.5
        int8_forms = {
            "head-major int8": (
                "flash_attention_int8", ref_hm,
                lambda: FK.flash_attention(q, k, v, kv, True, qk_int8=True),
                lambda n_keys, c_, shift: FK._launch_fwd(
                    FK.flash_attention_int8, q8, k8, v, n_keys, True, FK.MODE_HEAD_MAJOR,
                    qk=FK.SCORES_INT8, c=c_, kv_head_shift=shift), c),
            "stream int8": (
                "flash_attention_packed_stream", ref_st,
                lambda: FK.flash_attention_packed_stream(q, k, v, kv, qk_int8=True),
                lambda n_keys, c_, shift: FK._launch_fwd(
                    FK.flash_attention_packed_stream, q, kt8, v, n_keys, True,
                    FK.MODE_TOKEN_MAJOR, qk=FK.SCORES_INT8_Q_IN, c=c_, qinv=q_inv,
                    kv_head_shift=shift), ct),
        }
        checks = []
        for form, (name, ref, wrapper, launch, c_form) in int8_forms.items():
            out = wrapper()
            o0 = launch(kv, c_form, 0)
            same = torch.equal(o0, out)
            for _ in range(20):
                same = same and torch.equal(launch(kv, c_form, 0), o0)
            faults = {
                "c of head 0 for every head": launch(kv, c_form[:, :1].expand(B, H).contiguous(), 0),
                "last key tile left out": launch(cut, c_form, 0),
                "K/V of the next head": launch(kv, c_form, 1),
            }
            torch.cuda.synchronize()
            fault_errs = {f: err_to(x, ref) for f, x in faults.items()}
            print(f"{form} [{label}] q{shape} (TMA + wgmma, s8 scores): the wrapper's o and 21 "
                  f"launches on its grid bitwise equal: {same}; planted faults (must exceed "
                  f"tol {tol:.3e}): " + ", ".join(f"{f} {e:.3e}" for f, e in fault_errs.items()))
            if not same:
                raise AssertionError(f"{form} [{label}]: launches on the same inputs differ")
            checks.append((name, form, err_to(out, ref), err_to(out, exact), fault_errs))
            del out, o0, faults

        # the stream kernel's in-kernel q grid
        q8_out = torch.empty(shape, dtype=torch.int8, device=dev)
        FK._stream_int8(q, k, v, kv, None, q8_out=q8_out)
        torch.cuda.synchronize()
        grid_equal = torch.equal(q8_out, q8_plain)
        print(f"stream int8 [{label}]: the q grid made in the kernel equals quant_token_major's "
              f"int8 values: {grid_equal}")
        if not grid_equal:
            raise AssertionError("the streaming kernel quantises q to another grid")
        del q8, k8, q8_out, q8_plain, kt8

        # stream, bf16 form; fault: the last key tile skipped
        out = FK.flash_attention_packed_stream(q, k, v, kv)
        bad = FK.flash_attention_packed_stream(q, k, v, (nk - 1) // 64 * 64)
        torch.cuda.synchronize()
        checks.append(("flash_attention_packed_stream", "stream bf16", err_to(out, exact),
                       err_to(out, exact), {"last key tile skipped": err_to(bad, exact)}))
        del out, bad, exact, ref_hm, ref_st
        torch.cuda.empty_cache()

        runs = {
            "head-major int8": (
                lambda: FK.flash_attention(q, k, v, kv, True, qk_int8=True),
                lambda: FK.attention_plain_int8(q, k, v, kv, True),
                lambda: (FK.quant_per_head(q, kv), FK.quant_per_head(k, kv))),
            "stream bf16": (
                lambda: FK.flash_attention_packed_stream(q, k, v, kv),
                lambda: FK.attention_stream_plain(q, k, v, kv), None),
            "stream int8": (
                lambda: FK.flash_attention_packed_stream(q, k, v, kv, qk_int8=True),
                lambda: FK.attention_stream_plain(q, k, v, kv, True),
                lambda: (FK._abs_max_per_head(q, kv), FK.quant_token_major(k, kv))),
        }
        lib_ms = sdpa_ms(q, k, v, None if kv is None else nk)
        io_bytes = 2 * B * H * D * (2 * N + 2 * nk)  # bf16 q, k, v read, o written once
        for name, form, err, to_exact, fault_errs in checks:
            kernel, plain, quant = runs[form]
            ms, plain_ms = median_ms(kernel, 20), median_ms(plain, 3)
            quant_ms = median_ms(quant, 10) if quant else 0.0
            qk_ops = 2 * B * H * N * nk * D
            bnd = (bound(2 * qk_ops, io_bytes) if form == "stream bf16"
                   else bound(qk_ops, io_bytes, int8_ops=qk_ops))
            print(
                f"kernel {name} [{form}, {label}] q{shape}: max_abs_err {err:.3e} tol {tol:.3e} "
                f"(2^-7 max|v|, against the plain version on the same grid); to exact attention "
                f"{to_exact:.3e} (reported); planted faults (must exceed tol): "
                + ", ".join(f"{f} {e:.3e}" for f, e in fault_errs.items())
                + f" | wrapper {ms:.3f} ms of which the quantisation passes (plain torch ops) "
                f"{quant_ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}), "
                f"sdpa {lib_ms:.3f} ms"
            )
            if not (np.isfinite(err) and err <= tol):
                raise AssertionError(f"{name} [{form}, {label}] disagrees with its plain version")
            if not all(e > tol for e in fault_errs.values()):
                raise AssertionError(f"{name} [{form}, {label}]: a planted fault passes the check")
            r = results[name]
            r["errs"].append(err)
            r["ms"].append(ms)
            r["plain_ms"].append(plain_ms)
            r["bound"].append(bnd)
            r["library_ms"].append(lib_ms)
    return results


def check_conv(CK, dev):
    """The 3x3 convolution kernel against F.conv2d in fp32 from the same
    inputs, entry by entry: the flagship's output_conv2[0] shape and one
    ragged shape, fp32 and bf16, ReLU on and off, each with x in NCHW
    (copied once by the wrapper, counted on conv3x3_folded.relayouts) and
    in channels_last (read in place where TMA can map it); the planted halo
    fault (the left halo column left out) must fail every case; at the
    flagship 21 launches on the same inputs bitwise equal in both forms, and
    times: the kernel on both layouts and channels_last in with the NCHW
    output the heads take, F.conv2d on both layouts, the bound."""
    F = torch.nn.functional
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    result = new_results()
    # (B, cin, cout, H, W, the flagship's); both wider than one 64-column
    # unit, so the planted fault (the left halo column of every unit, the
    # image's own zero pad in the first) reaches real pixels
    cases = [(8, 128, 32, IMG, IMG, True), (1, 20, 24, 37, 77, False)]
    for B, cin, cout, H, W, flagship in cases:
        conv = torch.nn.Conv2d(cin, cout, 3, padding=1).to(dev)
        x32 = torch.randn((B, cin, H, W), generator=gen, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            x_nchw = x32.to(dtype)
            w = conv.weight.detach().to(dtype)
            with torch.no_grad():
                pre = F.conv2d(x_nchw.float(), w.float(), conv.bias, padding=1)
                mag = F.conv2d(x_nchw.float().abs(), w.float().abs(), conv.bias.abs(), padding=1)
            # both sides add 9 cin products and the bias in fp32 in their own
            # order: each within (9 cin + 1) 2^-24 of the sum of magnitudes;
            # the bf16 kernel also rounds its output to bf16 (2^-8 of it).
            # The ReLU is 1-Lipschitz, so the bound holds behind it too
            tol = mag.mul_(2 * (9 * cin + 1) * 2.0**-24)
            if dtype == torch.bfloat16:
                tol += 2.0**-8 * pre.abs()
            name = str(dtype).split('.')[-1]
            for layout in ("NCHW", "channels_last"):
                x = (x_nchw if layout == "NCHW"
                     else x_nchw.contiguous(memory_format=torch.channels_last))
                copies = 0
                for relu in (False, True):
                    ref = F.relu(pre) if relu else pre
                    before = CK.conv3x3_folded.relayouts
                    with torch.no_grad():
                        out = CK.conv3x3_folded(conv, x, relu)
                        bad = CK._launch(conv, x, relu, drop_halo_column=True)
                    copies += CK.conv3x3_folded.relayouts - before
                    torch.cuda.synchronize()
                    err = (out.float() - ref).abs()
                    ratio = (err / tol).max().item()
                    fault_ratio = ((bad.float() - ref).abs() / tol).max().item()
                    max_err = err.max().item()
                    del err, bad
                    line = (f"kernel conv3x3_folded [{B}x{cin}->{cout} {H}x{W} {layout} {name} "
                            f"relu={relu}]: max_abs_err {max_err:.3e}, worst err/tol {ratio:.3f} "
                            f"(tol per entry: 2 (9 cin + 1) 2^-24 conv(|x|, |w|) for both sides' "
                            f"fp32 sums"
                            + (", + 2^-8 |ref| for the bf16 output" if dtype == torch.bfloat16
                               else "")
                            + f"); planted fault (left halo column left out) err/tol "
                            f"{fault_ratio:.3g}")
                    if flagship and relu:
                        with torch.no_grad():
                            ms = median_ms(lambda: CK.conv3x3_folded(conv, x, relu), 10)
                            lib_ms = median_ms(
                                lambda: F.conv2d(x, w, conv.bias.to(dtype), padding=1), 10)
                            line += f" | kernel {ms:.4f} ms, F.conv2d on this x {lib_ms:.4f} ms"
                            if layout == "channels_last":
                                heads_ms = median_ms(lambda: CK.conv3x3_folded(
                                    conv, x, relu, memory_format=torch.contiguous_format), 10)
                                plain_ms = median_ms(lambda: CK.conv3x3_plain(conv, x, relu), 10)
                                line += (f", kernel with the NCHW output the heads take "
                                         f"{heads_ms:.4f} ms, plain {plain_ms:.4f} ms")
                                if dtype == torch.float32:
                                    torch.backends.cudnn.allow_tf32 = True
                                    tf32_ms = median_ms(
                                        lambda: F.conv2d(x, w, conv.bias, padding=1), 10)
                                    torch.backends.cudnn.allow_tf32 = False
                                    line += f" (F.conv2d TF32 off; {tf32_ms:.4f} ms with TF32 on)"
                                # 21 launches on the same inputs: the same bits
                                same = all(torch.equal(CK.conv3x3_folded(conv, x, relu), out)
                                           for _ in range(20))
                                line += f"; 21 launches bitwise equal: {same}"
                                if not same:
                                    raise AssertionError("conv3x3_folded: 21 launches differ")
                        flops = 2 * 9 * cin * cout * B * H * W
                        nbytes = x.element_size() * (x.numel() + out.numel() + w.numel())
                        bnd = (bound(0, nbytes, fp32_flops=flops) if dtype == torch.float32
                               else bound(flops, nbytes))
                        line += f", bound {bnd[0]:.4f} ms ({bnd[1]})"
                        if layout == "channels_last":  # what the heads hand it
                            result["ms"].append(ms)
                            result["plain_ms"].append(plain_ms)
                            result["bound"].append(bnd)
                            result["library_ms"].append(lib_ms)
                    print(line)
                    if not (np.isfinite(ratio) and ratio <= 1.0):
                        raise AssertionError("conv3x3_folded disagrees with its plain version")
                    if W > CK.TILE_W and not fault_ratio > 1.0:
                        raise AssertionError("conv3x3_folded: the planted fault passes the check")
                    result["errs"].append(max_err)
                    del out, ref
                want = 0 if CK.tma_mappable(x) else 4  # 2 calls + 2 planted faults
                print(f"  {layout} {name} x: {copies} relayout copies in 4 calls "
                      f"(TMA maps it in place: {CK.tma_mappable(x)})")
                if copies != want:
                    raise AssertionError(f"conv3x3_folded made {copies} relayouts, expected {want}")
                del x
            del pre, tol, x_nchw
            torch.cuda.empty_cache()
    return {"conv3x3_folded": result}


def probes_phase():
    """The layout probes (kernel 9); a FAIL fails the run."""
    from omnivggt_tpu_torch.tools import probe_layouts as PL

    stats = {}
    before = PL._launch.launches
    if not PL.run(stats=stats):
        raise AssertionError("a layout probe failed")
    result = new_results()
    result["errs"].append(stats["max_abs_err"])
    result["ms"].append(stats["ms"])
    result["plain_ms"].append(stats["plain_ms"])
    # each probe's plain version is one torch call of the same array function
    # (torch.roll, a slice, torch.cat, a matmul), so it is the library time too
    result["library_ms"].append(stats["plain_ms"])
    result["bound"].append(bound(0, stats["bytes"]))
    return {"layout_probes": result}, PL._launch.launches - before


def request_inputs(n, seed, with_gt):
    """One serving request as numpy arrays: n frames at 518 px, with GT
    cameras for 4 frames and depth for 2 when with_gt."""
    rng = np.random.default_rng(seed)
    req = {"images": rng.uniform(size=(n, IMG, IMG, 3)).astype(np.float32)}
    if with_gt:
        extr = np.tile(np.eye(3, 4, dtype=np.float32), (n, 1, 1))
        extr[:, :3, 3] = rng.normal(size=(n, 3))
        intr = np.tile(np.diag([500.0, 500.0, 1.0]).astype(np.float32), (n, 1, 1))
        intr[:, 0, 2] = intr[:, 1, 2] = IMG / 2
        req.update(
            extrinsics=extr, intrinsics=intr,
            depth=(1.0 + 4.0 * rng.uniform(size=(n, IMG, IMG, 1))).astype(np.float32),
            mask=np.ones((n, IMG, IMG), np.float32),
            camera_gt_index=[0, 1, 2, 3], depth_gt_index=[0, 1],
        )
    return req


def read_glb(data: bytes):
    """(glTF JSON, BIN chunk, POSITION count of each mesh) of a GLB; raises
    unless the header is glTF version 2 with the stated length and the
    chunks are a JSON chunk then a BIN chunk that fill it."""
    magic, version, length = struct.unpack_from("<III", data, 0)
    if (magic, version, length) != (0x46546C67, 2, len(data)):
        raise AssertionError(f"GLB header {magic:#x} v{version} length {length} of {len(data)}")
    jlen, jtype = struct.unpack_from("<II", data, 12)
    blen, btype = struct.unpack_from("<II", data, 20 + jlen)
    if (jtype, btype) != (0x4E4F534A, 0x004E4942) or 28 + jlen + blen != len(data):
        raise AssertionError("GLB chunks are not one JSON chunk and one BIN chunk")
    gltf = json.loads(data[20 : 20 + jlen])
    counts = [gltf["accessors"][m["primitives"][0]["attributes"]["POSITION"]]["count"]
              for m in gltf["meshes"]]
    return gltf, data[28 + jlen :], counts


def outputs_phase(session, req, card, reset, counts, expected):
    """(e) the scene outputs of a served S=8 request: POST /infer and POST
    /infer_glb (conf_thres 25, both prediction modes) on a local port, each
    GLB well formed, its point count what predictions_to_glb_data keeps and
    one frustum a frame, and byte for byte _glb_from_preds on the host of the
    /infer answer plus the request's images; the viewer (serve_scene) on a
    local port, its /data byte for byte _scene_payload's; the trajectory
    metrics of the predicted poses against the request's GT cameras (frames
    0-3) and a TUM round trip. Host times are taken on the host of the
    machine that holds the card, not on the device."""
    import tempfile

    from omnivggt_tpu_torch import serving as TS
    from omnivggt_tpu_torch.eval import trajectory as TT
    from omnivggt_tpu_torch.utils.geometry import (
        pose_encoding_to_extri_intri, unproject_depth_map_to_point_map,
    )
    from omnivggt_tpu_torch.viz import glb as TG
    from omnivggt_tpu_torch.viz import server as TSrv

    n = req["images"].shape[0]
    fields = {k: np.asarray(v) for k, v in req.items()}
    with socket.socket() as sock:
        sock.bind(("", 0))
        port = sock.getsockname()[1]

    def post(route, **extra):
        body = io.BytesIO()
        np.savez(body, **fields, **extra)
        request = urllib.request.Request(f"http://localhost:{port}{route}", data=body.getvalue(),
                                         method="POST")
        t0 = time.perf_counter()
        with urllib.request.urlopen(request, timeout=600) as resp:
            status, ctype, data = resp.status, resp.headers["Content-Type"], resp.read()
        ms = (time.perf_counter() - t0) * 1e3
        if status != 200:
            raise AssertionError(f"POST {route}: {status}")
        return ctype, data, ms

    httpd, _ = TS.serve(session, port=port, background=True)
    try:
        answer = dict(np.load(io.BytesIO(post("/infer")[1])))
        answer["images"] = req["images"]
        ext, intr = (t[0].numpy() for t in pose_encoding_to_extri_intri(
            torch.from_numpy(answer["pose_enc"])[None], (IMG, IMG)))
        preds = {**answer, "extrinsic": ext, "intrinsic": intr,
                 "world_points_from_depth": unproject_depth_map_to_point_map(
                     answer["depth"], ext, intr)}
        for mode, conf_key in (("Predicted Pointmap", "world_points_conf"), ("Depth", "depth_conf")):
            kw = dict(conf_thres=25.0, prediction_mode=mode)
            reset()
            ctype, body, _ = post("/infer_glb", conf_thres=np.float32(25.0), prediction_mode=mode)
            launches = counts()
            if launches != expected:
                raise AssertionError(f"/infer_glb launches {launches}, expected {expected}")
            _, _, positions = read_glb(body)
            kept = len(TG.predictions_to_glb_data(preds, **kw)[0])
            conf = answer[conf_key].reshape(-1)
            by_rule = int(((conf >= np.percentile(conf, 25.0)) & (conf > 1e-5)).sum())
            t0 = time.perf_counter()
            host = TS._glb_from_preds(answer, IMG, IMG, **kw)
            host_ms = (time.perf_counter() - t0) * 1e3
            print(f"outputs: POST /infer_glb [{mode}] {ctype}, {len(body) / 1e6:.3f} MB, "
                  f"{positions[0]} of {conf.size} points kept (predictions_to_glb_data {kept}, "
                  f"by the rule {by_rule}), {len(positions) - 1} frusta; launches {launches}; "
                  f"equal to _glb_from_preds on the host: {body == host}")
            if ctype != "model/gltf-binary" or positions[0] != kept or kept != by_rule:
                raise AssertionError(f"/infer_glb [{mode}]: malformed answer or point count")
            if len(positions) != 1 + n or any(c != 9 for c in positions[1:]):
                raise AssertionError(f"/infer_glb [{mode}]: {len(positions) - 1} frusta for {n} frames")
            if body != host:
                raise AssertionError(f"/infer_glb [{mode}] differs from _glb_from_preds of the "
                                     "/infer answer")
            print(f"outputs: host time of _glb_from_preds [{mode}] at {conf.size} points: "
                  f"{host_ms:.2f} ms (host time, on the machine that holds the card); GLB {len(body) / 1e6:.3f} MB, "
                  f"{sum(positions)} vertices; card {card}")
        infer_ms = [post("/infer")[2] for _ in range(3)]
        glb_ms = [post("/infer_glb", conf_thres=np.float32(25.0), prediction_mode="Depth")[2]
                  for _ in range(3)]
    finally:
        httpd.shutdown()
        httpd.server_close()
    print(f"outputs: S={n} {IMG}px request latency (host clock around the HTTP call, config (a)): "
          f"POST /infer_glb [Depth] median {statistics.median(glb_ms):.2f} ms "
          f"({', '.join(f'{t:.2f}' for t in glb_ms)}) against POST /infer median "
          f"{statistics.median(infer_ms):.2f} ms ({', '.join(f'{t:.2f}' for t in infer_ms)}); "
          f"card {card}")

    t0 = time.perf_counter()
    payload = TSrv._scene_payload(preds)
    payload_ms = (time.perf_counter() - t0) * 1e3
    with socket.socket() as sock:
        sock.bind(("", 0))
        view_port = sock.getsockname()[1]
    viewer = TSrv.serve_scene(preds, port=view_port, background_mode=True)
    try:
        with urllib.request.urlopen(f"http://localhost:{view_port}/", timeout=60) as resp:
            page_ok = resp.status == 200 and resp.headers["Content-Type"] == "text/html" \
                and b"<canvas" in resp.read()
        with urllib.request.urlopen(f"http://localhost:{view_port}/data", timeout=60) as resp:
            data = resp.read()
    finally:
        viewer.httpd.shutdown()
        viewer.httpd.server_close()
    header = struct.unpack_from("<III", data, 0)
    print(f"outputs: viewer GET / {'200 HTML' if page_ok else 'FAILED'}; GET /data "
          f"{len(data) / 1e6:.3f} MB, header (points, frames, segments) {header}, equal to "
          f"_scene_payload: {data == payload}; host time of the payload build {payload_ms:.2f} ms "
          f"(host time, on the machine that holds the card); card {card}")
    if not page_ok or data != payload or header != (n * IMG * IMG, n, 8 * n):
        raise AssertionError("the viewer's page or /data is wrong")

    gt = np.tile(np.eye(4), (4, 1, 1))
    gt[:, :3] = req["extrinsics"][:4]
    E = np.tile(np.eye(4), (4, 1, 1))
    E[:, :3] = ext[:4]
    pred_c2w, gt_c2w = np.linalg.inv(E), np.linalg.inv(gt)
    metrics = {**TT.eval_metrics(pred_c2w, gt_c2w), **TT.pose_auc(pred_c2w, gt_c2w)}
    print("outputs: trajectory of frames 0-3 against the request's GT cameras (seeded "
          "weights: the values mean nothing): "
          + ", ".join(f"{k} {v:.6g}" for k, v in metrics.items()))
    if not all(np.isfinite(v) for v in metrics.values()):
        raise AssertionError("non-finite trajectory metrics")
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/traj.txt"
        TT.save_trajectory_tum_format(pred_c2w, path)
        back, ts = TT.load_trajectory_tum_format(path)
    err = float(np.abs(back - pred_c2w).max())
    print(f"outputs: TUM round trip of the predicted poses: max abs error {err:.3e} (float32 "
          f"quaternions; limit 1e-5)")
    if not err <= 1e-5 or ts.tolist() != [0.0, 1.0, 2.0, 3.0]:
        raise AssertionError("the TUM round trip moved the poses")


def serving_phase(model, cfg, dev, card, FK, CK):
    """The serving path at full width: a bucketed InferenceSession on the
    flagship under the int8 fast modes, the stream flag, the Batcher and
    the HTTP endpoint. Returns the kernels' launches of one S=8 request
    under config (a), with the stream kernel's from config (b)."""
    from omnivggt_tpu_torch import serving as TS
    from omnivggt_tpu_torch.models import dpt_head as TDH
    from omnivggt_tpu_torch.models import omnivggt as TM
    from omnivggt_tpu_torch.ops import attention as TA
    from omnivggt_tpu_torch.ops import layers as TL

    depth, dino = cfg.aggregator.depth, cfg.aggregator.backbone.depth
    cfg_a = dataclasses.replace(cfg, attn_quant="int8", trunk_quant="int8",
                                head_dtype="bfloat16", approx_gelu=True)

    def counts():
        return {**FK.launches(), "conv3x3_folded": CK.conv3x3_folded.launches}

    def reset():
        FK.reset_launches()
        CK.conv3x3_folded.launches = 0
        CK.conv3x3_folded.relayouts = 0

    def expect(int8, stream, conv):
        return {"flash_attention": 0, "flash_attention_packed": depth + dino,
                "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0,
                "flash_attention_int8": int8, "flash_attention_packed_stream": stream,
                "conv3x3_folded": conv}

    def check_output(out, n):
        shapes = {"pose_enc": (n, 9), "depth": (n, IMG, IMG, 1), "depth_conf": (n, IMG, IMG),
                  "world_points": (n, IMG, IMG, 3), "world_points_conf": (n, IMG, IMG)}
        for key, shape in shapes.items():
            if out[key].shape != shape or not np.isfinite(out[key]).all():
                raise AssertionError(f"served {key}: shape {out[key].shape} (want {shape}) or non-finite")

    def gate(label, ref, fast, enforce=True):
        readings = TM._probe_readings(ref, fast)
        print(f"serving gate [{label}]: " + ", ".join(f"{k} {v:.3e}" for k, v in readings.items())
              + f" (limits pose {POSE_TOL:g}, median relative {REL_TOL:g})")
        if enforce and TM._probe_failures(ref, fast, POSE_TOL, REL_TOL):
            raise AssertionError(f"serving gate failed: {label}")

    def same_answer(label, ref, got):
        """A batched or HTTP answer against session.infer's answer to the
        same request: the same forward but for the batch width, so it must
        be the same answer, not merely one inside the serving gate (on
        random weights two different scenes are inside it). On top of that
        gate, the dense outputs' median relative error must stay under
        2^-10, a quarter of a bf16 step of the bf16 heads, so more than
        half of their entries are equal: the other scene's answer is
        outside that. pose_enc keeps the serving gate's limit: it is the
        bf16 camera head's own output, a wider batch may pick another
        cuBLAS kernel and move an entry by a bf16 step (1.6e-2 in [2, 4)),
        and on random weights it does not tell two scenes apart anyway."""
        gate(label, ref, got)
        dense = {k: v for k, v in TM._probe_readings(ref, got).items() if k != "pose_enc_maxabs"}
        print(f"same-answer gate [{label}]: " + ", ".join(f"{k} {v:.3e}" for k, v in dense.items())
              + f" (limit 2^-10 = {2.0**-10:.3e})")
        for key, val in dense.items():
            if not val <= 2.0**-10:
                raise AssertionError(f"{label}: {key} {val:.3e} is not the single request's answer")

    model.config = cfg_a
    TDH._PALLAS_HEAD_CONVS = True
    bucketed = TS.InferenceSession(model, buckets=(4, 8))
    exact = TS.InferenceSession(model, buckets=(4, 8), pad_mode="exact")
    reqs = {3: request_inputs(3, 11, False), 5: request_inputs(5, 12, False),
            8: request_inputs(8, 13, True)}
    print(f"serving config (a): attn_quant={cfg_a.attn_quant} trunk_quant={cfg_a.trunk_quant} "
          f"head_dtype={cfg_a.head_dtype} approx_gelu={cfg_a.approx_gelu}, head-conv kernel on, "
          f"stream off; buckets {bucketed.buckets}")
    bucketed.infer(**reqs[8])  # warm-up

    # the first int8 attention of the padded S=5 run: its q, with the padded
    # frames' rows, for the quantiser's exclusion check below
    captured = []
    quant_per_head = FK.quant_per_head

    def spy(x, valid=None):
        if not captured:
            captured.append((x, valid))
        return quant_per_head(x, valid)

    outs, launches = {}, {}
    for n in (3, 5, 8):
        FK.quant_per_head = spy if n == 5 else quant_per_head
        reset()
        try:
            outs[n] = bucketed.infer(**reqs[n])
        finally:
            FK.quant_per_head = quant_per_head
        launches[n] = counts()
        check_output(outs[n], n)
        print(f"served S={n} through bucket {bucketed._bucket(n)}: launches {launches[n]}, "
              f"conv relayout copies {CK.conv3x3_folded.relayouts}")
        if launches[n] != expect(depth, 0, 2):
            raise AssertionError(f"serving launches {launches[n]}, expected {expect(depth, 0, 2)}")
        # the heads hand the conv kernel channels_last: nothing to copy
        if CK.conv3x3_folded.relayouts != 0:
            raise AssertionError(f"the served request made {CK.conv3x3_folded.relayouts} conv "
                                 f"relayout copies, expected 0")
    print(f"forwards served (bucket, H, W, camera GT, depth GT, masked, batch): "
          f"{sorted(bucketed._served)}")

    x, valid = captured[0]
    rows = int(valid)
    padded_grid = quant_per_head(x, valid)[0][:, :rows]
    alone_grid = quant_per_head(x[:, :rows])[0]
    same = torch.equal(padded_grid, alone_grid)
    print(f"quantiser on the padded S=5 run's first global q {tuple(x.shape)}, valid {rows}: "
          f"max |q| of the real rows {x[:, :rows].abs().max().item():.3f}, of the padded rows "
          f"{x[:, rows:].abs().max().item():.3f}; int8 grid of the real rows equal to "
          f"quantising them alone: {same}")
    if not same:
        raise AssertionError("padded frames move the real frames' int8 grid")
    del captured, padded_grid, alone_grid, x

    out_exact = exact.infer(**reqs[5])
    gate("padded S=5 vs an exact-mode session", out_exact, outs[5])

    # (b) the stream flag
    TA._STREAM_ATTN = True
    try:
        for n in (8, 5):
            reset()
            out_s = bucketed.infer(**reqs[n])
            got = counts()
            check_output(out_s, n)
            print(f"stream flag on, served S={n}: launches {got}")
            if got != expect(0, depth, 2):
                raise AssertionError(f"stream launches {got}, expected {expect(0, depth, 2)}")
            if n == 8:
                stream_launches = got
            gate(f"stream flag on vs off, S={n}", outs[n], out_s, enforce=False)
        stream_ms = statistics.median(timed_requests(bucketed, reqs[8], 3))
    finally:
        TA._STREAM_ATTN = False

    # (c) the Batcher: two concurrent same-key requests, one B=2 forward
    # (two different scenes: each must get its own answer back)
    pair = [reqs[3], request_inputs(3, 21, False)]
    singles = [outs[3], bucketed.infer(**pair[1])]
    batcher = TS.Batcher(bucketed, max_batch=2, window_ms=3000.0)
    results = {}
    threads = [threading.Thread(target=lambda i=i: results.update(
        {i: batcher.submit(timeout=600.0, **pair[i])})) for i in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    batcher.close()
    key = (4, IMG, IMG, False, False, True, 2)
    print(f"batcher: {len(results)} results, forwards at batch 2: {bucketed._served.get(key, 0)}")
    if len(results) != 2 or bucketed._served.get(key, 0) != 1:
        raise AssertionError("the Batcher did not coalesce two requests into one B=2 forward")
    for i, single in enumerate(singles):
        check_output(results[i], 3)
        same_answer(f"batched B=2 vs single, scene {i}", single, results[i])
        # the limit tells scenes apart: the other scene's answer is outside it
        other = TM._probe_readings(singles[1 - i], results[i])
        print(f"  scene {i} against the other scene's single answer: "
              + ", ".join(f"{k} {v:.3e}" for k, v in other.items()))
        if not max(other["depth_medrel"], other["points_medrel"]) > 2.0**-10:
            raise AssertionError("the same-answer limit does not tell two scenes apart")

    # (d) the HTTP endpoint
    with socket.socket() as sock:
        sock.bind(("", 0))
        port = sock.getsockname()[1]
    httpd, _ = TS.serve(bucketed, port=port, background=True)
    try:
        body = io.BytesIO()
        np.savez(body, images=reqs[3]["images"])
        post = urllib.request.Request(f"http://localhost:{port}/infer", data=body.getvalue(),
                                      method="POST")
        with urllib.request.urlopen(post, timeout=600) as resp:
            status, seconds = resp.status, resp.headers["X-Inference-Seconds"]
            got = dict(np.load(io.BytesIO(resp.read())))
        with urllib.request.urlopen(f"http://localhost:{port}/healthz", timeout=60) as resp:
            health = json.loads(resp.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
    check_output(got, 3)
    same_answer("POST /infer vs session.infer, S=3", outs[3], got)
    print(f"http: POST /infer {status} in {seconds} s; GET /healthz {health['status']} "
          f"backend {health['backend']} ready {health['ready']}")
    if status != 200 or health["status"] != "ok":
        raise AssertionError("the HTTP endpoint did not answer")

    # (e) the scene outputs of the S=8 request: /infer_glb, the viewer, the
    # trajectory metrics
    outputs_phase(bucketed, reqs[8], card, reset, counts, expect(depth, 0, 2))

    # request latencies (numpy in, numpy out) and peak memory
    def latency(label):
        torch.cuda.reset_peak_memory_stats()
        times = timed_requests(bucketed, reqs[8], 3)
        ms = statistics.median(times)
        print(f"serving request S=8 {IMG}px [{label}]: {ms:.2f} ms median of {len(times)} "
              f"({', '.join(f'{t:.2f}' for t in times)}), {8 / ms * 1e3:.3f} views/s, peak memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB; card {card}")
        return ms

    a_ms = latency("(a) int8 trunk and scores, bf16 heads, tanh GELU, conv kernel")
    print(f"serving request S=8 {IMG}px [(b) the same with the stream flag on]: {stream_ms:.2f} ms "
          f"median of 3, {8 / stream_ms * 1e3:.3f} views/s; card {card}")
    TDH._PALLAS_HEAD_CONVS = False
    latency("(a) without the conv kernel (library convolution)")
    # W8A8 head convolutions: each the sum over its taps of one int8 product
    model.config = dataclasses.replace(cfg_a, head_quant="int8")
    check_output(bucketed.infer(**reqs[8]), 8)
    latency("(a) + head_quant=int8 (library int8 products per tap)")
    model.config = cfg_a
    TDH._PALLAS_HEAD_CONVS = True

    # the quantisation passes' share: CUDA events around every quantiser call
    spans = []

    def timed(fn):
        def wrapper(*args, **kwargs):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            spans.append((fn.__name__, start, end))
            return out
        return wrapper

    patched = [(FK, "quant_per_head"), (TL, "_quantise_weight"), (TL, "_quantise_rows")]
    originals = [getattr(mod, name) for mod, name in patched]
    for (mod, name), fn in zip(patched, originals):
        setattr(mod, name, timed(fn))
    try:
        bucketed.infer(**reqs[8])
        torch.cuda.synchronize()
    finally:
        for (mod, name), fn in zip(patched, originals):
            setattr(mod, name, fn)
    by_name = defaultdict(float)
    for name, start, end in spans:
        by_name[name] += start.elapsed_time(end)
    total = sum(by_name.values())
    print(f"quantisation passes in one S=8 request under (a): {total:.2f} ms of {a_ms:.2f} "
          f"({total / a_ms * 100:.1f}%): "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in sorted(by_name.items())))

    profile_breakdown("serving request S=8, config (a)", lambda: bucketed.infer(**reqs[8]))

    TDH._PALLAS_HEAD_CONVS = False
    # what a checkpoint load certifies by default (no quantising rung)
    model.config = dataclasses.replace(cfg, head_dtype="bfloat16", approx_gelu=True)
    latency("bf16 heads, tanh GELU, nothing quantised (the default load's top rung)")
    TDH._S2D_HEAD_CONVS = True
    try:
        latency("the same with the space-to-depth head convolutions (OMNIVGGT_S2D_HEAD_CONVS)")
    finally:
        TDH._S2D_HEAD_CONVS = False
    model.config = cfg
    default_ms = latency("default config: bf16 scores, fp32 heads, erf GELU")
    print(f"serving request S=8: (a) {a_ms:.2f} ms, (b) {stream_ms:.2f} ms, default "
          f"{default_ms:.2f} ms")
    launches[8]["flash_attention_packed_stream"] = stream_launches["flash_attention_packed_stream"]
    return launches[8]


def timed_requests(session, req, n):
    session.infer(**req)
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        session.infer(**req)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def ladder_phase(model, cfg):
    """certify_fast_modes on the flagship's seeded weights: every rung's
    readings and the config returned. A finding, whatever wins."""
    from omnivggt_tpu_torch.models import omnivggt as TM

    for hw in (140, 448):
        ref = TM._probe_outputs(model, cfg, hw, 2)
        if not all(np.isfinite(v).all() for v in ref.values()):
            raise AssertionError(f"the ladder's reference forward at {hw} px is not finite")
    report = []
    t0 = time.perf_counter()
    best = TM.certify_fast_modes(model, cfg, report=report)
    print(f"ladder: {len(report)} gates in {time.perf_counter() - t0:.2f} s at probe sizes "
          f"140 and 448 px, S=2, gates pose {POSE_TOL:g} / median relative {REL_TOL:g}")
    for r in report:
        print(f"  rung [{r['stage']} @ {r['hw']} px] head_dtype={r['head_dtype']} "
              f"approx_gelu={r['approx_gelu']} trunk_quant={r['trunk_quant']} "
              f"attn_quant={r['attn_quant']} head_quant={r['head_quant']}: "
              f"pose_enc_maxabs {r['pose_enc_maxabs']:.3e}, depth_medrel {r['depth_medrel']:.3e}, "
              f"points_medrel {r['points_medrel']:.3e}, depth_conf_medrel "
              f"{r['depth_conf_medrel']:.3e} -> {'pass' if r['passed'] else 'refused'}")
    print(f"ladder returns: head_dtype={best.head_dtype} approx_gelu={best.approx_gelu} "
          f"trunk_quant={best.trunk_quant} attn_quant={best.attn_quant} "
          f"head_quant={best.head_quant}")
    cut_report = []
    cut = TM.certify_fast_modes(model, cfg, report=cut_report, quantising_rungs=False)
    print(f"ladder without the quantising rungs (from_safetensors' default), {len(cut_report)} "
          f"gates: " + "; ".join(
              f"[{r['stage']} @ {r['hw']} px] approx_gelu={r['approx_gelu']} pose "
              f"{r['pose_enc_maxabs']:.3e} depth {r['depth_medrel']:.3e} points "
              f"{r['points_medrel']:.3e} conf {r['depth_conf_medrel']:.3e} "
              f"{'pass' if r['passed'] else 'refused'}" for r in cut_report)
          + f" -> head_dtype={cut.head_dtype} approx_gelu={cut.approx_gelu} "
          f"trunk_quant={cut.trunk_quant} attn_quant={cut.attn_quant} head_quant={cut.head_quant}")


def check_ring(RK, FK, dev):
    """The two ring wrappers against ring_attention_plain, the head-major
    kernel, their own slots and planted faults, over logical ranks."""
    from omnivggt_tpu_torch.parallel.mesh import make_mesh

    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    H, D = 16, 64
    hbm, vmem = "ring_flash_attention_hbm", "ring_flash_attention"
    # (wrapper, label, ranks, N, bounded, int8, on the main path)
    cases = [
        (hbm, "S=8 518 px, bounded", 4, S * P_TOKENS, True, False, True),
        (hbm, "S=8 518 px, running-max", 4, S * P_TOKENS, False, False, False),
        (hbm, "S=8 518 px, bounded int8", 4, S * P_TOKENS, True, True, True),
        (hbm, "S=8 518 px, running-max int8", 4, S * P_TOKENS, False, True, False),
        (hbm, "S=8 518 px, 8 ranks, bounded", 8, S * P_TOKENS, True, False, False),
        (vmem, "two chunks a rank, bounded", 4, 16384, True, False, False),
        (vmem, "two chunks a rank, bounded int8", 4, 16384, True, True, False),
        (vmem, "S=4 224 px, bounded", 4, 4 * 261, True, False, True),
        (vmem, "S=4 224 px, bounded int8", 4, 4 * 261, True, True, True),
    ]
    results = {vmem: new_results(), hbm: new_results()}
    inputs, lib = {}, {}
    for name, label, n, N, bounded, int8, on_path in cases:
        if N not in inputs:
            inputs.clear()  # one shape's tensors at a time
            torch.cuda.empty_cache()
            shape = (1, N, H, D)
            # q scaled per head from 2 to 8: a peaked softmax, so the output is
            # of v's size and a shard read twice or left out shows
            scale = torch.linspace(2.0, 8.0, H, device=dev)[None, None, :, None]
            q = (torch.randn(shape, generator=gen, device=dev) * scale).to(torch.bfloat16)
            k, v = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
                    for _ in range(2))
            inputs[N] = (q, k, v)
            lib[N] = sdpa_ms(q, k, v, None)
        q, k, v = inputs[N]
        nl = N // n
        mesh = make_mesh(data=1, seq=n, device=dev)
        wrapper = getattr(RK, name)
        chunk = RK.CHUNK_Q if name == vmem else None

        def run():
            return RK.ring_flash_attention(q, k, v, mesh, "seq", bounded_logits=bounded,
                                           qk_int8=int8)

        RK.reset_launches()
        out = run()
        torch.cuda.synchronize()
        if RK.launches() != {vmem: int(name == vmem), hbm: int(name == hbm)}:
            raise AssertionError(f"ring [{label}]: dispatched to {RK.launches()}, expected {name}")
        # 21 launches in all (the wrapper's, then 20 more on its own): every
        # repeat bitwise equal to the first
        same = True
        for _ in range(20):
            again, slots = RK._ring_launch(wrapper, q, k, v, n, bounded, int8, chunk_q=chunk)
            same = same and torch.equal(out, again)
        bad, _ = RK._ring_launch(wrapper, q, k, v, n, bounded, int8, chunk_q=chunk,
                                 skip_rotation_at=n - 2)
        # the tile's planted faults: the last key tile of every shard left
        # out; K and V of the next head; int8: head 0's v scale for every head
        tile_faults = [
            RK._ring_launch(wrapper, q, k, v, n, bounded, int8, chunk_q=chunk, **hook)[0]
            for hook in (dict(drop_last_key_tile=True), dict(kv_head_shift=1))]
        if int8:
            on_card = RK.quant_ring(q, k, v, n, D**-0.5)
            one_scale = on_card[3].clone()
            one_scale[:, :, 1] = on_card[3][:, :1, 1]  # B = 1: row h is head h
            tile_faults.append(RK._ring_run(*on_card[:3], one_scale, n, bounded, chunk)[0])
        torch.cuda.synchronize()
        if not same:
            raise AssertionError(f"ring [{label}]: 21 runs on the same inputs differ")

        # every rank's last-read slot holds its right neighbour's shard
        held_k, held_v = k, v
        if int8:
            on_cpu = RK.quant_ring(q.cpu(), k.cpu(), v.cpu(), n, D**-0.5)
            if not all(torch.equal(a.cpu(), b) for a, b in zip(on_card, on_cpu)):
                raise AssertionError(f"ring [{label}]: quant_ring gives another grid on the card")
            held_k, held_v = on_card[1], on_card[2]
        last = (n - 1) % 2
        turned = all(
            torch.equal(slots[r][last, kv],
                        x[0, (r + 1) % n * nl:((r + 1) % n + 1) * nl].transpose(0, 1))
            for r in range(n) for kv, x in enumerate((held_k, held_v))
        )
        del slots, again

        f = [x.float() for x in (q, k, v)]
        ref = RK.ring_attention_plain(*f, n, bounded, chunk_q=chunk, qk_int8=int8)
        del f
        # P rounded to bf16 and the output rounded to bf16, each within
        # 2^-8 max|v|; the int8 form shares its plain version's grids
        tol = 2.0**-7 * v.float().abs().max().item()
        err = (out.float() - ref).abs().max().item()
        fault_err = (bad.float() - ref).abs().max().item()
        tile_errs = [(x.float() - ref).abs().max().item() for x in tile_faults]
        line = (f"kernel {name} [{label}] q(1, {N}, {H}, {D}) over {n} ranks, nl {nl}: "
                f"max_abs_err {err:.3e} tol {tol:.3e} (2^-7 max|v|, against "
                f"ring_attention_plain{' on the grids of quant_ring (equal to the CPU grids: True)' if int8 else ''}); "
                f"21 launches bitwise equal: {same}; "
                f"slots rotated (last-read slot == right neighbour's shard, exactly): {turned}; "
                f"planted faults (must exceed tol): last rotation left out {fault_err:.3e}, "
                f"last key tile of every shard left out {tile_errs[0]:.3e}, "
                f"K/V of the next head {tile_errs[1]:.3e}")
        if int8:
            line += f", v scale of head 0 for every head {tile_errs[2]:.3e}"
        sharp_ok = True
        if bounded and not int8:
            head_major = FK.flash_attention(q, k, v, bounded_logits=True).float()
            ratio = ((out.float() - head_major).abs()
                     / RK.reorder_tolerance(head_major, v, N)).max().item()
            sharp_ok = ratio <= 1.0
            line += (f"; against the head-major kernel: worst err/tol {ratio:.3f} "
                     f"(RK.reorder_tolerance: the order of the fp32 sums and one bf16 step)")
            del head_major
        del ref, bad, tile_faults

        ms = median_ms(run, 10)
        plain_ms = median_ms(
            lambda: RK.ring_attention_plain(q, k, v, n, bounded, chunk_q=chunk, qk_int8=int8), 2)
        quant_ms = median_ms(lambda: RK.quant_ring(q, k, v, n, D**-0.5), 5) if int8 else 0.0
        # the launch function alone, on the grids made once (the wrapper adds
        # quant_ring); the events also hold its host set-up before the first
        # launch, which the wrapper's quant_ring hides
        alone_ms = median_ms(lambda: RK._ring_run(*on_card, n, bounded, chunk), 10) if int8 else ms
        products = 2 * H * N * N * D  # one of the two products, over all ranks
        esize = 1 if int8 else 2
        io_bytes = 2 * H * D * 4 * N  # bf16 q, k, v read and o written once
        rotation = 2 * (n - 1) * 2 * H * D * N * esize  # (n-1) x (K + V), read and written
        bnd = (bound(products, io_bytes + rotation, int8_ops=products) if int8
               else bound(2 * products, io_bytes + rotation))
        line += (f" | wrapper {ms:.3f} ms"
                 + (f" of which quant_ring (plain torch ops) {quant_ms:.3f} ms, _ring_run alone "
                    f"on the grids made once {alone_ms:.3f} ms (with its host set-up)"
                    if int8 else "")
                 + f", plain {plain_ms:.3f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}; rotation "
                 f"{rotation / 1e6:.1f} MB of {(io_bytes + rotation) / 1e6:.1f} MB), sdpa over the "
                 f"whole sequence {lib[N]:.3f} ms")
        print(line)
        if not (np.isfinite(err) and err <= tol and sharp_ok):
            raise AssertionError(f"{name} [{label}] disagrees with its plain version")
        if not turned:
            raise AssertionError(f"{name} [{label}]: the slots do not hold the rotated shards")
        if not (fault_err > tol and all(e > tol for e in tile_errs)):
            raise AssertionError(f"{name} [{label}]: a planted fault passes the check")
        r = results[name]
        r["errs"].append(err)
        if on_path:
            r["ms"].append(ms)
            r["plain_ms"].append(plain_ms)
            r["bound"].append(bnd)
            r["library_ms"].append(lib[N])
        del out
    inputs.clear()
    torch.cuda.empty_cache()
    return results


def np_outputs(TM, preds):
    return {k: preds[k].float().cpu().numpy() for k in TM.PROBE_KEYS}


def sharded_phase(model, cfg, inputs, dev, card, FK, RK):
    """The flagship forward sharded over N_RANKS logical ranks under every
    strategy, against the single-device forward; returns the ring wrappers'
    launches on this path."""
    from omnivggt_tpu_torch.models import omnivggt as TM
    from omnivggt_tpu_torch.ops import attention as TA
    from omnivggt_tpu_torch.parallel import attention as PA
    from omnivggt_tpu_torch.parallel.mesh import make_mesh
    from omnivggt_tpu_torch.parallel.sharding import ModelSharding

    n = N_RANKS
    mesh = make_mesh(data=1, seq=n, device=dev)
    depth, dino = cfg.aggregator.depth, cfg.aggregator.backbone.depth
    cfg_q = dataclasses.replace(cfg, attn_quant="int8")
    nl = S * P_TOKENS // n
    print(f"sharded forward: mesh (1 x {n}) of logical ranks on {dev}, S={S} {IMG}px, "
          f"{nl} tokens a rank; fits_hbm_ring {RK.fits_hbm_ring(nl)}")

    def counts():
        return {**FK.launches(), **RK.launches(),
                "unfused_fallbacks": PA.fused_ring_attention.unfused_fallbacks}

    def reset():
        FK.reset_launches()
        RK.reset_launches()
        PA.fused_ring_attention.unfused_fallbacks = 0

    def expect(**kw):
        # frame and DINOv2 attention: the rows strategy, one packed launch
        # per rank's rows
        base = {"flash_attention": 0, "flash_attention_packed": n * (depth + dino),
                "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0,
                "flash_attention_int8": 0, "flash_attention_packed_stream": 0,
                "ring_flash_attention": 0, "ring_flash_attention_hbm": 0,
                "unfused_fallbacks": 0}
        return {**base, **kw}

    def timed(fn):
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    def gate(label, ref, got, same_answer):
        readings = TM._probe_readings(ref, got)
        print(f"sharded gate [{label}] vs the single-device forward: "
              + ", ".join(f"{k} {v:.3e}" for k, v in readings.items())
              + f" (limits pose {POSE_TOL:g}, median relative {REL_TOL:g}"
              + (f"; same answer: dense median relative <= 2^-10 = {2.0**-10:.3e})" if same_answer
                 else ")"))
        if TM._probe_failures(ref, got, POSE_TOL, REL_TOL):
            raise AssertionError(f"sharded forward fails the serving gate: {label}")
        if same_answer and not all(v <= 2.0**-10 for k, v in readings.items()
                                   if k != "pose_enc_maxabs"):
            raise AssertionError(f"sharded forward is not the single-device answer: {label}")

    # the first n K shards on their way to the gather, and what they gather to
    shards = []

    def spy_on(mod, name):
        real = getattr(mod, name)

        def spy(x, *args, **kw):
            out = real(x, *args, **kw)
            if kw.get("amax_reduce") is not None and len(shards) < n:
                shards.append((x, out))
            return out

        setattr(mod, name, spy)
        return real

    path = {}
    with torch.inference_mode():
        refs, single_ms = {}, {}
        for key, config in (("bf16", cfg), ("int8", cfg_q)):
            model.config = config
            refs[key] = np_outputs(TM, model(**inputs))
            single_ms[key] = timed(lambda: model(**inputs))
        # (label, strategy, config key, stream flag, expected launches)
        cases = [
            ("ring_fused", "ring_fused", "bf16", False, expect(ring_flash_attention_hbm=depth)),
            ("ring", "ring", "bf16", False, expect()),
            ("allgather", "allgather", "bf16", False, expect(flash_attention=n * depth)),
            ("ring_fused int8", "ring_fused", "int8", False,
             expect(ring_flash_attention_hbm=depth)),
            ("allgather int8", "allgather", "int8", False,
             expect(flash_attention_int8=n * depth)),
            ("allgather int8, stream flag on", "allgather", "int8", True,
             expect(flash_attention_packed_stream=n * depth)),
        ]
        for label, strategy, key, stream, want in cases:
            sharding = ModelSharding(mesh, strategy)
            model.config = cfg_q if key == "int8" else cfg
            TA._STREAM_ATTN = stream
            quantiser = "quant_k_token_major" if stream else "quant_per_head"
            real = spy_on(FK, quantiser) if strategy == "allgather" and key == "int8" else None
            try:
                model(**inputs, sharding=sharding)  # warm-up
                shards.clear()
                reset()
                preds = model(**inputs, sharding=sharding)
                torch.cuda.synchronize()
                got = counts()
                ms = timed(lambda: model(**inputs, sharding=sharding))
            finally:
                TA._STREAM_ATTN = False
                model.config = cfg
                if real is not None:
                    setattr(FK, quantiser, real)
            print(f"sharded forward [{label}]: launches {got}")
            if got != want:
                raise AssertionError(f"sharded launches [{label}] {got}, expected {want}")
            if real is not None:
                whole = real(torch.cat([x for x, _ in shards], dim=1))
                same = (len(shards) == n
                        and torch.equal(torch.cat([o[0] for _, o in shards], dim=1), whole[0])
                        and all(torch.equal(o[1], whole[1]) for _, o in shards))
                print(f"  pre-gathered K [{label}]: the {n} shards' int8 values, gathered, and "
                      f"their scales equal {quantiser} of the whole K: {same}")
                if not same:
                    raise AssertionError(f"the pre-gathered int8 K is on another grid: {label}")
                shards.clear()
            out = np_outputs(TM, preds)
            del preds
            for name, shape in (("pose_enc", (1, S, 9)), ("depth", (1, S, IMG, IMG, 1))):
                if out[name].shape != shape or not np.isfinite(out[name]).all():
                    raise AssertionError(f"sharded {name} [{label}] malformed or non-finite")
            # int8: each rank's q scales are its own, so the sharded answer is
            # the single-device one only up to the int8 noise the gate allows
            gate(label, refs[key], out, same_answer=key == "bf16")
            if key == "int8":
                readings = TM._probe_readings(refs["bf16"], out)
                print("  against the bf16 single-device forward (reported): "
                      + ", ".join(f"{k} {v:.3e}" for k, v in readings.items()))
            print(f"sharded forward S={S} {IMG}px [{label}]: {ms:.2f} ms median of 3 beside the "
                  f"single-device forward's {single_ms[key]:.2f} ms in this run; card {card}")
            if label == "ring_fused":
                path["ring_flash_attention_hbm"] = got["ring_flash_attention_hbm"]

        fused = ModelSharding(mesh, "ring_fused")
        profile_breakdown(f"sharded forward S={S}, ring_fused, {n} logical ranks",
                          lambda: model(**inputs, sharding=fused))

        # S=4 at 224 px: 261 tokens a frame and a rank, within one block, so
        # the shards meet ring_flash_attention's own contract
        gen = torch.Generator(device=dev)
        gen.manual_seed(7)
        small = torch.rand((4, 224, 224, 3), generator=gen, device=dev)
        ref = np_outputs(TM, model(small))
        sharding = ModelSharding(mesh, "ring_fused")
        model(small, sharding=sharding)
        reset()
        preds = model(small, sharding=sharding)
        torch.cuda.synchronize()
        got = counts()
        print(f"sharded forward [ring_fused, S=4 224 px, 261 tokens a rank]: launches {got}")
        # 261 tokens a frame are below the attention dispatch's kernel
        # length (FLASH_MIN_SEQ), so frame and DINOv2 attention run plain
        # on every rank; the ring strategy streams whatever the length
        want = expect(flash_attention_packed=0, ring_flash_attention=depth)
        if got != want:
            raise AssertionError(f"sharded launches [S=4 224 px] {got}, expected {want}")
        gate("ring_fused, S=4 224 px", ref, np_outputs(TM, preds), same_answer=True)
        path["ring_flash_attention"] = got["ring_flash_attention"]
    return path


def sharded_serving_phase(model, dev, card):
    """A bucketed session under the allgather strategy; the ring strategies'
    refusal of bucket mode and their exact-mode service."""
    from omnivggt_tpu_torch import serving as TS
    from omnivggt_tpu_torch.models import omnivggt as TM
    from omnivggt_tpu_torch.parallel.mesh import make_mesh
    from omnivggt_tpu_torch.parallel.sharding import ModelSharding

    mesh = make_mesh(data=1, seq=N_RANKS, device=dev)
    reqs = {5: request_inputs(5, 31, False), 8: request_inputs(8, 32, True)}
    bucketed = TS.InferenceSession(model, buckets=(4, 8), sharding=ModelSharding(mesh, "allgather"))
    exact = TS.InferenceSession(model, buckets=(4, 8), pad_mode="exact")

    def gate(label, ref, got):
        readings = TM._probe_readings(ref, got)
        print(f"sharded serving gate [{label}]: "
              + ", ".join(f"{k} {v:.3e}" for k, v in readings.items())
              + f" (limits pose {POSE_TOL:g}, median relative {REL_TOL:g})")
        if TM._probe_failures(ref, got, POSE_TOL, REL_TOL):
            raise AssertionError(f"sharded serving gate failed: {label}")

    for n in (5, 8):
        out = bucketed.infer(**reqs[n])
        if out["depth"].shape != (n, IMG, IMG, 1) or not all(
                np.isfinite(out[k]).all() for k in TM.PROBE_KEYS):
            raise AssertionError(f"sharded session: S={n} answer malformed or non-finite")
        gate(f"allgather, buckets (4, 8), S={n} vs an unsharded exact-mode session",
             exact.infer(**reqs[n]), out)
    ms = statistics.median(timed_requests(bucketed, reqs[8], 3))
    print(f"sharded serving request S=8 {IMG}px [allgather, {N_RANKS} logical ranks]: {ms:.2f} ms "
          f"median of 3; forwards served {sorted(bucketed._served)}; card {card}")
    ring = ModelSharding(mesh, "ring_fused")
    try:
        TS.InferenceSession(model, buckets=(4, 8), sharding=ring)
    except ValueError as e:
        print(f"sharded serving: bucket mode under ring_fused refused: {e}")
    else:
        raise AssertionError("a bucketed session under ring_fused was not refused")
    ring_session = TS.InferenceSession(model, sharding=ring, pad_mode="exact")
    gate("ring_fused, exact mode, S=8", exact.infer(**reqs[8]), ring_session.infer(**reqs[8]))


def synthetic_inputs(dev):
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    images = torch.rand((S, IMG, IMG, 3), generator=gen, device=dev)
    n_cam = 4
    extr = torch.zeros((1, S, 3, 4), device=dev)
    extr[..., :3, :3] = torch.eye(3, device=dev)
    extr[..., :3, 3] = torch.randn((1, S, 3), generator=gen, device=dev)
    intr = torch.zeros((1, S, 3, 3), device=dev)
    intr[..., 0, 0] = intr[..., 1, 1] = 500.0
    intr[..., 0, 2] = intr[..., 1, 2] = IMG / 2
    intr[..., 2, 2] = 1.0
    depth = 1.0 + 4.0 * torch.rand((1, S, IMG, IMG, 1), generator=gen, device=dev)
    mask = torch.ones((1, S, IMG, IMG), device=dev)
    return dict(
        images=images, extrinsics=extr, intrinsics=intr, depth=depth, mask=mask,
        camera_gt_index=list(range(n_cam)), depth_gt_index=[0, 1],
    )


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs the port on the GPU only", file=sys.stderr)
        return 1
    print(card := card_line())
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} numpy {np.__version__}; "
          f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")

    from omnivggt_tpu_torch.checkpoint import cast_trunk_params
    from omnivggt_tpu_torch.config import OmniVGGTConfig
    from omnivggt_tpu_torch.models.omnivggt import OmniVGGT
    from omnivggt_tpu_torch.ops.kernels import build
    from omnivggt_tpu_torch.ops.kernels import conv3x3 as CK
    from omnivggt_tpu_torch.ops.kernels import flash_attention as FK
    from omnivggt_tpu_torch.ops.kernels import ring_attention as RK
    from omnivggt_tpu_torch.tools import probe_layouts as PL
    from omnivggt_tpu_torch.utils.geometry import (
        pose_encoding_to_extri_intri,
        unproject_depth_map_to_point_map,
    )

    t0 = time.perf_counter()
    logs = build.build_all(FK.SOURCES + (CK.SOURCE, PL.SOURCE, RK.SOURCE))  # every nvcc at once
    FK.load_kernels()
    CK.load_kernels()
    RK.load_kernels()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc sm_90a, one process per source: "
          f"{', '.join(sorted(set(SOURCES.values())))})")
    for log in logs.values():
        for line in log.splitlines():  # ptxas: registers and shared memory per kernel
            if "Compiling entry" in line or "Used" in line:
                print("  " + line.strip()[:160])
    forms = (("bf16", FK.SCORES_BF16), ("int8 q and k", FK.SCORES_INT8),
             ("int8 k, q quantised in the kernel", FK.SCORES_INT8_Q_IN))
    for d in FK.HEAD_DIMS:
        for form, qk in forms:
            threads, smem = FK.tma_launch_shape(d, qk)
            if smem:
                print(f"  forward kernel (flash_fwd_*_tma), {form}, head dim {d}: {threads} "
                      f"threads, {smem} bytes of dynamic shared memory a block")
    print("  ptxas' register count above is the launch's; setmaxnreg then gives the producer "
          "warpgroup 24 and the two consumer warpgroups 240 (the int8 ring: 40 for the "
          "producer and its V converters, 232)")
    backward_build_report(FK, logs[FK.SOURCES[1]])
    ring_build_report(RK, logs[RK.SOURCE])
    conv_build_report(CK, logs[CK.SOURCE], logs[PL.SOURCE])

    kernel_results = check_kernels(FK, dev)
    check_tma_forms(FK, dev)
    kernel_results.update(check_backward(FK, dev))
    kernel_results.update(check_serving_attention(FK, dev))
    kernel_results.update(check_ring(RK, FK, dev))
    kernel_results.update(check_conv(CK, dev))
    probe_results, probe_launches = probes_phase()
    kernel_results.update(probe_results)

    cfg = OmniVGGTConfig()
    t0 = time.perf_counter()
    model = OmniVGGT(cfg, device=dev, seed=0)
    # The reference init draws the camera token at 1e-6 scale. After 24
    # LayerScale-0.01 layers of random weights it then has std 0.02, and the
    # camera head's LayerNorm scales the bf16 noise of the O(1) patch tokens
    # up with it: on the plain path alone a 1e-3 image perturbation moves
    # pose_enc by 2.7e-2, beyond the gate. Drawn at unit scale it moves
    # pose_enc by 1.5e-3, so the gate below measures the kernels and not
    # the conditioning of an untrained camera token.
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    with torch.no_grad():
        model.aggregator.camera_token.normal_(generator=gen)
    model = cast_trunk_params(model).eval()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: {n_params / 1e9:.3f}B parameters, built in {time.perf_counter() - t0:.2f} s")
    inputs = synthetic_inputs(dev)

    with torch.inference_mode():
        model(**inputs)  # warm-up (cuBLAS/cuDNN plans)
        torch.cuda.synchronize()
        FK.reset_launches()
        preds = model(**inputs)
        extrinsic, intrinsic = pose_encoding_to_extri_intri(preds["pose_enc"], (IMG, IMG))
        torch.cuda.synchronize()
        launches = FK.launches()
        points = unproject_depth_map_to_point_map(preds["depth"][0], extrinsic[0], intrinsic[0])
        print(f"main path launches per forward: {launches}")
        expect = {"flash_attention": cfg.aggregator.depth,
                  "flash_attention_packed": cfg.aggregator.depth + cfg.aggregator.backbone.depth,
                  "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0,
                  "flash_attention_int8": 0, "flash_attention_packed_stream": 0}
        if launches != expect:
            raise AssertionError(f"kernel launches {launches}, expected {expect}")

        shapes = {
            "pose_enc": (1, S, 9), "depth": (1, S, IMG, IMG, 1), "depth_conf": (1, S, IMG, IMG),
            "world_points": (1, S, IMG, IMG, 3), "world_points_conf": (1, S, IMG, IMG),
        }
        for key, shape in shapes.items():
            t = preds[key]
            if tuple(t.shape) != shape or not torch.isfinite(t).all():
                raise AssertionError(f"{key}: shape {tuple(t.shape)} (want {shape}) or non-finite")
        if points.shape != (S, IMG, IMG, 3) or not np.isfinite(points).all():
            raise AssertionError("depth unprojection is malformed")

        def forward():
            model(**inputs)

        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            forward()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        fwd_ms = statistics.median(times)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        profile_breakdown(f"forward S={S}", forward)

        ref = model(**inputs, attn_impl="plain")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model(**inputs, attn_impl="plain")
        torch.cuda.synchronize()
        plain_fwd_ms = (time.perf_counter() - t0) * 1e3

    # the JAX package's serving gate, as the port's ladder applies it
    from omnivggt_tpu_torch.models import omnivggt as TM

    ref_np, fast_np = ({k: out[k].float().cpu().numpy() for k in TM.PROBE_KEYS}
                       for out in (ref, preds))
    for key, val in TM._probe_readings(ref_np, fast_np).items():
        tol = POSE_TOL if key == "pose_enc_maxabs" else REL_TOL
        print(f"gate kernel path vs plain path: {key} {val:.3e} (limit {tol:g})")
    failed = TM._probe_failures(ref_np, fast_np, POSE_TOL, REL_TOL)
    if failed:
        raise AssertionError(f"kernel path fails the serving gate: {failed}")
    del ref_np, fast_np

    print(
        f"flagship forward S={S} {IMG}px: {fwd_ms:.2f} ms median of {len(times)} "
        f"({S / fwd_ms * 1e3:.3f} views/s), plain-attention forward {plain_fwd_ms:.2f} ms, "
        f"peak memory {peak_gb:.3f} GB; card {card}"
    )
    del preds, ref
    torch.cuda.empty_cache()
    ring_launches = sharded_phase(model, cfg, inputs, dev, card, FK, RK)
    sharded_serving_phase(model, dev, card)
    del inputs
    torch.cuda.empty_cache()
    serving_launches = serving_phase(model, cfg, dev, card, FK, CK)
    ladder_phase(model, cfg)
    del model
    torch.cuda.empty_cache()
    train_launches = train_phase(FK, cfg, dev, card)
    # a kernel's launches on the main path that runs it: one train step, or
    # one served S=8 request for the serving kernels; the probes' in their phase
    # the ring wrappers' in the sharded flagship forwards
    path_launches = {**serving_launches, **ring_launches, "layout_probes": probe_launches}
    path_launches.update({k: n for k, n in train_launches.items() if n})

    # per kernel: the largest error over its checked variants; the mean
    # time, bound and library time over the variants the flagship runs
    summary = {"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": path_launches[name],
            "max_abs_err": max(r["errs"]),
            "ms": statistics.mean(r["ms"]),
            "plain_ms": statistics.mean(r["plain_ms"]),
            "bound_ms": statistics.mean(b for b, _ in r["bound"]),
            "bound_by": r["bound"][0][1],
            "library_ms": statistics.mean(r["library_ms"]) if r["library_ms"] else None,
        }
        for name, r in kernel_results.items()
    ]}
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
