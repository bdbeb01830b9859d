"""Chip smoke test of the PyTorch port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):
  1. card: prints the card's name and power limit; there must be a CUDA
     device (there is no CPU path here);
  2. build: compiles the Hopper kernels from csrc/ with nvcc; prints each
     kernel's registers and shared memory from ptxas' report, and fails if
     a backward kernel (dq, dk/dv, D 64 and 128) or a ring kernel
     (ring_step_tma bf16 and int8, ring_stage) or a conv kernel
     (conv3x3_bf16_tma, conv3x3_fp32_tma, conv_tf32x3 at N 16, 32, 64,
     128, split_weights) spills a register, if ptxas injects a fence
     between the tf32 kernel's products (C7519), or if the ring step's or a
     conv kernel's launch shape differs from RK.ring_launch_shape's,
     CK.conv_launch_shape's or CT.launch_shape's;
  3. kernels: each kernel against its plain PyTorch version at the shapes
     the flagship's 518 px, 8-view forward gives it, bf16 inputs, the plain
     version in fp32 from the same inputs; prints errors beside the stated
     tolerance and the median times of both (CUDA events); then the bf16
     forward kernel (TMA + wgmma) in each form the main path and training
     run, and at head dim 128: 21 launches on the same inputs bitwise
     equal (o and LSE), and two planted faults that must leave the
     tolerance (the last key tile left out; K and V of the next head,
     through the kernel's test hook); then the fp32 head convolutions'
     tensor-core kernel (conv2d_tf32x3) at the shapes the flagship's S=8
     heads give it (check_conv_tf32x3): against its plain version within
     the fp32 convolution tolerance, its median relative error against a
     float64 reference at most twice the plain version's (cuDNN fp32), a
     planted fault a shape that must fail, one launch and no copy a call;
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
     ("auto") and with attn_impl="plain" and every head convolution on the
     library; checks shapes, finiteness, the kernels' launch counts per
     forward (56 conv_tf32x3, 28 of each head's 32 convolutions), the
     pose decoding and depth unprojection, and the kernel path against the
     plain path under the serving gate (pose_enc max-abs and median
     relative errors <= 2e-2);
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
     int8), and 8-rank cases (bf16 and int8); each against ring_attention_plain within
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
 13. (f) fine-tuning from shards, after 6: four samples in SceneDataset
     layout made with numpy from a seed (S=4, 518 px, GT as in 6) written
     by write_shards into two tar shards and read back through
     ShardedSampleStream bytes-equal as a set; the training CLI
     (omnivggt_tpu_torch.tools.train.main, on the card by default) streaming
     them with --batch 2 on OmniVGGTConfig() for 4 steps: every logged
     loss finite, grad_norm > 0, the exact kernel launches (4 steps of 6's
     counts: the batch is a grid axis), the step time, peak memory and the
     final checkpoint's size and save time; the train gate of 6 at B=2 on a
     batch from the stream, which two planted faults must break (the last
     key tile skipped in every backward; delta = 0 only on the rows of the
     batch's second sample); remat="dots" against remat=True at B=1 S=4 on
     6's batch (learning rate 0, so both run on the same weights): step
     medians, peak memory, equal launches, one profiled step each, loss and
     trunk gradients bitwise equal or within the train gate; the photometric augmentation on a CUDA
     view against its CPU copy (parameters drawn on the CPU from generators
     seeded alike) within 1e-6, and its time.
 14. (g) checkpoints and the library surface, after 5 (before 11), with the
     safetensors and huggingface_hub packages made unimportable: the
     fp32 flagship (camera token as in 5) through save_pretrained and
     from_pretrained ("keep" and "float32"), every state dict bitwise
     equal, file size and times; both trunks cast and the S=8 forward of
     the loaded model bitwise equal to the original's (else the worst
     difference under the same-answer gate), 24 + 48 launches; the
     reference layout: write_safetensors, from_safetensors and
     tools/convert_checkpoint -> from_pretrained bitwise, and two planted
     faults that must raise (a tensor dropped: strict load; the file cut by
     1 MB); TF32 switches at torch's defaults for one step: the forward
     still bitwise equal (its exact_fp32 guard), the inference CLI on cuda
     leaving both switches off, and the guard bypassed as a planted fault
     that must differ (the TF32 heads' deltas, printed); guard_predictions
     clean, then a NaN in a depth-head weight reported under depth;
     enable_nan_debugging stopping at frame block 3 with a NaN planted
     there, its hook removed after; tools/profile_forward at S=8 (family
     table, trace with CUDA kernel events) and flops_estimate over 5's
     median forward in TFLOP/s; the vit_large DINOv2 alone on the 8 frames,
     in its GELU form (the flagship's) and with fused SwiGLU blocks
     (hidden 2736): 24 packed launches, the kernel path against the plain
     path (median relative error of the tokens) within sqrt(2) x what one
     bf16 step of noise at every attention output moves the plain path
     by, at most 2e-2; the kernel's output rounded to 5 mantissa bits and
     K/V of the next head, planted, must leave it; times.
 15. (h) multi-device training, after (f): the flagship (fp32 master
     weights, camera token as in 5) at B=2, S=4, 518 px, use_aux_inputs,
     remat, on make_mesh(data=2, seq=2) logical ranks under "allgather":
     one step's loss and trunk gradients against the one-device step's on
     the same weights (the train gate); then 3 steps (layer-decay AdamW,
     learning rate 1e-4 after one warm-up step) from the same init on one
     device and on the mesh under state_sharding "none", "zero2" and
     "fsdp": every mode's losses and grad_norm within the train gate's
     1e-2 of the one-device step's; every mode's parameters after the
     first update against one device's and mesh none's: at most 1% of the
     elements outside rtol 1e-4 / atol 1e-6 (tests/test_fsdp.py's) and an
     update gap ||got - ref|| / ||ref - init|| <= 0.1, and after the last
     step the same gap with at most 20% of the elements outside (a
     planted fault, zero2 shards stepping on the next shard's moments,
     must fail both times); kernels 1-4's launches a step equal
     across the modes, the median step, peak memory, and the state bytes a rank holds
     equal to fsdp.state_bytes_per_device; tools/dryrun_multichip --ranks 4
     on the card (parts (a), (b), (c); (d) on the CPU); the training CLI under torchrun
     --nproc_per_node 1 (--tiny, --mesh 1,2, --state_sharding zero2, two
     synthetic shards, 2 steps: exit 0, metrics.jsonl and one checkpoint);
     an NCCL process group of world size 1 in this process
     (multihost_initialize on a local port): one zero2 step and one fsdp
     step of the tiny config widened to head dim 64 at 224 px on a (1, 2)
     mesh whose data axis is the group, every torch.distributed call on
     CUDA tensors, against the same steps on logical ranks: bitwise, or (if
     the card's kernels are not bitwise run to run) within 4x the spread of
     the logical step run twice (both modes), the metrics within 1e-5.
 16. (i) the seq axis over processes, after (h): SEQ_PROCS = 4 processes
     spawned on this card (the kernels built here first), a gloo group of
     4 and make_mesh(data=1, seq=4), one seq rank each, their data through
     CUDA IPC (parallel/peer.py): an IPC probe (each writes a pattern into
     its symmetric buffer and reads every peer's back, then writes into its
     right neighbour's and reads what its left one wrote); kernels 5 and 6
     in the process form at the main path's shapes ((1, 10992, 16, 64), nl
     2748, through ring_flash_attention_hbm and (1, 1044, 16, 64), nl 261,
     through ring_flash_attention; bounded bf16 and int8): the gathered
     output bitwise equal to the logical form's computed here (else, bf16
     only, within RK.reorder_tolerance), within 2^-7 max|v| of
     ring_attention_plain, repeats bitwise, and a skipped rotation in rank
     0 alone must leave the tolerance; medians of CUDA events per process;
     the flagship at S=8 (phase 5's model and images, camera GT on frames
     2, 3, 5, 6 so the first lies in rank 1, depth on 1, 2, 6) under
     allgather, ring_fused and ring_fused int8: every process's whole
     prediction against the logical-rank forward of the same strategy
     (same-answer gate 2^-10 and the serving gate), 24 head-major or
     hbm-ring and 48 packed launches a process; one bucketed session
     request (3 frames in bucket 4, allgather) against the logical-rank
     session's. Time-sliced processes on one card measure correctness,
     not scaling.
 17. (j) training with the seq axis over processes, after (i): the
     reference here, the flagship (fp32 masters, camera token as in 5) at
     B=1, S=4, 518 px, use_aux_inputs, "allgather", remat, layer-decay
     AdamW (learning rate 1e-4 after one warm-up step), 3 steps on
     make_mesh(data=1, seq=2) logical ranks under two GT layouts (cameras
     on frames 1-3, the first valid one in rank 0's frames; on frames 2-3,
     in rank 1's; depth on frames 0 and 3): metrics, the trunk's gradients
     at the init and the parameters after the first update and the last
     step, written to files; the card freed. Then 2 processes spawned on
     the card (gloo + CUDA IPC, one seq rank of make_mesh(data=1, seq=2)
     each) take the same steps: every process's metrics bitwise equal to
     the other's and its parameters too after every step (a checksum of
     their bits taken on the card); the first step's loss within 1e-2 and
     the trunk gradients' cosine >= 1 - 1e-5 of the reference's (the
     train gate); the parameters against the reference under phase (h)'s
     fixed gates (after the first update <= 1% outside, gap <= 0.1; after
     the last <= 20%, gap <= 0.1); kernels 1-4's launches a step equal to
     the one-device step's (train_step_launches) and the collectives a
     step as derived (seq_step_collectives); two planted faults (the
     gather's backward keeping this process's own gradient, the gradients
     left unsummed over the seq group) must fail the gradient gate. Step
     ms, peak memory and the gradient sum's ms a process; read beside the
     gate, the camera loss's L1 residuals at the init (the processes'
     against the reference's) and the trunk leaves that hold most of the
     gradients' difference. Time-sliced processes on one card measure
     correctness, not scaling.
 18. (k) zero2 and fsdp with the seq axis over processes, after (j): the
     reference here, the flagship at B=1, S=8, 518 px as in 17 on 4
     logical seq ranks at state none (one GT layout: cameras on frames 1,
     2, 5, 6, depth on 0, 3, 4, 7), then 4 processes spawned on the card,
     one seq rank and one chunk of the state each, 3 steps under zero2 and
     then fsdp from the same init: each process's state bytes equal to
     fsdp.state_bytes_per_device, metrics and whole-parameter checksums
     equal across the processes after every step, the step-1 loss within
     1e-2, the trunk-gradient gate at K_GRAD_LIMIT (derived beside it for
     4 bf16-rounded partials), phase (h)'s fixed parameter gates, launches,
     collectives and barriers a step as derived in advance; two planted
     faults (the seq part of the reduce-scatter left out, the own chunk
     taken at the next index) must fail the gradient gate. Step ms, peak
     memory a process and on the card, peer-buffer bytes and barriers a
     step, per mode.
Bounds (bound_ms) are the larger of the bytes each kernel must move over
3.35 TB/s and its matrix-product operations over the H100 SXM's published
peak for their type: 989 TFLOP/s bf16 dense, 1,979 TOP/s int8, 67 TFLOP/s
fp32 outside the tensor cores. The line before the last is the kernels' JSON
summary; the last line is {"ok": true, "device": {...}}.

Matmul precision: the heads run fp32, and both TF32 switches are off
(torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 =
False), so fp32 convolutions and matmuls keep full fp32 as in the JAX
package's reference-parity heads; the forward keeps them off itself
(utils/platform.exact_fp32), which phase (g) checks under torch's defaults.
The profiler's kernel families and profile_breakdown are
omnivggt_tpu_torch/utils/profiling.py's.
"""

from __future__ import annotations

import dataclasses
import gc
import io
import json
import os
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
# script); at B=2 (phase (f)) 1.9e-6 sound, 1.8e-5 with the last key tile
# skipped and 3.4e-4 with delta = 0 on the second sample's rows: the limit
# 1e-5 sits between the sound readings and the faults. The last key tile
# skipped in the second sample alone read 6.6e-6, inside it: the gate is
# coarse, and check_backward holds the kernels entry by entry at the B=2
# shapes with that fault planted
LOSS_REL_TOL, GRAD_COS_MIN = 1e-2, 1 - 1e-5
PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12  # H100 SXM: bf16 dense, HBM
PEAK_INT8, PEAK_FP32 = 1979e12, 67e12  # int8 dense; fp32 outside the tensor cores
PEAK_TF32X3 = 495e12 / 3  # fp32-accurate products as three TF32 ones (dense TF32 495)
P_TOKENS = 1374  # tokens per frame at 518 px: 37 * 37 patches + 5 special tokens
REPLACES = {
    "flash_attention": "omnivggt_tpu/ops/pallas/flash_attention.py:60",
    "flash_attention_packed": "omnivggt_tpu/ops/pallas/flash_attention.py:764",
    "flash_attention_bwd_dq": "omnivggt_tpu/ops/pallas/flash_attention.py:461",
    "flash_attention_bwd_dkv": "omnivggt_tpu/ops/pallas/flash_attention.py:493",
    "flash_attention_int8": "omnivggt_tpu/ops/pallas/flash_attention.py:60",
    "flash_attention_packed_stream": "omnivggt_tpu/ops/pallas/flash_attention.py:1034",
    "conv3x3_folded": "omnivggt_tpu/ops/pallas/conv3x3.py:99",
    "conv_tf32x3": "none: XLA's fp32 convolutions of omnivggt_tpu/models/dpt_head.py",
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
    "conv_tf32x3": "omnivggt_tpu_torch/csrc/conv_tf32x3.cu",
    "layout_probes": "omnivggt_tpu_torch/csrc/layout_probes.cu",
    "ring_flash_attention": "omnivggt_tpu_torch/csrc/ring_attention.cu",
    "ring_flash_attention_hbm": "omnivggt_tpu_torch/csrc/ring_attention.cu",
}
N_RANKS = 4  # logical ranks of the sharded phases
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


def profile_breakdown(label, run):
    """utils.profiling.profile_breakdown, imported at the call: this script
    runs alone (without the package) far enough to refuse a machine
    without CUDA."""
    from omnivggt_tpu_torch.utils import profiling

    profiling.profile_breakdown(label, run)


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


def tf32x3_build_report(CT, log):
    """The fp32 head convolutions' tensor-core kernel (csrc/conv_tf32x3.cu):
    registers and spills of conv_tf32x3 at N 16, 32, 64 and 128 and of the
    weight split, from ptxas' report; a spill, a fence ptxas injects
    between the products (C7519: it would drain the tensor pipe before
    each), or a launch shape the built library reports that differs from
    CT.launch_shape's (the heads' widths and the card tests') fails the
    run."""
    for cout in (16, 32, 48, 128, 256, 512, 1024):
        built, shape = CT.built_launch_shape(cout), CT.launch_shape(cout)
        if built != shape:
            raise AssertionError(f"CT.launch_shape({cout}) {shape} is not the source's {built}")
    for cout in (256, 32):
        geo = CT._geometry(cout)
        print(f"  conv_tf32x3 at cout {cout}: N {geo['n']}, {geo['stages']} stages, "
              f"{geo['threads']} threads, {geo['smem']} bytes of dynamic shared memory")
    if not log:
        print("  conv_tf32x3: library built before this run, no ptxas report")
        return
    convs = ptxas_entries(log, r"(conv_tf32x3)ILi(\d+)ELi0E()")  # the forms real calls run
    split = ptxas_entries(log, r"(split_weights)()()")
    for (kernel, n, _), e in sorted({**convs, **split}.items()):
        regs = " (setmaxnreg: 40 producer, 232 consumers)" if n else ""
        print(f"  {kernel}{f' N={n}' if n else ''}: {e.get('registers')} registers at launch"
              f"{regs}, spill stores/loads {e.get('spills')} bytes")
    entries = {**convs, **split}
    spills = any(e.get("spills") != [0, 0] for e in entries.values())
    if (len(convs), len(split)) != (4, 1) or spills:
        raise AssertionError(f"a conv_tf32x3 kernel spills or is missing from ptxas' report: "
                             f"{entries}")
    if "C7519" in log:
        raise AssertionError("ptxas injected fences between conv_tf32x3's products (C7519)")


def check_kernels(FK, dev):
    """Each kernel vs its plain version at the main path's shapes."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    # (kernel, label, q shape, kv_valid, bounded): the flagship runs the
    # bounded head-major variant (global attention, qk-norm), the bounded
    # packed variant (frame attention) and the masked running-max packed
    # variant (DINOv2, valid prefix 1374 of 1376); the head-major
    # running-max variant serves weights that fail the logit bound; global
    # attention of a B=2 S=4 train step (phase (f)) is the head-major grid's
    # batch axis at 2 (its frame and DINOv2 shapes are the 8 frames above)
    cases = [
        ("flash_attention", "global bounded", (1, S * 1374, 16, 64), None, True),
        ("flash_attention", "global running-max", (1, S * 1374, 16, 64), None, False),
        ("flash_attention", "global bounded B=2", (2, S_TRAIN * 1374, 16, 64), None, True),
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
        ("global bounded B=2", (2, S_TRAIN * P_TOKENS, 16, 64), None, True, False),
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
MUST_FAIL = {"delta=0": (1, 2), "last key tile skipped": (0, 1, 2, 3),
             "last key tile skipped in sample 1": (0, 1, 2, 3)}


def backward_faults(FK, q, k, v, o, do, lse, kv, bounded, ref, tols, lse_ref, lse_tol,
                    two_samples):
    """Plants faults in the kernels' inputs: delta = 0 (o zeroed for the dq
    kernel, a zero delta for dk/dv) and the last key tile skipped (kv_valid
    cut to a multiple of 64, for the forward's LSE and the backward); with
    two_samples (a B=2 step's batch axis, sample-major: sample 1 is its
    second half) also the last key tile skipped in sample 1's rows alone,
    sample 0's from the sound launches. Returns {fault: [largest err/tol of
    LSE, dq, dk, dv]}."""
    n = k.shape[1] if kv is None else int(kv)
    cut = (n - 1) // 64 * 64
    packed = q.shape[1] <= FK.PACKED_MAX_KEYS
    zero_o = torch.zeros_like(o)
    dq0, _ = FK.flash_attention_bwd_dq(q, k, v, zero_o, do, lse, kv, bounded)
    dk0, dv0 = FK.flash_attention_bwd_dkv(q, k, v, do, lse, torch.zeros_like(lse), kv, bounded)
    _, lse_cut = FK._launch(q, k, v, cut, bounded, packed=packed, with_lse=True)
    dq1, dk1, dv1 = FK.flash_attention_backward(q, k, v, o, do, lse, cut, bounded)
    torch.cuda.synchronize()
    faults = {
        "delta=0": [float("nan")] + [r[1] for r in ratios((dq0, dk0, dv0), ref, tols)],
        "last key tile skipped": [((lse_cut - lse_ref).abs() / lse_tol).max().item()]
        + [r[1] for r in ratios((dq1, dk1, dv1), ref, tols)],
    }
    if two_samples:
        h = q.shape[0] // 2
        one = (q[h:], k[h:], v[h:])
        _, lse_h = FK._launch(*one, cut, bounded, packed=packed, with_lse=True)
        lse_1 = torch.cat([lse[:h], lse_h])
        sound = FK.flash_attention_backward(q, k, v, o, do, lse, kv, bounded)
        bad = FK.flash_attention_backward(*one, o[h:], do[h:], lse[h:], cut, bounded)
        grads = [torch.cat([a[:h], b]) for a, b in zip(sound, bad)]
        torch.cuda.synchronize()
        faults["last key tile skipped in sample 1"] = (
            [((lse_1 - lse_ref).abs() / lse_tol).max().item()]
            + [r[1] for r in ratios(grads, ref, tols)])
    return faults


def check_backward(FK, dev):
    """The forward kernel's LSE against attention_plain's and the two
    backward kernels against attention_backward_plain (given the kernel's
    o and the plain LSE) at the training shapes, with per-entry
    tolerances; on the training path, two planted faults must fail them,
    and at a B=2 step's shapes (phase (f): the grids' batch axis at 2 for
    global attention, 8 frames for frame attention and DINOv2) a third,
    confined to the second sample's rows."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    n_tok = S_TRAIN * 1374
    kv_dyn = torch.tensor(1374, device=dev)
    # (label, q shape, kv_valid, bounded, q scale, path): path "B=1" is the
    # train phase's step (its times go into the kernels line), "B=2" phase
    # (f)'s (DINOv2 runs unpadded in training: 1374 tokens)
    cases = [
        ("global bounded", (1, n_tok, 16, 64), None, True, 1.0, "B=1"),
        ("frame bounded", (S_TRAIN, 1374, 16, 64), None, True, 1.0, "B=1"),
        ("dino running-max", (S_TRAIN, 1374, 16, 64), None, False, 1.0, "B=1"),
        ("global bounded B=2", (2, n_tok, 16, 64), None, True, 1.0, "B=2"),
        ("frame bounded B=2", (2 * S_TRAIN, 1374, 16, 64), None, True, 1.0, "B=2"),
        ("dino running-max B=2", (2 * S_TRAIN, 1374, 16, 64), None, False, 1.0, "B=2"),
        ("dino running-max kv 1374 B=2", (2 * S_TRAIN, 1376, 16, 64), 1374, False, 1.0, "B=2"),
        ("dynamic kv_valid 1374", (S_TRAIN, 1376, 16, 64), kv_dyn, False, 1.0, None),
        ("clamp saturation q x 40", (S_TRAIN, 1374, 16, 64), None, True, 40.0, None),
    ]
    names = ("flash_attention_bwd_dq", "flash_attention_bwd_dkv")
    results = {n: {"errs": [], "ms": [], "plain_ms": [], "bound": [], "library_ms": []}
               for n in names}
    for label, shape, kv, bounded, q_scale, path in cases:
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
        faults = (backward_faults(FK, q, k, v, o, do, lse, kv, bounded, ref, tols, lse_ref,
                                  lse_tol, two_samples=path == "B=2")
                  if path else {})
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
        if path == "B=1":
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
    from omnivggt_tpu_torch.train.optim import make_finetune_optimizer
    from omnivggt_tpu_torch.train.step import init_state, make_train_step, synthetic_batch

    t0 = time.perf_counter()
    model = new_model_for_training(cfg, dev)
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
    expect = train_step_launches(cfg)
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
    # weights, over the trunk; then with each planted fault in the backward
    del optimizer, state
    torch.cuda.empty_cache()
    train_gate(FK, cfg, model, batch, ("delta=0", "last key tile skipped"), check_reference=True)
    return launches


def train_step_launches(cfg) -> dict:
    """Kernel launches per train step with remat on, at any batch size (the
    batch is a grid axis): remat runs each frame/global attention forward
    twice (the pass and its recomputation); DINOv2 is not rematted; every
    attention has one backward (dq then dk/dv)."""
    depth, dino = cfg.aggregator.depth, cfg.aggregator.backbone.depth
    return {
        "flash_attention": 2 * depth,
        "flash_attention_packed": 2 * depth + dino,
        "flash_attention_bwd_dq": 2 * depth + dino,
        "flash_attention_bwd_dkv": 2 * depth + dino,
        "flash_attention_int8": 0,
        "flash_attention_packed_stream": 0,
    }


def new_model_for_training(cfg, dev):
    """The flagship with fp32 master weights and a unit-scale camera token
    (as in the forward phase), in training mode."""
    from omnivggt_tpu_torch.models.omnivggt import OmniVGGT

    model = OmniVGGT(cfg, device=dev, seed=0).train()
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    with torch.no_grad():
        model.aggregator.camera_token.normal_(generator=gen)
    return model


def gradient_sums(g_k, g_p) -> dict:
    """The sums behind gradient_readings, in float64: <g_k, g_p>, ||g_k||^2
    and ||g_p||^2 over the leaves of g_p, and per leaf (name, ||diff||^2,
    ||ref||^2). Sums of parts (chunks of sharded leaves held by different
    processes) add up to the sums of the whole."""
    dot = n_k = n_p = 0.0
    leaves = []
    for n, b in g_p.items():
        a, b = g_k[n].double(), b.to(g_k[n].device).double()
        dot += (a * b).sum().item()
        n_k += (a * a).sum().item()
        b_sq = (b * b).sum().item()
        n_p += b_sq
        leaves.append((n, ((a - b) ** 2).sum().item(), b_sq))
    return {"dot": dot, "n_k": n_k, "n_p": n_p, "leaves": leaves}


def readings_of_sums(x) -> dict:
    """1 - cosine, both norms and the leaves of gradient_sums `x`."""
    return {"one_minus_cos": 1 - x["dot"] / (x["n_k"] * x["n_p"]) ** 0.5,
            "norm": x["n_k"] ** 0.5, "ref_norm": x["n_p"] ** 0.5, "leaves": x["leaves"]}


def gradient_readings(g_k, g_p) -> dict:
    """Gradients g_k against the reference g_p ({name: tensor}; each of g_p
    moved to its g_k's device in turn, so g_p may be a file's mapped
    tensors): 1 - cosine, both norms, and per leaf of g_p (name, ||diff||^2,
    ||ref||^2), all in float64."""
    x = gradient_sums(g_k, g_p)
    x["n_k"] = sum((a.double() ** 2).sum().item() for a in g_k.values())
    return readings_of_sums(x)


def trunk_gradient_gate(label, loss_k, g_k, loss_p, g_p):
    """The train gate: loss relative difference <= LOSS_REL_TOL and the
    cosine of the trunk's gradients >= GRAD_COS_MIN, (loss_k, g_k) against
    the reference (loss_p, g_p); prints the readings and returns whether
    both hold."""
    g = gradient_readings(g_k, g_p)
    leaves = sorted(((d / b_sq) ** 0.5, n) for n, d, b_sq in g["leaves"] if b_sq > 0)
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    print(f"train gate [{label}]: loss rel {loss_rel:.3e} (limit "
          f"{LOSS_REL_TOL:g}), trunk gradient 1 - cosine {g['one_minus_cos']:.3e} (limit "
          f"{1 - GRAD_COS_MIN:.0e}), trunk grad norms {g['norm']:.4f} / {g['ref_norm']:.4f} over "
          f"{len(g_p)} leaves; leaf relative errors: median "
          f"{leaves[len(leaves) // 2][0]:.3e}, worst {leaves[-1][1]} {leaves[-1][0]:.3e}")
    return loss_rel <= LOSS_REL_TOL and g["one_minus_cos"] <= 1 - GRAD_COS_MIN


class _CheckpointedBlocks:
    """ops.layers with `block` under torch.utils.checkpoint: swapped into
    models.dinov2 for the plain reference, whose DINOv2 (not rematted)
    would otherwise keep every block's fp32 probabilities for the backward
    (about 1.9 GB a block at 8 frames: 46 GB at B=2 S=4). The recomputation
    repeats the same operations, so the gradients are the same numbers."""

    def __init__(self, layers):
        self._layers = layers

    def __getattr__(self, name):
        return getattr(self._layers, name)

    def block(self, *args, **kwargs):
        from torch.utils.checkpoint import checkpoint

        return checkpoint(self._layers.block, *args, use_reentrant=False, **kwargs)


def loss_and_trunk_grads(cfg, model, batch, impl, remat=True, checkpoint_dino=False,
                         sharding=None):
    """One step's total loss and the trunk's gradients (aggregator and
    DINOv2: every parameter whose gradient passes through an attention
    backward) under attention `impl`, without an update; checkpoint_dino:
    each DINOv2 block under torch.utils.checkpoint (_CheckpointedBlocks);
    sharding: the step's ModelSharding (phase (h))."""
    from omnivggt_tpu_torch.models import dinov2
    from omnivggt_tpu_torch.train.step import make_train_step

    fn = make_train_step(cfg, None, sharding, use_aux_inputs=True, remat=remat, attn_impl=impl)
    layers = dinov2.L
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        if checkpoint_dino:
            dinov2.L = _CheckpointedBlocks(layers)
        losses = fn.loss_and_grads(model, batch, 0)
    finally:
        dinov2.L = layers
    torch.cuda.synchronize()
    print(f"loss and gradients, attention {impl}, remat {remat}"
          f"{', DINOv2 blocks checkpointed' if checkpoint_dino else ''}"
          f"{f', mesh ({sharding.mesh.data}x{sharding.mesh.seq}) {sharding.global_attn}' if sharding else ''}: "
          f"{(time.perf_counter() - t0) * 1e3:.2f} ms, total loss {losses['total'].item():.6f}")
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
             if n.startswith("aggregator.") and p.grad is not None}
    model.zero_grad(set_to_none=True)
    return losses["total"].item(), grads


def train_gate(FK, cfg, model, batch, faults, check_reference=False):
    """The kernel path's loss and trunk gradients against the plain path's
    on the same weights and batch; then the same with each named planted
    fault in the backward, which the gate must reject. Faults: "delta=0",
    "last key tile skipped" (in every backward), "delta=0 in sample 1"
    (only on the rows of the batch's second sample: the second half of
    every attention's batch axis, which is sample-major). The plain path
    checkpoints its DINOv2 blocks (at B=2 it would not fit otherwise);
    check_reference: first hold it against the plain path without, loss
    and trunk gradients bitwise or within the gate."""
    loss_p, g_p = loss_and_trunk_grads(cfg, model, batch, "plain", checkpoint_dino=True)
    if check_reference:
        loss_u, g_u = loss_and_trunk_grads(cfg, model, batch, "plain")
        bitwise = loss_u == loss_p and all(torch.equal(g_u[n], g) for n, g in g_p.items())
        print(f"plain reference, DINOv2 blocks checkpointed vs not: loss and trunk gradients "
              f"bitwise equal: {bitwise}")
        if not bitwise and not trunk_gradient_gate("plain, DINOv2 checkpointed vs not", loss_p,
                                                   g_p, loss_u, g_u):
            raise AssertionError("checkpointing DINOv2 changes the plain reference")
        # the same call run twice: the card's own spread (reported, not held)
        trunk_gradient_gate("plain, not checkpointed, the same call again",
                            *loss_and_trunk_grads(cfg, model, batch, "plain"), loss_u, g_u)
        del g_u
        torch.cuda.empty_cache()
    if not trunk_gradient_gate("kernels vs plain", *loss_and_trunk_grads(cfg, model, batch, "auto"),
                               loss_p, g_p):
        raise AssertionError("the kernel path's train step disagrees with the plain path")
    sound_backward = FK.flash_attention_backward

    def delta_zero(q, k, v, o, do, lse, kv, bounded):
        dq, _ = FK.flash_attention_bwd_dq(q, k, v, torch.zeros_like(o), do, lse, kv, bounded)
        return (dq, *FK.flash_attention_bwd_dkv(q, k, v, do, lse, torch.zeros_like(lse), kv,
                                                bounded))

    def last_tile_skipped(q, k, v, o, do, lse, kv, bounded):
        n = k.shape[1] if kv is None else int(kv)
        return sound_backward(q, k, v, o, do, lse, (n - 1) // 64 * 64, bounded)

    def in_sample_1(fault):
        def planted(q, k, v, o, do, lse, kv, bounded):
            out = sound_backward(q, k, v, o, do, lse, kv, bounded)
            h = q.shape[0] // 2
            bad = fault(q[h:], k[h:], v[h:], o[h:], do[h:], lse[h:], kv, bounded)
            return tuple(torch.cat([a[:h], b]) for a, b in zip(out, bad))

        return planted

    planted = {"delta=0": delta_zero, "last key tile skipped": last_tile_skipped,
               "delta=0 in sample 1": in_sample_1(delta_zero)}
    passed = {}
    try:
        for label in faults:
            FK.flash_attention_backward = planted[label]
            passed[label] = trunk_gradient_gate(
                f"fault {label} vs plain", *loss_and_trunk_grads(cfg, model, batch, "auto"), loss_p,
                g_p)
    finally:
        FK.flash_attention_backward = sound_backward
    if any(passed.values()):
        raise AssertionError(f"the train gate does not reject a planted fault: {passed}")


B_SHARDS, N_SHARD_SAMPLES, CLI_STEPS = 2, 4, 4


def sample_digest(sample) -> bytes:
    """The bytes of a sample: every array's name, dtype, shape and data."""
    import hashlib

    h = hashlib.sha256()
    for k in sorted(sample):
        a = np.ascontiguousarray(sample[k])
        h.update(f"{k} {a.dtype} {a.shape}".encode())
        h.update(a.tobytes())
    return h.digest()


MESH_TRAIN, H_STEPS = (2, 2), 3  # phase (h): (data, seq) logical ranks; steps a mode
# the gate on the parameters of two runs from one init, both fixed: the
# share of elements outside tests/test_fsdp.py's tolerance (rtol 1e-4, atol
# 1e-6), and the relative error of one run's update against the other's,
# ||got - ref|| / ||ref - init||. A lost update reads 1 on both, half an
# update ~0.5. The card's run-to-run spread (the upsample's backward adds
# atomically, and Adam's first steps turn the sign of a near-zero gradient
# into a whole step) moves few elements: PERF.md, phase (h).
# Both hold after the first update (step 1: its gradients are taken at the
# init in every run). After the last step the share's limit is
# FINAL_OUTSIDE_MAX: the first update's sign noise moves the predictions by
# ~2e-3, enough to flip the sign of an L1 term of the camera loss at step
# 2 in some runs and not in others (grad_norm 38.889 against 39.103, in
# any mode, one device and the parent's tree included), and that moves
# 4.98e-2 of the elements past rtol 1e-4 at a gap of 1.5e-2; a planted
# fault moves 0.93 of them (PERF.md, phase (h))
PARAM_RTOL, PARAM_ATOL, OUTSIDE_MAX, FINAL_OUTSIDE_MAX = 1e-4, 1e-6, 1e-2, 2e-1
UPDATE_GAP_TOL = 1e-1
FIRST_UPDATE = 1  # warmup 1: step 0's rate is 0, step 1 moves the parameters


def per_rank_state_bytes(state) -> int:
    """The bytes a rank holds of a TrainState: each parameter (one shard
    of a sharded one under fsdp) and its two AdamW moments (one shard's
    under zero2 and fsdp)."""
    layout, opt, total = state.layout, state.optimizer, 0
    for name, slots in opt.slots.items():
        param = (layout.params[name] if layout is not None and layout.mode == "zero2"
                 and name in layout.specs else slots[0])
        moments = opt.adamw.state[slots[0]]
        total += sum(t.numel() * t.element_size()
                     for t in (param, moments["exp_avg"], moments["exp_avg_sq"]))
    return total


def param_readings(got, ref, dev, init=None, update_sq=None) -> dict:
    """Parameters of two runs from the same init ({name: tensor}, any
    device, a file's mapped tensors too; compared on `dev` one tensor at a
    time): whether they are bitwise equal, how many elements leave
    PARAM_RTOL / PARAM_ATOL, the worst difference, and the update gap
    ||got - ref|| / ||ref - init||, with ||ref - init||^2 taken from `init`
    or given as `update_sq`."""
    bitwise, outside, worst, n, diff_sq, ref_sq = True, 0, 0.0, 0, 0.0, 0.0
    for k, r in ref.items():
        r, g = r.to(dev), got[k].to(dev)
        n += r.numel()
        if init is not None:
            ref_sq += torch.linalg.vector_norm(r - init[k].to(dev)).item() ** 2
        if torch.equal(g, r):
            continue
        bitwise = False
        d = g - r
        diff_sq += torch.linalg.vector_norm(d).item() ** 2
        d = d.abs()
        worst = max(worst, d.max().item())
        outside += int((d > PARAM_ATOL + PARAM_RTOL * r.abs()).sum())
    update_sq = ref_sq if update_sq is None else update_sq
    return {"bitwise": bitwise, "outside": outside, "n": n, "worst": worst,
            "gap": (diff_sq / update_sq) ** 0.5 if update_sq else float("inf")}


def params_pass(label, x, outside_max=OUTSIDE_MAX) -> bool:
    """Prints param_readings `x`; returns whether they pass the gate
    (bitwise, or within outside_max (a share of the elements) and
    UPDATE_GAP_TOL)."""
    print(f"  parameters, {label}: bitwise {x['bitwise']}; {x['outside']} of {x['n']} elements "
          f"({x['outside'] / x['n']:.3e}; limit {outside_max:g}) outside "
          f"rtol {PARAM_RTOL:g} atol {PARAM_ATOL:g}, max |diff| {x['worst']:.3e}; update gap "
          f"{x['gap']:.3e} (limit {UPDATE_GAP_TOL:g})")
    return x["bitwise"] or (x["outside"] <= outside_max * x["n"] and x["gap"] <= UPDATE_GAP_TOL)


def params_against(label, got, ref, init, dev, outside_max=OUTSIDE_MAX):
    """param_readings of two runs from the same `init`, printed and gated
    (params_pass)."""
    return params_pass(label, param_readings(got, ref, dev, init=init), outside_max)


def moments_of_the_next_shard(state):
    """A planted fault of the zero2 / fsdp layouts: every sharded
    parameter's chunks step with the AdamW moments of the next chunk."""
    adam = state.optimizer.adamw.state
    for name in state.layout.specs:
        chunks = state.optimizer.slots[name]
        entries = [adam[c] for c in chunks]
        for c, e in zip(chunks, entries[1:] + entries[:1]):
            adam[c] = e


def sharded_train_phase(FK, cfg, dev, card, img=IMG):
    """(h) multi-device training: the flagship step on a (2, 2) mesh of
    logical ranks under every state sharding, against the one-device step;
    the data axis as a process group (NCCL, world size 1) against logical
    ranks; the training CLI under torchrun; the dry run."""
    from omnivggt_tpu_torch.models.omnivggt import OmniVGGT
    from omnivggt_tpu_torch.parallel import collectives as C
    from omnivggt_tpu_torch.parallel import fsdp
    from omnivggt_tpu_torch.parallel.mesh import make_mesh
    from omnivggt_tpu_torch.parallel.sharding import ModelSharding
    from omnivggt_tpu_torch.train.optim import make_finetune_optimizer
    from omnivggt_tpu_torch.train.step import init_state, make_train_step, synthetic_batch

    batch = synthetic_batch(S_TRAIN, img, dev, seed=3, scenes=2)  # the train phase's, and one
    sharding = ModelSharding(make_mesh(*MESH_TRAIN, device=dev), "allgather")
    mesh = sharding.mesh
    print(f"sharded training: flagship B=2 S={S_TRAIN} {img}px, mesh ({mesh.data}x{mesh.seq}) "
          f"logical ranks, global attention allgather, remat on, {H_STEPS} steps a mode; "
          f"card {card}")

    # 1. one step's loss and trunk gradients on the mesh against one device
    # (the train gate), on the same weights
    model = new_model_for_training(cfg, dev)
    loss_1, g_1 = loss_and_trunk_grads(cfg, model, batch, "auto")
    if not trunk_gradient_gate("mesh (2x2) vs one device", *loss_and_trunk_grads(
            cfg, model, batch, "auto", sharding=sharding), loss_1, g_1):
        raise AssertionError("the sharded step's gradients disagree with the one-device step's")
    del model, g_1
    gc.collect()
    torch.cuda.empty_cache()

    # 2. three steps from the same init: one device, then every mode on the
    # mesh, mesh none twice (the card's spread), and zero2 with a planted
    # fault that the gate on the final parameters must catch
    meta = OmniVGGT(cfg, device="meta", seed=None)
    largest = max(p.numel() * p.element_size() for p in meta.parameters())
    init = {k: v.detach().cpu() for k, v in new_model_for_training(cfg, dev).state_dict().items()}
    runs, moved = {}, {}  # moved: the parameters after the first update, of the references
    # (label, reference, must pass) of the comparisons after the first update
    first_checks = {"mesh none": [("one device", True)],
                    "mesh none again": [("mesh none", None)],
                    "mesh zero2": [("one device", True), ("mesh none", True)],
                    "mesh fsdp": [("one device", True), ("mesh none", True)],
                    "mesh zero2, planted fault: moments of the next shard": [("mesh none", False)]}
    for label, sh, mode, fault in (
            ("one device", None, "none", None), ("mesh none", sharding, "none", None),
            ("mesh none again", sharding, "none", None), ("mesh zero2", sharding, "zero2", None),
            ("mesh fsdp", sharding, "fsdp", None),
            ("mesh zero2, planted fault: moments of the next shard", sharding, "zero2",
             moments_of_the_next_shard)):
        model = new_model_for_training(cfg, dev)
        # warmup 1: the first step's rate is 0, so Adam's first update sees two
        # gradients; from a single one it moves every element by a whole step
        # in its gradient's sign, and the mesh's other summation order, which
        # flips near-zero gradients, takes one device's losses 1.3e-2 away in
        # two steps (PERF.md, phase (h))
        opt = make_finetune_optimizer(model, learning_rate=1e-4, warmup_steps=1, total_steps=100)
        state = init_state(model, opt)
        if mode != "none":
            fsdp.shard_state(state, mesh, mode)
        step_fn = make_train_step(cfg, opt, sh, use_aux_inputs=True, remat=True,
                                  state_sharding=mode)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times, history = [], []
        for i in range(H_STEPS):
            if i == 1:
                FK.reset_launches()
                C.reset_calls()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            if i == 1:
                launches, calls = FK.launches(), C.calls()
            history.append({k: v.item() for k, v in metrics.items()})
            if fault is not None:
                fault(state)
            if i == FIRST_UPDATE:
                after = {k: v.detach().cpu() for k, v in (
                    state.layout.full_state_dict() if state.layout is not None
                    else model.state_dict()).items()}
                for ref_label, must in first_checks.get(label, ()):
                    passed = params_against(f"after the first update, {label} vs {ref_label}"
                                            + (" (the card's spread)" if must is None else ""),
                                            after, moved[ref_label], init, dev)
                    if must is True and not passed:
                        raise AssertionError(f"{label}: parameters after the first update "
                                             f"differ from {ref_label}'s")
                    if must is False and passed:
                        raise AssertionError("the gate on the parameters passes moments of the "
                                             "wrong shard")
                if label in ("one device", "mesh none"):
                    moved[label] = after
                del after
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        held = per_rank_state_bytes(state)
        want = fsdp.state_bytes_per_device(meta, mesh if sh is not None else 1, mode)
        final = {k: v.detach().cpu() for k, v in (
            state.layout.full_state_dict() if state.layout is not None
            else model.state_dict()).items()}
        runs[label] = dict(history=history, launches=launches, final=final)
        for i, m in enumerate(history):
            print(f"  {label} step {i}: " + ", ".join(f"{k} {v:.6f}" for k, v in sorted(m.items())))
        print(f"{label}: train step B=2 S={S_TRAIN} {img}px {statistics.median(times):.2f} ms "
              f"median of {H_STEPS} ({', '.join(f'{t:.2f}' for t in times)}), peak memory "
              f"{peak_gb:.3f} GB, state {held / 1e9:.3f} GB a rank (state_bytes_per_device "
              f"{want / 1e9:.3f} GB), launches a step {launches}, collectives a step "
              f"{calls}; card {card}")
        if not all(np.isfinite(v) for m in history for v in m.values()):
            raise AssertionError(f"{label}: a loss or grad_norm is not finite")
        if held != want:
            raise AssertionError(f"{label}: a rank holds {held} bytes of state, "
                                 f"state_bytes_per_device says {want}")
        if label == "mesh fsdp":
            save_fsdp_checkpoint(state, largest, card)
        del state, model, opt, step_fn
        gc.collect()
        torch.cuda.empty_cache()

    one, none = runs["one device"], runs["mesh none"]
    params_against("final, mesh none again vs mesh none (the card's spread)",
                   runs["mesh none again"]["final"], none["final"], init, dev,
                   outside_max=FINAL_OUTSIDE_MAX)
    for label in ("mesh none", "mesh zero2", "mesh fsdp"):
        run = runs[label]
        if run["launches"] != none["launches"]:
            raise AssertionError(f"{label}: launches {run['launches']}, mesh none "
                                 f"{none['launches']}")
        worst = max(abs(g[k] - w[k]) / abs(w[k]) for g, w in zip(run["history"], one["history"])
                    for k in w)
        print(f"  {label} vs one device: losses and grad_norm, worst relative difference "
              f"{worst:.3e} (limit {LOSS_REL_TOL:g})")
        if worst > LOSS_REL_TOL:
            raise AssertionError(f"{label}: losses or grad_norm leave the train gate")
        for ref_label in ("one device", "mesh none") if label != "mesh none" else ("one device",):
            if not params_against(f"final, {label} vs {ref_label}", run["final"],
                                  runs[ref_label]["final"], init, dev,
                                  outside_max=FINAL_OUTSIDE_MAX):
                raise AssertionError(f"{label}: final parameters differ from {ref_label}'s")
    planted = "mesh zero2, planted fault: moments of the next shard"
    if params_against(f"final, {planted} vs mesh none", runs[planted]["final"], none["final"],
                      init, dev, outside_max=FINAL_OUTSIDE_MAX):
        raise AssertionError("the gate on the final parameters passes moments of the wrong shard")
    print(f"main path launches per sharded train step (mesh {MESH_TRAIN}, every mode): "
          f"{none['launches']}; one device {one['launches']}")
    del runs, one, none, init, moved
    gc.collect()

    dryrun_phase()
    torchrun_cli_phase(dev, card)
    process_group_phase(dev, card)


def save_fsdp_checkpoint(state, largest, card):
    """A checkpoint of the flagship's fsdp state: the device memory the save
    adds on top of the state (it gathers one tensor at a time onto the
    host) must stay within two of the largest parameter's bytes."""
    import shutil
    import tempfile

    from omnivggt_tpu_torch.train.checkpointing import save_train_state

    tmp = tempfile.mkdtemp(prefix="chip_smoke_fsdp_ckpt_")
    try:
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        path = save_train_state(tmp, state)
        save_s = time.perf_counter() - t0
        added = torch.cuda.max_memory_allocated() - before
        size = os.path.getsize(path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"mesh fsdp: checkpoint {size / 1e9:.3f} GB saved in {save_s:.2f} s, device memory "
          f"added by the save {added / 1e6:.1f} MB (limit: twice the largest parameter, "
          f"{2 * largest / 1e6:.1f} MB), state on the device {before / 1e9:.3f} GB; card {card}")
    if added > 2 * largest:
        raise AssertionError(f"the fsdp save added {added} bytes of device memory")


def dryrun_phase():
    """tools/dryrun_multichip --ranks 4 on the card: parts (a), (b), (c), and
    (d) and (e) on the CPU."""
    from omnivggt_tpu_torch.tools import dryrun_multichip

    t0 = time.perf_counter()
    if dryrun_multichip.main(["--ranks", "4"]) != 0:
        raise AssertionError("the dry run failed on the card")
    print(f"dryrun_multichip --ranks 4 on the card: {time.perf_counter() - t0:.2f} s")


def torchrun_cli_phase(dev, card):
    """The training CLI under torchrun --nproc_per_node 1 on the card:
    --mesh 1,2 --state_sharding zero2, --tiny, 2 steps from two synthetic
    shards; it must exit 0 and write metrics.jsonl and one checkpoint."""
    import shutil
    import tempfile

    from omnivggt_tpu_torch.data.streaming import write_shards
    from omnivggt_tpu_torch.train.step import synthetic_batch

    tmp = tempfile.mkdtemp(prefix="chip_smoke_torchrun_")
    try:
        samples = [{k: v.numpy() for k, v in synthetic_batch(2, 28, "cpu", seed=i).items()}
                   for i in range(4)]
        write_shards(samples, os.path.join(tmp, "shards"), samples_per_shard=2)
        ck = os.path.join(tmp, "run")
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", "1", "-m", "omnivggt_tpu_torch.tools.train",
               "--shards", os.path.join(tmp, "shards", "shard-*.tar"), "--views", "2", "--tiny",
               "--mesh", "1,2", "--state_sharding", "zero2", "--steps", "2", "--warmup", "1",
               "--log_every", "1", "--ckpt_dir", ck]
        repo = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=repo, env=env, capture_output=True, text=True, timeout=300)
        wall = time.perf_counter() - t0
        print(proc.stdout[-2000:])
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            raise AssertionError(f"torchrun training CLI exited {proc.returncode}")
        with open(os.path.join(ck, "metrics.jsonl")) as f:
            logged = [json.loads(line) for line in f]
        files = sorted(os.listdir(ck))
        if [m["step"] for m in logged] != [1, 2] or files != ["metrics.jsonl", "step_00000002.pt"]:
            raise AssertionError(f"torchrun CLI: logged steps {[m['step'] for m in logged]}, "
                                 f"files {files}")
        print(f"torchrun --nproc_per_node 1 training CLI (--tiny, mesh 1,2, zero2, cuda): exit 0 "
              f"in {wall:.2f} s, {files}; card {card}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def process_group_phase(dev, card):
    """The data axis over processes on CUDA tensors: an NCCL group of world
    size 1 (this process), one zero2 step and one fsdp step on a (1, 2)
    mesh of the tiny config widened to head dim 64 at 224 px, against the
    same steps on logical ranks (run twice: the card's own spread, printed)."""
    import torch.distributed as dist

    from omnivggt_tpu_torch.models.omnivggt import OmniVGGT
    from omnivggt_tpu_torch.parallel import collectives as C
    from omnivggt_tpu_torch.parallel import fsdp
    from omnivggt_tpu_torch.parallel.mesh import make_mesh, multihost_initialize
    from omnivggt_tpu_torch.parallel.sharding import ModelSharding
    from omnivggt_tpu_torch.tools.dryrun_multichip import dryrun_config
    from omnivggt_tpu_torch.train.step import (
        init_state, make_optimizer, make_train_step, synthetic_batch,
    )

    cfg = dryrun_config(dev)
    batch = synthetic_batch(4, 224, dev, seed=5)

    def one_step(mode, mesh):
        model = OmniVGGT(cfg, device=dev, seed=0).train()
        opt = make_optimizer(model, learning_rate=1e-3, warmup_steps=0, total_steps=100)
        state = fsdp.shard_state(init_state(model, opt), mesh, mode, min_elems=0)
        step = make_train_step(cfg, opt, ModelSharding(mesh, "allgather"), use_aux_inputs=True,
                               state_sharding=mode)
        C.reset_calls()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        final = {k: v.detach().clone() for k, v in state.layout.full_state_dict().items()}
        return {k: v.item() for k, v in metrics.items()}, final, C.calls()

    init = OmniVGGT(cfg, device=dev, seed=0).state_dict()
    logical = make_mesh(data=1, seq=2, device=dev)
    ref = {m: one_step(m, logical) for m in ("zero2", "fsdp")}
    again = {m: one_step(m, logical) for m in ("zero2", "fsdp")}
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    seen = defaultdict(list)
    sound = {n: getattr(dist, n) for n in ("reduce_scatter_tensor", "all_gather_into_tensor",
                                           "all_reduce")}

    def counted(name):
        def call(out, *args, **kwargs):
            seen[name].append(out.device.type)
            return sound[name](out, *args, **kwargs)
        return call

    t0 = time.perf_counter()
    multihost_initialize(backend="nccl", world_size=1, rank=0,
                         init_method=f"tcp://127.0.0.1:{port}", timeout=120)
    try:
        init_s = time.perf_counter() - t0
        pmesh = make_mesh(data=1, seq=2, device=dev)
        if pmesh.group is None or dist.get_backend() != "nccl":
            raise AssertionError("the mesh did not take the NCCL group")
        for n in sound:
            setattr(dist, n, counted(n))
        try:
            got = {m: one_step(m, pmesh) for m in ("zero2", "fsdp")}
        finally:
            for n, fn in sound.items():
                setattr(dist, n, fn)
    finally:
        dist.destroy_process_group()
    print(f"NCCL process group, world size 1: initialised in {init_s:.2f} s; torch.distributed "
          f"calls {({n: len(v) for n, v in seen.items()})}, on devices "
          f"{sorted({d for v in seen.values() for d in v})}; card {card}")
    if set(seen) != set(sound) or {d for v in seen.values() for d in v} != {dev.type}:
        raise AssertionError(f"the collectives did not all run on {dev} tensors: {dict(seen)}")
    for mode in ("zero2", "fsdp"):
        (m_ref, p_ref, c_ref), (m_got, p_got, c_got) = ref[mode], got[mode]
        if c_got != c_ref or not (c_got["reduce_scatter"] and c_got["all_gather"]):
            raise AssertionError(f"{mode}: collectives {c_got} vs logical {c_ref}")
        rel = max(abs(m_got[k] - v) / abs(v) for k, v in m_ref.items())
        print(f"  {mode}: NCCL step vs logical ranks: metrics worst relative difference "
              f"{rel:.3e} (limit 1e-5); metrics {m_got}; collectives {c_got}")
        params_against(f"{mode}, logical ranks again vs logical ranks (the card's spread)",
                       again[mode][1], p_ref, init, dev)
        if rel > 1e-5 or not params_against(f"{mode}, NCCL vs logical ranks", p_got, p_ref,
                                            init, dev):
            raise AssertionError(f"{mode}: the NCCL step differs from logical ranks")


def check_augmentation_on_the_card(dev, card):
    """The photometric augmentation on a CUDA view against its CPU copy,
    parameters drawn on the CPU from generators seeded alike: whole draws
    over seeds 0-39 (jitter in each order, grayscale and blur when drawn),
    and each operation with its parameter given; within 1e-6."""
    from omnivggt_tpu_torch.data import augmentation as TA

    view = torch.rand((IMG, IMG, 3), generator=torch.Generator().manual_seed(5))
    view_cuda = view.to(dev)
    augment = TA.make_augmentation(gau_blur=True)
    worst, applied = 0.0, 0
    for seed in range(40):
        out_cuda = augment(torch.Generator().manual_seed(seed), view_cuda)
        out_cpu = augment(torch.Generator().manual_seed(seed), view)
        worst = max(worst, (out_cuda.cpu() - out_cpu).abs().max().item())
        applied += not torch.equal(out_cpu, view)
    ops = {
        "color_jitter": lambda im: TA.color_jitter(im, 1.3, 0.7, 1.2, -0.06, (3, 1, 0, 2)),
        "to_grayscale": TA.to_grayscale,
        "gaussian_blur": lambda im: TA.gaussian_blur(im, 0.7),
    }
    for name, op in ops.items():
        err = (op(view_cuda).cpu() - op(view)).abs().max().item()
        print(f"augmentation {name}: CUDA vs CPU max abs {err:.3e} (limit 1e-6)")
        worst = max(worst, err)
    print(f"augmentation make_augmentation(gau_blur=True), 40 draws ({applied} changed the "
          f"view): CUDA vs CPU max abs over every check {worst:.3e} (limit 1e-6)")
    if worst > 1e-6:
        raise AssertionError(f"the augmentation on the card differs from the CPU's: {worst}")
    ms = median_ms(lambda: augment(torch.Generator().manual_seed(0), view_cuda), 10)
    ms_jitter = median_ms(lambda: ops["color_jitter"](view_cuda), 10)
    print(f"augmentation of one {IMG}px view on the card: {ms:.3f} ms a draw (seed 0), "
          f"color_jitter alone {ms_jitter:.3f} ms; card {card}")


def shards_phase(FK, cfg, dev, card):
    """(f) fine-tuning from shards: samples written to tar shards and read
    back; the training CLI streaming them at --batch 2 on the flagship with
    the kernels' launches per step; the train gate at B=2 with its planted
    faults; remat="dots" against remat=True; the augmentation on the card."""
    import shutil
    import tempfile

    from omnivggt_tpu_torch.data.streaming import ShardedSampleStream, batch_stream, write_shards
    from omnivggt_tpu_torch.tools import train as train_cli
    from omnivggt_tpu_torch.train import checkpointing as TCK
    from omnivggt_tpu_torch.train.optim import make_finetune_optimizer
    from omnivggt_tpu_torch.train.step import (
        batch_to_device, init_state, make_train_step, synthetic_batch,
    )

    tmp = tempfile.mkdtemp(prefix="chip_smoke_shards_")
    try:
        # 1. shards: written, then read back through the stream as a set
        # SceneDataset layout: synthetic_batch's arrays (its masks are (S,))
        samples = [{k: v.numpy() for k, v in synthetic_batch(S_TRAIN, IMG, "cpu", 10 + i).items()}
                   for i in range(N_SHARD_SAMPLES)]
        t0 = time.perf_counter()
        paths = write_shards(samples, os.path.join(tmp, "shards"), samples_per_shard=2)
        write_s = time.perf_counter() - t0
        pattern = os.path.join(tmp, "shards", "shard-*.tar")
        t0 = time.perf_counter()
        back = list(ShardedSampleStream(pattern, shuffle_buffer=4, seed=0, repeat=False))
        read_s = time.perf_counter() - t0
        size_mb = sum(os.path.getsize(p) for p in paths) / 1e6
        if sorted(map(sample_digest, back)) != sorted(map(sample_digest, samples)):
            raise AssertionError("the shards do not give back the samples written")
        print(f"shards: {len(samples)} samples of {S_TRAIN} views at {IMG}px into {len(paths)} "
              f"shards, {size_mb:.1f} MB, written in {write_s:.2f} s, read back bytes-equal "
              f"(as a set) in {read_s:.2f} s; disk free under {tmp}: "
              f"{shutil.disk_usage(tmp).free / 1e9:.1f} GB")
        del samples, back

        # 2. the training CLI at full width, streaming the shards at B=2
        ckpt_dir = os.path.join(tmp, "run")
        saves, sound_save = [], TCK.save_train_state

        def timed_save(*args, **kwargs):
            t0 = time.perf_counter()
            path = sound_save(*args, **kwargs)
            saves.append((path, os.path.getsize(path), time.perf_counter() - t0))
            return path

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        TCK.save_train_state = timed_save
        try:
            FK.reset_launches()
            t0 = time.perf_counter()
            state = train_cli.main([
                "--shards", pattern, "--batch", str(B_SHARDS), "--views", str(S_TRAIN),
                "--steps", str(CLI_STEPS), "--log_every", "1", "--warmup", "1",
                "--save_every", "1000", "--ckpt_dir", ckpt_dir,
            ])
            torch.cuda.synchronize()
            cli_s = time.perf_counter() - t0
            launches = FK.launches()
        finally:
            TCK.save_train_state = sound_save
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        if next(state.model.parameters()).device.type != dev.type:
            raise AssertionError("the training CLI did not train on the card by default")
        del state
        gc.collect()
        torch.cuda.empty_cache()
        with open(os.path.join(ckpt_dir, "metrics.jsonl")) as f:
            logged = [json.loads(line) for line in f]
        for m in logged:
            print("cli step " + ", ".join(f"{k} {v}" for k, v in sorted(m.items())))
        if [m["step"] for m in logged] != list(range(1, CLI_STEPS + 1)):
            raise AssertionError(f"the CLI logged steps {[m['step'] for m in logged]}")
        if not all(np.isfinite(m[k]) for m in logged for k in m):
            raise AssertionError("a loss or grad_norm of the CLI run is not finite")
        if not all(m["grad_norm"] > 0 for m in logged):
            raise AssertionError("grad_norm is 0 in the CLI run")
        expect = {k: CLI_STEPS * n for k, n in train_step_launches(cfg).items()}
        print(f"main path launches over {CLI_STEPS} train steps at B={B_SHARDS} from shards: "
              f"{launches} (expected {expect})")
        if launches != expect:
            raise AssertionError(f"B={B_SHARDS} train-step launches {launches}, expected {expect}")
        step_ms = statistics.median(m["sec_per_step"] for m in logged[1:]) * 1e3
        (ckpt, ckpt_bytes, save_s), = saves
        print(f"flagship train step B={B_SHARDS} S={S_TRAIN} {IMG}px from shards (CLI): "
              f"{step_ms:.0f} ms median of steps 2-{CLI_STEPS} "
              f"({', '.join(str(m['sec_per_step']) for m in logged)} s a step), "
              f"{B_SHARDS * S_TRAIN / step_ms * 1e3:.3f} views/s, peak memory {peak_gb:.3f} GB, "
              f"CLI wall {cli_s:.2f} s; checkpoint {os.path.basename(ckpt)} "
              f"{ckpt_bytes / 1e9:.3f} GB saved in {save_s:.2f} s; card {card}")
        shutil.rmtree(ckpt_dir)

        # 3. the train gate at B=2 on a batch from the stream
        stream = ShardedSampleStream(pattern, shuffle_buffer=4, seed=1, repeat=False)
        batch = batch_to_device(next(iter(batch_stream(stream, B_SHARDS))), dev)
        if tuple(batch["images"].shape) != (B_SHARDS, S_TRAIN, IMG, IMG, 3):
            raise AssertionError(f"stream batch images {tuple(batch['images'].shape)}")
        model = new_model_for_training(cfg, dev)
        train_gate(FK, cfg, model, batch,
                   ("last key tile skipped", "delta=0 in sample 1"))

        # 4. remat="dots" against remat=True on the same weights: B=1 S=4 on
        # the train phase's batch, then B=2 on the streamed one
        optimizer = make_finetune_optimizer(model, learning_rate=0.0, warmup_steps=1,
                                            total_steps=100)  # the weights stay as they are
        for label, b in (("B=1", synthetic_batch(S_TRAIN, IMG, dev, seed=3)), ("B=2", batch)):
            readings = {}
            for remat in (True, "dots"):
                step_fn = make_train_step(cfg, optimizer, use_aux_inputs=True, remat=remat)
                state = init_state(model, optimizer)
                step_fn(state, b)  # warm-up
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                times = []
                for i in range(3):
                    if i == 0:
                        FK.reset_launches()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    step_fn(state, b)
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t0) * 1e3)
                    if i == 0:
                        step_launches = FK.launches()
                readings[remat] = (statistics.median(times), times,
                                   torch.cuda.max_memory_allocated() / 1e9, step_launches)
                print(f"remat={remat!r}: train step {label} S={S_TRAIN} {IMG}px "
                      f"{readings[remat][0]:.2f} ms median of 3 "
                      f"({', '.join(f'{t:.2f}' for t in times)}), peak memory "
                      f"{readings[remat][2]:.3f} GB, launches {step_launches}; card {card}")
                profile_breakdown(f"train step {label} S={S_TRAIN} remat={remat!r}",
                                  lambda: step_fn(state, b))
                del state
                torch.cuda.empty_cache()
            if (readings[True][3] != readings["dots"][3]
                    or readings[True][3] != train_step_launches(cfg)):
                raise AssertionError(f"remat launches differ at {label}: {readings[True][3]} vs "
                                     f"{readings['dots'][3]}")
            loss_full, g_full = loss_and_trunk_grads(cfg, model, b, "auto", remat=True)
            loss_dots, g_dots = loss_and_trunk_grads(cfg, model, b, "auto", remat="dots")
            bitwise = loss_full == loss_dots and all(
                torch.equal(g_dots[n], g) for n, g in g_full.items())
            print(f"remat='dots' vs remat=True at {label}: loss and trunk gradients bitwise "
                  f"equal: {bitwise}; step {readings['dots'][0] - readings[True][0]:+.2f} ms, "
                  f"peak memory {readings['dots'][2] - readings[True][2]:+.3f} GB")
            if not bitwise and not trunk_gradient_gate(f"remat='dots' vs remat=True, {label}",
                                                       loss_dots, g_dots, loss_full, g_full):
                raise AssertionError(f"remat='dots' disagrees with remat=True at {label}")
            trunk_gradient_gate(f"remat=True, the same call again, {label} (reported)",
                                *loss_and_trunk_grads(cfg, model, b, "auto", remat=True),
                                loss_full, g_full)
            del g_full, g_dots
            torch.cuda.empty_cache()
        del optimizer, model, batch
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # 5. the augmentation on the card
    check_augmentation_on_the_card(dev, card)


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


# (cin, cout, k, side, relu, planted fault) of the fp32 head convolutions
# the flagship's S=8 forward gives conv_tf32x3: the residual units' 256 ->
# 256 3x3 at 148, 74, 37 and 19, layer3_rn, the 1x1 projections at 37,
# output_conv1 and output_conv2[0]; each with one planted fault
TF32X3_CASES = [
    (256, 256, 3, 148, True, "halo_column"), (256, 256, 3, 74, False, "one_pass_tf32"),
    (256, 256, 3, 37, False, "lo_hi_dropped"), (256, 256, 3, 19, False, "one_pass_tf32"),
    (1024, 256, 3, 37, False, "lo_hi_dropped"), (2048, 256, 1, 37, False, "bias_dropped"),
    (2048, 512, 1, 37, False, "lo_hi_dropped"), (2048, 1024, 1, 37, False, "one_pass_tf32"),
    (256, 128, 3, 296, False, "bias_dropped"), (128, 32, 3, IMG, True, "relu_dropped"),
]
TF32X3_MEDIAN_RATIO = 2.0  # its median relative error against cuDNN fp32's, at most


def check_conv_tf32x3(CT, dev):
    """The fp32 head convolutions' tensor-core kernel (conv2d_tf32x3, x
    channels-last as the heads hand it, S=8 frames) against its plain
    version (conv2d_tf32x3_plain: cuDNN fp32, TF32 off) at every case of
    TF32X3_CASES: entry by entry within 2 (taps cin + 1) 2^-24 conv(|x|,
    |w|) + |b| terms (both sides' fp32 sums), and against a float64
    F.conv2d of the same inputs with a median relative error at most
    TF32X3_MEDIAN_RATIO times the plain version's; one launch and no input
    copy a call, the output channels-last; each case's planted fault must
    fail one of the two; at 148 21 launches bitwise equal; times of the
    kernel, the plain version and F.conv2d, and the bound (the operations
    over 495 / 3 TFLOP/s, TF32 at three products a multiply, against the
    bytes)."""
    F = torch.nn.functional
    result = new_results()
    for cin, cout, k, side, relu, fault in TF32X3_CASES:
        gen = torch.Generator(device="cpu").manual_seed(cin * 1000 + side)
        conv = torch.nn.Conv2d(cin, cout, k, padding=k // 2)
        with torch.no_grad():
            conv.weight.copy_((torch.rand(conv.weight.shape, generator=gen) * 2 - 1)
                              * (cin * k * k) ** -0.5)
            conv.bias.copy_(torch.rand(cout, generator=gen) - 0.5)
        conv = conv.to(dev).requires_grad_(False)
        x = torch.randn((S, side, side, cin), generator=gen).to(dev).permute(0, 3, 1, 2)
        pad = k // 2
        with torch.no_grad():
            before = (CT.conv2d_tf32x3.launches, CT.conv2d_tf32x3.relayouts)
            out = CT.conv2d_tf32x3(conv, x, pad, relu=relu)
            calls = (CT.conv2d_tf32x3.launches - before[0], CT.conv2d_tf32x3.relayouts - before[1])
            plain = CT.conv2d_tf32x3_plain(conv, x, pad, relu=relu)
            bad = CT._launch(conv, x, relu, fault=CT.FAULTS[fault])
            x64, w64, b64 = x.double(), conv.weight.double(), conv.bias.double()
            ref = F.conv2d(x64, w64, b64, padding=pad)
            ref = F.relu(ref) if relu else ref
            tol = F.conv2d(x64.abs(), w64.abs(), b64.abs(), padding=pad)
            tol.mul_(2 * (k * k * cin + 1) * 2.0**-24)  # the ReLU is 1-Lipschitz
            del x64
        torch.cuda.synchronize()
        if calls != (1, 0) or not out.is_contiguous(memory_format=torch.channels_last):
            raise AssertionError(f"conv_tf32x3: {calls} (launches, copies) a call, or the output "
                                 "is not channels-last")
        diff = (out - plain).abs()
        ratio = (diff.double() / tol).max().item()
        max_err = diff.max().item()
        nz = ref != 0

        def median_rel(y):
            return ((y.double() - ref).abs()[nz] / ref[nz].abs()).median().item()

        med, med_plain = median_rel(out), median_rel(plain)
        bad_ratio = ((bad.double() - ref).abs() / tol).max().item()
        bad_med = median_rel(bad)
        del diff, bad, nz
        line = (f"kernel conv_tf32x3 [{S}x{cin}->{cout} {k}x{k} {side}x{side} channels_last fp32 "
                f"relu={relu}]: vs plain max_abs_err {max_err:.3e}, worst err/tol {ratio:.3e} "
                f"(tol per entry: 2 (taps cin + 1) 2^-24 conv(|x|, |w|) + |b|); median relative "
                f"error vs float64 {med:.3e}, plain {med_plain:.3e} (ratio {med / med_plain:.3f}, "
                f"limit {TF32X3_MEDIAN_RATIO:g}); planted fault {fault}: err/tol {bad_ratio:.3g}, "
                f"median {bad_med:.3e}")
        if not (np.isfinite(ratio) and ratio <= 1.0 and med <= TF32X3_MEDIAN_RATIO * med_plain):
            raise AssertionError("conv_tf32x3 disagrees with its plain version")
        if not (bad_ratio > 1.0 or bad_med > TF32X3_MEDIAN_RATIO * med_plain):
            raise AssertionError(f"conv_tf32x3: the planted fault {fault} passes the check")
        with torch.no_grad():
            ms = median_ms(lambda: CT.conv2d_tf32x3(conv, x, pad, relu=relu), 10)
            plain_ms = median_ms(lambda: CT.conv2d_tf32x3_plain(conv, x, pad, relu=relu), 10)
            lib_ms = median_ms(lambda: F.conv2d(x, conv.weight, conv.bias, padding=pad), 10)
            if side == 148:  # 21 launches on the same inputs: the same bits
                same = all(torch.equal(CT.conv2d_tf32x3(conv, x, pad, relu=relu), out)
                           for _ in range(20))
                line += f"; 21 launches bitwise equal: {same}"
                if not same:
                    raise AssertionError("conv_tf32x3: 21 launches differ")
        flops = 2 * k * k * cin * cout * S * side * side
        nbytes = 4 * (x.numel() + out.numel() + 2 * conv.weight.numel())
        by_ops, by_bytes = flops / PEAK_TF32X3 * 1e3, nbytes / PEAK_BYTES * 1e3
        bnd = (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")
        line += (f" | kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} "
                 f"ms, F.conv2d fp32 {lib_ms:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]})")
        print(line)
        result["errs"].append(max_err)
        result["ms"].append(ms)
        result["plain_ms"].append(plain_ms)
        result["library_ms"].append(lib_ms)
        result["bound"].append(bnd)
        del x, out, plain, ref, tol
        torch.cuda.empty_cache()
    return {"conv_tf32x3": result}


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
        (hbm, "S=8 518 px, 8 ranks, bounded int8", 8, S * P_TOKENS, True, True, False),
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


def _must_raise(what, exc, fn):
    """A planted fault must raise `exc`; loading or running through it fails
    the run."""
    try:
        fn()
    except exc as e:
        print(f"  planted fault {what}: raised {type(e).__name__}: {str(e)[:150]}")
        return e
    raise AssertionError(f"planted fault {what} did not raise {exc.__name__}")


def _state_dicts_equal(label, a, b):
    sa, sb = a.state_dict(), b.state_dict()
    if sa.keys() != sb.keys():
        raise AssertionError(f"{label}: state dict keys differ")
    for k in sa:
        if sa[k].dtype != sb[k].dtype or not torch.equal(sa[k], sb[k]):
            raise AssertionError(f"{label}: {k} differs")
    print(f"  {label}: {len(sa)} tensors bitwise equal")


def _outputs_equal(label, ref, got):
    """True when every output is bitwise equal; else prints the worst
    differences and holds them to the same-answer gate (dense median
    relative error <= 2^-10, the serving gate on pose_enc)."""
    from omnivggt_tpu_torch.models import omnivggt as TM

    keys = ("pose_enc", "depth", "depth_conf", "world_points", "world_points_conf")
    if all(torch.equal(ref[k], got[k]) for k in keys):
        print(f"  {label}: outputs bitwise equal")
        return True
    worst = {k: float((ref[k].float() - got[k].float()).abs().max()) for k in keys}
    readings = TM._probe_readings(*({k: o[k].float().cpu().numpy() for k in TM.PROBE_KEYS}
                                    for o in (ref, got)))
    print(f"  {label}: NOT bitwise; worst |diff| "
          + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
          + "; gate " + ", ".join(f"{k} {v:.3e}" for k, v in readings.items()))
    dense = {k: v for k, v in readings.items() if k != "pose_enc_maxabs"}
    if readings["pose_enc_maxabs"] > POSE_TOL or any(not v <= 2.0**-10 for v in dense.values()):
        raise AssertionError(f"{label}: outside the same-answer gate")
    return False


# the DINOv2 embedder alone, kernel path against plain path, read twice.
# (1) Block by block, on the q, k, v the plain path hands each block's
# attention: the kernel's output and the plain path's (which rounds P and
# o to bf16 once each, as the kernel does) against exact fp32 attention,
# as RMS errors; the kernel's may be at most DINO_BLOCK_FACTOR times the
# plain path's in every block. A fault of the kernel's own precision
# class, its output rounded to DINO_COARSE_BITS mantissa bits instead of
# bf16's 7 (a last rounding 4x coarser), must leave that limit. (2) The
# tokens after 24 blocks, as a median relative error, within sqrt(2) x
# what one bf16 step of noise at every attention block's output (each
# output moved by up to 2^-8 of itself, the largest error of one rounding
# to bf16, uniform in size and sign) moves the plain path by (the errors
# of two independent paths add in quadrature), and never above the
# serving gate's 2e-2. The random-weight blocks amplify any perturbation of
# bf16's size to ~1e-2 there, so (2) holds gross faults (K and V of the
# next head, planted) and (1) the kernel's precision (PERF.md, the DINOv2 reads).
DINO_BLOCK_FACTOR, DINO_COARSE_BITS = 2.0**0.5, 5
DINO_NOISE_FACTOR, DINO_LIMIT_CAP = 2.0**0.5, 2e-2


def dino_kernel_vs_plain(FK, TD, TM, label, vcfg, imgs, dev, card):
    """A DINOv2 of `vcfg` (seeded weights) on the S frames `imgs`: the
    packed kernel's launches (one a block); the kernel against the plain
    path block by block (RMS error against exact fp32 attention, at most
    DINO_BLOCK_FACTOR x the plain path's) and over the whole embedder
    (median relative error of the tokens, at most DINO_NOISE_FACTOR x the
    plain path's own movement under one-bf16-step noise at every attention
    block's output, and DINO_LIMIT_CAP); two planted faults (the kernel's
    output rounded to DINO_COARSE_BITS mantissa bits; K and V of the next
    head) must break the block limit, the second also the whole one.
    Times of both paths."""
    from omnivggt_tpu_torch.ops import attention as A

    with torch.device("meta"):
        vit = TD.DinoVisionTransformer(vcfg)
    vit.to_empty(device=dev)
    TM.init_weights(vit, torch.Generator(device=dev).manual_seed(2))
    hidden_w = (vit.blocks[0].mlp.w3.in_features if vcfg.ffn_layer == "swiglufused"
                else vit.blocks[0].mlp.fc2.in_features)
    if (len(vit.blocks), vcfg.embed_dim) != (24, 1024):
        raise AssertionError(f"{label} DINOv2: {len(vit.blocks)} blocks, width {vcfg.embed_dim}")

    def med_rel(a, b):
        a, b = a.double(), b.double()
        return float(((a - b).abs() / (a.abs() + 1e-3)).median())

    gen = torch.Generator(device=dev)
    gen.manual_seed(3)

    def one_step_noise(module, args, out):
        u = torch.rand(out.shape, generator=gen, device=out.device) * 2 - 1
        return (out.float() * (1 + u * 2.0**-8)).to(out.dtype)

    def coarse(o):  # o rounded to DINO_COARSE_BITS explicit mantissa bits
        m, e = torch.frexp(o.float())  # m in [0.5, 1): one implicit bit
        step = 2.0 ** (DINO_COARSE_BITS + 1)
        return torch.ldexp(torch.round(m * step) / step, e).to(o.dtype)

    real_launch, real_plain = FK._launch_fwd, A.attention_plain
    faults = {
        f"output rounded to {DINO_COARSE_BITS} mantissa bits":
            lambda *a, **kw: coarse(real_launch(*a, **kw)),
        "K/V of the next head": lambda *a, **kw: real_launch(*a, **{**kw, "kv_head_shift": 1}),
    }
    blocks = []  # (q, k, v, kv_valid, o) the plain path's attention of each block

    def recording_plain(q, k, v, kv_valid=None):
        o = real_plain(q, k, v, kv_valid)
        blocks.append((q, k, v, kv_valid, o))
        return o

    def kernel(q, k, v, kv_valid, fault=None):
        FK._launch_fwd = real_launch if fault is None else faults[fault]
        try:
            return A.scaled_dot_product_attention(q, k, v, impl="auto", kv_valid=kv_valid)
        finally:
            FK._launch_fwd = real_launch

    whole_bad, block_ratio = {}, {name: [] for name in (None, *faults)}
    with torch.inference_mode():
        TD.apply(vit, imgs)
        torch.cuda.synchronize()
        FK.reset_launches()
        tok = TD.apply(vit, imgs)
        torch.cuda.synchronize()
        launches = FK.launches()
        A.attention_plain = recording_plain
        try:
            ref = TD.apply(vit, imgs, attn_impl="plain")
        finally:
            A.attention_plain = real_plain
        for q, k, v, kv, o_plain in blocks:
            exact = real_plain(q.float(), k.float(), v.float(), kv)
            plain_rms = float((o_plain.float() - exact).pow(2).mean().sqrt())
            for name in block_ratio:
                o = kernel(q, k, v, kv, name)
                block_ratio[name].append(float((o.float() - exact).pow(2).mean().sqrt())
                                         / plain_rms)
            del exact
        del blocks[:]
        hooks = [blk.attn.register_forward_hook(one_step_noise) for blk in vit.blocks]
        try:
            noisy = TD.apply(vit, imgs, attn_impl="plain")
        finally:
            for h in hooks:
                h.remove()
        for name, launch in faults.items():
            FK._launch_fwd = launch
            try:
                whole_bad[name] = med_rel(ref, TD.apply(vit, imgs))
            finally:
                FK._launch_fwd = real_launch
        kernel_ms = median_ms(lambda: TD.apply(vit, imgs), 5)
        plain_ms = median_ms(lambda: TD.apply(vit, imgs, attn_impl="plain"), 3)
    want = {k: 0 for k in launches}
    want["flash_attention_packed"] = vcfg.depth
    print(f"  {label} DINOv2 (vit_large, {vcfg.ffn_layer}, hidden {hidden_w}), S={S} {IMG}px: "
          f"launches {launches}")
    if launches != want:
        raise AssertionError(f"{label} DINOv2 launches {launches}, expected {want}")
    ratios = {name: max(r) for name, r in block_ratio.items()}
    print(f"  {label} DINOv2 block by block, RMS error against exact fp32 attention over the "
          f"plain path's (bf16 P and o), worst of {len(block_ratio[None])} blocks: kernel "
          f"{ratios[None]:.3f} (median {statistics.median(block_ratio[None]):.3f}; limit "
          f"{DINO_BLOCK_FACTOR:.4f}); planted faults "
          + ", ".join(f"{name} {ratios[name]:.3f} (best block {min(block_ratio[name]):.3f})"
                      for name in faults)
          + " (each must exceed the limit in some block)")
    err, rounding = med_rel(ref, tok), med_rel(ref, noisy)
    limit = min(DINO_NOISE_FACTOR * rounding, DINO_LIMIT_CAP)
    finite = bool(torch.isfinite(tok).all())
    print(f"  {label} DINOv2 tokens, kernel path vs plain: median relative error {err:.3e}, limit "
          f"{limit:.3e} = min({DINO_NOISE_FACTOR:.4f} x {rounding:.3e} (the plain path under one "
          f"bf16 step of noise at every attention output), {DINO_LIMIT_CAP:g}); planted faults "
          + ", ".join(f"{name} {v:.3e} ({v / limit:.2f}x the limit)" for name, v in whole_bad.items())
          + f" (K/V of the next head must exceed it); finite {finite}; {kernel_ms:.2f} ms, plain "
          f"{plain_ms:.2f} ms; card {card}")
    if not finite or tok.shape != (S, (IMG // 14) ** 2, 1024):
        raise AssertionError(f"{label} DINOv2 kernel path: not finite or misshaped")
    if not ratios[None] <= DINO_BLOCK_FACTOR:
        raise AssertionError(f"{label} DINOv2: the kernel leaves the block limit")
    if not err <= limit:
        raise AssertionError(f"{label} DINOv2 kernel path fails against the plain path")
    for name in faults:
        if not ratios[name] > DINO_BLOCK_FACTOR:
            raise AssertionError(f"{label} DINOv2: the planted fault ({name}) passes the "
                                 "block limit")
    if not whole_bad["K/V of the next head"] > limit:
        raise AssertionError(f"{label} DINOv2: K/V of the next head passes the limit")
    del vit, tok, ref, noisy
    torch.cuda.empty_cache()


def checkpoint_phase(FK, cfg, dev, card, inputs, fwd_ms, expect):
    """(g) Checkpoints and the library surface on the card, after phase 5:
    save_pretrained / from_pretrained and the reference layout with the
    port's own safetensors I/O (the safetensors and huggingface_hub
    packages made unimportable for the phase), bitwise round trips and
    forwards, planted faults (a tensor dropped, a truncated file), TF32
    under torch's defaults (the forward's guard, the inference CLI, the
    guard bypassed as a planted fault: the TF32 heads' deltas), validation
    (guard_predictions, enable_nan_debugging), profiling (profile_forward,
    achieved TFLOP/s), and the DINOv2 embedder alone at full width in its
    GELU (the flagship's) and SwiGLU forms (dino_kernel_vs_plain). Frees
    what it builds."""
    import contextlib
    import shutil
    import tempfile

    from omnivggt_tpu_torch.checkpoint import cast_trunk_params, write_safetensors
    from omnivggt_tpu_torch.config import vit_large
    from omnivggt_tpu_torch.models import aggregator as TA
    from omnivggt_tpu_torch.models import dinov2 as TD
    from omnivggt_tpu_torch.models import omnivggt as TM
    from omnivggt_tpu_torch.tools import convert_checkpoint, profile_forward
    from omnivggt_tpu_torch.utils import platform as TPl
    from omnivggt_tpu_torch.utils.profiling import flops_estimate
    from omnivggt_tpu_torch.utils.validation import enable_nan_debugging, guard_predictions

    print(f"(g) checkpoints and the library surface; card {card}")
    # 1. no package needed: the port reads and writes safetensors itself
    hidden = {name: sys.modules.get(name) for name in ("safetensors", "huggingface_hub")}
    for name in hidden:
        sys.modules[name] = None
    tmp = tempfile.mkdtemp(prefix="omnivggt_ckpt_")
    try:
        # 2. checkpoint round trip on the card
        model = TM.OmniVGGT(cfg, device=dev, seed=0)
        gen = torch.Generator(device=dev)
        gen.manual_seed(1)
        with torch.no_grad():
            model.aggregator.camera_token.normal_(generator=gen)  # as phase 5 draws it
        model.eval()
        native = os.path.join(tmp, "native")
        t0 = time.perf_counter()
        model.save_pretrained(native)
        save_s = time.perf_counter() - t0
        size_gb = os.path.getsize(os.path.join(native, TM.WEIGHTS_NAME)) / 1e9
        print(f"  save_pretrained: model.safetensors {size_gb:.3f} GB in {save_s:.2f} s "
              f"({size_gb / save_s:.2f} GB/s); card {card}")
        loaded = {}
        for head_dtype in ("keep", "float32"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loaded[head_dtype] = TM.OmniVGGT.from_pretrained(native, head_dtype=head_dtype,
                                                             device=dev).eval()
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            print(f"  from_pretrained(head_dtype={head_dtype!r}): {load_s:.2f} s "
                  f"({size_gb / load_s:.2f} GB/s)")
            _state_dicts_equal(f"from_pretrained({head_dtype!r}) vs the saved model",
                               loaded[head_dtype], model)
        shutil.rmtree(native)
        original, restored, fp32 = model, loaded["keep"], loaded["float32"]
        del model, loaded
        cast_trunk_params(original)
        cast_trunk_params(restored)
        with torch.inference_mode():
            out_orig = original(**inputs)
            FK.reset_launches()
            out_rest = restored(**inputs)
            torch.cuda.synchronize()
            launches = FK.launches()
        print(f"  launches per forward of the loaded model: {launches}")
        if launches != expect:
            raise AssertionError(f"kernel launches {launches}, expected {expect}")
        roundtrip_bitwise = _outputs_equal(f"S={S} forward, loaded vs original", out_orig, out_rest)

        # 3. the reference layout: one file, read back, converted, faults
        ref_path = os.path.join(tmp, "reference.safetensors")
        sd = fp32.state_dict()
        t0 = time.perf_counter()
        write_safetensors(ref_path, sd)
        print(f"  write_safetensors (reference layout): {os.path.getsize(ref_path) / 1e9:.3f} GB "
              f"in {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        m = TM.OmniVGGT.from_safetensors(ref_path, head_dtype="float32", device=dev)
        torch.cuda.synchronize()
        print(f"  from_safetensors: {time.perf_counter() - t0:.2f} s")
        _state_dicts_equal("from_safetensors vs the saved model", m, fp32)
        del m
        converted = os.path.join(tmp, "converted")
        convert_checkpoint.main([ref_path, converted, "--head_dtype", "float32"])
        m = TM.OmniVGGT.from_pretrained(converted, device=dev)
        _state_dicts_equal("convert_checkpoint -> from_pretrained vs the saved model", m, fp32)
        del m
        shutil.rmtree(converted)
        dropped = os.path.join(tmp, "dropped.safetensors")
        gone = "depth_head.scratch.output_conv1.weight"
        write_safetensors(dropped, {k: v for k, v in sd.items() if k != gone})
        _must_raise(f"{gone} dropped from the file", RuntimeError,
                    lambda: TM.OmniVGGT.from_safetensors(dropped, head_dtype="float32", device=dev))
        os.remove(dropped)
        os.truncate(ref_path, os.path.getsize(ref_path) - (1 << 20))
        _must_raise("the file truncated by 1 MB", ValueError,
                    lambda: TM.OmniVGGT.from_safetensors(ref_path, head_dtype="float32", device=dev))
        os.remove(ref_path)
        del sd, fp32
        torch.cuda.empty_cache()

        # 4. TF32 under torch's defaults (matmul off, cuDNN on)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = True
        try:
            print(f"  TF32 switches set to torch's defaults: {TPl.tf32_switches()}")
            with torch.inference_mode():
                out_tf32 = restored(**inputs)
                _outputs_equal(f"S={S} forward under torch's TF32 defaults vs step 2", out_rest, out_tf32)
                guard, TM.exact_fp32 = TM.exact_fp32, contextlib.nullcontext
                try:
                    out_bypass = restored(**inputs)  # planted fault: the heads' guard bypassed
                finally:
                    TM.exact_fp32 = guard
            if all(torch.equal(out_rest[k], out_bypass[k]) for k in ("depth", "world_points")):
                raise AssertionError("the forward without its TF32 guard equals the guarded one")
            readings = TM._probe_readings(*({k: o[k].float().cpu().numpy() for k in TM.PROBE_KEYS}
                                            for o in (out_rest, out_bypass)))
            worst = {k: float((out_rest[k] - out_bypass[k]).abs().max())
                     for k in ("pose_enc", "depth", "world_points", "depth_conf")}
            print("  planted fault, the forward's TF32 guard bypassed (TF32 heads): worst |diff| "
                  + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
                  + "; serving gate readings " + ", ".join(f"{k} {v:.3e}" for k, v in readings.items())
                  + f" (limits {POSE_TOL:g} / {REL_TOL:g}); card {card}")
            del out_tf32, out_bypass
            from omnivggt_tpu_torch import inference
            from omnivggt_tpu_torch.data import loader

            def synthetic_folder(*args, **kwargs):  # reading a folder needs PIL
                n = 2
                return (inputs["images"][:n].cpu().numpy(), np.zeros((1, n, 3, 4), np.float32),
                        np.zeros((1, n, 3, 3), np.float32),
                        np.zeros((1, n, IMG, IMG, 1), np.float32),
                        np.zeros((1, n, IMG, IMG), np.float32), [], [])

            real_loader = loader.load_images_and_cameras
            loader.load_images_and_cameras = synthetic_folder
            try:
                preds = inference.main(["--image_folder", tmp, "--no_viewer", "--device", "cuda"])
            finally:
                loader.load_images_and_cameras = real_loader
            if not all(np.isfinite(preds[k]).all() for k in ("depth", "world_points")):
                raise AssertionError("the inference CLI's outputs are not finite")
            print(f"  inference CLI (--device cuda, random weights) left the TF32 switches "
                  f"{TPl.tf32_switches()}")
            if TPl.tf32_switches() != (False, False):
                raise AssertionError("the inference CLI left TF32 on")
            del preds
        finally:
            TPl.set_tf32(False)  # chip_smoke's own mode
        gc.collect()
        torch.cuda.empty_cache()

        # 5. validation
        problems = guard_predictions(out_rest)
        print(f"  guard_predictions on the S={S} outputs: {problems}")
        if problems:
            raise AssertionError(f"guard_predictions: {problems}")
        w = restored.depth_head.scratch.output_conv2[2].weight
        kept = w.detach().clone()
        with torch.no_grad():
            w[0, 0, 0, 0] = float("nan")
        with torch.inference_mode():
            problems = guard_predictions(restored(**inputs))
        with torch.no_grad():
            w.copy_(kept)
        print(f"  guard_predictions with a NaN in depth_head.scratch.output_conv2.2.weight: {problems}")
        if not any(p.startswith("depth:") for p in problems) or any(
                p.startswith(("world_points", "pose_enc")) for p in problems):
            raise AssertionError(f"the NaN in the depth head was reported as {problems}")
        from torch.nn.modules import module as nn_module

        block = restored.aggregator.frame_blocks[3]
        w = block.attn.proj.weight
        kept = w.detach().clone()
        with torch.no_grad():
            w[0, 0] = float("nan")
        n_hooks = len(nn_module._global_forward_hooks)
        enable_nan_debugging()
        try:
            with torch.inference_mode():
                err = _must_raise("a NaN in frame block 3's attn.proj.weight under "
                                  "enable_nan_debugging()", FloatingPointError,
                                  lambda: restored(**inputs))
            hooks_on = len(nn_module._global_forward_hooks)
        finally:
            enable_nan_debugging(False)
            with torch.no_grad():
                w.copy_(kept)
        hooks_off = len(nn_module._global_forward_hooks)
        in_block = any(err.module is mod for mod in block.modules())
        print(f"  raised at a module of frame block 3: {in_block} "
              f"({type(err.module).__name__}); global forward hooks {n_hooks} -> {hooks_on} -> "
              f"{hooks_off}")
        if not in_block or hooks_on != n_hooks + 1 or hooks_off != n_hooks:
            raise AssertionError("enable_nan_debugging did not stop at frame block 3 or left its hook")
        del original, restored, out_orig, out_rest, block, w, kept, err
        gc.collect()
        torch.cuda.empty_cache()

        # 6. profiling
        logdir = os.path.join(tmp, "trace")
        prof = profile_forward.main(["--views", str(S), "--logdir", logdir])
        with open(os.path.join(logdir, "trace.json")) as f:
            events = json.load(f)["traceEvents"]
        n_kernels = sum(1 for e in events if e.get("cat") == "kernel")
        print(f"  trace {os.path.getsize(os.path.join(logdir, 'trace.json')) / 1e6:.1f} MB, "
              f"{n_kernels} CUDA kernel events")
        if not n_kernels:
            raise AssertionError("the trace holds no CUDA kernel event")
        flops = flops_estimate(cfg, S)
        print(f"  flops_estimate(OmniVGGTConfig(), {S}) = {flops / 1e12:.3f} TFLOP; over phase 5's "
              f"median forward {fwd_ms:.2f} ms: {flops / fwd_ms / 1e9:.2f} TFLOP/s, "
              f"{flops / fwd_ms / 1e9 / (PEAK_FLOPS / 1e12) * 100:.2f}% of 989 TFLOP/s bf16 dense; "
              f"profile_forward's wall {prof['wall_ms']:.2f} ms; card {card}")
        del prof, events
        gc.collect()
        torch.cuda.empty_cache()

        # 7. the DINOv2 embedder alone at full width: the flagship's GELU form
        # and the fused SwiGLU form, kernel path against plain path
        mean = torch.tensor(TA._RESNET_MEAN, device=dev)
        std = torch.tensor(TA._RESNET_STD, device=dev)
        imgs = ((inputs["images"] - mean) / std).to(torch.bfloat16)
        for label, vcfg in (("GELU (the flagship's)", cfg.aggregator.backbone),
                            ("SwiGLU", vit_large(ffn_layer="swiglufused"))):
            dino_kernel_vs_plain(FK, TD, TM, label, vcfg, imgs, dev, card)
        del imgs
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        for name, mod in hidden.items():
            if mod is None:
                del sys.modules[name]
            else:
                sys.modules[name] = mod
    gc.collect()
    torch.cuda.empty_cache()
    print(f"(g) passed: round trip bitwise {roundtrip_bitwise}")


# (i) the seq axis over processes: 4 processes on the one card, one seq rank
# each, through a gloo group and CUDA IPC
SEQ_PROCS = 4
# the first GT camera in seq rank 1's frames (2, 3), the others rebased to
# it in ranks 1-3; depth in ranks 0, 1 and 3, so the scene's mean adds over
# three processes
SEQ_CAMERA_GT, SEQ_DEPTH_GT = [2, 3, 5, 6], [1, 2, 6]
# (wrapper, label, N, int8): the main path's shapes, bounded bf16 and int8
SEQ_RING_CASES = (
    ("ring_flash_attention_hbm", "S=8 518 px, bounded", S * P_TOKENS, False),
    ("ring_flash_attention_hbm", "S=8 518 px, bounded int8", S * P_TOKENS, True),
    ("ring_flash_attention", "S=4 224 px, bounded", 4 * 261, False),
    ("ring_flash_attention", "S=4 224 px, bounded int8", 4 * 261, True),
)
SEQ_FLAGSHIP_CASES = (("allgather", "allgather", False), ("ring_fused", "ring_fused", False),
                      ("ring_fused int8", "ring_fused", True))
SEQ_JOIN_S = 600


def seq_ring_inputs(N, dev):
    """The ring check's inputs (check_ring's draw), the same in every process."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(16)
    H, D = 16, 64
    scale = torch.linspace(2.0, 8.0, H, device=dev)[None, None, :, None]
    q = (torch.randn((1, N, H, D), generator=gen, device=dev) * scale).to(torch.bfloat16)
    k, v = (torch.randn((1, N, H, D), generator=gen, device=dev).to(torch.bfloat16)
            for _ in range(2))
    return q, k, v


def seq_flagship(cfg, dev):
    """Phase 5's model (seed 0, camera token at unit scale, trunk in bf16)."""
    from omnivggt_tpu_torch.checkpoint import cast_trunk_params
    from omnivggt_tpu_torch.models.omnivggt import OmniVGGT

    model = OmniVGGT(cfg, device=dev, seed=0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    with torch.no_grad():
        model.aggregator.camera_token.normal_(generator=gen)
    return cast_trunk_params(model).eval()


def seq_inputs(dev):
    return {**synthetic_inputs(dev), "camera_gt_index": SEQ_CAMERA_GT,
            "depth_gt_index": SEQ_DEPTH_GT}


def seq_session_request():
    """3 frames for bucket 4 (the last seq rank holds the padding frame)."""
    req = request_inputs(3, 43, True)
    req["camera_gt_index"], req["depth_gt_index"] = [1, 2], [0, 2]
    return req


def seq_worker(rank, port, tmp, body=None):
    """One process of phase (i), or of phase (j) with its `body`; exits
    non-zero on any failure."""
    import traceback

    status = 1
    try:
        (body or seq_worker_body)(rank, port, tmp)
        status = 0
    except Exception:
        traceback.print_exc()
    finally:
        # no interpreter teardown: a peer that failed leaves gloo and the
        # IPC mappings to the parent's kill
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(status)


def seq_worker_body(rank, port, tmp):
    import torch.distributed as dist

    from omnivggt_tpu_torch import serving as TS
    from omnivggt_tpu_torch.config import OmniVGGTConfig
    from omnivggt_tpu_torch.models import omnivggt as TM
    from omnivggt_tpu_torch.ops.kernels import flash_attention as FK
    from omnivggt_tpu_torch.ops.kernels import ring_attention as RK
    from omnivggt_tpu_torch.parallel import collectives as C
    from omnivggt_tpu_torch.parallel.mesh import make_mesh, multihost_initialize
    from omnivggt_tpu_torch.parallel.sharding import ModelSharding

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    dev = multihost_initialize(device="cuda", backend="gloo", local_rank=0,
                               init_method=f"tcp://127.0.0.1:{port}", world_size=SEQ_PROCS,
                               rank=rank, timeout=300)
    mesh = make_mesh(data=1, seq=SEQ_PROCS, device=dev)
    if not (mesh.seq_processes and mesh.seq_rank == rank and mesh.peer is not None
            and mesh.local_shape == {"data": 1, "seq": 1}):
        raise AssertionError(f"rank {rank}: the mesh is not a seq-process mesh: {mesh}")
    n, res = SEQ_PROCS, {"rank": rank, "ready_s": time.perf_counter() - t0}

    # 1. the IPC probe: each process writes a pattern into its own symmetric
    # buffer and reads every peer's back; then into its right neighbour's
    # (the ring's direction) and reads what its left neighbour wrote
    probe = mesh.peer.buffer("probe", (1 << 20,), torch.int32)

    def pattern(tag):
        return torch.arange(1 << 20, dtype=torch.int32, device=dev) * 7 + tag * 1000003

    probe.own.copy_(pattern(rank))
    mesh.peer.barrier()
    read = all(torch.equal(probe.view(r), pattern(r)) for r in range(n))
    mesh.peer.barrier()
    probe.view((rank + 1) % n).copy_(pattern(100 + rank))
    mesh.peer.barrier()
    written = torch.equal(probe.own, pattern(100 + (rank - 1) % n))
    mesh.peer.barrier()
    res["ipc"] = {"read_peers": read, "written_by_left": written, "opens": mesh.peer.opens}
    if not (read and written):
        raise AssertionError(f"rank {rank}: the IPC probe failed: {res['ipc']}")

    # 2. kernels 5 and 6 in the process form at the main path's shapes
    class Count:
        launches = 0

    res["ring"] = []
    for i, (name, label, N, int8) in enumerate(SEQ_RING_CASES):
        ref = torch.load(os.path.join(tmp, f"ring_{i}.pt"))
        q, k, v = seq_ring_inputs(N, dev)
        nl = N // n
        own = slice(rank * nl, (rank + 1) * nl)
        ql, kl, vl = (x[:, own].contiguous() for x in (q, k, v))
        v_max = v.float().abs().max()
        del q, k, v
        wrapper = getattr(RK, name)
        chunk = RK.CHUNK_Q if name == "ring_flash_attention" else None

        def run():
            return RK.ring_flash_attention(ql, kl, vl, mesh, "seq", bounded_logits=True,
                                           qk_int8=int8)

        RK.reset_launches()
        out = run()
        launched = RK.launches()
        whole = C.seq_all_gather(out, mesh, 1)
        logical, plain = ref["logical"].to(dev), ref["plain"].to(dev)
        bitwise = torch.equal(whole, logical)
        ratio = float(((whole.float() - logical.float()).abs()
                       / RK.reorder_tolerance(logical, v_max, N)).max())
        err = float((whole.float() - plain).abs().max())
        bad, _ = RK._ring_launch(Count, ql, kl, vl, n, True, int8, chunk_q=chunk,
                                 skip_rotation_at=n - 2 if rank == 0 else -1, mesh=mesh)
        fault = float((C.seq_all_gather(bad, mesh, 1).float() - plain).abs().max())
        again = all([torch.equal(run(), out) for _ in range(3)])  # every process runs 3
        ms = median_ms(run, 5)
        res["ring"].append({"name": name, "label": label, "nl": nl, "launches": launched[name],
                            "bitwise_vs_logical": bitwise, "reorder_ratio": ratio,
                            "err_vs_plain": err, "tol": ref["tol"], "fault_err": fault,
                            "repeat_bitwise": again, "ms": ms})
        del out, whole, logical, plain, bad
        torch.cuda.empty_cache()

    # 3. the flagship at S=8 over the 4 processes, each given the whole request
    cfg = OmniVGGTConfig()
    cfg_q = dataclasses.replace(cfg, attn_quant="int8")
    model = seq_flagship(cfg, dev)
    inputs = seq_inputs(dev)
    depth, dino = cfg.aggregator.depth, cfg.aggregator.backbone.depth
    res["flagship"] = []
    with torch.inference_mode():
        for label, strategy, int8 in SEQ_FLAGSHIP_CASES:
            model.config = cfg_q if int8 else cfg
            sharding = ModelSharding(mesh, strategy)
            model(**inputs, sharding=sharding)  # warm-up
            FK.reset_launches()
            RK.reset_launches()
            preds = model(**inputs, sharding=sharding)
            torch.cuda.synchronize()
            counts = {**FK.launches(), **RK.launches()}
            got = np_outputs(TM, preds)
            ref = dict(np.load(os.path.join(tmp, f"flagship_{label}.npz")))
            readings = TM._probe_readings(ref, got)
            res["flagship"].append({
                "label": label, "launches": {k: c for k, c in counts.items() if c},
                "shapes": {k: list(x.shape) for k, x in got.items()},
                "finite": all(bool(np.isfinite(x).all()) for x in got.values()),
                "bitwise": all(np.array_equal(ref[k], got[k]) for k in ref),
                "readings": readings,
                "serving_gate": not TM._probe_failures(ref, got, POSE_TOL, REL_TOL),
                "ms": median_ms(lambda: model(**inputs, sharding=sharding), 3),
            })
            del preds
        model.config = cfg
        expect_frames = S // n
        res["expected_packed"] = depth + dino
        res["frames"] = expect_frames

        # 4. one bucketed session request: 3 frames in bucket 4 under allgather
        session = TS.InferenceSession(model, buckets=(4,),
                                      sharding=ModelSharding(mesh, "allgather"))
        FK.reset_launches()
        answer = session.infer(**seq_session_request())
        counts = {k: c for k, c in FK.launches().items() if c}
        ref = dict(np.load(os.path.join(tmp, "session.npz")))
        got = {k: answer[k] for k in ref}
        res["session"] = {"launches": counts, "readings": TM._probe_readings(ref, got),
                          "shapes": {k: list(x.shape) for k, x in got.items()},
                          "serving_gate": not TM._probe_failures(ref, got, POSE_TOL, REL_TOL),
                          "served": [list(k) for k in session._served]}
    del model
    mesh.close()
    with open(os.path.join(tmp, f"seq_{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


def run_processes(phase, n, tmp, body=None, join_s=SEQ_JOIN_S) -> float:
    """n processes spawned on a free local port, each seq_worker(rank,
    port, tmp, body), joined within join_s (the rest killed); raises unless
    all exit 0. Returns the seconds they took."""
    import torch.multiprocessing as mp

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=seq_worker, args=(r, port, tmp, body)) for r in range(n)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    deadline = time.monotonic() + join_s
    for p in procs:
        p.join(timeout=max(deadline - time.monotonic(), 1))
    alive = [i for i, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(timeout=30)
    codes = [p.exitcode for p in procs]
    if alive or codes != [0] * n:
        raise AssertionError(f"{phase} seq processes: exit codes {codes}, still running {alive}")
    return time.perf_counter() - t0


def seq_process_phase(cfg, dev, card):
    """(i) The seq axis over processes: references on logical ranks here,
    then SEQ_PROCS spawned processes on this card (seq_worker), each
    one seq rank of make_mesh(data=1, seq=4) over a gloo group: the IPC
    probe, kernels 5 and 6 in the process form, the flagship and a
    bucketed session; every process's readings are held here."""
    import shutil
    import tempfile

    from omnivggt_tpu_torch import serving as TS
    from omnivggt_tpu_torch.models import omnivggt as TM
    from omnivggt_tpu_torch.ops.kernels import ring_attention as RK
    from omnivggt_tpu_torch.parallel.mesh import make_mesh
    from omnivggt_tpu_torch.parallel.sharding import ModelSharding

    t_phase = time.perf_counter()
    n = SEQ_PROCS
    print(f"(i) the seq axis over {n} processes on one card (gloo group + CUDA IPC): time-sliced "
          f"processes on one card measure correctness, not scaling; card {card}")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_seq_")
    logical = make_mesh(data=1, seq=n, device=dev)
    try:
        logical_ms = {}
        for i, (name, label, N, int8) in enumerate(SEQ_RING_CASES):
            q, k, v = seq_ring_inputs(N, dev)
            RK.reset_launches()
            out = RK.ring_flash_attention(q, k, v, logical, "seq", bounded_logits=True,
                                          qk_int8=int8)
            if RK.launches()[name] != 1:
                raise AssertionError(f"(i) logical ring [{label}] went to {RK.launches()}")
            chunk = RK.CHUNK_Q if name == "ring_flash_attention" else None
            plain = RK.ring_attention_plain(*(x.float() for x in (q, k, v)), n, True,
                                            chunk_q=chunk, qk_int8=int8)
            tol = 2.0**-7 * v.float().abs().max().item()
            logical_ms[label] = median_ms(
                lambda: RK.ring_flash_attention(q, k, v, logical, "seq", bounded_logits=True,
                                                qk_int8=int8), 5)
            torch.save({"logical": out.cpu(), "plain": plain.cpu(), "tol": tol},
                       os.path.join(tmp, f"ring_{i}.pt"))
            del q, k, v, out, plain
        model = seq_flagship(cfg, dev)
        inputs = seq_inputs(dev)
        cfg_q = dataclasses.replace(cfg, attn_quant="int8")
        with torch.inference_mode():
            for label, strategy, int8 in SEQ_FLAGSHIP_CASES:
                model.config = cfg_q if int8 else cfg
                sharding = ModelSharding(logical, strategy)
                out = np_outputs(TM, model(**inputs, sharding=sharding))
                logical_ms[label] = median_ms(lambda: model(**inputs, sharding=sharding), 3)
                np.savez(os.path.join(tmp, f"flagship_{label}.npz"), **out)
            model.config = cfg
            session = TS.InferenceSession(model, buckets=(4,),
                                          sharding=ModelSharding(logical, "allgather"))
            answer = session.infer(**seq_session_request())
            np.savez(os.path.join(tmp, "session.npz"), **{k: answer[k] for k in TM.PROBE_KEYS})
        del model, inputs, session
        gc.collect()
        torch.cuda.empty_cache()
        ref_s = time.perf_counter() - t_phase

        procs_s = run_processes("(i)", n, tmp)
        got = []
        for r in range(n):
            with open(os.path.join(tmp, f"seq_{r}.json")) as f:
                got.append(json.load(f))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    for r, res in enumerate(got):
        print(f"  seq rank {r}: ready (group, mesh) in {res['ready_s']:.2f} s; IPC probe "
              f"{res['ipc']}")
        if not (res["ipc"]["read_peers"] and res["ipc"]["written_by_left"]):
            raise AssertionError(f"(i) IPC probe failed in rank {r}")
    frames, packed = got[0]["frames"], got[0]["expected_packed"]
    for i, (name, label, N, int8) in enumerate(SEQ_RING_CASES):
        rows = [res["ring"][i] for res in got]
        c = rows[0]
        print(f"kernel {name} process form [{label}] q(1, {N}, 16, 64) over {n} processes, nl "
              f"{c['nl']}: launches a process {[x['launches'] for x in rows]}; gathered "
              f"output bitwise equal to the logical form: {all(x['bitwise_vs_logical'] for x in rows)} "
              f"(worst err/RK.reorder_tolerance {max(x['reorder_ratio'] for x in rows):.3f}); "
              f"max_abs_err vs ring_attention_plain {c['err_vs_plain']:.3e} tol {c['tol']:.3e}; "
              f"planted fault (rank 0's rotation at step {n - 2} left out) "
              f"{c['fault_err']:.3e}; repeats bitwise {all(x['repeat_bitwise'] for x in rows)}; "
              f"wrapper ms per process (median of 5 CUDA events) "
              f"{[round(x['ms'], 3) for x in rows]} beside the logical form's "
              f"{logical_ms[label]:.3f} ms in one process; card {card}")
        for x in rows:
            same = x["bitwise_vs_logical"] or (not int8 and x["reorder_ratio"] <= 1.0)
            if x["launches"] != 1 or not same or not x["repeat_bitwise"]:
                raise AssertionError(f"(i) {name} [{label}] process form: {x}")
            if not x["err_vs_plain"] <= x["tol"] or not x["fault_err"] > x["tol"]:
                raise AssertionError(f"(i) {name} [{label}]: against its plain version {x}")
    for i, (label, strategy, int8) in enumerate(SEQ_FLAGSHIP_CASES):
        rows = [res["flagship"][i] for res in got]
        want = {"flash_attention_packed": packed}
        want["flash_attention" if strategy == "allgather" else "ring_flash_attention_hbm"] = \
            cfg.aggregator.depth
        print(f"(i) flagship S={S} {IMG}px [{label}] over {n} processes ({frames} frames each): "
              f"launches a process {rows[0]['launches']} (want {want}); bitwise equal to the "
              f"logical forward: {[x['bitwise'] for x in rows]}; worst readings against it "
              + ", ".join(f"{k} {max(x['readings'][k] for x in rows):.3e}" for k in rows[0]["readings"])
              + f" (same answer: dense median relative <= 2^-10, pose <= {POSE_TOL:g}); "
              f"forward ms per process {[round(x['ms'], 2) for x in rows]} beside "
              f"{logical_ms[label]:.2f} ms on {n} logical ranks in one process; card {card}")
        for x in rows:
            dense_ok = all(v <= 2.0**-10 for k, v in x["readings"].items()
                           if k != "pose_enc_maxabs")
            shapes_ok = (x["shapes"]["pose_enc"] == [1, S, 9]
                         and x["shapes"]["depth"] == [1, S, IMG, IMG, 1])
            if (x["launches"] != want or not x["finite"] or not shapes_ok or not dense_ok
                    or not x["serving_gate"]):
                raise AssertionError(f"(i) flagship [{label}] over processes: {x}")
    rows = [res["session"] for res in got]
    want = {"flash_attention": cfg.aggregator.depth, "flash_attention_packed": packed}
    print(f"(i) bucketed session over {n} processes [allgather, 3 frames in bucket 4]: launches "
          f"{rows[0]['launches']} (want {want}), served {rows[0]['served']}, worst readings "
          "against the logical-rank session "
          + ", ".join(f"{k} {max(x['readings'][k] for x in rows):.3e}" for k in rows[0]["readings"]))
    for x in rows:
        if (x["launches"] != want or not x["serving_gate"]
                or x["shapes"]["depth"] != [3, IMG, IMG, 1]
                or not all(v <= 2.0**-10 for k, v in x["readings"].items()
                           if k != "pose_enc_maxabs")):
            raise AssertionError(f"(i) bucketed session over processes: {x}")
    print(f"(i) passed in {time.perf_counter() - t_phase:.2f} s (references on logical ranks "
          f"{ref_s:.2f} s, {n} processes {procs_s:.2f} s); card {card}")


# (j) training with the seq axis over processes: 2 processes on the one
# card, one seq rank each, against the same steps on logical ranks here
SEQ_TRAIN_PROCS, J_STEPS = 2, 3
# (label, frames with camera GT): the first valid camera in rank 0's
# frames (0, 1), or in rank 1's (2, 3); depth GT on frames 0 and 3, so the
# depth mean adds over both processes
SEQ_TRAIN_LAYOUTS = (("first camera in rank 0", (1, 2, 3)), ("first camera in rank 1", (2, 3)))
SEQ_TRAIN_DEPTH_GT = (0, 3)
SEQ_TRAIN_FAULTS = ("the gather's backward keeps this process's own gradient",
                    "the gradients left unsummed over the seq group")


def seq_train_batch(cam, dev, frames=S_TRAIN, depth_gt=SEQ_TRAIN_DEPTH_GT):
    """The train phase's batch (seed 3) of `frames` frames with a layout's
    camera GT and depth GT on `depth_gt`."""
    from omnivggt_tpu_torch.train.step import synthetic_batch

    batch = synthetic_batch(frames, IMG, dev, seed=3)
    idx = torch.arange(frames, device=dev)
    cam_mask = torch.isin(idx, torch.tensor(cam, device=dev))
    batch.update(camera_mask=cam_mask, camera_valid=cam_mask,
                 depth_mask=torch.isin(idx, torch.tensor(depth_gt, device=dev)))
    return batch


def seq_train_step(cfg, model, mesh, state_sharding="none"):
    """A fresh layer-decay optimizer on `model` and the allgather train step
    on `mesh` (the phase's settings), the state laid out for
    `state_sharding` on it."""
    from omnivggt_tpu_torch.parallel import fsdp as FS
    from omnivggt_tpu_torch.parallel.sharding import ModelSharding
    from omnivggt_tpu_torch.train.optim import make_finetune_optimizer
    from omnivggt_tpu_torch.train.step import init_state, make_train_step

    model.zero_grad(set_to_none=True)
    opt = make_finetune_optimizer(model, learning_rate=1e-4, warmup_steps=1, total_steps=100)
    step_fn = make_train_step(cfg, opt, ModelSharding(mesh, "allgather"), use_aux_inputs=True,
                              remat=True, state_sharding=state_sharding)
    return FS.shard_state(init_state(model, opt), mesh, state_sharding), step_fn


def seq_step_collectives(cfg, n_params) -> dict:
    """The seq collectives of one step a process, allgather, remat, GT
    cameras and depth: the K and V gathers of every global layer twice
    (the pass and its recomputation) and the camera tokens' once, all
    differentiable; a reduce-scatter for each gather the graph keeps; the
    cameras' gathers (the pose encoding's, the loss's rebase); the depth
    mean's sum, the three counts' and the metrics'; the gradients in
    buckets of collectives.SEQ_BUCKET_ELEMS."""
    from omnivggt_tpu_torch.parallel import collectives as C

    depth = cfg.aggregator.depth
    return {"seq_all_gather": 2, "seq_max": 0, "seq_sum": 5, "seq_gather": 4 * depth + 1,
            "seq_reduce_scatter": 2 * depth + 1,
            "seq_all_reduce": -(-n_params // C.SEQ_BUCKET_ELEMS)}


def tensor_words(t) -> torch.Tensor:
    """The sum of a tensor's int32 words and the sum of each word times its
    position mod 65521 plus 1 (int64, wrapping), taken on its device."""
    w = t.detach().reshape(-1).view(torch.int32).to(torch.int64)
    pos = torch.arange(w.numel(), device=w.device) % 65521 + 1
    return torch.stack([w.sum(), (w * pos).sum()])


def param_checksum(model) -> str:
    """A digest of the parameters' bits: tensor_words of each, hashed on
    the host."""
    import hashlib

    h = hashlib.sha256()
    for name, p in model.named_parameters():
        h.update(name.encode())
        h.update(tensor_words(p).cpu().numpy().tobytes())
    return h.hexdigest()


def trunk_grads(model) -> dict:
    """The trunk's gradients (phase (h)'s: aggregator and DINOv2)."""
    return {n: p.grad.detach() for n, p in model.named_parameters()
            if n.startswith("aggregator.") and p.grad is not None}


def load_mapped(tmp, name) -> dict:
    """A reference file of seq_train_reference, mapped (read as used)."""
    return torch.load(os.path.join(tmp, name), map_location="cpu", mmap=True, weights_only=True)


def reference_gradient_readings(model, tmp, layout) -> dict:
    """gradient_readings of this process's trunk gradients against the
    reference's of `layout`, with the three leaves that hold most of the
    squared difference (name, relative error, share of the difference,
    share of the reference's squared norm) in place of every leaf."""
    ref = load_mapped(tmp, f"grads_{layout}.pt")
    got = trunk_grads(model)
    if set(got) != set(ref):
        raise AssertionError("the trunk's gradients name other tensors than the reference's")
    g = gradient_readings(got, ref)
    diff_sq = sum(d for _, d, _ in g["leaves"]) or 1.0
    g["leaves"] = [[n, (d / b_sq) ** 0.5 if b_sq else float("inf"), d / diff_sq,
                    b_sq / g["ref_norm"] ** 2]
                   for n, d, b_sq in sorted(g["leaves"], key=lambda x: -x[1])[:3]]
    return g


@torch.no_grad()
def camera_residuals(cfg, model, batch, mesh) -> list:
    """The camera loss's L1 residuals at these weights, predicted minus GT
    encoding on the frames with camera GT, (T, frames, 9) as lists: the
    no-grad forward on `mesh` under the step's settings. A residual near 0
    is a term whose sign the two runs of a comparison can read apart."""
    from omnivggt_tpu_torch.models import omnivggt as M
    from omnivggt_tpu_torch.models.aggregator import AuxInputs, masked_normalize_extrinsics
    from omnivggt_tpu_torch.parallel.sharding import ModelSharding
    from omnivggt_tpu_torch.utils import geometry as G

    aux = AuxInputs(**{k: batch[k] for k in ("extrinsics", "intrinsics", "depth", "depth_valid",
                                             "camera_mask", "depth_mask")})
    preds = M.apply(model, batch["images"], cfg, aux, pad_tokens=False,
                    sharding=ModelSharding(mesh, "allgather"))
    valid = batch["camera_valid"]
    gt = G.extri_intri_to_pose_encoding(
        masked_normalize_extrinsics(batch["extrinsics"].float(), valid[None]),
        batch["intrinsics"].float(), (IMG, IMG))
    return (preds["pose_enc_list"][:, 0] - gt[0][None])[:, valid].cpu().tolist()


def seq_train_reference(cfg, dev, tmp, card, n=SEQ_TRAIN_PROCS, layouts=SEQ_TRAIN_LAYOUTS,
                        frames=S_TRAIN, depth_gt=SEQ_TRAIN_DEPTH_GT, steps=J_STEPS,
                        phase="(j)"):
    """The phase's steps on make_mesh(data=1, seq=n) logical ranks here, at
    state none: {layout: metrics, step ms, launches, ||ref - init||^2 after
    the first update and the last}; the trunk's gradients at the init and
    the parameters after the first update and the last step go to files in
    `tmp`."""
    from omnivggt_tpu_torch.ops.kernels import flash_attention as FK
    from omnivggt_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(data=1, seq=n, device=dev)
    model = new_model_for_training(cfg, dev)
    init = {k: v.detach().to("cpu", copy=True) for k, v in model.state_dict().items()}
    refs = {}
    for li, (label, cam) in enumerate(layouts):
        if li:
            model.load_state_dict(init)
        state, step_fn = seq_train_step(cfg, model, mesh)
        batch = seq_train_batch(cam, dev, frames, depth_gt)
        ref = {"history": [], "ms": [], "update_sq": {},
               "residuals": camera_residuals(cfg, model, batch, mesh)}
        torch.cuda.reset_peak_memory_stats()
        for i in range(steps):
            if i == 1:
                FK.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            torch.cuda.synchronize()
            ref["ms"].append((time.perf_counter() - t0) * 1e3)
            if i == 1:
                ref["launches"] = FK.launches()
                ref["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            ref["history"].append({k: v.item() for k, v in metrics.items()})
            if i == 0:
                torch.save({n: g.cpu() for n, g in trunk_grads(model).items()},
                           os.path.join(tmp, f"grads_{li}.pt"))
            if i in (FIRST_UPDATE, steps - 1):
                params = {n: p.detach().cpu() for n, p in model.named_parameters()}
                ref["update_sq"][i] = sum(
                    torch.linalg.vector_norm(p.double() - init[n].double()).item() ** 2
                    for n, p in params.items())
                torch.save(params, os.path.join(tmp, f"params_{li}_{i}.pt"))
                del params
        refs[label] = ref
        print(f"{phase} reference [{label}], {n} logical ranks in one process: steps "
              + "; ".join(", ".join(f"{k} {v:.6f}" for k, v in sorted(m.items()))
                          for m in ref["history"])
              + f"; step ms {[round(t, 2) for t in ref['ms']]}; launches {ref['launches']}; "
              f"peak {ref['peak_gb']:.3f} GB; card {card}")
        del state, step_fn, batch
        gc.collect()
    del model, init
    gc.collect()
    torch.cuda.empty_cache()
    return refs


def seq_train_worker_body(rank, port, tmp):
    import torch.distributed as dist

    from omnivggt_tpu_torch.config import OmniVGGTConfig
    from omnivggt_tpu_torch.ops.kernels import flash_attention as FK
    from omnivggt_tpu_torch.parallel import collectives as C
    from omnivggt_tpu_torch.parallel.mesh import make_mesh, multihost_initialize

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    dev = multihost_initialize(device="cuda", backend="gloo", local_rank=0,
                               init_method=f"tcp://127.0.0.1:{port}",
                               world_size=SEQ_TRAIN_PROCS, rank=rank, timeout=300)
    mesh = make_mesh(data=1, seq=SEQ_TRAIN_PROCS, device=dev)
    if not (mesh.seq_processes and mesh.seq_rank == rank
            and (mesh.peer is not None) == (dev.type == "cuda")):
        raise AssertionError(f"rank {rank}: the mesh is not a seq-process mesh: {mesh}")
    with open(os.path.join(tmp, "reference.json")) as f:
        update_sq = json.load(f)
    cfg = OmniVGGTConfig()
    model = new_model_for_training(cfg, dev)
    init = {k: v.detach().to("cpu", copy=True) for k, v in model.state_dict().items()}
    res = {"rank": rank, "ready_s": time.perf_counter() - t0, "layouts": [], "faults": []}

    sum_ms = []
    sound_sum = C.seq_all_reduce_sum

    def timed_sum(tensors, mesh, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        sound_sum(tensors, mesh, **kw)
        torch.cuda.synchronize()
        sum_ms.append((time.perf_counter() - t) * 1e3)

    C.seq_all_reduce_sum = timed_sum
    for li, (label, cam) in enumerate(SEQ_TRAIN_LAYOUTS):
        if li:
            model.load_state_dict(init)
        state, step_fn = seq_train_step(cfg, model, mesh)
        batch = seq_train_batch(cam, dev)
        out = {"history": [], "ms": [], "checksums": [], "params": {},
               "residuals": camera_residuals(cfg, model, batch, mesh)}
        del sum_ms[:]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for i in range(J_STEPS):
            if i == 1:
                FK.reset_launches()
                C.reset_calls()
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, metrics = step_fn(state, batch)
            torch.cuda.synchronize()
            out["ms"].append((time.perf_counter() - t) * 1e3)
            if i == 1:
                out["launches"], out["calls"] = FK.launches(), C.calls()
            out["history"].append({k: v.item() for k, v in metrics.items()})
            out["checksums"].append(param_checksum(model))
            if i == 0:
                out["grads"] = reference_gradient_readings(model, tmp, li)
            if i in (FIRST_UPDATE, J_STEPS - 1):
                out["params"][i] = param_readings(
                    {n: p.detach() for n, p in model.named_parameters()},
                    load_mapped(tmp, f"params_{li}_{i}.pt"), dev,
                    update_sq=update_sq[str(li)][str(i)])
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out["sum_ms"] = list(sum_ms)
        res["layouts"].append(out)
        del state, step_fn
        gc.collect()
        torch.cuda.empty_cache()
    C.seq_all_reduce_sum = sound_sum
    res["n_params"] = sum(p.numel() for p in model.parameters())

    # the planted faults, each one step from the init on the first layout
    batch = seq_train_batch(SEQ_TRAIN_LAYOUTS[0][1], dev)
    sound_backward = C._SeqGather.backward

    def own_only(ctx, grad):
        part = grad.shape[ctx.dim] // ctx.mesh.seq
        return grad.narrow(ctx.dim, ctx.mesh.seq_rank * part, part).contiguous(), None, None

    for fault in SEQ_TRAIN_FAULTS:
        model.load_state_dict(init)
        state, step_fn = seq_train_step(cfg, model, mesh)
        if fault == SEQ_TRAIN_FAULTS[0]:
            C._SeqGather.backward = staticmethod(own_only)
        else:
            C.seq_all_reduce_sum = lambda tensors, mesh, **kw: None
        try:
            state, metrics = step_fn(state, batch)
        finally:
            C._SeqGather.backward = staticmethod(sound_backward)
            C.seq_all_reduce_sum = sound_sum
        res["faults"].append({"fault": fault, "total": metrics["total"].item(),
                              "grads": reference_gradient_readings(model, tmp, 0)})
        del state, step_fn
    del model
    mesh.close()
    with open(os.path.join(tmp, f"seq_train_{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


def seq_training_phase(cfg, dev, card):
    """(j) Training with the seq axis over processes: the reference on
    logical ranks here (seq_train_reference), then SEQ_TRAIN_PROCS spawned
    processes on this card (seq_train_worker_body), each one seq rank of
    make_mesh(data=1, seq=2) over a gloo group, taking the same steps;
    every process's readings are held here."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    n = SEQ_TRAIN_PROCS
    print(f"(j) training with the seq axis over {n} processes on one card (gloo group + CUDA "
          f"IPC), flagship B=1 S={S_TRAIN} {IMG}px, allgather, remat, {J_STEPS} steps a layout: "
          f"time-sliced processes on one card measure correctness, not scaling; card {card}")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_seq_train_")
    try:
        refs = seq_train_reference(cfg, dev, tmp, card)
        with open(os.path.join(tmp, "reference.json"), "w") as f:
            json.dump({str(li): {str(i): sq for i, sq in refs[label]["update_sq"].items()}
                       for li, (label, _) in enumerate(SEQ_TRAIN_LAYOUTS)}, f)
        ref_s = time.perf_counter() - t_phase
        free, total = torch.cuda.mem_get_info()
        print(f"(j) the card before the spawn: {free / 1e9:.3f} of {total / 1e9:.3f} GB free "
              f"(this process holds {torch.cuda.memory_allocated() / 1e9:.3f} GB); reference "
              f"{ref_s:.2f} s; card {card}")
        procs_s = run_processes("(j)", n, tmp, body=seq_train_worker_body)
        got = []
        for r in range(n):
            with open(os.path.join(tmp, f"seq_train_{r}.json")) as f:
                got.append(json.load(f))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    want_launches = train_step_launches(cfg)
    want_calls = seq_step_collectives(cfg, got[0]["n_params"])
    for r, res in enumerate(got):
        print(f"  seq rank {r}: ready (group, mesh, model) in {res['ready_s']:.2f} s")
    for li, (label, _) in enumerate(SEQ_TRAIN_LAYOUTS):
        ref = refs[label]
        rows = [res["layouts"][li] for res in got]
        for r, x in enumerate(rows):
            print(f"(j) [{label}] seq rank {r}: steps "
                  + "; ".join(", ".join(f"{k} {v:.6f}" for k, v in sorted(m.items()))
                              for m in x["history"])
                  + f"; launches a step {x['launches']} (want {want_launches}); collectives a "
                  f"step {x['calls']}")
        x = rows[0]
        r_ref, r_got = np.asarray(ref["residuals"]), np.asarray(x["residuals"])
        print(f"(j) [{label}] the camera loss's {r_ref.size} L1 terms at the init: smallest "
              f"|residual| {np.abs(r_ref).min():.3e}; seq rank 0's iterates differ from the "
              f"logical ranks' by up to {np.abs(r_got - r_ref).max():.3e}; terms whose sign "
              f"differs {int((np.sign(r_got) != np.sign(r_ref)).sum())}")
        loss_rel = abs(x["history"][0]["total"] - ref["history"][0]["total"]) / abs(
            ref["history"][0]["total"])
        cos = ", ".join(f"{y['grads']['one_minus_cos']:.3e}" for y in rows)
        print(f"(j) [{label}] train gate against the logical ranks: step-1 loss rel "
              f"{loss_rel:.3e} (limit {LOSS_REL_TOL:g}), trunk gradient 1 - cosine a process "
              f"{cos} (limit {1 - GRAD_COS_MIN:.0e}), norms {x['grads']['norm']:.4f} / "
              f"{x['grads']['ref_norm']:.4f}; the leaves holding most of the difference "
              "(relative error, share of the squared difference, share of the squared norm): "
              + "; ".join(f"{n} {e:.3e} {d:.3f} {b:.3e}" for n, e, d, b in x["grads"]["leaves"]))
        for i, limit in ((FIRST_UPDATE, OUTSIDE_MAX), (J_STEPS - 1, FINAL_OUTSIDE_MAX)):
            if not params_pass(f"after step {i}, seq rank 0 vs the logical ranks",
                               x["params"][str(i)], limit):
                raise AssertionError(f"(j) [{label}]: parameters after step {i} differ from "
                                     "the logical ranks'")
        print(f"(j) [{label}] step ms a process {[[round(t, 2) for t in y['ms']] for y in rows]} "
              f"beside {[round(t, 2) for t in ref['ms']]} on 2 logical ranks in one process; "
              f"peak memory a process {[round(y['peak_gb'], 3) for y in rows]} GB; gradient sum "
              f"(seq_all_reduce_sum, {want_calls['seq_all_reduce']} buckets) ms a process "
              f"{[[round(t, 2) for t in y['sum_ms']] for y in rows]}; card {card}")
        if loss_rel > LOSS_REL_TOL or any(y["grads"]["one_minus_cos"] > 1 - GRAD_COS_MIN
                                          for y in rows):
            raise AssertionError(f"(j) [{label}]: the processes' step leaves the train gate")
        for y in rows[1:]:
            if y["history"] != x["history"] or y["checksums"] != x["checksums"]:
                raise AssertionError(f"(j) [{label}]: the processes' metrics or parameters "
                                     "differ from each other")
        for y in rows:
            calls = {k: v for k, v in y["calls"].items() if k.startswith("seq")}
            if y["launches"] != want_launches or calls != want_calls:
                raise AssertionError(f"(j) [{label}]: launches {y['launches']} (want "
                                     f"{want_launches}), collectives {calls} (want {want_calls})")
            if not all(np.isfinite(v) for m in y["history"] for v in m.values()):
                raise AssertionError(f"(j) [{label}]: a loss or grad_norm is not finite")
        print(f"  metrics bitwise equal across the processes, parameter checksums equal after "
              f"every step: {x['checksums'][-1][:16]}...")
    for i, fault in enumerate(SEQ_TRAIN_FAULTS):
        rows = [res["faults"][i] for res in got]
        readings = [y["grads"]["one_minus_cos"] for y in rows]
        print(f"(j) planted fault, {fault}: trunk gradient 1 - cosine a process "
              + ", ".join(f"{v:.3e}" for v in readings) + f" (must exceed {1 - GRAD_COS_MIN:.0e})")
        if not all(v > 1 - GRAD_COS_MIN for v in readings):
            raise AssertionError(f"(j) the train gate passes a planted fault: {fault}")
    print(f"(j) passed in {time.perf_counter() - t_phase:.2f} s (reference on logical ranks "
          f"{ref_s:.2f} s, {n} processes {procs_s:.2f} s); card {card}")


# (k) zero2 and fsdp with the seq axis over processes: 4 flagship processes
# on the one card, one seq rank and one chunk of the sharded state each,
# against 4 logical seq ranks at state none here
K_PROCS, K_FRAMES, K_STEPS = 4, 8, 3
K_MODES = ("zero2", "fsdp")
# (label, frames with camera GT), seq rank r holding frames 2r, 2r + 1: the
# first valid camera in rank 0 and cameras in every rank; depth GT in every
# rank. One layout: how the state is sharded does not depend on where the
# GT cameras sit, and phase (j) crosses the camera rebase with the first
# camera in rank 1
K_LAYOUTS = (("first camera in rank 0", (1, 2, 5, 6)),)
K_DEPTH_GT = (0, 3, 4, 7)
K_FAULTS = ("the seq part of the reduce-scatter left out",
            "the process's own chunk taken at the next index")
# The train gate's limit on 1 - cosine of the trunk's gradients at k seq
# processes, against the same step on k logical ranks in one process.
# The trunk's weight gradients come out of cuBLAS in bf16 (the fp32
# masters are cast at use), so a process's gradient of a weight is the
# partial g_i of its frames rounded to bf16 once, and the processes' sum
# adds k rounded partials, sum (g_i + e_i), where the logical ranks round
# the whole g = sum g_i once (e_0). Round to nearest in bf16 (8 significant
# bits) errs by at most u = 2^-8 of the value, so ||e_i|| <= u ||g_i||; the
# errors of different roundings are independent and of mean 0, so
# E ||sum e_i - e_0||^2 <= u^2 (sum ||g_i||^2 + ||g||^2). 1 - cosine is
# half the squared relative size of the difference's part across g, at
# most ||diff||^2 / (2 ||g||^2). With no process's partial larger than the
# whole in norm (||g_i|| <= ||g||), sum ||g_i||^2 <= k ||g||^2, and
#     1 - cosine <= u^2 (k + 1) / 2 = 2^-17 (k + 1).
# k = 2: 2.289e-5, which phase (j)'s sound readings meet (4.706e-6 with a
# GT camera in both processes, 3.3e-8 with one) and the own-gradient-only
# fault fails (1.084e-4, 4.7x; PERF.md, phase (j)). k = 4: 3.815e-5, 2.8x
# under that fault's 2-process reading; this phase's faults must exceed
# it too. Phases (h) and (j) keep 1e-5.
K_GRAD_LIMIT = 2.0 ** -17 * (K_PROCS + 1)


def sharded_step_collectives(cfg, mode, n) -> dict:
    """The collectives of one step a process under `mode` over n seq
    processes (data 1), allgather, remat, GT cameras and depth: state
    none's seq collectives (seq_step_collectives) with one more seq_sum
    (the global norm's shard squares) and the replicated gradients in
    buckets of collectives.SEQ_BUCKET_ELEMS; a reduce-scatter counted for
    every sharded tensor. zero2: the sharded gradients in flat buckets of
    SEQ_BUCKET_ELEMS / n elements a destination, the update gathered back
    in groups of at most SEQ_BUCKET_ELEMS whole elements (a flat bucket
    each). fsdp: a flat gather a group (parallel/fsdp.py's block groups and
    the rest), twice for the aggregator's frame and global blocks (remat
    recomputes them; DINOv2 is not), and a flat reduce-scatter for each
    group once. Bucket counts follow collectives.state_buckets. The
    meta-device layout gives the groups; nothing runs."""
    from omnivggt_tpu_torch.models.omnivggt import OmniVGGT
    from omnivggt_tpu_torch.parallel import collectives as C
    from omnivggt_tpu_torch.parallel import fsdp as FS
    from omnivggt_tpu_torch.parallel.mesh import Mesh

    model = OmniVGGT(cfg, device="meta", seed=None)
    n_params = sum(p.numel() for p in model.parameters())
    layout = FS.StateLayout(model, Mesh(1, n, torch.device("meta")), mode)
    size = {name: sum(s.numel() for s in shards) for name, shards in layout.shards.items()}
    sharded = list(size)
    depth, bucket = cfg.aggregator.depth, C.SEQ_BUCKET_ELEMS
    calls = {"seq_all_gather": 2, "seq_max": 0, "seq_sum": 6, "seq_gather": 4 * depth + 1,
             "seq_reduce_scatter": 2 * depth + 1,
             "seq_all_reduce": -(-(n_params - sum(size.values())) // bucket),
             "reduce_scatter": len(sharded)}

    def gathers(names):
        return len(C.state_buckets([size[x] // n for x in names], bucket))

    def scatters(names):
        return len(C.state_buckets([size[x] // n for x in names], bucket // n))

    if mode == "zero2":
        sizes = [size[x] for x in sharded]
        groups = [[sharded[i] for i, _ in members]
                  for members, _ in C.state_buckets(sizes, max(sizes + [bucket]))]
        calls.update(all_gather=len(sharded), state_seq_scatter=scatters(sharded),
                     state_seq_gather=sum(gathers(g) for g in groups))
    else:
        groups = {**layout.block_groups, "rest": layout.rest}

        def uses(group):
            return 2 if group.startswith(("aggregator.frame_blocks.",
                                          "aggregator.global_blocks.")) else 1

        calls.update(
            all_gather=sum(len(names) * uses(g) for g, names in groups.items()),
            state_seq_gather=sum(gathers(names) * uses(g) for g, names in groups.items() if names),
            state_seq_scatter=sum(scatters(names) for names in groups.values() if names))
    return calls


def step_barriers(calls) -> int:
    """Peer-memory barriers of a step's counted collectives: two a seq
    collective or bucket."""
    return 2 * sum(v for k, v in calls.items() if k.startswith(("seq_", "state_seq_")))


def whole_param_checksum(state) -> str:
    """param_checksum of the whole parameters: under fsdp the sharded ones
    gathered in groups of at most collectives.SEQ_BUCKET_ELEMS elements,
    one flat collective each (every process calls this)."""
    import hashlib

    from omnivggt_tpu_torch.parallel import collectives as C

    layout, model = state.layout, state.model
    if layout is None or layout.mode != "fsdp":
        return param_checksum(model)
    sums = {n: tensor_words(p) for n, p in model.named_parameters() if n not in layout.specs}
    sharded = [n for n, _ in model.named_parameters() if n in layout.specs]
    sizes = [layout.shards[n][0].numel() * layout.mesh.size for n in sharded]
    for members, _ in C.state_buckets(sizes, max(sizes + [C.SEQ_BUCKET_ELEMS])):
        group = [sharded[i] for i, _ in members]
        fulls = C.all_gather_many([layout.shards[n] for n in group], layout.mesh,
                                  [layout.specs[n] for n in group])
        for n, full in zip(group, fulls):
            sums[n] = tensor_words(full)
        del fulls
    h = hashlib.sha256()
    for n, _ in model.named_parameters():
        h.update(n.encode())
        h.update(sums[n].cpu().numpy().tobytes())
    return h.hexdigest()


def process_parts(state, mesh, ref, grads):
    """(this process's part of each tensor of `ref`, the same part of
    ref's): a sharded one's chunk (data rank x seq + seq rank, taken from
    the mesh, not from the layout) of the gradient the optimizer stepped
    (`grads`) or of the parameter; a replicated one whole, in seq rank 0
    alone, since every process holds the same, so that the parent's sums
    over the processes are the sums of the whole."""
    layout, slots = state.layout, state.optimizer.slots
    index = mesh.rank * mesh.seq + mesh.seq_rank
    got, want = {}, {}
    for name, r in ref.items():
        t = slots[name][0].grad if grads else slots[name][0].detach()
        if name in layout.specs:
            dim = layout.specs[name]
            n = r.shape[dim] // mesh.size
            got[name], want[name] = t, r.narrow(dim, index * n, n)
        elif mesh.seq_rank == 0:
            got[name], want[name] = t, r
    return got, want


def partial_param_readings(state, mesh, ref, dev) -> dict:
    """param_readings of this process's parts (process_parts), with the
    squared difference in place of the gap (the parent adds them up)."""
    x = param_readings(*process_parts(state, mesh, ref, grads=False), dev, update_sq=1.0)
    x["diff_sq"] = x.pop("gap") ** 2
    return x


def combined_param_readings(parts, update_sq) -> dict:
    """partial_param_readings of every process as param_readings of the whole."""
    return {"bitwise": all(x["bitwise"] for x in parts),
            "outside": sum(x["outside"] for x in parts), "n": sum(x["n"] for x in parts),
            "worst": max(x["worst"] for x in parts),
            "gap": (sum(x["diff_sq"] for x in parts) / update_sq) ** 0.5}


def combined_gradient_readings(parts) -> dict:
    """gradient_sums of every process's parts as gradient_readings of the
    whole, with the three leaves that hold most of the squared difference
    (name, relative error, share of the difference, share of the squared
    norm)."""
    total = {k: sum(x[k] for x in parts) for k in ("dot", "n_k", "n_p")}
    leaves = defaultdict(lambda: [0.0, 0.0])
    for x in parts:
        for name, d, b_sq in x["leaves"]:
            leaves[name][0] += d
            leaves[name][1] += b_sq
    g = readings_of_sums({**total, "leaves": []})
    diff_sq = sum(d for d, _ in leaves.values()) or 1.0
    g["leaves"] = [[n, (d / b_sq) ** 0.5 if b_sq else float("inf"), d / diff_sq,
                    b_sq / g["ref_norm"] ** 2]
                   for n, (d, b_sq) in sorted(leaves.items(), key=lambda kv: -kv[1][0])[:3]]
    return g


def seq_shard_worker_body(rank, port, tmp):
    import torch.distributed as dist

    from omnivggt_tpu_torch.config import OmniVGGTConfig
    from omnivggt_tpu_torch.ops.kernels import flash_attention as FK
    from omnivggt_tpu_torch.parallel import collectives as C
    from omnivggt_tpu_torch.parallel.mesh import Mesh, make_mesh, multihost_initialize

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    with open(os.path.join(tmp, "reference.json")) as f:
        shared = json.load(f)
    on_card = shared["device"] == "cuda"
    dev = multihost_initialize(device=shared["device"], backend="gloo", local_rank=0,
                               init_method=f"tcp://127.0.0.1:{port}", world_size=K_PROCS,
                               rank=rank, timeout=300)
    mesh = make_mesh(data=1, seq=K_PROCS, device=dev)
    if not (mesh.seq_processes and mesh.seq_rank == rank and (mesh.peer is not None) == on_card):
        raise AssertionError(f"rank {rank}: the mesh is not a seq-process mesh: {mesh}")
    cfg = OmniVGGTConfig()
    res = {"rank": rank, "ready_s": time.perf_counter() - t0, "runs": {}, "faults": []}

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def fresh(mode):
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        return seq_train_step(cfg, new_model_for_training(cfg, dev), mesh, mode)

    for mode in K_MODES:
        for li, (label, cam) in enumerate(K_LAYOUTS):
            state, step_fn = fresh(mode)
            batch = seq_train_batch(cam, dev, K_FRAMES, K_DEPTH_GT)
            out = {"history": [], "ms": [], "checksums": [], "params": {}, "card_gb": [],
                   "peak_gb": [], "peak_reserved_gb": []}
            for i in range(K_STEPS):
                if i == 1:
                    FK.reset_launches()
                    C.reset_calls()
                    barriers = mesh.peer.barriers if on_card else 0
                sync()
                if on_card:  # the step's own peak, not the readings' between steps
                    torch.cuda.reset_peak_memory_stats()
                t = time.perf_counter()
                state, metrics = step_fn(state, batch)
                sync()
                out["ms"].append((time.perf_counter() - t) * 1e3)
                out["peak_gb"].append(torch.cuda.max_memory_allocated() / 1e9 if on_card else 0.0)
                out["peak_reserved_gb"].append(
                    torch.cuda.max_memory_reserved() / 1e9 if on_card else 0.0)
                if i == 1:
                    out["launches"], out["calls"] = FK.launches(), C.calls()
                    out["barriers"] = mesh.peer.barriers - barriers if on_card else None
                free, total = torch.cuda.mem_get_info() if on_card else (0, 0)
                out["card_gb"].append((total - free) / 1e9)
                out["history"].append({k: v.item() for k, v in metrics.items()})
                if i == 0:
                    out["grads"] = gradient_sums(*process_parts(
                        state, mesh, load_mapped(tmp, f"grads_{li}.pt"), grads=True))
                    out["state_bytes"] = per_rank_state_bytes(state)
                if i in (FIRST_UPDATE, K_STEPS - 1):
                    out["params"][i] = partial_param_readings(
                        state, mesh, load_mapped(tmp, f"params_{li}_{i}.pt"), dev)
                out["checksums"].append(whole_param_checksum(state))
            out["peak_gb"], out["peak_reserved_gb"] = max(out["peak_gb"]), max(
                out["peak_reserved_gb"])
            out["peer_bytes"] = mesh.peer.nbytes if on_card else 0
            res["runs"][f"{mode} {li}"] = out
            del state, step_fn, batch

    # the planted faults, each one fsdp step from the init on the first layout
    batch = seq_train_batch(K_LAYOUTS[0][1], dev, K_FRAMES, K_DEPTH_GT)
    sound_scatter, sound_ranks = C._seq_scatter_state, Mesh.own_ranks

    def own_part_only(xs, mesh, dims, bucket_elems):
        return [x.narrow(d, mesh.seq_rank * (x.shape[d] // mesh.seq), x.shape[d] // mesh.seq)
                .clone() for x, d in zip(xs, dims)]

    def next_index(m):
        first = (sound_ranks.fget(m).start + 1) % m.size
        return range(first, first + m.local_size)

    for fault in K_FAULTS:
        try:
            if fault == K_FAULTS[0]:
                C._seq_scatter_state = own_part_only
            else:
                Mesh.own_ranks = property(next_index)
            state, step_fn = fresh("fsdp")
            state, metrics = step_fn(state, batch)
        finally:
            C._seq_scatter_state, Mesh.own_ranks = sound_scatter, sound_ranks
        res["faults"].append({"fault": fault, "total": metrics["total"].item(),
                              "grads": gradient_sums(*process_parts(
                                  state, mesh, load_mapped(tmp, "grads_0.pt"), grads=True))})
        del state, step_fn
    mesh.close()
    with open(os.path.join(tmp, f"seq_shard_{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


def seq_sharded_training_phase(cfg, dev, card):
    """(k) zero2 and fsdp with the seq axis over processes: the reference on
    K_PROCS logical seq ranks at state none here (seq_train_reference),
    then K_PROCS spawned processes on this card (seq_shard_worker_body),
    each one seq rank of make_mesh(data=1, seq=4) over a gloo group and
    one chunk of the state, taking the same steps under zero2 and then
    fsdp; every process's readings are held here."""
    import shutil
    import tempfile

    from omnivggt_tpu_torch.models.omnivggt import OmniVGGT
    from omnivggt_tpu_torch.parallel import fsdp as FS
    from omnivggt_tpu_torch.parallel.mesh import Mesh

    t_phase = time.perf_counter()
    n = K_PROCS
    print(f"(k) zero2 and fsdp with the seq axis over {n} processes on one card (gloo group + "
          f"CUDA IPC), flagship B=1 S={K_FRAMES} {IMG}px, allgather, remat, {K_STEPS} steps a "
          f"mode and layout, the state in {n} chunks, one a process: time-sliced processes on "
          f"one card measure correctness and memory, not scaling; card {card}")
    meta = OmniVGGT(cfg, device="meta", seed=None)
    want_bytes = {m: FS.state_bytes_per_device(meta, Mesh(1, n, torch.device("meta")), m)
                  for m in K_MODES}
    want_calls = {m: sharded_step_collectives(cfg, m, n) for m in K_MODES}
    want_launches = train_step_launches(cfg)
    for m in K_MODES:
        print(f"(k) {m}, derived before the run: state {want_bytes[m] / 1e9:.3f} GB a process; "
              f"collectives a process a step {want_calls[m]}; barriers a step "
              f"{step_barriers(want_calls[m])}; launches a step {want_launches}")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_seq_shard_")
    try:
        refs = seq_train_reference(cfg, dev, tmp, card, n=n, layouts=K_LAYOUTS,
                                   frames=K_FRAMES, depth_gt=K_DEPTH_GT, steps=K_STEPS,
                                   phase="(k)")
        with open(os.path.join(tmp, "reference.json"), "w") as f:
            json.dump({"device": dev.type}, f)
        ref_s = time.perf_counter() - t_phase
        free, total = torch.cuda.mem_get_info()
        print(f"(k) the card before the spawn: {free / 1e9:.3f} of {total / 1e9:.3f} GB free "
              f"(this process holds {torch.cuda.memory_allocated() / 1e9:.3f} GB); reference "
              f"{ref_s:.2f} s; card {card}")
        procs_s = run_processes("(k)", n, tmp, body=seq_shard_worker_body)
        got = []
        for r in range(n):
            with open(os.path.join(tmp, f"seq_shard_{r}.json")) as f:
                got.append(json.load(f))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    for r, res in enumerate(got):
        print(f"  seq rank {r}: ready (group, mesh) in {res['ready_s']:.2f} s")
    print(f"(k) train gate limit 1 - cosine <= 2^-17 x ({n} + 1) = {K_GRAD_LIMIT:.3e} "
          f"({n} bf16-rounded partials, derived in K_GRAD_LIMIT's comment)")
    checksums = {}
    for mode in K_MODES:
        for li, (label, _) in enumerate(K_LAYOUTS):
            ref = refs[label]
            rows = [res["runs"][f"{mode} {li}"] for res in got]
            x = rows[0]
            tag = f"(k) {mode} [{label}]"
            for r, y in enumerate(rows):
                print(f"{tag} seq rank {r}: steps "
                      + "; ".join(", ".join(f"{k} {v:.6f}" for k, v in sorted(m.items()))
                                  for m in y["history"])
                      + f"; launches a step {y['launches']}; collectives a step "
                      f"{ {k: v for k, v in y['calls'].items() if v} }; barriers a step "
                      f"{y['barriers']}")
            loss_rel = abs(x["history"][0]["total"] - ref["history"][0]["total"]) / abs(
                ref["history"][0]["total"])
            g = combined_gradient_readings([y["grads"] for y in rows])
            print(f"{tag} train gate against {n} logical ranks at state none: step-1 loss rel "
                  f"{loss_rel:.3e} (limit {LOSS_REL_TOL:g}), trunk gradient 1 - cosine "
                  f"{g['one_minus_cos']:.3e} (limit {K_GRAD_LIMIT:.3e}), norms {g['norm']:.4f} "
                  f"/ {g['ref_norm']:.4f}; the leaves holding most of the difference (relative "
                  "error, share of the squared difference, share of the squared norm): "
                  + "; ".join(f"{nm} {e:.3e} {d:.3f} {b:.3e}" for nm, e, d, b in g["leaves"]))
            if loss_rel > LOSS_REL_TOL or g["one_minus_cos"] > K_GRAD_LIMIT:
                raise AssertionError(f"{tag}: the processes' step leaves the train gate")
            for i, limit in ((FIRST_UPDATE, OUTSIDE_MAX), (K_STEPS - 1, FINAL_OUTSIDE_MAX)):
                readings = combined_param_readings([y["params"][str(i)] for y in rows],
                                                   ref["update_sq"][i])
                if not params_pass(f"{mode} [{label}] after step {i}, the processes' chunks vs "
                                   "the logical ranks", readings, limit):
                    raise AssertionError(f"{tag}: parameters after step {i} differ from the "
                                         "logical ranks'")
            for y in rows[1:]:
                if y["history"] != x["history"] or y["checksums"] != x["checksums"]:
                    raise AssertionError(f"{tag}: the processes' metrics or parameters differ "
                                         "from each other")
            checksums[(mode, li)] = x["checksums"]
            for r, y in enumerate(rows):
                calls = {k: y["calls"][k] for k in want_calls[mode]}
                if y["launches"] != want_launches or calls != want_calls[mode]:
                    raise AssertionError(f"{tag} seq rank {r}: launches {y['launches']} (want "
                                         f"{want_launches}), collectives {calls} (want "
                                         f"{want_calls[mode]})")
                if y["barriers"] != step_barriers(want_calls[mode]):
                    raise AssertionError(f"{tag} seq rank {r}: {y['barriers']} barriers a step, "
                                         f"want {step_barriers(want_calls[mode])}")
                if y["state_bytes"] != want_bytes[mode]:
                    raise AssertionError(f"{tag} seq rank {r}: state {y['state_bytes']} bytes, "
                                         f"state_bytes_per_device {want_bytes[mode]}")
                if not all(np.isfinite(v) for m in y["history"] for v in m.values()):
                    raise AssertionError(f"{tag}: a loss or grad_norm is not finite")
            peaks = [y["peak_gb"] for y in rows]
            print(f"{tag} step ms a process {[[round(t, 2) for t in y['ms']] for y in rows]} "
                  f"beside {[round(t, 2) for t in ref['ms']]} on {n} logical ranks in one process "
                  f"(peak {ref['peak_gb']:.3f} GB); state a process {x['state_bytes'] / 1e9:.3f} "
                  f"GB (= state_bytes_per_device); peak memory a process "
                  f"{[round(v, 3) for v in peaks]} GB, their sum {sum(peaks):.3f} GB (reserved "
                  f"{sum(y['peak_reserved_gb'] for y in rows):.3f}); the card in use after a "
                  f"step, largest reading {max(v for y in rows for v in y['card_gb']):.3f} GB; "
                  f"peer buffers a process {x['peer_bytes'] / 2**20:.1f} MiB; barriers a step "
                  f"{x['barriers']}; card {card}")
            print(f"  metrics bitwise equal across the processes, whole-parameter checksums "
                  f"equal after every step: {x['checksums'][-1][:16]}...")
    for li, (label, _) in enumerate(K_LAYOUTS):
        same = checksums[("zero2", li)] == checksums[("fsdp", li)]
        print(f"(k) [{label}] zero2 and fsdp hold bitwise equal parameters after every step: "
              f"{same}")
    for i, fault in enumerate(K_FAULTS):
        g = combined_gradient_readings([res["faults"][i]["grads"] for res in got])
        print(f"(k) planted fault (fsdp), {fault}: trunk gradient 1 - cosine "
              f"{g['one_minus_cos']:.3e} (must exceed {K_GRAD_LIMIT:.3e})")
        if not g["one_minus_cos"] > K_GRAD_LIMIT:
            raise AssertionError(f"(k) the train gate passes a planted fault: {fault}")
    print(f"(k) passed in {time.perf_counter() - t_phase:.2f} s (reference on logical ranks "
          f"{ref_s:.2f} s, {n} processes {procs_s:.2f} s); card {card}")


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
    from omnivggt_tpu_torch.models import dpt_head as TDH
    from omnivggt_tpu_torch.ops.kernels import conv3x3 as CK
    from omnivggt_tpu_torch.ops.kernels import conv_tf32x3 as CT
    from omnivggt_tpu_torch.ops.kernels import flash_attention as FK
    from omnivggt_tpu_torch.ops.kernels import ring_attention as RK
    from omnivggt_tpu_torch.parallel import peer as PE
    from omnivggt_tpu_torch.tools import probe_layouts as PL
    from omnivggt_tpu_torch.utils.geometry import (
        pose_encoding_to_extri_intri,
        unproject_depth_map_to_point_map,
    )

    t0 = time.perf_counter()
    # every nvcc at once, here before any process is spawned (phase (i))
    logs = build.build_all(FK.SOURCES + (CK.SOURCE, CT.SOURCE, PL.SOURCE, RK.SOURCE, PE.SOURCE))
    FK.load_kernels()
    CK.load_kernels()
    CT.load_kernels()
    RK.load_kernels()
    PE.load_library()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc sm_90a, one process per source: "
          f"{', '.join(sorted(set(SOURCES.values())))}, omnivggt_tpu_torch/csrc/peer.cu)")
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
    tf32x3_build_report(CT, logs[CT.SOURCE])

    kernel_results = check_kernels(FK, dev)
    check_tma_forms(FK, dev)
    kernel_results.update(check_backward(FK, dev))
    kernel_results.update(check_serving_attention(FK, dev))
    kernel_results.update(check_ring(RK, FK, dev))
    kernel_results.update(check_conv(CK, dev))
    kernel_results.update(check_conv_tf32x3(CT, dev))
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
        convs, tc = TDH.conv_counts(), (CT.conv2d_tf32x3.launches, CT.conv2d_tf32x3.relayouts)
        preds = model(**inputs)
        extrinsic, intrinsic = pose_encoding_to_extri_intri(preds["pose_enc"], (IMG, IMG))
        torch.cuda.synchronize()
        launches = FK.launches()
        # the fp32 heads: 28 of each head's 32 convolutions (one chunk of S
        # frames) on the tensor-core kernel, none of its inputs copied
        routes = TDH.conv_counts(since=convs)
        tc = (CT.conv2d_tf32x3.launches - tc[0], CT.conv2d_tf32x3.relayouts - tc[1])
        print(f"main path head convolutions per forward: {routes}; conv_tf32x3 launches, input "
              f"copies {tc}")
        if routes != {"kernel_convs": 56, "library_convs": 8} or tc != (56, 0):
            raise AssertionError(f"head convolution routes {routes}, conv_tf32x3 {tc}: expected "
                                 "28 + 4 a head, 56 launches, no copies")
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

        # the plain path: plain attention, and every head convolution on
        # the library (the kernel's rule forced to refuse them all)
        rule, CT.eligible = CT.eligible, lambda *a, **k: False
        try:
            convs = TDH.conv_counts()
            ref = model(**inputs, attn_impl="plain")
            plain_routes = TDH.conv_counts(since=convs)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model(**inputs, attn_impl="plain")
            torch.cuda.synchronize()
            plain_fwd_ms = (time.perf_counter() - t0) * 1e3
        finally:
            CT.eligible = rule
        print(f"plain path head convolutions per forward: {plain_routes}")
        if plain_routes != {"kernel_convs": 0, "library_convs": 64}:
            raise AssertionError(f"the plain path's head convolutions {plain_routes}: expected "
                                 "all 64 on the library")

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
    checkpoint_phase(FK, cfg, dev, card, inputs, fwd_ms, expect)
    ring_launches = sharded_phase(model, cfg, inputs, dev, card, FK, RK)
    sharded_serving_phase(model, dev, card)
    del inputs
    torch.cuda.empty_cache()
    serving_launches = serving_phase(model, cfg, dev, card, FK, CK)
    ladder_phase(model, cfg)
    del model
    torch.cuda.empty_cache()
    train_launches = train_phase(FK, cfg, dev, card)
    torch.cuda.empty_cache()
    shards_phase(FK, cfg, dev, card)
    torch.cuda.empty_cache()
    sharded_train_phase(FK, cfg, dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    seq_process_phase(cfg, dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    seq_training_phase(cfg, dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    seq_sharded_training_phase(cfg, dev, card)
    # a kernel's launches on the main path that runs it: one train step, or
    # one served S=8 request for the serving kernels; the probes' in their phase
    # the ring wrappers' in the sharded flagship forwards
    path_launches = {**serving_launches, **ring_launches, "layout_probes": probe_launches,
                     "conv_tf32x3": tc[0]}
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
