"""Chip smoke test of the PyTorch port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):
  1. card: prints the card's name and power limit; there must be a CUDA
     device (there is no CPU path here);
  2. build: compiles the Hopper kernels from csrc/ with nvcc;
  3. kernels: each kernel against its plain PyTorch version at the shapes
     the flagship's 518 px, 8-view forward gives it, bf16 inputs, the plain
     version in fp32 from the same inputs; prints errors beside the stated
     tolerance and the median times of both (CUDA events);
  4. backward kernels, at the shapes the flagship's S=4 training step
     gives them (global bounded, frame bounded, DINOv2 running-max), plus
     a dynamic kv_valid and a clamp-saturation case: the forward kernel's
     o and LSE against attention_plain's (the LSE row by row within
     lse_tolerance, from fp32 rounding), then the dq and dk/dv kernels
     against attention_backward_plain given the plain LSE, entry by entry
     within backward_tolerance (bf16 rounding of ds / p and of the
     outputs, fp32 rounding of p and ds), printed beside max |ref| and
     mean |ref|; on the training
     shapes two planted faults (delta = 0, the last key tile skipped)
     must fail those tolerances; times beside the plain version's and
     F.scaled_dot_product_attention's forward+backward (a yardstick only);
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
Bounds (bound_ms) are the larger of the bytes each kernel must move over
3.35 TB/s and its matrix-product FLOPs over 989 TFLOP/s (bf16 dense), the
H100 SXM's published peaks. The line before the last is the kernels' JSON
summary; the last line is {"ok": true, "device": {...}}.

Matmul precision: the heads run fp32, and both TF32 switches are off
(torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 =
False), so fp32 convolutions and matmuls keep full fp32 as in the JAX
package's reference-parity heads.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
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
REPLACES = {
    "flash_attention": "omnivggt_tpu/ops/pallas/flash_attention.py:60",
    "flash_attention_packed": "omnivggt_tpu/ops/pallas/flash_attention.py:764",
    "flash_attention_bwd_dq": "omnivggt_tpu/ops/pallas/flash_attention.py:461",
    "flash_attention_bwd_dkv": "omnivggt_tpu/ops/pallas/flash_attention.py:493",
}
SOURCES = {
    "flash_attention": "omnivggt_tpu_torch/csrc/flash_attention.cu",
    "flash_attention_packed": "omnivggt_tpu_torch/csrc/flash_attention.cu",
    "flash_attention_bwd_dq": "omnivggt_tpu_torch/csrc/flash_attention_bwd.cu",
    "flash_attention_bwd_dkv": "omnivggt_tpu_torch/csrc/flash_attention_bwd.cu",
}
# kernel families of the profiled device time, first match wins
FAMILIES = (
    ("flash_fwd_head_major", ("flash_fwd_head_major",)),
    ("flash_fwd_packed", ("flash_fwd_packed",)),
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


def bound(flops, nbytes):
    """(least ms the card could take, "operations" or "bytes")."""
    by_ops, by_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
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
        torch.cuda.synchronize()
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
            f"plain backward {plain_ms:.3f} ms, sdpa fwd+bwd {lib_ms:.3f} ms"
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
                results[n]["library_ms"].append(lib_ms)
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


def med_rel(a, b, floor=1e-3):
    a, b = a.double(), b.double()
    return ((a - b).abs() / (a.abs() + floor)).median().item()


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs the port on the GPU only", file=sys.stderr)
        return 1
    print(card := card_line())
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")

    from omnivggt_tpu_torch.checkpoint import cast_trunk_params
    from omnivggt_tpu_torch.config import OmniVGGTConfig
    from omnivggt_tpu_torch.models.omnivggt import OmniVGGT
    from omnivggt_tpu_torch.ops.kernels import flash_attention as FK
    from omnivggt_tpu_torch.utils.geometry import (
        pose_encoding_to_extri_intri,
        unproject_depth_map_to_point_map,
    )

    t0 = time.perf_counter()
    log = FK.load_kernels()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc sm_90a, one process per source: "
          f"{', '.join(sorted(set(SOURCES.values())))})")
    for line in log.splitlines():  # ptxas: registers and shared memory per kernel
        if "Compiling entry" in line or "Used" in line:
            print("  " + line.strip())

    kernel_results = check_kernels(FK, dev)
    kernel_results.update(check_backward(FK, dev))

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
                  "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0}
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

    gate = {
        "pose_enc_maxabs": ((preds["pose_enc"] - ref["pose_enc"]).abs().max().item(), POSE_TOL),
        "depth_medrel": (med_rel(ref["depth"], preds["depth"]), REL_TOL),
        "points_medrel": (med_rel(ref["world_points"], preds["world_points"]), REL_TOL),
        "depth_conf_medrel": (med_rel(ref["depth_conf"], preds["depth_conf"]), REL_TOL),
    }
    for key, (val, tol) in gate.items():
        print(f"gate kernel path vs plain path: {key} {val:.3e} (limit {tol:g})")
    failed = [k for k, (val, tol) in gate.items() if not (np.isfinite(val) and val <= tol)]
    if failed:
        raise AssertionError(f"kernel path fails the serving gate: {failed}")

    print(
        f"flagship forward S={S} {IMG}px: {fwd_ms:.2f} ms median of {len(times)} "
        f"({S / fwd_ms * 1e3:.3f} views/s), plain-attention forward {plain_fwd_ms:.2f} ms, "
        f"peak memory {peak_gb:.3f} GB; card {card}"
    )
    del model, preds, ref, inputs
    torch.cuda.empty_cache()
    train_launches = train_phase(FK, cfg, dev, card)

    # per kernel: the largest error over its checked variants; the mean
    # time, bound and library time over the variants the flagship runs;
    # the launches of one train step (the forward path's are printed above)
    summary = {"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": train_launches[name],
            "max_abs_err": max(r["errs"]),
            "ms": statistics.mean(r["ms"]),
            "plain_ms": statistics.mean(r["plain_ms"]),
            "bound_ms": statistics.mean(b for b, _ in r["bound"]),
            "bound_by": r["bound"][0][1],
            "library_ms": statistics.mean(r["library_ms"]),
        }
        for name, r in kernel_results.items()
    ]}
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
