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
  4. flagship forward: the 1.2B OmniVGGTConfig() at S=8, 518x518, seeded
     random weights (trunk stored in bf16), synthetic images with GT
     cameras and depth for some frames, through model(...) with the kernels
     ("auto") and with attn_impl="plain"; checks shapes, finiteness, the
     kernels' launch counts per forward, the pose decoding and depth
     unprojection, and the kernel path against the plain path under the
     serving gate (pose_enc max-abs and median relative errors <= 2e-2).
The line before the last is the kernels' JSON summary; the last line is
{"ok": true, "device": {...}}.

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

import numpy as np
import torch

S, IMG = 8, 518
POSE_TOL = REL_TOL = 2e-2  # the JAX package's serving gate (_probe_failures)
REPLACES = {
    "flash_attention": "omnivggt_tpu/ops/pallas/flash_attention.py:60",
    "flash_attention_packed": "omnivggt_tpu/ops/pallas/flash_attention.py:764",
}
SOURCE = "omnivggt_tpu_torch/csrc/flash_attention.cu"


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
    results = {name: {"errs": [], "ms": [], "plain_ms": []} for name in REPLACES}
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
        print(
            f"kernel {name} [{label}] q{shape} kv_valid={kv}: max_abs_err {max_err:.3e} "
            f"mean_abs_err {mean_err:.3e} tol {tol:.3e} (2^-7 max|v|: bf16 rounding of P "
            f"and of the output) | kernel {ms:.3f} ms, "
            f"plain {plain_ms:.3f} ms"
        )
        if not (np.isfinite(max_err) and max_err <= tol):
            raise AssertionError(f"{name} [{label}] disagrees with its plain version")
        results[name]["errs"].append(max_err)
        if label in on_path:
            results[name]["ms"].append(ms)
            results[name]["plain_ms"].append(plain_ms)
        del q, k, v, out
        torch.cuda.empty_cache()
    return results


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
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc sm_90a, {SOURCE})")
    for line in log.splitlines():  # ptxas: registers and shared memory per kernel
        if "Compiling entry" in line or "Used" in line:
            print("  " + line.strip())

    kernel_results = check_kernels(FK, dev)

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
        FK.flash_attention.launches = FK.flash_attention_packed.launches = 0
        preds = model(**inputs)
        extrinsic, intrinsic = pose_encoding_to_extri_intri(preds["pose_enc"], (IMG, IMG))
        torch.cuda.synchronize()
        launches = {
            "flash_attention": FK.flash_attention.launches,
            "flash_attention_packed": FK.flash_attention_packed.launches,
        }
        points = unproject_depth_map_to_point_map(preds["depth"][0], extrinsic[0], intrinsic[0])
        print(f"main path launches per forward: {launches}")
        expect = {"flash_attention": cfg.aggregator.depth,
                  "flash_attention_packed": cfg.aggregator.depth + cfg.aggregator.backbone.depth}
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
    # per kernel: the largest error over its checked variants, and the mean
    # time over the variants the flagship runs (packed: frame and DINOv2)
    summary = {"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": SOURCE,
            "replaces": REPLACES[name],
            "launches": launches[name],
            "max_abs_err": max(r["errs"]),
            "ms": statistics.mean(r["ms"]),
            "plain_ms": statistics.mean(r["plain_ms"]),
        }
        for name, r in kernel_results.items()
    ]}
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
