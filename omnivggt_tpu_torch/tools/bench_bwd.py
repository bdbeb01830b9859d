"""Times the flash-attention backward kernels and the flagship train step on one card.

    python3 omnivggt_tpu_torch/tools/bench_bwd.py [--tree DIR] [--label NAME]

Imports `omnivggt_tpu_torch` from DIR (default: the checkout this file is
in), so one call on the card can time two trees in turns (A, B, B, A), each
in a process of its own that builds its own kernels; the helpers shared
with bench_ring.py come from this file's own directory. Uses only what both
trees have: the two backward wrappers and `flash_attention_backward`, the
forward's `_launch` (for o and the LSE), the model and the train step.

Measured, on bf16 inputs made from a seed, at the three shapes the S=4,
518 px train step gives the backward (global attention (1, 5496, 16, 64)
bounded; frame attention (4, 1374, 16, 64) bounded; DINOv2 (4, 1376, 16,
64) running-max with 1374 valid keys):
  - the dq kernel alone (`flash_attention_bwd_dq`, TPU kernel 3), the dk/dv
    kernel alone (`flash_attention_bwd_dkv`, TPU kernel 4, from the delta
    the dq kernel wrote) and both (`flash_attention_backward`): medians of
    20 calls (CUDA events around each call: where the wrapper's host time
    exceeds the kernel's, as at the frame shapes, it shows here); and each
    kernel's device time, the mean over 20 calls back to back under the
    profiler;
  - the backward alone of F.scaled_dot_product_attention on the same
    inputs (keys cut to the valid prefix): each rep runs one SDPA forward
    untimed, then CUDA events around its backward, as chip_smoke.py's
    `sdpa_backward_ms` does; a yardstick only, never called by the port;
  - the bounds, with chip_smoke.py's counts: dq 6 N nk D H bf16 FLOPs
    (three products) against q, k, v, o, dO, lse read and dq, delta
    written; dk/dv 8 N nk D H (four products) against q, k, v, dO, lse,
    delta read and dk, dv written; 989 TFLOP/s and 3.35 TB/s;
  - the flagship train step (the 1.2B model, seeded weights, camera token
    at unit scale, fp32 master weights, bf16 trunk, remat on, S=4 at
    518 px, chip_smoke.py's synthetic batch and optimizer): the median of
    4 steps after a warm-up (host clock), and one profiled step: its wall
    time, summed kernel time, and each backward kernel's device time and
    launches.
The last line is one JSON object of every number, with the card's name and
power limit. Exit code 1 without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import torch

if __package__:  # imported as omnivggt_tpu_torch.tools.bench_bwd
    from .bench_ring import IMG, P_TOKENS, PEAK_BYTES, PEAK_FLOPS, _card, _median_ms
else:  # run as a script: this file's directory is on sys.path
    from bench_ring import IMG, P_TOKENS, PEAK_BYTES, PEAK_FLOPS, _card, _median_ms

S_TRAIN = 4
KERNELS = ("flash_bwd_dq", "flash_bwd_dkv")


def _sdpa_backward_ms(q, k, v, kv, do, reps=20):
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


def backward_kernels(dev):
    from omnivggt_tpu_torch.ops.kernels import flash_attention as FK

    cases = [  # (label, shape, kv_valid, bounded)
        ("global bounded", (1, S_TRAIN * P_TOKENS, 16, 64), None, True),
        ("frame bounded", (S_TRAIN, P_TOKENS, 16, 64), None, True),
        ("dino running-max kv 1374", (S_TRAIN, 1376, 16, 64), P_TOKENS, False),
    ]
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    out = {}
    for label, shape, kv, bounded in cases:
        B, N, H, D = shape
        q, k, v, do = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
                       for _ in range(4))
        o, lse = FK._launch(q, k, v, kv, bounded, packed=N <= FK.PACKED_MAX_KEYS, with_lse=True)
        _, delta = FK.flash_attention_bwd_dq(q, k, v, o, do, lse, kv, bounded)
        both = lambda: FK.flash_attention_backward(q, k, v, o, do, lse, kv, bounded)  # noqa: E731
        row = {
            "dq_ms": _median_ms(
                lambda: FK.flash_attention_bwd_dq(q, k, v, o, do, lse, kv, bounded), 20),
            "dkv_ms": _median_ms(
                lambda: FK.flash_attention_bwd_dkv(q, k, v, do, lse, delta, kv, bounded), 20),
            "both_ms": _median_ms(both, 20),
            "sdpa_backward_ms": _sdpa_backward_ms(q, k, v, kv, do),
        }
        both()
        _, _, hits = _profiled(both, 20)
        row.update({f"{name}_device_ms": ms / 20 for name, (ms, _) in hits.items()})
        nk = N if kv is None else kv
        tile = 2 * B * H * D  # bytes of one bf16 token row over all heads
        rows = 4 * B * H * N  # bytes of one fp32 (B, H, N) row vector
        row["dq_bound_ms"] = max(6 * B * H * N * nk * D / PEAK_FLOPS,
                                 (tile * (3 * N + 2 * nk) + 2 * rows) / PEAK_BYTES) * 1e3
        row["dkv_bound_ms"] = max(8 * B * H * N * nk * D / PEAK_FLOPS,
                                  (tile * (2 * N + 4 * nk) + 2 * rows) / PEAK_BYTES) * 1e3
        print(f"backward [{label}] q{shape} kv_valid={kv}: dq {row['dq_ms']:.3f} ms (bound "
              f"{row['dq_bound_ms']:.4f}), dk/dv {row['dkv_ms']:.3f} ms (bound "
              f"{row['dkv_bound_ms']:.4f}), both {row['both_ms']:.3f} ms; device time a call: "
              f"dq {row['flash_bwd_dq_device_ms']:.3f} ms, dk/dv "
              f"{row['flash_bwd_dkv_device_ms']:.3f} ms; sdpa backward alone "
              f"{row['sdpa_backward_ms']:.3f} ms: factor "
              f"{row['both_ms'] / row['sdpa_backward_ms']:.2f}", flush=True)
        out[label] = row
        del q, k, v, do, o, lse, delta
        torch.cuda.empty_cache()
    return out


def _profiled(run, calls=1):
    """(wall ms, summed kernel ms, {kernel: [ms, launches]}) of `calls`
    run()s back to back under the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    total = 0.0
    hits = {name: [0.0, 0] for name in KERNELS}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA or evt.self_device_time_total <= 0:
            continue
        total += evt.self_device_time_total / 1e3
        for name in KERNELS:
            if name in evt.key:
                hits[name][0] += evt.self_device_time_total / 1e3
                hits[name][1] += evt.count
                break
    return wall, total, hits


def train_step(dev):
    from omnivggt_tpu_torch.config import OmniVGGTConfig
    from omnivggt_tpu_torch.models.omnivggt import OmniVGGT
    from omnivggt_tpu_torch.train.optim import make_finetune_optimizer
    from omnivggt_tpu_torch.train.step import init_state, make_train_step, synthetic_batch

    cfg = OmniVGGTConfig()
    model = OmniVGGT(cfg, device=dev, seed=0).train()
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    with torch.no_grad():
        model.aggregator.camera_token.normal_(generator=gen)
    optimizer = make_finetune_optimizer(model, learning_rate=1e-4, warmup_steps=1, total_steps=100)
    step_fn = make_train_step(cfg, optimizer, use_aux_inputs=True, remat=True)
    state = init_state(model, optimizer)
    batch = synthetic_batch(S_TRAIN, IMG, dev, seed=3)
    state, _ = step_fn(state, batch)  # warm-up
    times = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = step_fn(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    wall, total, hits = _profiled(lambda: step_fn(state, batch))
    row = {"median_ms": statistics.median(times), "times_ms": times, "profiled_wall_ms": wall,
           "profiled_kernel_ms": total,
           **{f"{name}_ms": ms for name, (ms, _) in hits.items()},
           **{f"{name}_launches": n for name, (_, n) in hits.items()}}
    print(f"train step S={S_TRAIN} {IMG}px: {row['median_ms']:.2f} ms median of 4 "
          f"({', '.join(f'{t:.2f}' for t in times)}); profiled step: wall {wall:.2f} ms, kernels "
          f"{total:.2f} ms, " + ", ".join(f"{name} {ms:.2f} ms over {n} launches"
                                         for name, (ms, n) in hits.items()), flush=True)
    return row


def main() -> int:
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=here, help="checkout whose omnivggt_tpu_torch is timed")
    ap.add_argument("--label", default="", help="a name for this run in the output")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device: bench_bwd.py times the kernels on the card only", file=sys.stderr)
        return 1
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import omnivggt_tpu_torch

    if not os.path.abspath(omnivggt_tpu_torch.__file__).startswith(tree):
        raise RuntimeError(f"omnivggt_tpu_torch came from {omnivggt_tpu_torch.__file__}, not {tree}")
    card = _card()
    print(f"[{args.label}] tree {tree}; card {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    result = {"label": args.label, "card": card, "backward": backward_kernels(dev),
              "train_step": train_step(dev)}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
