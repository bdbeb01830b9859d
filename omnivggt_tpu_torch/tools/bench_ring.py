"""Times the ring kernels and the sharded flagship forward on one card.

    python3 omnivggt_tpu_torch/tools/bench_ring.py [--tree DIR] [--label NAME]

Imports `omnivggt_tpu_torch` from DIR (default: the checkout this file is
in), so one call on the card can time two trees in turns (A, B, B, A), each
in a process of its own that builds its own kernels. Uses only what both
trees have: the two ring wrappers, `quant_ring` and the ring library's C
entry point (one signature in both), the two bf16 forward wrappers,
`make_mesh`, `ModelSharding`, the model and its `attn_quant` setting.

Measured, on bf16 inputs made from a seed:
  - the bf16 forward kernels whose tile the ring's bf16 forms share: the
    head-major grid at the global attention's (1, 10992, 16, 64), bounded,
    and the token-major grid at frame attention's (8, 1374, 16, 64),
    bounded, and DINOv2's (8, 1376, 16, 64) with 1374 valid keys,
    running-max: medians of 20 calls;
  - the ring wrappers (TPU kernels 5 and 6) at the shapes the main path and
    the checks give them: (1, 10992, 16, 64) over 4 ranks (nl 2748,
    ragged: ring_flash_attention_hbm), bounded and running-max; the same
    over 8 ranks (nl 1374); (1, 16384, 16, 64) over 4 ranks, two 2048-row
    query chunks a rank; (1, 1044, 16, 64) over 4 ranks (nl 261, the S=4
    224 px forward: ring_flash_attention). Each: the median of 20 calls
    (CUDA events), F.scaled_dot_product_attention over the whole unsharded
    sequence on the same inputs (a yardstick only, never called by the
    port) and the bound: 4 N^2 D H bf16 FLOPs over 989 TFLOP/s against the
    bytes (q, k, v read and o written once, plus the rotation: (n - 1)
    shards of K and V read and written once each) over 3.35 TB/s. At nl 261
    also the host's share: the wall time of 20 calls issued back to back
    against the device time of the ring kernels in them (profiler);
  - the int8 form (qk_int8) at the same five shapes: the wrapper (which
    runs quant_ring, plain torch ops, then the kernel) and the kernel alone
    on the int8 grids and table made once, with buffers allocated once
    (the C entry point called directly), both medians of 20, its output
    checked bitwise against the wrapper's; SDPA as above; the bound: one
    int8 product (2 N^2 D H operations over 1,979 TOP/s) and one bf16
    product over 989 TFLOP/s, against the bytes with the rotation in int8;
    at nl 261 the host's share as above;
  - the flagship 1.2B model at S=8, 518 px (seeded weights, camera token
    at unit scale, bf16 trunk): the single-device forward and the forward
    sharded over 4 logical ranks under "ring_fused", medians of 5, and one
    profiled sharded forward: its wall time, its summed kernel time and
    the ring kernels' device time and launches; then the same under
    attn_quant="int8" (the global attention on the int8 ring).
The last line is one JSON object of every number, with the card's name and
power limit. Exit code 1 without a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import torch

PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12  # H100 SXM: bf16 dense, HBM
PEAK_INT8 = 1979e12  # int8 dense
S, IMG, P_TOKENS = 8, 518, 1374


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def _median_ms(fn, reps):
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


def _ring_device_ms(run, calls):
    """(wall ms, summed kernel ms, ring kernels' ms, ring launches) of
    `calls` back-to-back run()s under the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    total = ring = 0.0
    launches = 0
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA or evt.self_device_time_total <= 0:
            continue
        total += evt.self_device_time_total / 1e3
        if "ring_st" in evt.key:  # ring_step, ring_step_tma, ring_stage
            ring += evt.self_device_time_total / 1e3
            launches += evt.count
    return wall, total, ring, launches


def _kernel_alone(RK, q, k, v, n, bounded, chunk):
    """(run, o): run() launches the ring kernel's int8 form once on the
    quant_ring grids of q, k, v, made here once, into buffers allocated
    once, through the library's C entry point (the kernel alone, without
    quant_ring and the wrapper's allocations); o is its output buffer."""
    B, N, H, D = q.shape
    nl = N // n
    q8, k8, v8, table = RK.quant_ring(q, k, v, n, D**-0.5)
    dev = q.device
    o = torch.empty(q.shape, dtype=torch.bfloat16, device=dev)
    rows = -(-chunk // 128) * 128
    slots = [torch.empty((2, 2, B * H, nl, D), dtype=torch.int8, device=dev) for _ in range(n)]
    acc = [torch.empty((B * H, rows, D), dtype=torch.float32, device=dev) for _ in range(n)]
    ml = [torch.empty((2, B * H, rows), dtype=torch.float32, device=dev) for _ in range(n)]
    tables = [RK._pointer_table([x[:, r * nl:(r + 1) * nl] for r in range(n)])
              for x in (q8, k8, v8, o)]
    tables += [RK._pointer_table(x) for x in (slots, acc, ml)]
    c_table = RK._pointer_table(list(table))
    strides = RK._strides(q8, k8, v8, o)
    fn = RK._library()[0]
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run():
        for q0 in range(0, nl, chunk):
            err = fn(int(bounded), D, 1, *tables, c_table, strides, B, H, nl, q0,
                     min(chunk, nl - q0), n, -1, D**-0.5, stream, 0, 0)
            if err:
                raise RuntimeError(f"ring kernel launch failed: cudaError {err}")

    run.buffers = (q8, k8, v8, table, slots, acc, ml)  # alive while run is
    return run, o


def ring_shapes(dev):
    from omnivggt_tpu_torch.ops.kernels import ring_attention as RK
    from omnivggt_tpu_torch.parallel.mesh import make_mesh

    F = torch.nn.functional
    H, D = 16, 64
    shapes = [  # (label, wrapper, ranks, N, bounded)
        ("flagship 4 ranks bounded", "ring_flash_attention_hbm", 4, S * P_TOKENS, True),
        ("flagship 4 ranks running-max", "ring_flash_attention_hbm", 4, S * P_TOKENS, False),
        ("flagship 8 ranks bounded", "ring_flash_attention_hbm", 8, S * P_TOKENS, True),
        ("16384, two chunks a rank, bounded", "ring_flash_attention", 4, 16384, True),
        ("S=4 224 px, nl 261, bounded", "ring_flash_attention", 4, 4 * 261, True),
    ]
    # the bf16 forms first (their inputs as before the int8 rows came), then int8
    cases = [(label, *rest, False) for label, *rest in shapes]
    cases += [(label + " int8", *rest, True) for label, *rest in shapes]
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    out = {}
    for label, name, n, N, bounded, int8 in cases:
        shape = (1, N, H, D)
        scale = torch.linspace(2.0, 8.0, H, device=dev)[None, None, :, None]
        q = (torch.randn(shape, generator=gen, device=dev) * scale).to(torch.bfloat16)
        k, v = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16) for _ in range(2))
        mesh = make_mesh(data=1, seq=n, device=dev)
        wrapper = getattr(RK, name)

        def run():
            return wrapper(q, k, v, mesh, "seq", bounded_logits=bounded, qk_int8=int8)

        RK.reset_launches()
        first = run()
        torch.cuda.synchronize()
        if RK.launches()[name] != 1:
            raise AssertionError(f"{label}: dispatched to {RK.launches()}, expected {name}")
        ms = _median_ms(run, 20)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        sdpa = _median_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), 20)
        products = 2 * H * N * N * D  # one of the two, over all ranks
        esize = 1 if int8 else 2  # the ring buffer's
        nbytes = 2 * H * D * 4 * N + 2 * (n - 1) * 2 * H * D * N * esize
        by_ops = (products / PEAK_FLOPS + products / PEAK_INT8 if int8
                  else 2 * products / PEAK_FLOPS)
        bound = max(by_ops, nbytes / PEAK_BYTES) * 1e3
        row = {"ms": ms, "sdpa_ms": sdpa, "bound_ms": bound, "ranks": n, "N": N}
        line = f"ring [{label}] q{shape} over {n} ranks, nl {N // n} ({name}): "
        timed = run
        if int8:
            chunk = N // n if name == "ring_flash_attention_hbm" else min(RK.CHUNK_Q, N // n)
            alone, o = _kernel_alone(RK, q, k, v, n, bounded, chunk)
            alone()
            torch.cuda.synchronize()
            same = torch.equal(o, first)
            row.update(kernel_ms=_median_ms(alone, 20), kernel_equals_wrapper=same)
            line += (f"kernel alone (grids made once) {row['kernel_ms']:.3f} ms, output bitwise "
                     f"the wrapper's: {same}; wrapper (quant_ring + kernel) ")
            timed = alone
        line += (f"{ms:.3f} ms, sdpa over the whole sequence {sdpa:.3f} ms, bound "
                 f"{bound:.4f} ms")
        if N // n == 261:
            wall, total, ring, launches = _ring_device_ms(timed, 20)
            row.update(host_wall_ms=wall / 20, device_ms=total / 20, ring_device_ms=ring / 20,
                       ring_launches_per_call=launches / 20)
            line += (f"; 20 {'kernel-alone ' if int8 else ''}calls back to back: wall "
                     f"{wall / 20:.3f} ms a call, device time {total / 20:.3f} ms a call (ring "
                     f"kernels {ring / 20:.3f} ms, {launches / 20:.0f} launches)")
        print(line, flush=True)
        out[label] = row
        del q, k, v, qt, kt, vt, first
        torch.cuda.empty_cache()
    return out


def forward_kernels(dev):
    from omnivggt_tpu_torch.ops.kernels import flash_attention as FK

    cases = [  # (label, wrapper, shape, kv_valid, bounded)
        ("head-major global bounded", FK.flash_attention, (1, S * P_TOKENS, 16, 64), None, True),
        ("token-major frame bounded", FK.flash_attention_packed, (S, P_TOKENS, 16, 64), None,
         True),
        ("token-major dino running-max kv 1374", FK.flash_attention_packed, (S, 1376, 16, 64),
         1374, False),
    ]
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    out = {}
    for label, wrapper, shape, kv, bounded in cases:
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
                   for _ in range(3))
        ms = _median_ms(lambda: wrapper(q, k, v, kv_valid=kv, bounded_logits=bounded), 20)
        print(f"forward kernel [{label}] q{shape}: {ms:.3f} ms", flush=True)
        out[label] = ms
    return out


def _inputs(dev):
    """chip_smoke.py's synthetic S=8 scene: images, GT cameras for 4 frames,
    GT depth for 2."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    images = torch.rand((S, IMG, IMG, 3), generator=gen, device=dev)
    extr = torch.zeros((1, S, 3, 4), device=dev)
    extr[..., :3, :3] = torch.eye(3, device=dev)
    extr[..., :3, 3] = torch.randn((1, S, 3), generator=gen, device=dev)
    intr = torch.zeros((1, S, 3, 3), device=dev)
    intr[..., 0, 0] = intr[..., 1, 1] = 500.0
    intr[..., 0, 2] = intr[..., 1, 2] = IMG / 2
    intr[..., 2, 2] = 1.0
    depth = 1.0 + 4.0 * torch.rand((1, S, IMG, IMG, 1), generator=gen, device=dev)
    mask = torch.ones((1, S, IMG, IMG), device=dev)
    return dict(images=images, extrinsics=extr, intrinsics=intr, depth=depth, mask=mask,
                camera_gt_index=[0, 1, 2, 3], depth_gt_index=[0, 1])


def sharded_forward(dev):
    from omnivggt_tpu_torch.checkpoint import cast_trunk_params
    from omnivggt_tpu_torch.config import OmniVGGTConfig
    from omnivggt_tpu_torch.models.omnivggt import OmniVGGT
    from omnivggt_tpu_torch.parallel.mesh import make_mesh
    from omnivggt_tpu_torch.parallel.sharding import ModelSharding

    cfg = OmniVGGTConfig()
    model = OmniVGGT(cfg, device=dev, seed=0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    with torch.no_grad():
        model.aggregator.camera_token.normal_(generator=gen)
    model = cast_trunk_params(model).eval()
    inputs = _inputs(dev)
    sharding = ModelSharding(make_mesh(data=1, seq=4, device=dev), "ring_fused")

    def timed(fn):
        fn()
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    out = {}
    with torch.inference_mode():
        for key, config in (("bf16", cfg), ("int8", dataclasses.replace(cfg, attn_quant="int8"))):
            model.config = config
            single = timed(lambda: model(**inputs))
            sharded = timed(lambda: model(**inputs, sharding=sharding))
            wall, total, ring, launches = _ring_device_ms(
                lambda: model(**inputs, sharding=sharding), 1)
            print(f"flagship forward S={S} {IMG}px, attn_quant {key}: single device "
                  f"{single:.2f} ms, ring_fused over 4 logical ranks {sharded:.2f} ms (medians "
                  f"of 5); profiled sharded forward: wall {wall:.2f} ms, kernels {total:.2f} ms, "
                  f"ring kernels {ring:.2f} ms over {launches} launches", flush=True)
            row = {"single_ms": single, "ring_fused_ms": sharded, "profiled_wall_ms": wall,
                   "profiled_kernel_ms": total, "ring_device_ms": ring, "ring_launches": launches}
            if key == "bf16":
                out.update(row)  # the keys of the bf16 forward as before
            else:
                out["int8"] = row
    return out


def main() -> int:
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=here, help="checkout whose omnivggt_tpu_torch is timed")
    ap.add_argument("--label", default="", help="a name for this run in the output")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device: bench_ring.py times the kernels on the card only", file=sys.stderr)
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
    result = {"label": args.label, "card": card, "forward_kernels": forward_kernels(dev),
              "rings": ring_shapes(dev), "forward": sharded_forward(dev)}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
