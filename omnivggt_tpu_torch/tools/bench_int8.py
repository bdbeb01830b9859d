"""Times the int8-score attention forms and the served int8 request on one card.

    python3 omnivggt_tpu_torch/tools/bench_int8.py [--tree DIR] [--label NAME]

Imports `omnivggt_tpu_torch` from DIR (default: the checkout this file is
in), so one call on the card can time two trees in turns (A, B, B, A), each
in a process of its own that builds its own kernels; the helpers shared
with bench_ring.py come from this file's own directory. Uses only what both
trees have: the two int8 wrappers and `_launch_fwd`, the quantisers, the
model and `InferenceSession`.

Measured, on bf16 inputs made from a seed, at the global attention's
(1, 10992, 16, 64), bounded (q scaled per head from 2 to 8, as in
chip_smoke.py), with a static key axis and a dynamic valid prefix of 6870
keys (5 of 8 frames, a device scalar):
  - the head-major int8 form (`flash_attention(..., qk_int8=True)`,
    TPU kernel 1's qk_int8 form) and the stream int8 form
    (`flash_attention_packed_stream(..., qk_int8=True)`, TPU kernel 7's
    int8 form): the wrapper (the quantisers in torch ops and one launch)
    and the kernel alone on grids made once (`_launch_fwd`), medians of 20
    calls (CUDA events); the bf16 head-major kernel beside them;
  - F.scaled_dot_product_attention on the same bf16 inputs (keys cut to
    the valid prefix; a yardstick only, never called by the port) and the
    bound: the score product's 2 N nk D H int8 operations over 1,979 TOP/s
    plus P V's as many bf16 FLOPs over 989 TFLOP/s, against the bytes (bf16
    q, k, v read and o written once) over 3.35 TB/s;
  - the served S=8, 518 px request (seeded 1.2B flagship, camera token at
    unit scale, bf16 trunk, chip_smoke.py's request with GT cameras for 4
    frames and depth for 2) behind a bucketed `InferenceSession` under
    config (a) (attn_quant = trunk_quant = "int8", bf16 heads, tanh GELU,
    the head-conv kernel on) and config (b) ((a) with the stream flag on):
    medians of 5 requests (host clock, numpy in and out), and one profiled
    request each: its wall time, summed kernel time, the int8 attention
    kernel's device time and launches.
The last line is one JSON object of every number, with the card's name and
power limit. Exit code 1 without a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

if __package__:  # imported as omnivggt_tpu_torch.tools.bench_int8
    from .bench_ring import IMG, P_TOKENS, PEAK_BYTES, PEAK_FLOPS, S, _card, _median_ms
else:  # run as a script: this file's directory is on sys.path
    from bench_ring import IMG, P_TOKENS, PEAK_BYTES, PEAK_FLOPS, S, _card, _median_ms

PEAK_INT8 = 1979e12  # H100 SXM: int8 dense


def _int8_attention(name):
    """A forward kernel with int8 scores: the score form is the kernels'
    last template argument (1 or 2) in both trees' sources."""
    return "flash_fwd_" in name and (", 1>" in name or ", 2>" in name)


def _device_ms(run, match):
    """(wall ms, summed kernel ms, ms and launches of the kernels whose name
    match() accepts) of one run() under the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    total = hit = 0.0
    launches = 0
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA or evt.self_device_time_total <= 0:
            continue
        total += evt.self_device_time_total / 1e3
        if match(evt.key):
            hit += evt.self_device_time_total / 1e3
            launches += evt.count
    return wall, total, hit, launches


def int8_forms(dev):
    from omnivggt_tpu_torch.ops.kernels import flash_attention as FK

    F = torch.nn.functional
    B, N, H, D = shape = (1, S * P_TOKENS, 16, 64)
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    head_scale = torch.linspace(2.0, 8.0, H, device=dev)[None, None, :, None]
    q = (torch.randn(shape, generator=gen, device=dev) * head_scale).to(torch.bfloat16)
    k, v = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16) for _ in range(2))
    out = {}
    for label, kv in (("static", None),
                      ("dynamic 6870", torch.tensor(5 * P_TOKENS, dtype=torch.int32, device=dev))):
        nk = N if kv is None else int(kv)
        q8, q_scale = FK.quant_per_head(q, kv)
        k8, k_scale = FK.quant_per_head(k, kv)
        c = q_scale * k_scale * D**-0.5
        _, qt_scale, q_inv = FK.quant_token_major(q, kv)
        kt8, kt_scale, _ = FK.quant_token_major(k, kv)
        ct = qt_scale * kt_scale * D**-0.5
        runs = {
            "head-major int8": (
                lambda: FK.flash_attention(q, k, v, kv, True, qk_int8=True),
                lambda: FK._launch_fwd(FK.flash_attention_int8, q8, k8, v, kv, True,
                                       FK.MODE_HEAD_MAJOR, qk=FK.SCORES_INT8, c=c)),
            "stream int8": (
                lambda: FK.flash_attention_packed_stream(q, k, v, kv, qk_int8=True),
                lambda: FK._launch_fwd(FK.flash_attention_packed_stream, q, kt8, v, kv, True,
                                       FK.MODE_TOKEN_MAJOR, qk=FK.SCORES_INT8_Q_IN, c=ct,
                                       qinv=q_inv)),
        }
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k[:, :nk], v[:, :nk]))
        sdpa = _median_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), 20)
        bf16 = _median_ms(lambda: FK.flash_attention(q, k, v, kv, True), 20)
        ops = 2 * B * H * N * nk * D  # each of the two products
        nbytes = 2 * B * H * D * (2 * N + 2 * nk)
        bound = max(ops / PEAK_INT8 + ops / PEAK_FLOPS, nbytes / PEAK_BYTES) * 1e3
        for form, (wrapper, kernel) in runs.items():
            row = {"wrapper_ms": _median_ms(wrapper, 20), "kernel_ms": _median_ms(kernel, 20),
                   "sdpa_ms": sdpa, "bound_ms": bound, "bf16_head_major_ms": bf16}
            print(f"{form} [{label}] q{shape} kv {nk}: wrapper {row['wrapper_ms']:.3f} ms, "
                  f"kernel alone {row['kernel_ms']:.3f} ms, sdpa {sdpa:.3f} ms, bound "
                  f"{bound:.4f} ms (operations), bf16 head-major kernel {bf16:.3f} ms", flush=True)
            out[f"{form} {label}"] = row
        del q8, k8, kt8, qt, kt, vt
        torch.cuda.empty_cache()
    return out


def _request(n, seed):
    """chip_smoke.py's served request: n frames at 518 px, GT cameras for 4
    frames and depth for 2, numpy in."""
    rng = np.random.default_rng(seed)
    req = {"images": rng.uniform(size=(n, IMG, IMG, 3)).astype(np.float32)}
    extr = np.tile(np.eye(3, 4, dtype=np.float32), (n, 1, 1))
    extr[:, :3, 3] = rng.normal(size=(n, 3))
    intr = np.tile(np.diag([500.0, 500.0, 1.0]).astype(np.float32), (n, 1, 1))
    intr[:, 0, 2] = intr[:, 1, 2] = IMG / 2
    req.update(extrinsics=extr, intrinsics=intr,
               depth=(1.0 + 4.0 * rng.uniform(size=(n, IMG, IMG, 1))).astype(np.float32),
               mask=np.ones((n, IMG, IMG), np.float32), camera_gt_index=[0, 1, 2, 3],
               depth_gt_index=[0, 1])
    return req


def served(dev):
    from omnivggt_tpu_torch import serving as TS
    from omnivggt_tpu_torch.checkpoint import cast_trunk_params
    from omnivggt_tpu_torch.config import OmniVGGTConfig
    from omnivggt_tpu_torch.models import dpt_head as TDH
    from omnivggt_tpu_torch.models.omnivggt import OmniVGGT
    from omnivggt_tpu_torch.ops import attention as TA

    cfg = OmniVGGTConfig()
    model = OmniVGGT(cfg, device=dev, seed=0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    with torch.no_grad():
        model.aggregator.camera_token.normal_(generator=gen)
    model = cast_trunk_params(model).eval()
    model.config = dataclasses.replace(cfg, attn_quant="int8", trunk_quant="int8",
                                       head_dtype="bfloat16", approx_gelu=True)
    TDH._PALLAS_HEAD_CONVS = True
    session = TS.InferenceSession(model, buckets=(4, 8))
    req = _request(8, 13)
    out = {}
    try:
        for label, stream in (("(a)", False), ("(b) stream flag on", True)):
            TA._STREAM_ATTN = stream
            session.infer(**req)  # warm-up
            times = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                session.infer(**req)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            wall, total, attn, launches = _device_ms(lambda: session.infer(**req), _int8_attention)
            row = {"median_ms": statistics.median(times), "times_ms": times,
                   "profiled_wall_ms": wall, "profiled_kernel_ms": total,
                   "int8_attention_ms": attn, "int8_attention_launches": launches}
            print(f"served S=8 {IMG}px {label}: {row['median_ms']:.2f} ms median of 5 "
                  f"({', '.join(f'{t:.2f}' for t in times)}); profiled request: wall {wall:.2f} "
                  f"ms, kernels {total:.2f} ms, int8 attention kernel {attn:.2f} ms over "
                  f"{launches} launches", flush=True)
            out[label] = row
    finally:
        TA._STREAM_ATTN = False
        TDH._PALLAS_HEAD_CONVS = False
    return out


def main() -> int:
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=here, help="checkout whose omnivggt_tpu_torch is timed")
    ap.add_argument("--label", default="", help="a name for this run in the output")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device: bench_int8.py times the kernels on the card only", file=sys.stderr)
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
    result = {"label": args.label, "card": card, "int8_forms": int8_forms(dev),
              "served": served(dev)}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
