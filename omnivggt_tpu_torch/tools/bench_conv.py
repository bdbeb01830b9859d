"""Times the heads' convolution kernels, the layout probes and the served request on one card.

    python3 omnivggt_tpu_torch/tools/bench_conv.py [--tree DIR] [--label NAME] [--parts ...]

Imports `omnivggt_tpu_torch` from DIR (default: the checkout this file is
in), so one call on the card can time two trees in turns (A, B, B, A), each
in a process of its own that builds its own kernels; the helpers shared
with bench_ring.py and bench_int8.py come from this file's own directory.
A tree without `ops/kernels/conv_tf32x3.py` times the library alone in the
parts that need it. `--parts` picks what runs (default: all of them):

  - `conv3x3`: `conv3x3_folded` (TPU kernel 8) at the heads' (8, 128 ->
    32, 518, 518) + ReLU, bf16 and fp32, on x in channels_last and in NCHW
    (a tree whose kernel needs channels_last copies an NCHW x first,
    inside the call), and where the tree has it, channels_last in with the
    NCHW output (`memory_format`); F.conv2d on the same x in both layouts
    (TF32 off; a yardstick only), and the bound: bf16 the bytes (x read
    once, the output written once) over 3.35 TB/s, fp32 the 2 * 9 * cin *
    cout operations a pixel over 67 TFLOP/s;
  - `probes`: the eleven layout probes (TPU kernel 9): their summed times
    and their torch expressions';
  - `served`: the served S=8, 518 px request (seeded 1.2B flagship, camera
    token at unit scale, bf16 trunk, chip_smoke.py's request) behind a
    bucketed `InferenceSession` under config (a) (attn_quant = trunk_quant
    = "int8", bf16 heads, tanh GELU, the head-conv kernel on): the median
    of 5 requests (host clock, numpy in and out) and one profiled request:
    its wall time, summed kernel time, and the device time and launches of
    the conv kernel, the upsample and the copies-and-casts families, with
    the conv wrapper's launches and relayout copies;
  - `tf32x3`: the fp32 heads' tensor-core kernel `conv2d_tf32x3` (3xTF32;
    the weight split's launch included) at the heads' four main shapes (8
    frames, x channels-last as the heads hand it): 256 -> 256 3x3 at 148
    and 74, 256 -> 128 3x3 at 296 (output_conv1), 128 -> 32 3x3 at 518
    (output_conv2[0]), and its rate in TFLOP/s; F.conv2d fp32 (TF32 off)
    on x channels-last and NCHW, and with TF32 on (one-pass TF32, a
    yardstick only: it fails the fp32 gate); the bounds: the operations
    over 67 TFLOP/s (fp32 FFMA) and over 165 TFLOP/s (TF32's 495 over
    three products);
  - `head`: one flagship fp32 DPT head (seeded) on 8 frames at 518 px
    through `dpt_head.apply`: ms a call with the kernel's routes and with
    every convolution on the library, and the routes taken.
Medians of 10 calls (CUDA events) unless said. The last line is one JSON
object of every number, with the card's name and power limit. Exit code 1
without a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import inspect
import json
import os
import statistics
import sys
import time
from collections import defaultdict

import torch

if __package__:  # imported as omnivggt_tpu_torch.tools.bench_conv
    from .bench_int8 import _request
    from .bench_ring import IMG, PEAK_BYTES, _card, _median_ms
else:  # run as a script: this file's directory is on sys.path
    from bench_int8 import _request
    from bench_ring import IMG, PEAK_BYTES, _card, _median_ms

PEAK_FP32, PEAK_TF32X3 = 67e12, 495e12 / 3  # H100 SXM: FFMA; TF32 dense over three products
SHAPE = (8, 128, 32, IMG, IMG)  # B, cin, cout, H, W: the heads' output_conv2[0]
# kernel families of the profiled request, first match wins
FAMILIES = (("conv3x3 kernel", ("conv3x3_",)), ("upsample / interpolate", ("upsample", "interp")),
            ("copies and casts", ("copy", "cast")))
FRAMES = 8
# (name, cin, cout, side) of the tensor-core kernel's timed shapes
SHAPES = (("rcu 148", 256, 256, 148), ("rcu 74", 256, 256, 74),
          ("output_conv1 296", 256, 128, 296), ("output_conv2[0] 518", 128, 32, IMG))
PARTS = ("conv3x3", "probes", "served", "tf32x3", "head")


def conv_forms(dev):
    from omnivggt_tpu_torch.ops.kernels import conv3x3 as CK

    F = torch.nn.functional
    B, cin, cout, H, W = SHAPE
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    conv = torch.nn.Conv2d(cin, cout, 3, padding=1).to(dev)
    takes_format = "memory_format" in inspect.signature(CK.conv3x3_folded).parameters
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        x_nchw = torch.randn((B, cin, H, W), generator=gen, device=dev).to(dtype)
        x_cl = x_nchw.contiguous(memory_format=torch.channels_last)
        w, b = conv.weight.detach().to(dtype), conv.bias.detach().to(dtype)
        flops = 2 * 9 * cin * cout * B * H * W
        nbytes = x_nchw.element_size() * (x_nchw.numel() + B * cout * H * W)
        bound = (max(nbytes / PEAK_BYTES, flops / PEAK_FP32) if dtype == torch.float32
                 else nbytes / PEAK_BYTES) * 1e3
        name = str(dtype).split(".")[-1]
        row = {"bound_ms": bound}
        with torch.no_grad():
            for layout, x in (("channels_last", x_cl), ("nchw", x_nchw)):
                row[f"kernel_{layout}_ms"] = _median_ms(lambda: CK.conv3x3_folded(conv, x, True), 10)
                row[f"library_{layout}_ms"] = _median_ms(lambda: F.conv2d(x, w, b, padding=1), 10)
            if takes_format:
                row["kernel_channels_last_to_nchw_ms"] = _median_ms(
                    lambda: CK.conv3x3_folded(conv, x_cl, True,
                                              memory_format=torch.contiguous_format), 10)
        print(f"conv3x3_folded {name} {SHAPE[0]}x{cin}->{cout} {H}x{W} + ReLU: "
              + ", ".join(f"{k} {v:.4f}" for k, v in row.items()), flush=True)
        out[name] = row
        del x_nchw, x_cl
        torch.cuda.empty_cache()
    return out


def probes():
    from omnivggt_tpu_torch.tools import probe_layouts as PL

    stats = {}
    lines = []
    ok = PL.run(out=lines.append, stats=stats)
    for line in lines:
        print(line, flush=True)
    return {"all_pass": ok, "ms": stats["ms"], "torch_ms": stats["plain_ms"]}


def _families(run):
    """(wall ms, summed kernel ms, {family: [ms, launches]}) of one run()
    under the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    total, fams = 0.0, defaultdict(lambda: [0.0, 0])
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA or evt.self_device_time_total <= 0:
            continue
        total += evt.self_device_time_total / 1e3
        low = evt.key.lower()
        for fam, keys in FAMILIES:
            if any(k in low for k in keys):
                fams[fam][0] += evt.self_device_time_total / 1e3
                fams[fam][1] += evt.count
                break
    return wall, total, dict(fams)


def served(dev):
    from omnivggt_tpu_torch import serving as TS
    from omnivggt_tpu_torch.checkpoint import cast_trunk_params
    from omnivggt_tpu_torch.config import OmniVGGTConfig
    from omnivggt_tpu_torch.models import dpt_head as TDH
    from omnivggt_tpu_torch.models.omnivggt import OmniVGGT
    from omnivggt_tpu_torch.ops.kernels import conv3x3 as CK

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
    try:
        session = TS.InferenceSession(model, buckets=(4, 8))
        req = _request(8, 13)
        session.infer(**req)  # warm-up
        launches, relayouts = CK.conv3x3_folded.launches, getattr(CK.conv3x3_folded, "relayouts", 0)
        session.infer(**req)
        launches = CK.conv3x3_folded.launches - launches
        relayouts = getattr(CK.conv3x3_folded, "relayouts", 0) - relayouts
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            session.infer(**req)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        wall, total, fams = _families(lambda: session.infer(**req))
    finally:
        TDH._PALLAS_HEAD_CONVS = False
    row = {"median_ms": statistics.median(times), "times_ms": times, "profiled_wall_ms": wall,
           "profiled_kernel_ms": total, "families": fams, "conv_launches": launches,
           "conv_relayouts": relayouts}
    print(f"served S=8 {IMG}px (a): {row['median_ms']:.2f} ms median of 5 "
          f"({', '.join(f'{t:.2f}' for t in times)}); profiled request: wall {wall:.2f} ms, "
          f"kernels {total:.2f} ms; " + ", ".join(f"{k} {v[0]:.3f} ms / {v[1]} launches"
                                                  for k, v in fams.items())
          + f"; conv3x3_folded launches {launches}, relayouts {relayouts}", flush=True)
    return row


def conv_shapes(dev, CT):
    F = torch.nn.functional
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    out = {}
    for name, cin, cout, side in SHAPES:
        conv = torch.nn.Conv2d(cin, cout, 3, padding=1).to(dev).requires_grad_(False)
        x = torch.randn((FRAMES, side, side, cin), generator=gen, device=dev).permute(0, 3, 1, 2)
        x_nchw = x.contiguous()
        w, b = conv.weight, conv.bias
        flops = 2 * 9 * cin * cout * FRAMES * side * side
        row = {"gflop": flops / 1e9, "bound_fp32_ms": flops / PEAK_FP32 * 1e3,
               "bound_tf32x3_ms": flops / PEAK_TF32X3 * 1e3}
        with torch.no_grad():
            if CT is not None:
                row["kernel_ms"] = _median_ms(lambda: CT.conv2d_tf32x3(conv, x, padding=1), 10)
                row["kernel_tflops"] = flops / row["kernel_ms"] / 1e9
            row["cudnn_fp32_channels_last_ms"] = _median_ms(lambda: F.conv2d(x, w, b, padding=1), 10)
            row["cudnn_fp32_nchw_ms"] = _median_ms(lambda: F.conv2d(x_nchw, w, b, padding=1), 10)
            torch.backends.cudnn.allow_tf32 = True
            try:
                row["cudnn_tf32_channels_last_ms"] = _median_ms(
                    lambda: F.conv2d(x, w, b, padding=1), 10)
            finally:
                torch.backends.cudnn.allow_tf32 = False
        print(f"{FRAMES}x{cin}->{cout} 3x3 at {side}^2 ({name}): "
              + ", ".join(f"{k} {v:.4f}" for k, v in row.items()), flush=True)
        out[name] = row
        del x, x_nchw
        torch.cuda.empty_cache()
    return out


def head(dev, CT):
    """ms of one flagship fp32 DPT head call on 8 frames at 518 px, with the
    kernel's routes (where the tree has them) and on the library alone."""
    from omnivggt_tpu_torch.config import DPTHeadConfig
    from omnivggt_tpu_torch.models import dpt_head as TDH

    torch.manual_seed(0)
    h = TDH.DPTHead(DPTHeadConfig()).to(dev).eval()
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    p = (IMG // 14) ** 2
    layers = [torch.randn((1, FRAMES, 5 + p, 2048), generator=gen, device=dev).to(torch.bfloat16)
              for _ in range(4)]
    call = lambda: TDH.apply(h, layers, (IMG, IMG), 5)  # noqa: E731
    row = {}
    with torch.no_grad():
        if CT is not None:
            counts = TDH.conv_counts()
            call()
            row["routes"] = TDH.conv_counts(since=counts)
            row["kernel_routes_ms"] = _median_ms(call, 5)
            rule = CT.eligible
            CT.eligible = lambda *a, **k: False
        try:
            row["library_ms"] = _median_ms(call, 5)
        finally:
            if CT is not None:
                CT.eligible = rule
    print(f"DPT head, {FRAMES} frames at {IMG} px: " + ", ".join(f"{k} {v}" for k, v in row.items()),
          flush=True)
    return row


def main() -> int:
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=here, help="checkout whose omnivggt_tpu_torch is timed")
    ap.add_argument("--label", default="", help="a name for this run in the output")
    ap.add_argument("--parts", nargs="+", choices=PARTS, default=list(PARTS),
                    help="what to time (default: all)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device: bench_conv.py times the kernels on the card only", file=sys.stderr)
        return 1
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import omnivggt_tpu_torch

    if not os.path.abspath(omnivggt_tpu_torch.__file__).startswith(tree):
        raise RuntimeError(f"omnivggt_tpu_torch came from {omnivggt_tpu_torch.__file__}, not {tree}")
    CT = None
    if importlib.util.find_spec("omnivggt_tpu_torch.ops.kernels.conv_tf32x3") is not None:
        from omnivggt_tpu_torch.ops.kernels import conv_tf32x3 as CT
    card = _card()
    print(f"[{args.label}] tree {tree}; card {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    parts = {"conv3x3": lambda: conv_forms(dev), "probes": probes, "served": lambda: served(dev),
             "tf32x3": lambda: conv_shapes(dev, CT), "head": lambda: head(dev, CT)}
    result = {"label": args.label, "card": card}
    for name in args.parts:
        result[name] = parts[name]()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
