"""Profile the flagship forward on the card and print where the time goes
(counterpart of tools/profile_forward.py).

Builds OmniVGGTConfig() from a seed (trunk stored in bf16; the camera
token drawn at unit scale, as chip_smoke.py draws it), runs S views at
518 px once to warm up, times one forward, runs one under
utils.profiling.trace (a Chrome / Perfetto trace in --logdir) and one under
profile_breakdown, and prints the top device operations by summed time,
the device time by kernel family, the wall time with flops_estimate / wall
in TFLOP/s, and the card's nvidia-smi line.

    python -m omnivggt_tpu_torch.tools.profile_forward [--views 8] [--logdir DIR] \\
        [--head_dtype float32|bfloat16] [--approx_gelu] [--attn_quant none|int8]
    python -m omnivggt_tpu_torch.tools.profile_forward --tiny --device cpu --size 28

The config is the port's default unless the flags say otherwise.
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess
import tempfile


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="profile the flagship forward")
    ap.add_argument("--views", type=int, default=8)
    ap.add_argument("--size", type=int, default=518, help="frame size in px")
    ap.add_argument("--logdir", default=None, help="trace directory (default: a new temporary one)")
    ap.add_argument("--head_dtype", default="float32", choices=("float32", "bfloat16"))
    ap.add_argument("--approx_gelu", action="store_true", help="tanh GELU in the trunk")
    ap.add_argument("--attn_quant", default="none", choices=("none", "int8"))
    ap.add_argument("--tiny", action="store_true", help="the tiny test config (CPU smoke runs)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a CUDA device) or cpu")
    return ap.parse_args(argv)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def top_device_ops(prof, n: int):
    """(name, summed device ms, calls) of the n device operations with the
    most self time."""
    import torch

    rows = [
        (evt.key, evt.self_device_time_total / 1e3, evt.count)
        for evt in prof.key_averages()
        if evt.device_type == torch.autograd.DeviceType.CUDA and evt.self_device_time_total > 0
    ]
    return sorted(rows, key=lambda r: -r[1])[:n]


def main(argv=None):
    args = parse_args(argv)
    from omnivggt_tpu_torch.utils.platform import ensure_platform

    device = ensure_platform(args.device)

    import numpy as np
    import torch

    from omnivggt_tpu_torch.checkpoint import cast_trunk_params
    from omnivggt_tpu_torch.config import OmniVGGTConfig, tiny_test_config
    from omnivggt_tpu_torch.models.omnivggt import OmniVGGT
    from omnivggt_tpu_torch.utils.profiling import (
        Timer, flops_estimate, profile_breakdown, trace,
    )

    cfg = dataclasses.replace(
        tiny_test_config() if args.tiny else OmniVGGTConfig(),
        head_dtype=args.head_dtype, approx_gelu=args.approx_gelu, attn_quant=args.attn_quant,
    )
    model = OmniVGGT(cfg, device=device, seed=0)
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    with torch.no_grad():
        model.aggregator.camera_token.normal_(generator=gen)
    model = cast_trunk_params(model).eval()
    images = torch.as_tensor(
        np.random.default_rng(0).uniform(size=(args.views, args.size, args.size, 3)),
        dtype=torch.float32, device=device,
    )

    def run():
        return model(images)

    timer = Timer()
    with torch.inference_mode():
        with timer.section("warm-up") as s:
            s.set(run()["world_points_conf"].sum())
        with timer.section("forward") as s:
            # a scalar made after every output: forcing it waits for them all
            s.set(run()["world_points_conf"].sum())
        logdir = args.logdir or tempfile.mkdtemp(prefix="omnivggt_trace_")
        with trace(logdir) as prof:
            run()
        print(f"trace in {logdir}; top device operations (summed self time, calls):")
        for name, ms, calls in top_device_ops(prof, 15):
            print(f"  {ms:10.2f} ms  {calls:6d}  {name[:100]}")
        if device.type == "cuda":
            profile_breakdown(f"forward S={args.views}", run)
    wall_ms = timer.totals["forward"] * 1e3
    flops = flops_estimate(cfg, args.views, args.size, args.size)
    print(f"forward S={args.views} {args.size}px: wall {wall_ms:.2f} ms; flops_estimate "
          f"{flops / 1e12:.3f} TFLOP -> {flops / wall_ms / 1e9:.2f} TFLOP/s")
    if device.type == "cuda":
        print(f"card: {card_line()}")
    return {"wall_ms": wall_ms, "flops": flops, "logdir": logdir}


if __name__ == "__main__":
    main()
