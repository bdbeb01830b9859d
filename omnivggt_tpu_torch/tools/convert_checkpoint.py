"""Convert a reference OmniVGGT safetensors checkpoint into the port's own
checkpoint directory (counterpart of tools/convert_checkpoint.py): the
file is loaded strictly (every tensor consumed, nothing left over) and
written by `OmniVGGT.save_pretrained` as config.json + model.safetensors,
which `OmniVGGT.from_pretrained` reads back.

    python -m omnivggt_tpu_torch.tools.convert_checkpoint OmniVGGT.safetensors out_dir/
    python -m omnivggt_tpu_torch.tools.convert_checkpoint ckpt.safetensors out_dir/ \\
        --tiny --device cpu --head_dtype float32

--head_dtype auto (the default, as the JAX tool loads) certifies the fast
serving modes on the way and saves the config they give; float32 keeps
reference parity and skips the probes. Prints the parameter count and the
read and write times and sizes.

A VGGT-layout file (VGGT's or StreamVGGT's) converts with `--layout vggt`:
OmniVGGT's own leaves are set to zero and the track head's are skipped and
listed. StreamVGGT adds `--global_attention frame_causal`:

    python -m omnivggt_tpu_torch.tools.convert_checkpoint streamvggt.safetensors out_dir/ \
        --layout vggt --global_attention frame_causal --head_dtype float32
"""

from __future__ import annotations

import argparse
import os
import time


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="reference safetensors -> save_pretrained directory")
    ap.add_argument("src", help="reference .safetensors file")
    ap.add_argument("dst", help="output directory")
    ap.add_argument("--head_dtype", default="auto", choices=("auto", "float32", "bfloat16"))
    ap.add_argument("--layout", default="omnivggt", choices=("omnivggt", "vggt"),
                    help="the file's state-dict layout (vggt: VGGT or StreamVGGT)")
    ap.add_argument("--global_attention", default="full", choices=("full", "frame_causal"),
                    help="frame_causal for StreamVGGT")
    ap.add_argument("--tiny", action="store_true", help="the tiny test config (CPU smoke runs)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a CUDA device) or cpu")
    return ap.parse_args(argv)


def _size_mb(path: str) -> float:
    if os.path.isdir(path):
        return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path)) / 1e6
    return os.path.getsize(path) / 1e6


def main(argv=None):
    args = parse_args(argv)
    from omnivggt_tpu_torch.utils.platform import ensure_platform

    device = ensure_platform(args.device)

    import dataclasses

    import torch

    from omnivggt_tpu_torch.checkpoint import VGGT_ONLY, _parse_header
    from omnivggt_tpu_torch.config import OmniVGGTConfig, tiny_test_config
    from omnivggt_tpu_torch.models.omnivggt import OmniVGGT

    print(f"converting {args.src} ...")
    cfg = tiny_test_config() if args.tiny else OmniVGGTConfig()
    cfg = dataclasses.replace(cfg, global_attention=args.global_attention)
    if args.layout == "vggt":
        skipped = sorted(k for k in _parse_header(args.src)[0] if k.startswith(VGGT_ONLY))
        print(f"skipping {len(skipped)} leaves this model has no place for: "
              f"{', '.join(skipped) or 'none'}")
    t0 = time.perf_counter()
    model = OmniVGGT.from_safetensors(args.src, cfg, device=device, head_dtype=args.head_dtype,
                                      layout=args.layout)
    if device.type == "cuda":
        torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    model.save_pretrained(args.dst)
    write_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    print(f"read {args.src}: {_size_mb(args.src):.1f} MB in {read_s:.2f} s; wrote {args.dst}: "
          f"{_size_mb(args.dst):.1f} MB in {write_s:.2f} s ({n_params / 1e6:.1f}M params, "
          f"head_dtype {model.config.head_dtype})")
    return model


if __name__ == "__main__":
    main()
