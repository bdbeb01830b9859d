"""Dry run of the sequence-sharded forward on a mesh of logical ranks.

    python -m omnivggt_tpu_torch.tools.dryrun_multichip [--ranks 8] [--device cpu]

Counterpart of part (b) of `__graft_entry__.dryrun_multichip`: one
tiny-config forward of `ranks` frames on a (1, ranks) mesh through the
"ring" strategy, "ring_fused", "ring_fused" with attn_quant="int8" and
"allgather" with attn_quant="int8" (attn_impl="flash", since "auto" never
picks a kernel path for so short a sequence and the check would certify
nothing), each against the single-device forward: finite, and pose_enc
within 5e-4 for the exact strategies on an fp32 trunk, 5e-2 for the int8
ones and for a bf16 trunk. Parts (a) (a sharded train step) and (c) (an
ahead-of-time lowering) have no counterpart yet.

On the card the tiny config is widened to head dim 64 with a bf16 trunk
(what the kernels take) and the frames are 224 px, so that the gathered key
axis passes the packed kernel's contract and the int8 pre-gather runs; on
the CPU it is the JAX dry run's fp32 tiny config at 28 px, where every
wrapper computes its plain version. Exit code 1 on any failure.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import torch

from omnivggt_tpu_torch.config import tiny_test_config
from omnivggt_tpu_torch.models.omnivggt import OmniVGGT
from omnivggt_tpu_torch.ops.kernels import flash_attention as FK
from omnivggt_tpu_torch.ops.kernels import ring_attention as RK
from omnivggt_tpu_torch.parallel.mesh import make_mesh
from omnivggt_tpu_torch.parallel.sharding import ModelSharding
from omnivggt_tpu_torch.utils.device import resolve_device

EXACT_TOL, INT8_TOL = 5e-4, 5e-2


def run(ranks: int = 8, device=None, img: int = None, seed: int = 0, out=print) -> bool:
    """Runs the four sharded forwards; returns whether all passed."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    cfg = tiny_test_config(embed_dim=128, num_heads=2) if on_card else tiny_test_config()
    if on_card:
        cfg = dataclasses.replace(cfg, compute_dtype="bfloat16")
    img = img or (224 if on_card else 28)
    model = OmniVGGT(cfg, device=dev, seed=seed).eval()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    images = torch.rand((1, ranks, img, img, 3), generator=gen, device=dev)
    mesh = make_mesh(data=1, seq=ranks, device=dev)
    cfg_q = dataclasses.replace(cfg, attn_quant="int8")
    exact_tol = INT8_TOL if on_card else EXACT_TOL
    # (label, strategy, config, attn_impl, pose_enc limit)
    cases = [
        ("ring", "ring", cfg, "auto", exact_tol),
        ("ring_fused", "ring_fused", cfg, "auto", exact_tol),
        ("ring_fused int8", "ring_fused", cfg_q, "auto", INT8_TOL),
        ("allgather int8", "allgather", cfg_q, "flash", INT8_TOL),
    ]
    ok = True
    with torch.inference_mode():
        ref = model(images)["pose_enc"].float()
        for label, strategy, config, impl, tol in cases:
            model.config = config
            FK.reset_launches()
            RK.reset_launches()
            pose = model(images, attn_impl=impl,
                         sharding=ModelSharding(mesh, strategy))["pose_enc"].float()
            model.config = cfg
            delta = (pose - ref).abs().max().item()
            passed = bool(torch.isfinite(pose).all()) and delta <= tol
            ok &= passed
            launched = {k: n for k, n in {**FK.launches(), **RK.launches()}.items() if n}
            out(f"{'PASS' if passed else 'FAIL'} {label} forward on mesh (1x{ranks}), {img} px: "
                f"max pose_enc delta vs single device {delta:.2e} (limit {tol:g}); "
                f"kernel launches {launched}")
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--img", type=int, default=None, help="frame size in px (multiple of 14)")
    args = ap.parse_args(argv)
    return 0 if run(args.ranks, args.device, args.img) else 1


if __name__ == "__main__":
    sys.exit(main())
