"""Dry run of the parallel stack on a mesh of logical ranks, and of the seq
axis over processes.

    python -m omnivggt_tpu_torch.tools.dryrun_multichip [--ranks 8] [--device cpu]

Counterpart of `__graft_entry__.dryrun_multichip`, in its three parts, and
a fourth of the port's own:

  (a) one sharded train step of the tiny config under "allgather" on a
      (2, ranks / 2) mesh with use_aux_inputs (B = 2 synthetic scenes of 2
      frames a seq rank, train.step.synthetic_batch), then one under
      state_sharding="fsdp" from sharded_init: every loss and grad_norm
      finite, and the largest sharded parameter and its AdamW moments held
      as shards (mesh.size chunks, the model's own entry empty);
  (b) one tiny-config forward of `ranks` frames on a (1, ranks) mesh
      through the "ring" strategy, "ring_fused", "ring_fused" with
      attn_quant="int8" and "allgather" with attn_quant="int8"
      (attn_impl="flash", since "auto" never picks a kernel path for so
      short a sequence and the check would certify nothing), each against
      the single-device forward: finite, and pose_enc within 5e-4 for the
      exact strategies on an fp32 trunk, 5e-2 for the int8 ones and for a
      bf16 trunk;
  (c) the counterpart of the JAX package's ahead-of-time lowering: the
      flagship OmniVGGTConfig() forward of 128 views at 518 px,
      sequence-sharded on a (1, ranks) mesh under "ring", on the meta
      device (shapes only: no memory, no launch); pose_enc must come out
      (1, 128, 9). A data-dependent host read in the forward would stop it;
  (d) SEQ_PROCESSES = 2 gloo processes on the CPU whatever --device, one
      seq rank each of make_mesh(data=1, seq=2) over their group: the
      tiny config's forward of 4 frames at 28 px with GT cameras and
      depth under "allgather", "ring" and "ring_fused" in every process,
      each process's whole prediction against the same forward on 2
      logical ranks here within 1e-6.

On the card the tiny config is widened to head dim 64 with a bf16 trunk
(what the kernels take) and the frames are 224 px, so that the gathered key
axis passes the packed kernel's contract and the int8 pre-gather runs; on
the CPU it is the JAX dry run's fp32 tiny config at 28 px, where every
wrapper computes its plain version. Exit code 1 on any failure.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import multiprocessing
import os
import sys
import tempfile
import time

import torch

from omnivggt_tpu_torch.config import OmniVGGTConfig, tiny_test_config
from omnivggt_tpu_torch.models import omnivggt as M
from omnivggt_tpu_torch.models.omnivggt import OmniVGGT
from omnivggt_tpu_torch.ops.kernels import flash_attention as FK
from omnivggt_tpu_torch.ops.kernels import ring_attention as RK
from omnivggt_tpu_torch.parallel.mesh import make_mesh
from omnivggt_tpu_torch.parallel.sharding import ModelSharding
from omnivggt_tpu_torch.utils.device import resolve_device

EXACT_TOL, INT8_TOL = 5e-4, 5e-2
SEQ_PROCESSES, PROCESS_TOL, PROCESS_JOIN_S = 2, 1e-6, 300
FLAGSHIP_VIEWS, FLAGSHIP_IMG = 128, 518


def dryrun_config(dev):
    """The tiny config, widened to head dim 64 with a bf16 trunk on the card."""
    if dev.type != "cuda":
        return tiny_test_config()
    return dataclasses.replace(tiny_test_config(embed_dim=128, num_heads=2),
                               compute_dtype="bfloat16")


def train_steps(ranks: int = 8, device=None, img: int = None, seed: int = 0, out=print) -> bool:
    """(a) one sharded train step under "allgather", then one under fsdp;
    returns whether both passed."""
    from omnivggt_tpu_torch.parallel import fsdp
    from omnivggt_tpu_torch.train.step import make_optimizer, make_train_step, synthetic_batch

    dev = resolve_device(device)
    cfg = dryrun_config(dev)
    img = img or (224 if dev.type == "cuda" else 28)
    data = 2 if ranks % 2 == 0 and ranks > 1 else 1
    mesh = make_mesh(data=data, seq=ranks // data, device=dev)
    sharding = ModelSharding(mesh, "allgather")
    batch = synthetic_batch(2 * mesh.seq, img, dev, seed + 1, scenes=data)
    ok = True
    for mode in ("none", "fsdp"):
        FK.reset_launches()
        # min_elems 0: the tiny config's leaves are all below the default
        state = fsdp.sharded_init(lambda: OmniVGGT(cfg, device=dev, seed=seed).train(),
                                  make_optimizer, mesh, mode, min_elems=0)
        step = make_train_step(cfg, state.optimizer, sharding, use_aux_inputs=True,
                               state_sharding=mode)
        state, metrics = step(state, batch)
        metrics = {k: v.item() for k, v in metrics.items()}
        passed = all(map(math.isfinite, metrics.values()))
        held = ""
        if mode == "fsdp":
            name = max(state.layout.shards, key=lambda n: state.layout.shards[n][0].numel())
            shards = state.layout.shards[name]
            moments = [state.optimizer.adamw.state[s]["exp_avg"] for s in shards]
            whole = shards[0].numel() * mesh.size
            sharded = (len(shards) == mesh.local_size and all(
                m.shape == s.shape for m, s in zip(moments, shards))
                and state.model.get_parameter(name).numel() == 0)
            passed &= sharded
            held = (f"; largest parameter {name} ({whole} elements) held as {len(shards)} "
                    f"shards of {shards[0].numel()}, its moments alike: {sharded}")
        ok &= passed
        launched = {k: n for k, n in FK.launches().items() if n}
        out(f"{'PASS' if passed else 'FAIL'} train step ({sharding.global_attn}, "
            f"state_sharding={mode}) on mesh ({mesh.data}x{mesh.seq}), B={data} "
            f"S={2 * mesh.seq} {img} px: " + ", ".join(f"{k} {v:.4f}" for k, v in metrics.items())
            + f"; kernel launches {launched}{held}")
    return ok


def flagship_on_meta(ranks: int = 8, out=print) -> bool:
    """(c) the flagship's 128-view sequence-sharded forward on the meta
    device; returns whether pose_enc came out (1, 128, 9)."""
    cfg = OmniVGGTConfig()
    model = OmniVGGT(cfg, device="meta", seed=None)
    mesh = make_mesh(data=1, seq=ranks, device="meta")
    images = torch.empty((1, FLAGSHIP_VIEWS, FLAGSHIP_IMG, FLAGSHIP_IMG, 3), device="meta")
    with torch.no_grad():
        pose = M.apply(model, images, cfg, sharding=ModelSharding(mesh, "ring"))["pose_enc"]
    passed = tuple(pose.shape) == (1, FLAGSHIP_VIEWS, 9) and pose.device.type == "meta"
    n_params = sum(p.numel() for p in model.parameters())
    out(f"{'PASS' if passed else 'FAIL'} flagship forward on the meta device: "
        f"{n_params / 1e9:.3f}B parameters, {FLAGSHIP_VIEWS} views at {FLAGSHIP_IMG} px "
        f"sequence-sharded under ring on mesh (1x{ranks}): pose_enc {tuple(pose.shape)}")
    return passed


def run(ranks: int = 8, device=None, img: int = None, seed: int = 0, out=print) -> bool:
    """(b) the four sharded forwards; returns whether all passed."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    cfg = dryrun_config(dev)
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


def _seq_request(n: int, seed: int):
    """2 n frames at 28 px with GT cameras on the second half and depth on
    every other frame, so the rebase and the depth mean cross processes."""
    import numpy as np

    S = 2 * n
    rng = np.random.default_rng(seed)
    extr = np.tile(np.eye(3, 4, dtype=np.float32), (1, S, 1, 1))
    extr[..., :3, 3] = rng.normal(size=(1, S, 3))
    intr = np.tile(np.diag([30.0, 30.0, 1.0]).astype(np.float32), (1, S, 1, 1))
    intr[..., 0, 2] = intr[..., 1, 2] = 14.0
    return dict(
        images=rng.uniform(size=(S, 28, 28, 3)).astype(np.float32), extrinsics=extr,
        intrinsics=intr, depth=rng.uniform(0.5, 5.0, size=(1, S, 28, 28, 1)).astype(np.float32),
        mask=(rng.uniform(size=(1, S, 28, 28)) < 0.6).astype(np.float32),
        camera_gt_index=list(range(n, S)), depth_gt_index=list(range(0, S, 2)),
    )


def _seq_forwards(mesh, n: int, seed: int) -> dict:
    model = OmniVGGT(tiny_test_config(), device="cpu", seed=seed).eval()
    req = _seq_request(n, seed)
    with torch.inference_mode():
        return {strategy: {k: v for k, v in model(**req, sharding=ModelSharding(mesh, strategy))
                           .items() if k != "images"}
                for strategy in ("allgather", "ring", "ring_fused")}


def _seq_worker(rank: int, n: int, rdzv: str, out_dir: str, seed: int) -> None:
    import torch.distributed as dist

    from omnivggt_tpu_torch.parallel.mesh import multihost_initialize

    torch.set_num_threads(1)
    multihost_initialize(device="cpu", init_method=rdzv, world_size=n, rank=rank, timeout=120)
    mesh = make_mesh(data=1, seq=n, device="cpu")
    torch.save(_seq_forwards(mesh, n, seed), os.path.join(out_dir, f"rank_{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def seq_processes(n: int = SEQ_PROCESSES, seed: int = 0, out=print) -> bool:
    """(d) the forward over n gloo processes against n logical ranks;
    returns whether every process's answer is within PROCESS_TOL."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=_seq_worker, args=(r, n, f"file://{tmp}/rdzv", tmp, seed))
                 for r in range(n)]
        for p in procs:
            p.start()
        ref = _seq_forwards(make_mesh(data=1, seq=n, device="cpu"), n, seed)
        deadline = time.monotonic() + PROCESS_JOIN_S
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        codes = [p.exitcode for p in procs]
        if codes != [0] * n:
            out(f"FAIL seq axis over {n} gloo processes: exit codes {codes}")
            return False
        got = [torch.load(os.path.join(tmp, f"rank_{r}.pt")) for r in range(n)]
    ok = True
    for strategy, want in ref.items():
        worst = max(float((g[strategy][k] - w).abs().max()) for g in got for k, w in want.items())
        passed = worst <= PROCESS_TOL
        ok &= passed
        out(f"{'PASS' if passed else 'FAIL'} {strategy} forward over {n} gloo processes (one seq "
            f"rank each, {2 * n} frames at 28 px): worst |diff| against {n} logical ranks "
            f"{worst:.2e} (limit {PROCESS_TOL:g}) over every output of every process")
    out(f"seq processes: {time.perf_counter() - t0:.2f} s")
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--img", type=int, default=None, help="frame size in px (multiple of 14)")
    args = ap.parse_args(argv)
    ok = train_steps(args.ranks, args.device, args.img)
    ok &= run(args.ranks, args.device, args.img)
    ok &= flagship_on_meta(args.ranks)
    ok &= seq_processes()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
