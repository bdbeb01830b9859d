"""Training CLI of the PyTorch port (counterpart of tools/train.py).

Scene roots (example-layout folders, ScanNet scenes, CO3D sequences;
data/dataset.py, one scene a step) or pre-built streaming tar shards
(data/streaming.py, --batch scenes a step) feed the train step
(train/step.py) with the layer-decay fine-tune optimizer (train/optim.py),
metric logging to {ckpt_dir}/metrics.jsonl, and checkpoint save/resume
(train/checkpointing.py). It runs on --device (default cuda, which must
exist); --device cpu runs the kernels' plain versions on the CPU.

--mesh data,seq runs the step on a (data, seq) mesh (parallel/mesh.py) and
--state_sharding zero2 / fsdp lays the training state out over it
(parallel/fsdp.py). Started by torchrun (the process group comes from its
environment), either the data axis lies over the processes (data = the
number of processes, seq logical ranks in each) or both axes do (data x
seq = the number of processes, one seq rank each, under every
--state_sharding; with data 1 the group is gloo and the processes may
share a card, their seq data moving through peer memory). The state is
laid out before a checkpoint is restored into it, so no process holds the
whole state on the way. --batch is the global batch: each
data rank streams its own partition of the shards and takes batch / data
scenes of it, the seq processes of one data rank read the same samples
and each runs its own frames, and only the process of global rank 0 logs
and writes checkpoints. Without torchrun every rank is a logical rank of
this one process.

    # fine-tune on a folder of scenes, one GPU
    python -m omnivggt_tpu_torch.tools.train --data_root scenes/ --steps 1000 \\
        --checkpoint OmniVGGT.safetensors --ckpt_dir runs/ft

    # stream shards (written by omnivggt_tpu_torch.tools.make_shards), four
    # scenes a step over four GPUs, moments and gradients sharded
    torchrun --standalone --nproc_per_node 4 -m omnivggt_tpu_torch.tools.train \\
        --shards 'shards/shard-*.tar' --batch 4 --mesh 4,1 --state_sharding zero2 \\
        --steps 10000 --ckpt_dir runs/ft

    # smoke run on the CPU with the tiny config on a 2-way sequence mesh
    python -m omnivggt_tpu_torch.tools.train --data_root scenes/ --tiny \\
        --device cpu --steps 2 --views 2 --target_size 28 --mesh 1,2

    # the same 2-way sequence mesh as two processes (gloo on the CPU), each
    # running 2 of the 4 frames of every scene, the state laid out over both
    torchrun --standalone --nproc_per_node 2 -m omnivggt_tpu_torch.tools.train \\
        --shards 'shards/shard-*.tar' --batch 1 --views 4 --tiny --device cpu \\
        --mesh 1,2 --state_sharding fsdp --steps 2

    # the flagship over 4 seq processes on one card, each 2 of 8 frames and
    # a quarter of the sharded state (gloo + CUDA IPC)
    torchrun --standalone --nproc_per_node 4 -m omnivggt_tpu_torch.tools.train \\
        --shards 'shards/shard-*.tar' --batch 1 --views 8 --mesh 1,4 \\
        --state_sharding fsdp --steps 1000 --ckpt_dir runs/ft
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="OmniVGGT training (PyTorch)")
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--data_root", help="root of scene folders")
    src.add_argument("--shards", help="glob of streaming tar shards")
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--views", type=int, default=4, help="views per sample")
    ap.add_argument("--batch", type=int, default=1, help="scenes per batch (shards mode)")
    ap.add_argument("--target_size", type=int, default=518)
    ap.add_argument("--tiny", action="store_true", help="tiny config (CPU smoke runs)")
    ap.add_argument("--checkpoint", help="init from an OmniVGGT .safetensors")
    ap.add_argument("--ckpt_dir", default="runs/default")
    ap.add_argument("--save_every", type=int, default=500)
    ap.add_argument("--log_every", type=int, default=10)
    ap.add_argument("--lr", type=float, default=1e-5)
    ap.add_argument("--layer_decay", type=float, default=0.9)
    ap.add_argument("--warmup", type=int, default=500)
    ap.add_argument("--drop_path", type=float, default=0.0)
    ap.add_argument("--mesh", help="data,seq mesh (e.g. 1,4; under torchrun data = processes)")
    ap.add_argument("--state_sharding", default="none", choices=("none", "zero2", "fsdp"),
                    help="ZeRO-style state sharding over the mesh: zero2 shards the gradients "
                         "and AdamW moments, fsdp also the parameters")
    ap.add_argument("--no_remat", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a CUDA device) or cpu")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.state_sharding != "none" and not args.mesh:
        raise SystemExit("--state_sharding requires --mesh")

    from omnivggt_tpu_torch.parallel.mesh import process_group

    # under torchrun one process per data rank, or per (data, seq) rank;
    # TF32 off: the fp32 heads keep full fp32
    backend = launch_backend(args.mesh, int(os.environ.get("WORLD_SIZE", "1")))
    with process_group(args.device, backend=backend) as device:
        return _train(args, device)


def _mesh_axes(mesh):
    """(data, seq) of --mesh, (1, 1) without one."""
    return tuple(int(x) for x in mesh.split(",")) if mesh else (1, 1)


def launch_backend(mesh, world: int):
    """The process group's backend for --mesh over `world` processes:
    "gloo" when the seq axis lies over them with data 1 (no NCCL collective
    runs, and gloo lets the processes share a card), else the default
    (NCCL on CUDA, gloo on the CPU)."""
    data_ax, seq_ax = _mesh_axes(mesh)
    return "gloo" if data_ax == 1 and seq_ax > 1 and seq_ax == world else None


def _train(args, device):
    import torch.distributed as dist

    from omnivggt_tpu_torch.config import OmniVGGTConfig, tiny_test_config
    from omnivggt_tpu_torch.models.omnivggt import OmniVGGT
    from omnivggt_tpu_torch.parallel import fsdp
    from omnivggt_tpu_torch.parallel.mesh import make_mesh
    from omnivggt_tpu_torch.parallel.sharding import ModelSharding
    from omnivggt_tpu_torch.train.checkpointing import resume_or_init, save_train_state
    from omnivggt_tpu_torch.train.optim import make_finetune_optimizer
    from omnivggt_tpu_torch.train.step import batch_to_device, init_state, make_train_step
    from omnivggt_tpu_torch.utils.logging import MetricLogger

    sharding, local_batch, rank0, partition = None, args.batch, True, {}
    if args.mesh:
        data_ax, seq_ax = _mesh_axes(args.mesh)
        batch_dim = 1 if args.data_root else args.batch
        if batch_dim % data_ax:
            raise SystemExit(
                f"mesh data axis {data_ax} must divide the batch size {batch_dim} "
                "(--data_root mode always yields batch 1: use --mesh 1,N)"
            )
        if args.views % seq_ax:
            raise SystemExit(f"mesh seq axis {seq_ax} must divide --views {args.views}")
        mesh = make_mesh(data=data_ax, seq=seq_ax, device=device)
        sharding = ModelSharding(mesh)
        if dist.is_initialized():
            # each data rank its scenes and its partition of the shards; the
            # seq processes of a data rank read the same ones
            local_batch, rank0 = args.batch // data_ax, dist.get_rank() == 0
            partition = dict(shard_rank=mesh.rank, num_shards=mesh.data)
    elif dist.is_initialized():
        raise SystemExit("started by torchrun: pass --mesh data,seq with data, or data x seq, "
                         "the number of processes (each would otherwise train alone on its own "
                         "batch)")

    cfg = tiny_test_config() if args.tiny else OmniVGGTConfig()
    if args.drop_path > 0:
        cfg = dataclasses.replace(
            cfg, aggregator=dataclasses.replace(cfg.aggregator, drop_path_rate=args.drop_path)
        )
    if args.checkpoint:
        # also re-certifies the fixed-max softmax against these weights; the
        # head dtype is forced, so no fast serving mode is certified for training
        model = OmniVGGT.from_safetensors(args.checkpoint, cfg, device=device,
                                          head_dtype=cfg.head_dtype)
        cfg = model.config
    else:
        model = OmniVGGT(cfg, device=device, seed=args.seed)
    model.train()

    optimizer = make_finetune_optimizer(
        model, learning_rate=args.lr, layer_decay=args.layer_decay,
        warmup_steps=args.warmup, total_steps=args.steps,
    )
    train_step = make_train_step(
        cfg, optimizer, sharding, use_aux_inputs=True, remat=not args.no_remat, seed=args.seed,
        state_sharding=args.state_sharding,
    )
    state = init_state(model, optimizer)
    if sharding is not None:
        # laid out first: a restore then loads each process's own chunks
        fsdp.shard_state(state, sharding.mesh, args.state_sharding)
    state = resume_or_init(args.ckpt_dir, state)
    start = state.step
    if start and rank0:
        print(f"resumed from {args.ckpt_dir} at step {start}")

    if args.data_root:
        from omnivggt_tpu_torch.data.dataset import SceneDataset, prefetch

        ds = SceneDataset(
            args.data_root, views_per_sample=args.views, target_size=args.target_size,
            seed=args.seed,
        )
        if rank0:
            print(f"{len(ds)} scene(s) under {args.data_root}")
        batches = prefetch(ds.batches())
    else:
        from omnivggt_tpu_torch.data.streaming import ShardedSampleStream, batch_stream

        # under torchrun each data rank streams its own partition of the shards
        stream = ShardedSampleStream(args.shards, shuffle_buffer=64, seed=args.seed, **partition)
        batches = batch_stream(stream, local_batch)

    logger = None
    if rank0:
        os.makedirs(args.ckpt_dir, exist_ok=True)
        logger = MetricLogger(jsonl_path=os.path.join(args.ckpt_dir, "metrics.jsonl"))
    t0 = time.perf_counter()
    last_logged = start
    for step, batch in zip(range(start, args.steps), batches):
        state, metrics = train_step(state, batch_to_device(batch, device))
        if logger is not None and ((step + 1) % args.log_every == 0 or step + 1 == args.steps):
            metrics = {k: float(v) for k, v in metrics.items()}
            dt = (time.perf_counter() - t0) / (step + 1 - last_logged)
            t0, last_logged = time.perf_counter(), step + 1
            logger.update(step=step + 1, sec_per_step=round(dt, 3), **metrics)
            print(f"step {step + 1}: " + ", ".join(
                f"{k}={v:.4f}" for k, v in sorted(metrics.items())
            ))
        if (step + 1) % args.save_every == 0 or step + 1 == args.steps:
            path = save_train_state(args.ckpt_dir, state)  # every process gathers, rank 0 writes
            if rank0:
                print(f"saved {path}")
    return state


if __name__ == "__main__":
    main()
