"""Toy training loop: overfit the tiny model on one synthetic batch of
`data` scenes (train.step.synthetic_batch; counterpart of
examples/train_toy.py).

    python -m omnivggt_tpu_torch.examples.train_toy [--steps 20] [--ranks 8] \\
        [--state_sharding zero2] [--device cpu]
    torchrun --standalone --nproc_per_node 2 -m omnivggt_tpu_torch.examples.train_toy \\
        --ranks 4 --device cpu

The whole training subsystem at toy sizes: the sharded (data x seq) train
step with modality injection and remat, the layer-decay fine-tune
optimizer, metric logging and checkpoint save/resume. The mesh has `ranks`
logical ranks (data 2 when ranks is even, as in the JAX example); started
by torchrun, the data axis lies over the processes (gloo with --device cpu,
NCCL on cards) and each keeps ranks / processes seq ranks.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    ap = argparse.ArgumentParser(description="toy training loop on a (data, seq) mesh")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--ranks", type=int, default=8, help="data x seq ranks of the mesh")
    ap.add_argument("--state_sharding", default="none", choices=("none", "zero2", "fsdp"))
    ap.add_argument("--ckpt_dir", default="runs/toy")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a CUDA device) or cpu")
    args = ap.parse_args(argv)

    from omnivggt_tpu_torch.parallel.mesh import process_group

    with process_group(args.device) as device:  # torchrun: the group from its environment
        return _train(args, device)


def _train(args, device):
    import torch.distributed as dist

    from omnivggt_tpu_torch.config import tiny_test_config
    from omnivggt_tpu_torch.models.omnivggt import OmniVGGT
    from omnivggt_tpu_torch.parallel import fsdp
    from omnivggt_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from omnivggt_tpu_torch.parallel.sharding import ModelSharding
    from omnivggt_tpu_torch.train.checkpointing import resume_or_init, save_train_state
    from omnivggt_tpu_torch.train.optim import make_finetune_optimizer
    from omnivggt_tpu_torch.train.step import init_state, make_train_step, synthetic_batch
    from omnivggt_tpu_torch.utils.logging import MetricLogger

    if dist.is_initialized():
        data = dist.get_world_size()
        seq = max(args.ranks // data, 1)
    else:
        data = 2 if args.ranks % 2 == 0 and args.ranks > 1 else 1
        seq = args.ranks // data
    mesh = make_mesh(data=data, seq=seq, device=device)
    sharding = ModelSharding(mesh)

    cfg = tiny_test_config()
    model = OmniVGGT(cfg, device=device, seed=0).train()
    optimizer = make_finetune_optimizer(model, learning_rate=3e-4, warmup_steps=2,
                                        total_steps=args.steps)
    state = resume_or_init(args.ckpt_dir, init_state(model, optimizer))
    # min_elems 0: the tiny config's leaves are all below the default
    fsdp.shard_state(state, mesh, args.state_sharding, min_elems=0)
    train_step = make_train_step(cfg, optimizer, sharding, use_aux_inputs=True,
                                 state_sharding=args.state_sharding)
    # the whole batch made here (each process the same), each process keeping its scenes
    batch = shard_batch(mesh, synthetic_batch(2 * seq, 28, device, scenes=data))

    rank0 = mesh.rank == 0
    logger = None
    if rank0:
        os.makedirs(args.ckpt_dir, exist_ok=True)
        logger = MetricLogger(jsonl_path=os.path.join(args.ckpt_dir, "metrics.jsonl"))
    steps = range(state.step, args.steps)
    for _ in logger.log_every(steps, print_freq=5, header="toy") if logger else steps:
        state, metrics = train_step(state, batch)
        if logger:
            logger.update(**{k: float(v) for k, v in metrics.items()})
    path = save_train_state(args.ckpt_dir, state)
    if rank0:
        print(f"mesh ({mesh.data}x{mesh.seq}), state_sharding={args.state_sharding}: final "
              f"loss {logger.meters['total'].value:.4f}; checkpoint at {path}")
    return state


if __name__ == "__main__":
    main()
