"""The training step (counterpart of omnivggt_tpu/train/step.py).

Eager PyTorch: the loss of `models.omnivggt.apply` under `total_loss`, its
gradients by autograd (through the flash-attention backward kernels when
the attention runs on them), then the optimizer. Mixed precision as in the
JAX package: the parameters stay fp32 masters, the trunk casts them to
bf16 at use (config.compute_dtype), the heads and the optimizer state run
in fp32.

On a mesh (`sharding`, parallel/sharding.ModelSharding) the forward runs
under its strategies, and `state_sharding` lays the state out as the JAX
step's annotations do (parallel/fsdp.py): "none" keeps it replicated,
"zero2" shards the AdamW moments and reduce-scatters the gradients onto
them, "fsdp" shards the parameters too. With the data axis over processes
(parallel/mesh.py) each process computes its scenes' share of the global
loss (the counts it divides by are summed over the data ranks), and the
gradients are summed over the processes.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from omnivggt_tpu_torch.config import OmniVGGTConfig
from omnivggt_tpu_torch.models import omnivggt as M
from omnivggt_tpu_torch.models.aggregator import AuxInputs
from omnivggt_tpu_torch.parallel.collectives import all_reduce_sum
from omnivggt_tpu_torch.train import losses as LS
from omnivggt_tpu_torch.train.optim import Optimizer, warmup_cosine_decay_schedule


@dataclasses.dataclass
class TrainState:
    """The model (fp32 parameters), its optimizer and the step count;
    updated in place by the train step. layout: the parallel/fsdp.py
    StateLayout under zero2 / fsdp, else None."""

    model: torch.nn.Module
    optimizer: Optimizer
    step: int = 0
    layout: Optional[object] = None


def make_optimizer(
    model: torch.nn.Module,
    learning_rate: float = 1e-4,
    weight_decay: float = 0.05,
    warmup_steps: int = 1000,
    total_steps: int = 100_000,
    grad_clip: float = 1.0,
) -> Optimizer:
    """AdamW + warmup-cosine schedule + global-norm clipping, with biases,
    norms, LayerScale gammas and learned tokens not decayed."""
    schedule = warmup_cosine_decay_schedule(
        0.0, learning_rate, warmup_steps, total_steps, learning_rate * 0.05
    )
    return Optimizer(model, schedule, weight_decay, grad_clip)


def init_state(model: torch.nn.Module, optimizer: Optimizer) -> TrainState:
    return TrainState(model, optimizer, 0)


def batch_to_device(batch: dict, device) -> dict:
    """numpy (or tensor) batch -> tensors on `device`."""
    return {k: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v,
                               device=device)
            for k, v in batch.items()}


def synthetic_batch(S: int, size: int, device, seed: int = 0, scenes: int = 1) -> dict:
    """A synthetic (scenes, S)-view batch at size x size px, made on `device`
    (the layout of tools/bench_train_step.py's batch), scene b from seed
    + b: random rotations and translations, a 500 px focal length, depth
    in [0.5, 3), every pixel valid, camera GT kept on frame 0 and depth GT
    on the first half of the frames ((S,) masks)."""
    from omnivggt_tpu_torch.utils.geometry import quat_to_mat

    parts = []
    for b in range(scenes):
        gen = torch.Generator(device=device)
        gen.manual_seed(seed + b)
        quat = torch.randn((1, S, 4), generator=gen, device=device)
        quat = quat / quat.norm(dim=-1, keepdim=True)
        t = torch.randn((1, S, 3, 1), generator=gen, device=device)
        K = torch.diag(torch.tensor([500.0, 500.0, 1.0], device=device)).repeat(1, S, 1, 1)
        K[..., 0, 2] = K[..., 1, 2] = size / 2
        ones = torch.ones((1, S, size, size), device=device)
        parts.append({
            "images": torch.rand((1, S, size, size, 3), generator=gen, device=device),
            "extrinsics": torch.cat([quat_to_mat(quat), t], -1),
            "intrinsics": K,
            "depth": 0.5 + 2.5 * torch.rand((1, S, size, size, 1), generator=gen, device=device),
            "depth_valid": ones,
            "world_points": torch.randn((1, S, size, size, 3), generator=gen, device=device),
            "point_valid": ones,
        })
    frames = torch.arange(S, device=device)
    return {
        **{k: torch.cat([p[k] for p in parts]) for k in parts[0]},
        "camera_mask": frames < 1,
        "depth_mask": frames < max(S // 2, 1),
        "camera_valid": torch.ones(S, dtype=torch.bool, device=device),
    }


def make_train_step(
    cfg: OmniVGGTConfig,
    optimizer: Optimizer,
    sharding=None,
    *,
    use_aux_inputs: bool = False,
    remat=True,
    seed: int = 0,
    attn_impl: str = "auto",
    state_sharding: str = "none",
) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics).

    batch: tensors on the model's device with keys images (B,S,H,W,3),
    extrinsics, intrinsics, depth, depth_valid, world_points; optionally
    point_valid, camera_valid, and camera_mask/depth_mask (S,) when
    use_aux_inputs (modality-injection training). With the data axis over
    processes, each process's own B / data scenes (mesh.shard_batch).
    metrics: the losses and grad_norm (before clipping), as device
    scalars, over the whole batch.

    sharding: a parallel.sharding.ModelSharding; the forward runs under its
    strategies ("allgather" or "ring" for the global attention: the ring
    kernels of "ring_fused" have no backward). state_sharding: "none",
    "zero2" or "fsdp" (needs `sharding`, whose mesh the state shards
    over); the state must be laid out for it first
    (parallel/fsdp.shard_state or sharded_init), else the step raises.

    Stochastic depth (cfg.aggregator.drop_path_rate > 0) draws from a
    generator seeded by (seed, step). DINOv2 runs unpadded (pad_tokens=False),
    as in the JAX step. remat: True or "full" recomputes each aggregator
    layer pair in the backward and keeps nothing of it, "dots" keeps the
    linear layers' outputs (more memory, less recompute, but slower on the
    H100: see aggregator._dots_saveable), False keeps every activation.
    `train_step.loss_and_grads(model, batch, step)` fills the parameters'
    .grad and returns the losses, without an update.
    """
    from omnivggt_tpu_torch.parallel import fsdp as FS

    if (cfg.trunk_quant, cfg.attn_quant, cfg.head_quant) != ("none",) * 3:
        raise ValueError(
            "trunk_quant/attn_quant/head_quant are serving-only fast modes "
            "(round() kills the gradient); train with all set to 'none'"
        )
    if remat not in (True, False, "full", "dots"):
        raise ValueError(f"remat={remat!r}: True, 'full', 'dots' or False")
    FS.check_mode(state_sharding)
    if state_sharding != "none" and sharding is None:
        raise ValueError(
            "state_sharding needs a ModelSharding (its mesh is the axis set the state shards over)"
        )
    if sharding is not None and sharding.global_attn == "ring_fused":
        raise ValueError(
            "global_attn='ring_fused' cannot train: the ring kernels have no backward; "
            "use 'allgather' or 'ring' (torch ops, differentiable)"
        )
    mesh = sharding.mesh if sharding is not None else None
    if mesh is not None and mesh.seq_processes:
        raise NotImplementedError(
            "training with the seq axis over processes is not ported yet: it is the next "
            "slice (the loss's first-valid-camera rebase across processes, and the backward "
            "kernels through a seq-process mesh). Train on a mesh whose seq axis is logical "
            "ranks (make_mesh(data=<world size>, seq=...)); the forward and InferenceSession "
            "run over seq processes"
        )

    def global_count(x):
        return all_reduce_sum(x, mesh)

    def loss_and_grads(model, batch, step: int, layout=None) -> dict:
        images = batch["images"]
        H, W = images.shape[2:4]
        aux = None
        if use_aux_inputs:
            aux = AuxInputs(
                extrinsics=batch["extrinsics"], intrinsics=batch["intrinsics"],
                depth=batch["depth"], depth_valid=batch["depth_valid"],
                camera_mask=batch["camera_mask"], depth_mask=batch["depth_mask"],
            )
        generator = None
        if cfg.aggregator.drop_path_rate > 0.0:
            generator = torch.Generator(device=images.device)
            generator.manual_seed(seed * 2**32 + step)
        model.zero_grad(set_to_none=True)
        if layout is not None:
            layout.zero_grad()
        with layout.gathered_rest() if layout is not None else contextlib.nullcontext():
            preds = M.apply(
                model, images, cfg, aux, attn_impl=attn_impl, pad_tokens=False,
                remat=remat, train_generator=generator, sharding=sharding,
            )
            losses = LS.total_loss(preds, batch, (H, W),
                                   global_count=global_count if mesh is not None else None)
            losses["total"].backward()
        losses = {k: v.detach() for k, v in losses.items()}
        if mesh is not None:
            for v in losses.values():  # the shares, summed: the global losses
                all_reduce_sum(v, mesh)
        return losses

    def train_step(state: TrainState, batch: dict):
        laid_out = state.layout.mode if state.layout is not None else "none"
        if laid_out != state_sharding or (state.layout is not None
                                          and state.layout.mesh != mesh):
            raise ValueError(f"the state is laid out for state_sharding={laid_out!r} on "
                             f"{getattr(state.layout, 'mesh', None)}; this step is "
                             f"{state_sharding!r} on {mesh}")
        metrics = loss_and_grads(state.model, batch, state.step, state.layout)
        if state.layout is not None:
            state.layout.sync_grads()
        elif mesh is not None:
            for p in state.model.parameters():
                if p.grad is not None:
                    all_reduce_sum(p.grad, mesh)
        metrics["grad_norm"] = state.optimizer.step()
        if state.layout is not None and state.layout.mode == "zero2":
            state.layout.gather_params()
        state.step += 1
        return state, metrics

    train_step.loss_and_grads = loss_and_grads
    return train_step
