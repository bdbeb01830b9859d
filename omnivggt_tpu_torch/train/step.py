"""The training step (counterpart of omnivggt_tpu/train/step.py).

One device, eager PyTorch: the loss of `models.omnivggt.apply` under
`total_loss`, its gradients by autograd (through the flash-attention
backward kernels when the attention runs on them), then the optimizer.
Mixed precision as in the JAX package: the parameters stay fp32 masters,
the trunk casts them to bf16 at use (config.compute_dtype), the heads and
the optimizer state run in fp32.

The multi-device paths of the JAX step (a mesh `sharding`, ZeRO-2/FSDP
`state_sharding`) are not ported yet (the training CLI refuses them).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from omnivggt_tpu_torch.config import OmniVGGTConfig
from omnivggt_tpu_torch.models import omnivggt as M
from omnivggt_tpu_torch.models.aggregator import AuxInputs
from omnivggt_tpu_torch.train import losses as LS
from omnivggt_tpu_torch.train.optim import Optimizer, warmup_cosine_decay_schedule


@dataclasses.dataclass
class TrainState:
    """The model (fp32 parameters), its optimizer and the step count;
    updated in place by the train step."""

    model: torch.nn.Module
    optimizer: Optimizer
    step: int = 0


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


def synthetic_batch(S: int, size: int, device, seed: int = 0) -> dict:
    """A synthetic (1, S)-view batch at size x size px, made on `device` from
    `seed` (the layout of tools/bench_train_step.py's batch): random
    rotations and translations, a 500 px focal length, depth in
    [0.5, 3), every pixel valid, camera GT kept on frame 0 and depth GT
    on the first half of the frames."""
    from omnivggt_tpu_torch.utils.geometry import quat_to_mat

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    quat = torch.randn((1, S, 4), generator=gen, device=device)
    quat = quat / quat.norm(dim=-1, keepdim=True)
    t = torch.randn((1, S, 3, 1), generator=gen, device=device)
    K = torch.diag(torch.tensor([500.0, 500.0, 1.0], device=device)).repeat(1, S, 1, 1)
    K[..., 0, 2] = K[..., 1, 2] = size / 2
    ones = torch.ones((1, S, size, size), device=device)
    frames = torch.arange(S, device=device)
    return {
        "images": torch.rand((1, S, size, size, 3), generator=gen, device=device),
        "extrinsics": torch.cat([quat_to_mat(quat), t], -1),
        "intrinsics": K,
        "depth": 0.5 + 2.5 * torch.rand((1, S, size, size, 1), generator=gen, device=device),
        "depth_valid": ones,
        "world_points": torch.randn((1, S, size, size, 3), generator=gen, device=device),
        "point_valid": ones,
        "camera_mask": frames < 1,
        "depth_mask": frames < max(S // 2, 1),
        "camera_valid": torch.ones(S, dtype=torch.bool, device=device),
    }


def make_train_step(
    cfg: OmniVGGTConfig,
    optimizer: Optimizer,
    *,
    use_aux_inputs: bool = False,
    remat=True,
    seed: int = 0,
    attn_impl: str = "auto",
) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics).

    batch: tensors on the model's device with keys images (B,S,H,W,3),
    extrinsics, intrinsics, depth, depth_valid, world_points; optionally
    point_valid, camera_valid, and camera_mask/depth_mask (S,) when
    use_aux_inputs (modality-injection training). metrics: the losses and
    grad_norm (before clipping), as device scalars.

    Stochastic depth (cfg.aggregator.drop_path_rate > 0) draws from a
    generator seeded by (seed, step). DINOv2 runs unpadded (pad_tokens=False),
    as in the JAX step. remat: True or "full" recomputes each aggregator
    layer pair in the backward and keeps nothing of it, "dots" keeps the
    linear layers' outputs (more memory, less recompute, but slower on the
    H100: see aggregator._dots_saveable), False keeps every activation.
    `train_step.loss_and_grads(model, batch, step)` fills the parameters'
    .grad and returns the losses, without an update.
    """
    if (cfg.trunk_quant, cfg.attn_quant, cfg.head_quant) != ("none",) * 3:
        raise ValueError(
            "trunk_quant/attn_quant/head_quant are serving-only fast modes "
            "(round() kills the gradient); train with all set to 'none'"
        )
    if remat not in (True, False, "full", "dots"):
        raise ValueError(f"remat={remat!r}: True, 'full', 'dots' or False")

    def loss_and_grads(model, batch, step: int) -> dict:
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
        preds = M.apply(
            model, images, cfg, aux, attn_impl=attn_impl, pad_tokens=False,
            remat=remat, train_generator=generator,
        )
        losses = LS.total_loss(preds, batch, (H, W))
        losses["total"].backward()
        return {k: v.detach() for k, v in losses.items()}

    def train_step(state: TrainState, batch: dict):
        metrics = loss_and_grads(state.model, batch, state.step)
        metrics["grad_norm"] = state.optimizer.step()
        state.step += 1
        return state, metrics

    train_step.loss_and_grads = loss_and_grads
    return train_step
