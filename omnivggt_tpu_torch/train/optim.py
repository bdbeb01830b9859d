"""The optimizer: optax's chain, written over torch.optim.AdamW
(counterpart of omnivggt_tpu/train/optim.py and train/step.py's
make_optimizer).

The JAX package chains clip_by_global_norm -> adamw (masked weight decay,
warmup-cosine learning rate) -> scale_by_layer_decay. Here:

  - the global-norm clip is optax's: grads / norm * max_norm when the norm
    reaches max_norm (torch's clip_grad_norm_ would add 1e-6 to the norm);
    the step reports the norm before clipping;
  - adamw is torch.optim.AdamW at optax's defaults (b1 0.9, b2 0.999,
    eps 1e-8, decoupled decay): p -= lr * (m_hat / (sqrt(v_hat) + eps) + wd p);
  - the layer decay multiplies the whole adamw update, weight decay term
    included, so it is a per-parameter-group learning-rate multiplier;
  - the learning rate follows optax.warmup_cosine_decay_schedule, counted
    from 0 at the first step (warmup 1 makes the first step's rate 0);
  - parameters the forward did not reach get zero gradients, as in JAX,
    so their moments and weight decay still advance.

The weight-decay mask and the layer-decay scales are derived from the
port's parameter names with the JAX package's rules: no decay on biases,
norms, LayerScale gammas and learned tokens (1-D tensors, or a token
name); stacked blocks ("blocks", "frame_blocks", "global_blocks", "trunk")
scale by decay^(n - 1 - i) over their own depth n; everything else under a
"patch_embed" component (the DINOv2 backbone's non-block weights, or the
conv patchify) by decay^(deepest stack), and "depth_patch_embed" is not
such a component.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
from torch import nn

NO_DECAY_KEYS = (
    "cls_token", "pos_embed", "register_tokens", "camera_token", "register_token",
    "depth_placeholder", "empty_pose_tokens",
)
STACKED_BLOCK_KEYS = ("blocks", "frame_blocks", "global_blocks", "trunk")


def weight_decay_mask(model: nn.Module) -> Dict[str, bool]:
    """{parameter name: True to apply weight decay} (matrices and conv
    kernels only; no biases, norms, gammas or learned tokens)."""
    return {
        name: p.ndim >= 2 and not any(part in NO_DECAY_KEYS for part in name.split("."))
        for name, p in model.named_parameters()
    }


def _stack_depths(names) -> Dict[tuple, int]:
    """{(name prefix up to a stacked key): number of blocks in the stack}."""
    depths: Dict[tuple, int] = {}
    for name in names:
        parts = name.split(".")
        for key in STACKED_BLOCK_KEYS:
            if key in parts:
                i = parts.index(key)
                stack = tuple(parts[: i + 1])
                depths[stack] = max(depths.get(stack, 0), int(parts[i + 1]) + 1)
                break
    return depths


def layer_decay_scales(model: nn.Module, layer_decay: float) -> Dict[str, float]:
    """{parameter name: multiplier of its update} (scale_by_layer_decay)."""
    names = [name for name, _ in model.named_parameters()]
    depths = _stack_depths(names)
    max_depth = max(depths.values(), default=1)
    scales = {}
    for name in names:
        parts = name.split(".")
        key = next((k for k in STACKED_BLOCK_KEYS if k in parts), None)
        if key is not None:
            i = parts.index(key)
            n = depths[tuple(parts[: i + 1])]
            scales[name] = layer_decay ** (n - 1 - int(parts[i + 1]))
        elif "patch_embed" in parts:
            scales[name] = layer_decay ** max_depth
        else:
            scales[name] = 1.0
    return scales


def warmup_cosine_decay_schedule(
    init_value: float, peak_value: float, warmup_steps: int, decay_steps: int,
    end_value: float,
) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule: linear init -> peak over
    warmup_steps, then a half cosine to end_value at decay_steps (which
    counts the warmup)."""
    if decay_steps - warmup_steps <= 0:
        raise ValueError(f"decay_steps {decay_steps} must exceed warmup_steps {warmup_steps}")
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return init_value + (peak_value - init_value) * count / warmup_steps
        t = min(count - warmup_steps, decay_steps - warmup_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / (decay_steps - warmup_steps)))
        return peak_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


def global_norm(tensors) -> torch.Tensor:
    """sqrt(sum of squares) over every element of every tensor (fp32)."""
    return torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(t.float()) for t in tensors]))


class Optimizer:
    """clip_by_global_norm -> AdamW with masked weight decay and a
    schedule -> per-parameter update scales, over `model`'s parameters."""

    def __init__(
        self,
        model: nn.Module,
        schedule: Callable[[int], float],
        weight_decay: float = 0.05,
        grad_clip: Optional[float] = 1.0,
        scales: Optional[Dict[str, float]] = None,
    ):
        self.schedule = schedule
        self.grad_clip = grad_clip
        self.count = 0
        mask = weight_decay_mask(model)
        groups: Dict[tuple, list] = {}
        for name, p in model.named_parameters():
            key = (1.0 if scales is None else scales[name], mask[name])
            groups.setdefault(key, []).append(p)
        self.params = [p for ps in groups.values() for p in ps]
        self.adamw = torch.optim.AdamW(
            [
                {"params": ps, "lr_scale": scale, "weight_decay": weight_decay if decay else 0.0}
                for (scale, decay), ps in groups.items()
            ],
            lr=0.0, betas=(0.9, 0.999), eps=1e-8,
        )

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """One update from the parameters' .grad; returns the gradients'
        global norm before clipping."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        norm = global_norm(grads)
        if self.grad_clip is not None:
            # optax: t if norm < max_norm else t / norm * max_norm
            clip = norm >= self.grad_clip
            div = torch.where(clip, norm, 1.0)
            mul = torch.where(clip, torch.tensor(self.grad_clip, device=norm.device), 1.0)
            for g in grads:
                g.div_(div).mul_(mul)
        lr = self.schedule(self.count)
        for group in self.adamw.param_groups:
            group["lr"] = lr * group["lr_scale"]
        self.adamw.step()
        self.count += 1
        return norm

    def state_dict(self) -> dict:
        return {"adamw": self.adamw.state_dict(), "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        self.adamw.load_state_dict(state["adamw"])
        self.count = int(state["count"])


def make_finetune_optimizer(
    model: nn.Module,
    learning_rate: float = 1e-5,
    weight_decay: float = 0.05,
    layer_decay: float = 0.9,
    warmup_steps: int = 500,
    total_steps: int = 50_000,
    grad_clip: float = 1.0,
) -> Optimizer:
    """AdamW with warmup-cosine LR, masked weight decay and layer-wise
    decay; the warmup is clamped inside short runs, as in the JAX package."""
    warmup_steps = min(warmup_steps, max(total_steps - 1, 0))
    schedule = warmup_cosine_decay_schedule(
        0.0, learning_rate, warmup_steps, total_steps, learning_rate * 0.05
    )
    return Optimizer(
        model, schedule, weight_decay, grad_clip, layer_decay_scales(model, layer_decay)
    )
