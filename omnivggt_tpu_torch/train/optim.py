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
from typing import Callable, Dict, List, Optional

import torch
from torch import nn

from omnivggt_tpu_torch.parallel.collectives import all_reduce_sum, seq_sum

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
    schedule -> per-parameter update scales, over `model`'s parameters.

    Under a state layout (parallel/fsdp.py, `use_layout`) each sharded
    parameter's AdamW state lives per shard: the optimizer steps this
    process's shards, each with moments of its own, under the parameter's
    weight-decay mask and layer-decay scale. The global norm stays one norm
    over the whole gradient: the squares of the sharded gradients summed
    over every rank (over the seq processes in rank order, then over the
    data ranks, so every process clips by the same bits), each replicated
    gradient counted once. `state_dict`
    gathers the moments into the unsharded layout, `load_state_dict`
    re-shards such a dict, so a checkpoint restores under any layout."""

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
        self.weight_decay = weight_decay
        self.count = 0
        self.layout = None
        mask = weight_decay_mask(model)
        # {(update scale, decayed): parameter names}, in the model's order
        self.groups: Dict[tuple, List[str]] = {}
        for name, _ in model.named_parameters():
            key = (1.0 if scales is None else scales[name], mask[name])
            self.groups.setdefault(key, []).append(name)
        self._build({name: [p] for name, p in model.named_parameters()})

    def _build(self, slots: Dict[str, List[torch.Tensor]]) -> None:
        """AdamW over `slots` ({parameter name: the tensors it steps})."""
        self.slots = slots
        self.params = [t for names in self.groups.values() for n in names for t in slots[n]]
        self.adamw = torch.optim.AdamW(
            [
                {"params": [t for n in names for t in slots[n]], "lr_scale": scale,
                 "weight_decay": self.weight_decay if decay else 0.0}
                for (scale, decay), names in self.groups.items()
            ],
            lr=0.0, betas=(0.9, 0.999), eps=1e-8,
        )

    def use_layout(self, layout) -> None:
        """Step `layout`'s shards (parallel/fsdp.StateLayout) from now on;
        moments taken so far are split onto them."""
        if self.layout is not None:
            raise ValueError("the optimizer already steps a state layout")
        taken = {n: self.adamw.state[ts[0]] for n, ts in self.slots.items()
                 if ts[0] in self.adamw.state}
        self._build({n: layout.shards[n] if n in layout.shards else [layout.params[n]]
                     for n in self.slots})
        self.layout = layout
        for name, entry in taken.items():
            self._set_state(name, entry)

    def _set_state(self, name: str, entry: dict) -> None:
        """One parameter's AdamW state from its whole moments."""
        slots = self.slots[name]
        moments = {}
        for key in ("exp_avg", "exp_avg_sq"):
            whole = entry[key].to(device=slots[0].device, dtype=slots[0].dtype)
            moments[key] = (self.layout.local_pieces(name, whole)
                            if self.layout is not None and name in self.layout.specs else [whole])
        for i, t in enumerate(slots):
            self.adamw.state[t] = {"step": entry["step"].clone(),
                                   **{k: v[i].clone() for k, v in moments.items()}}

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    def _global_norm(self, grads) -> torch.Tensor:
        if self.layout is None:
            return global_norm(grads)
        sharded, replicated = [], []
        for name, ts in self.slots.items():
            (sharded if name in self.layout.specs else replicated).extend(t.grad for t in ts)

        def squares(gs):
            if not gs:
                return torch.zeros((), device=grads[0].device)
            return torch.stack([torch.linalg.vector_norm(g.float()) for g in gs]).square().sum()

        mesh = self.layout.mesh
        total = squares(sharded)
        if mesh.seq_processes:
            total = seq_sum(total, mesh)
        return (all_reduce_sum(total, mesh) + squares(replicated)).sqrt()

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """One update from the parameters' .grad (the shards' under a
        layout); returns the gradients' global norm before clipping."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        norm = self._global_norm(grads)
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

    def state_dict(self, place: Optional[Callable] = None) -> dict:
        """{"adamw": torch.optim.AdamW's state dict over the whole
        parameters in the model's order, "count"}; under a layout the
        moments are gathered (every process must call it), each passed
        through `place` as soon as it is whole (StateLayout.full_state_dict)."""
        sd = self.adamw.state_dict()
        if self.layout is None:
            return {"adamw": sd, "count": self.count}
        place = place or (lambda t: t)
        state, groups, idx = {}, [], 0
        for group, names in zip(sd["param_groups"], self.groups.values()):
            ids = []
            for name in names:
                entries = [self.adamw.state.get(t) for t in self.slots[name]]
                if entries[0]:
                    whole = {"step": entries[0]["step"].clone()}
                    for key in ("exp_avg", "exp_avg_sq"):
                        pieces = [e[key] for e in entries]
                        whole[key] = place(self.layout.full_tensor(name, pieces)
                                           if name in self.layout.specs else pieces[0].clone())
                    state[idx] = whole
                ids.append(idx)
                idx += 1
            groups.append({**{k: v for k, v in group.items() if k != "params"}, "params": ids})
        return {"adamw": {"state": state, "param_groups": groups}, "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        """Load a state_dict (in the unsharded layout, whoever wrote it)."""
        if self.layout is None:
            self.adamw.load_state_dict(state["adamw"])
        else:
            names = [n for ns in self.groups.values() for n in ns]
            for idx, entry in state["adamw"]["state"].items():
                self._set_state(names[int(idx)], entry)
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
