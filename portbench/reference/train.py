"""The fine-tuning step in plain float32 PyTorch: the published losses and
optimizer, written from the OmniVGGT / VGGT training recipe.

Loss (`loss`): the camera loss is the L1 error of the 9-value pose encoding
against the GT rebased on the frames with a valid camera, averaged over
those frames and summed over the camera head's iterates with weights
0.8^(T - 1 - t); the depth and point losses are the confidence-weighted L1
conf * |pred - gt| - 0.2 log(conf) averaged over valid pixels; the total
is their sum.

Optimizer (`AdamW`): the gradients' global norm is clipped to `grad_clip`
(g / norm * clip once the norm reaches clip); AdamW with beta (0.9, 0.999),
eps 1e-8, decoupled weight decay on matrices and kernels that are not
learned tokens; each parameter's learning rate is scaled by layer decay:
decay^(n - 1 - i) in a stack of n blocks ("blocks", "frame_blocks",
"global_blocks", "trunk"), decay^(deepest stack) in the patch embedder's
other weights, 1 elsewhere; the rate follows a linear warmup and a cosine
decay to 5% of the peak.

Imports torch only.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from portbench.reference.model import masked_pose_encoding

NO_DECAY = ("cls_token", "pos_embed", "register_tokens", "camera_token", "register_token",
            "depth_placeholder", "empty_pose_tokens")
STACKS = ("blocks", "frame_blocks", "global_blocks", "trunk")


def camera_loss(pose_list, ex, K, valid, hw, gamma: float = 0.8):
    gt = masked_pose_encoding(ex, K, valid, hw)
    T = pose_list.shape[0]
    w = valid.float()
    err = (pose_list - gt[None]).abs().mean(dim=-1)
    per_iter = (err * w[None]).sum(dim=(1, 2)) / w.sum().clamp_min(1.0)
    weights = gamma ** torch.arange(T - 1, -1, -1, device=pose_list.device, dtype=torch.float32)
    return (weights * per_iter).sum()


def conf_l1(pred, conf, gt, valid, alpha: float = 0.2):
    loss = conf * (pred - gt).abs().sum(dim=-1) - alpha * torch.log(conf)
    return (loss * valid).sum() / valid.sum().clamp_min(1.0)


def loss(preds: dict, batch: dict, hw) -> torch.Tensor:
    B, S = batch["images"].shape[:2]
    valid = batch["camera_valid"].bool().reshape(-1, S).expand(B, S)
    return (camera_loss(preds["pose_enc_list"], batch["extrinsics"], batch["intrinsics"], valid, hw)
            + conf_l1(preds["depth"], preds["depth_conf"], batch["depth"], batch["depth_valid"])
            + conf_l1(preds["world_points"], preds["world_points_conf"], batch["world_points"],
                      batch.get("point_valid", batch["depth_valid"])))


def lr_scales(names, decay: float) -> Dict[str, float]:
    depths: Dict[tuple, int] = {}
    for name in names:
        parts = name.split(".")
        for key in STACKS:
            if key in parts:
                i = parts.index(key)
                stack = tuple(parts[:i + 1])
                depths[stack] = max(depths.get(stack, 0), int(parts[i + 1]) + 1)
                break
    deepest = max(depths.values(), default=1)
    out = {}
    for name in names:
        parts = name.split(".")
        key = next((k for k in STACKS if k in parts), None)
        if key is not None:
            i = parts.index(key)
            out[name] = decay ** (depths[tuple(parts[:i + 1])] - 1 - int(parts[i + 1]))
        elif "patch_embed" in parts:
            out[name] = decay ** deepest
        else:
            out[name] = 1.0
    return out


class AdamW:
    def __init__(self, model, learning_rate: float, weight_decay: float, layer_decay: float,
                 warmup_steps: int, total_steps: int, grad_clip: float):
        self.params = dict(model.named_parameters())
        self.scale = lr_scales(list(self.params), layer_decay)
        self.decay = {n: p.ndim >= 2 and not any(k in n.split(".") for k in NO_DECAY)
                      for n, p in self.params.items()}
        self.m = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.peak, self.wd, self.clip = learning_rate, weight_decay, grad_clip
        self.warmup, self.total = warmup_steps, total_steps
        self.count = 0

    def rate(self, count: int) -> float:
        if count < self.warmup:
            return self.peak * count / self.warmup
        t = min(count - self.warmup, self.total - self.warmup)
        end = 0.05
        return self.peak * ((1 - end) * 0.5 * (1 + math.cos(math.pi * t / (self.total - self.warmup)))
                            + end)

    @torch.no_grad()
    def step(self) -> Dict[str, torch.Tensor]:
        """One update; returns the clipped gradients."""
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for n, p in self.params.items()}
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())).float()
        self.last_norm = norm
        factor = torch.where(norm >= self.clip, self.clip / norm, torch.ones_like(norm))
        grads = {n: g * factor for n, g in grads.items()}
        lr0 = self.rate(self.count)
        self.count += 1
        b1, b2, eps = 0.9, 0.999, 1e-8
        c1, c2 = 1 - b1 ** self.count, 1 - b2 ** self.count
        for n, p in self.params.items():
            lr = lr0 * self.scale[n]
            g = grads[n]
            if self.decay[n]:
                p.mul_(1 - lr * self.wd)
            self.m[n].mul_(b1).add_(g, alpha=1 - b1)
            self.v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
            p.addcdiv_(self.m[n] / c1, (self.v[n] / c2).sqrt().add_(eps), value=-lr)
        return grads
