"""Input validation at the serving boundary, and the qk-norm logit-bound
check behind the fixed-max softmax.

Counterpart of validate_batch, qk_logit_bound and check_bounded_logits_safe
in omnivggt_tpu/utils/validation.py. `validate_batch` checks shapes, ranges,
finite values and camera sanity of one request with messages a caller can
act on. After a per-head-dim LayerNorm with
weight g and bias b, each row y of q (or k) has
||y||_2 <= sqrt(D) * (max|g| + max|b|), so
|q . k| / sqrt(D) <= sqrt(D) * A_q * A_k with A = max|g| + max|b|.
The kernels clamp scores at 80; a bound comfortably under that keeps the
bounded softmax exact, and loading a checkpoint turns the bounded mode off
for weights that break it.
"""

from __future__ import annotations

import logging
import math
from typing import List, Optional

import numpy as np
from torch import nn

from omnivggt_tpu_torch.ops.layers import Attention


class ValidationError(ValueError):
    pass


def check_valid_array(x, name: str = "array") -> Optional[str]:
    """NaN/Inf guard: a message, or None when x is finite (or None)."""
    if x is None:
        return None
    x = np.asarray(x)
    n_nan, n_inf = int(np.isnan(x).sum()), int(np.isinf(x).sum())
    if n_nan or n_inf:
        return f"{name}: {n_nan} NaNs, {n_inf} Infs out of {x.size}"
    return None


def validate_batch(
    images,
    extrinsics=None,
    intrinsics=None,
    depth=None,
    mask=None,
    depth_gt_index: Optional[List[int]] = None,
    camera_gt_index: Optional[List[int]] = None,
    patch_size: int = 14,
) -> None:
    """Validate a model input batch (numpy arrays); raises ValidationError
    listing every problem."""
    problems = []
    images = np.asarray(images)
    if images.ndim == 4:
        images = images[None]
    if images.ndim != 5 or images.shape[-1] != 3:
        problems.append(f"images must be (B,S,H,W,3); got {images.shape}")
    else:
        B, S, H, W, _ = images.shape
        if H % patch_size or W % patch_size:
            problems.append(f"H={H}, W={W} must be multiples of patch size {patch_size}")
        if images.min() < -1e-3 or images.max() > 1 + 1e-3:
            problems.append(
                f"images must be in [0,1]; got [{images.min():.3f}, {images.max():.3f}]"
            )
        for name, arr, shape in (
            ("images", images, images.shape),
            ("extrinsics", extrinsics, (B, S, 3, 4)),
            ("intrinsics", intrinsics, (B, S, 3, 3)),
            ("depth", depth, (B, S, H, W, 1)),
            ("mask", mask, (B, S, H, W)),
        ):
            if arr is None:
                continue
            arr = np.asarray(arr)
            if arr.shape != shape:
                problems.append(f"{name} must be {shape}; got {arr.shape}")
            msg = check_valid_array(arr, name)
            if msg:
                problems.append(msg)
        for name, idx in (("camera_gt_index", camera_gt_index),
                          ("depth_gt_index", depth_gt_index)):
            bad = [i for i in idx or () if not 0 <= i < S]
            if bad:
                problems.append(f"{name} out of range [0,{S}): {bad}")
        if camera_gt_index and intrinsics is not None and not problems:
            K = np.asarray(intrinsics)
            for i in camera_gt_index:
                if K[0, i, 0, 0] <= 0 or K[0, i, 1, 1] <= 0:
                    problems.append(
                        f"intrinsics[{i}] has non-positive focal length "
                        f"({K[0, i, 0, 0]:.3f}, {K[0, i, 1, 1]:.3f})"
                    )
    if problems:
        raise ValidationError("invalid batch:\n  " + "\n  ".join(problems))


def qk_logit_bound(model: nn.Module, head_dim: int) -> float:
    """Worst-case |scaled attention score| over every qk-normed attention."""

    def amp(norm: nn.LayerNorm) -> float:
        return float(norm.weight.detach().abs().max()) + float(norm.bias.detach().abs().max())

    worst = 0.0
    for m in model.modules():
        if isinstance(m, Attention) and m.q_norm is not None:
            worst = max(worst, amp(m.q_norm) * amp(m.k_norm))
    return math.sqrt(head_dim) * worst


def check_bounded_logits_safe(model: nn.Module, head_dim: int, limit: float = 40.0) -> bool:
    """True when the bound stays under `limit` (half the kernels' clamp)."""
    bound = qk_logit_bound(model, head_dim)
    if bound > limit:
        logging.getLogger(__name__).warning(
            "qk-norm logit bound %.1f exceeds %.1f; disabling the fixed-max "
            "softmax (config.bounded_attn_logits=False) for this model",
            bound, limit,
        )
        return False
    return True
