"""Input validation at the serving boundary, NaN detection, and the
qk-norm logit-bound check behind the fixed-max softmax.

Counterpart of omnivggt_tpu/utils/validation.py:
  - validate_batch: shapes, ranges, finite values and camera sanity of one
    request, with messages a caller can act on;
  - guard_predictions: a NaN/Inf scan over a prediction dict (tensors on
    any device, or arrays);
  - enable_nan_debugging: the counterpart of `jax_debug_nans`. A global
    module forward hook raises FloatingPointError at the first module
    whose floating output holds a NaN (the port's functional layers run
    global hooks, ops/layers.run_forward_hooks), and autograd's anomaly
    mode does the same for the backward;
  - qk_logit_bound / check_bounded_logits_safe: after a per-head-dim
    LayerNorm with weight g and bias b, each row y of q (or k) has
    ||y||_2 <= sqrt(D) * (max|g| + max|b|), so
    |q . k| / sqrt(D) <= sqrt(D) * A_q * A_k with A = max|g| + max|b|.
    The kernels clamp scores at 80; a bound comfortably under that keeps
    the bounded softmax exact, and loading a checkpoint turns the bounded
    mode off for weights that break it.
"""

from __future__ import annotations

import logging
import math
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn
from torch.nn.modules.module import register_module_forward_hook

from omnivggt_tpu_torch.ops.layers import Attention
from omnivggt_tpu_torch.utils.pytree import check_valid_array


class ValidationError(ValueError):
    pass


_NAN_HOOK = None


def _holds_nan(out) -> bool:
    if isinstance(out, torch.Tensor):
        return out.is_floating_point() and bool(torch.isnan(out).any())
    if isinstance(out, dict):
        return any(_holds_nan(v) for v in out.values())
    if isinstance(out, (list, tuple)):
        return any(_holds_nan(v) for v in out)
    return False


def _nan_hook(module, args, out):
    if _holds_nan(out):
        err = FloatingPointError(f"NaN in the output of {type(module).__name__}")
        err.module = module
        raise err


def enable_nan_debugging(enabled: bool = True) -> None:
    """Raise FloatingPointError (with the module as `.module`) at the first
    module whose floating output holds a NaN, and turn on autograd's
    anomaly detection for the backward; False removes both. NaN only, as
    jax_debug_nans. Each check reads the device, so this is for debugging."""
    global _NAN_HOOK
    if _NAN_HOOK is not None:
        _NAN_HOOK.remove()
        _NAN_HOOK = None
    if enabled:
        _NAN_HOOK = register_module_forward_hook(_nan_hook)
    torch.autograd.set_detect_anomaly(enabled)


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


def guard_predictions(predictions: Dict, raise_on_error: bool = False) -> List[str]:
    """Scan a prediction dict for NaN/Inf; returns (and optionally raises)
    the list of problems."""
    problems = []
    for key, value in predictions.items():
        if hasattr(value, "ndim"):
            msg = check_valid_array(value, key)
            if msg:
                problems.append(msg)
    if problems and raise_on_error:
        raise ValidationError("non-finite predictions:\n  " + "\n  ".join(problems))
    return problems


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
