"""The qk-norm logit-bound check behind the fixed-max softmax.

Counterpart of qk_logit_bound / check_bounded_logits_safe in
omnivggt_tpu/utils/validation.py. After a per-head-dim LayerNorm with
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

from torch import nn

from omnivggt_tpu_torch.ops.layers import Attention


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
