"""Scaled dot-product attention over (B, N, H, D) with two implementations.

Counterpart of omnivggt_tpu/ops/attention.py:

  - "plain": materialised scores with an fp32 softmax (the counterpart of
    `_attention_xla`). A static (Python int) kv_valid slices K/V, so the
    softmax reduces over exactly the valid keys; a tensor kv_valid masks
    keys at or past it with -1e30. Unlike `_attention_xla`, P @ V runs in
    fp32 (no bf16 rounding of P), as in the kernels, so the kernel path and
    this reference path round only at their outputs.
  - "flash": the Hopper kernels (ops/kernels/flash_attention.py): the
    token-major kernel when the key axis fits its contract
    (Nk <= PACKED_MAX_KEYS: frame and DINOv2 attention), else the
    head-major kernel (global attention).
  - "auto": "flash" for CUDA tensors with N >= 1024, else "plain". The
    length split is the JAX package's; its TPU-measured row and score-byte
    thresholds are not carried over until they are measured on the H100.
"""

from __future__ import annotations

import torch

from omnivggt_tpu_torch.ops.kernels.flash_attention import (
    PACKED_MAX_KEYS,
    flash_attention,
    flash_attention_packed,
)
from omnivggt_tpu_torch.ops.kernels.flash_attention import (
    attention_plain as kernel_plain,
)

FLASH_MIN_SEQ = 1024


def attention_plain(q, k, v, kv_valid=None):
    """(B, N, H, D) attention with fp32 scores, softmax and P @ V; output in
    q's dtype. A static kv_valid slices K/V first."""
    if kv_valid is not None and not isinstance(kv_valid, torch.Tensor):
        k, v = k[:, : int(kv_valid)], v[:, : int(kv_valid)]
        kv_valid = None
    return kernel_plain(q, k, v, kv_valid, bounded_logits=False)


def resolve_impl(q: torch.Tensor, impl: str = "auto") -> str:
    """The implementation "auto" picks for this query tensor."""
    if impl != "auto":
        return impl
    if q.device.type == "cuda" and q.shape[1] >= FLASH_MIN_SEQ:
        return "flash"
    return "plain"


def scaled_dot_product_attention(
    q, k, v, impl: str = "auto", kv_valid=None, bounded_logits: bool = False
):
    """Non-causal multi-head attention over (B, N, H, D) tensors.

    kv_valid: optional valid-key prefix (Python int or integer tensor).
    bounded_logits: caller-guaranteed |scores| far below 80 (qk-normed
    inputs), which lets the kernels run at a fixed softmax max; the plain
    implementation ignores it."""
    impl = resolve_impl(q, impl)
    if impl == "plain":
        return attention_plain(q, k, v, kv_valid)
    if impl == "flash":
        kernel = (
            flash_attention_packed if k.shape[1] <= PACKED_MAX_KEYS else flash_attention
        )
        return kernel(q, k, v, kv_valid=kv_valid, bounded_logits=bounded_logits)
    raise ValueError(f"unknown attention impl: {impl}")
