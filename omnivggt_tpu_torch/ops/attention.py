"""Scaled dot-product attention over (B, N, H, D) with three implementations.

Counterpart of omnivggt_tpu/ops/attention.py:

  - "plain": materialised scores with an fp32 softmax (the counterpart of
    `_attention_xla`). A static (Python int) kv_valid slices K/V, so the
    softmax reduces over exactly the valid keys; a tensor kv_valid masks
    keys at or past it with -1e30. As in `_attention_xla`, the normalised
    probabilities are rounded to v's dtype before P @ V, which accumulates
    in fp32: bf16 inputs give bf16 P, fp32 inputs an fp32 P @ V. (The
    kernels and their plain versions round the unnormalised P, as the TPU
    kernels do, and divide by the row sum last.)
  - "blockwise": streaming softmax over key blocks of BLOCK_K in plain
    torch ops, with a running (max, denominator, fp32 accumulator) carry
    (the counterpart of `_attention_blockwise`): memory O(N * BLOCK_K),
    any device, differentiable by autograd.
  - "flash": the Hopper kernels (ops/kernels/flash_attention.py), in the
    JAX package's order: the token-major packed kernel when the key axis
    fits its contract (Nk <= PACKED_MAX_KEYS, head dim 64 or 128: frame and
    DINOv2 attention;
    it wins over qk_int8 there, as in the JAX dispatch), else the
    token-major streaming kernel when `stream_eligible`, else the
    head-major kernel (global attention), each of the last two in its int8
    form under qk_int8.
  - "auto": "flash" for CUDA tensors with N >= 1024; otherwise the JAX
    package's branches off the TPU: "plain" while N <= 4096 and the fp32
    score tensor B * H * N^2 * 4 stays within 8e9 bytes
    (OMNIVGGT_XLA_MAX_SCORE_BYTES, the JAX package's name), else
    "blockwise". The JAX package's TPU-measured row threshold is not
    carried over until it is measured on the H100.
"""

from __future__ import annotations

import os

import torch

from omnivggt_tpu_torch.ops.kernels.flash_attention import (
    HEAD_DIMS,
    NEG_INF,
    PACKED_MAX_KEYS,
    flash_attention,
    flash_attention_packed,
    flash_attention_packed_stream,
)

FLASH_MIN_SEQ = 1024
# sequences at or below this length, whose fp32 score tensor stays within
# the byte cap, materialise their scores ("plain"); longer ones stream keys
PLAIN_MAX_SEQ = 4096
PLAIN_MAX_SCORE_BYTES = int(float(os.environ.get("OMNIVGGT_XLA_MAX_SCORE_BYTES", "8e9")))
BLOCK_K = 1024

# The token-major streaming kernel for long (global-attention) key axes is
# off by default, as in the JAX package, whose TPU measurements had it lose
# to the head-major int8 kernel; OMNIVGGT_STREAM_ATTN=1 opts in. This
# card's own times of both are in PERF.md.
_STREAM_ATTN = os.environ.get("OMNIVGGT_STREAM_ATTN", "0") == "1"


def packed_eligible(q_shape, n_keys: int) -> bool:
    """Whether the token-major packed kernel serves this (q, k) pair: the
    key axis fits its contract and the head dim is one it takes (the JAX
    package's rule without its TPU-measured row threshold)."""
    return n_keys <= PACKED_MAX_KEYS and q_shape[-1] in HEAD_DIMS


def stream_eligible(q_shape, n_keys: int, bounded: bool) -> bool:
    """Whether the token-major streaming kernel serves this (q, k) pair:
    the flag is on, the softmax is bounded, the key axis is past the packed
    kernel's contract, and D == 64 with an even head count (the JAX
    package's contract, kept so both packages dispatch alike)."""
    H, D = q_shape[-2], q_shape[-1]
    return (
        _STREAM_ATTN and bool(bounded) and n_keys > PACKED_MAX_KEYS
        and D == 64 and H % 2 == 0
    )


def attention_plain(q, k, v, kv_valid=None):
    """(B, N, H, D) attention with fp32 scores and softmax, the
    probabilities rounded to v's dtype, P @ V accumulated in fp32 (the
    arithmetic of `_attention_xla`); output in q's dtype. A static kv_valid
    slices K/V first. Differentiable by autograd."""
    if kv_valid is not None and not isinstance(kv_valid, torch.Tensor):
        k, v = k[:, : int(kv_valid)], v[:, : int(kv_valid)]
        kv_valid = None
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()).mul_(q.shape[-1] ** -0.5)
    if kv_valid is not None:
        s.masked_fill_(torch.arange(k.shape[1], device=q.device) >= kv_valid, NEG_INF)
    probs = torch.softmax(s, dim=-1)
    del s  # one (B, H, N, Nk) fp32 tensor at a time beside the rounded copy
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(), v.float()).to(q.dtype)


def attention_blockwise(q, k, v, kv_valid=None, block_k: int = BLOCK_K):
    """(B, N, H, D) attention streamed over key blocks: each block's fp32
    scores update a running row max m, denominator l and fp32 accumulator,
    rescaled by exp(m_old - m_new); output acc / l in q's dtype. Keys at or
    past a tensor kv_valid score -1e30; a static kv_valid slices K/V first,
    and the last block is shorter rather than padded, so no padded key
    enters a sum. Memory O(N * block_k) per block; differentiable by
    autograd (the max is a constant shift, taken without a gradient)."""
    if kv_valid is not None and not isinstance(kv_valid, torch.Tensor):
        k, v = k[:, : int(kv_valid)], v[:, : int(kv_valid)]
        kv_valid = None
    B, N, H, D = q.shape
    qf = q.float() * D**-0.5
    m = torch.full((B, H, N), NEG_INF, dtype=torch.float32, device=q.device)
    den = torch.zeros((B, H, N), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, N, D), dtype=torch.float32, device=q.device)
    for k0 in range(0, k.shape[1], block_k):
        kb, vb = k[:, k0 : k0 + block_k].float(), v[:, k0 : k0 + block_k].float()
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kb)
        if kv_valid is not None:
            key = k0 + torch.arange(kb.shape[1], device=q.device)
            s = s.masked_fill(key >= kv_valid, NEG_INF)
        m_new = torch.maximum(m, s.detach().amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        den = den * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vb)
        m = m_new
    return (acc / den[..., None]).transpose(1, 2).to(q.dtype)


def resolve_impl(q: torch.Tensor, impl: str = "auto") -> str:
    """The implementation "auto" picks for this query tensor (its shape and
    device only: a meta tensor will do)."""
    if impl != "auto":
        return impl
    B, N, H, _ = q.shape
    if q.device.type == "cuda" and N >= FLASH_MIN_SEQ:
        return "flash"
    if N <= PLAIN_MAX_SEQ and B * H * N * N * 4 <= PLAIN_MAX_SCORE_BYTES:
        return "plain"
    return "blockwise"


def scaled_dot_product_attention(
    q, k, v, impl: str = "auto", kv_valid=None, bounded_logits: bool = False,
    qk_int8: bool = False,
):
    """Non-causal multi-head attention over (B, N, H, D) tensors.

    kv_valid: optional valid-key prefix (Python int or integer tensor).
    bounded_logits: caller-guaranteed |scores| far below 80 (qk-normed
    inputs), which lets the kernels run at a fixed softmax max; the plain
    and blockwise implementations ignore it.
    qk_int8: int8 scores in the flash kernels that have an int8 form
    (serving only); the plain and blockwise implementations and the packed
    kernel ignore it, as in the JAX package."""
    impl = resolve_impl(q, impl)
    if impl == "plain":
        return attention_plain(q, k, v, kv_valid)
    if impl == "blockwise":
        return attention_blockwise(q, k, v, kv_valid)
    if impl == "flash":
        if packed_eligible(q.shape, k.shape[1]):
            return flash_attention_packed(
                q, k, v, kv_valid=kv_valid, bounded_logits=bounded_logits
            )
        if stream_eligible(q.shape, k.shape[1], bounded_logits):
            return flash_attention_packed_stream(q, k, v, kv_valid=kv_valid, qk_int8=qk_int8)
        if qk_int8:
            return flash_attention(
                q, k, v, kv_valid=kv_valid, bounded_logits=bounded_logits, qk_int8=True
            )
        return flash_attention(q, k, v, kv_valid=kv_valid, bounded_logits=bounded_logits)
    raise ValueError(f"unknown attention impl: {impl}")
