"""Transformer layers: parameter modules plus plain functions over them.

Counterpart of omnivggt_tpu/ops/layers.py. The modules hold parameters
under the reference's state-dict names (`qkv`, `proj`, `q_norm`, `norm1`,
`mlp.fc1`, `ls1.gamma`, `patch_embed.proj`, ...); the computation lives in
plain functions that take a module the way the JAX functions take a
parameter dict, and cast each weight to the activation dtype at its point
of use:

  - linear, layer_norm (fp32 statistics), mlp (exact-erf or tanh GELU);
  - attention: fused qkv, per-head-dim q/k LayerNorm, 2D RoPE;
  - block: pre-LN with LayerScale and, when training, stochastic depth
    (drop_path) from keep masks the caller draws;
  - patch_embed and conv2d, channels-last like the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from omnivggt_tpu_torch.ops.attention import scaled_dot_product_attention
from omnivggt_tpu_torch.ops.rope import apply_rope


class LayerScale(nn.Module):
    def __init__(self, dim: int, init_values: float = 1.0):
        super().__init__()
        self.init_values = init_values
        self.gamma = nn.Parameter(torch.full((dim,), float(init_values)))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, out_dim: Optional[int] = None, bias: bool = True):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden, bias=bias)
        self.fc2 = nn.Linear(hidden, out_dim or dim, bias=bias)


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, *, qkv_bias=True, proj_bias=True, qk_norm=False):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim, bias=proj_bias)
        if qk_norm:
            self.q_norm = nn.LayerNorm(dim // num_heads)
            self.k_norm = nn.LayerNorm(dim // num_heads)
        else:
            self.q_norm = self.k_norm = None


class Block(nn.Module):
    """Pre-LN transformer block parameters (norm1, attn, norm2, mlp, and
    ls1/ls2 when init_values is set)."""

    def __init__(
        self, dim: int, num_heads: int, *, mlp_ratio: float = 4.0, qkv_bias=True,
        proj_bias=True, ffn_bias=True, init_values: Optional[float] = None,
        qk_norm=False,
    ):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim)
        self.attn = Attention(
            dim, num_heads, qkv_bias=qkv_bias, proj_bias=proj_bias, qk_norm=qk_norm
        )
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), bias=ffn_bias)
        if init_values:
            self.ls1 = LayerScale(dim, init_values)
            self.ls2 = LayerScale(dim, init_values)
        else:
            self.ls1 = self.ls2 = None


class PatchEmbed(nn.Module):
    """Convolutional patchify parameters (`proj`, a stride-p conv)."""

    def __init__(self, patch_size: int, in_chans: int, embed_dim: int):
        super().__init__()
        self.patch_size = patch_size
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size, stride=patch_size)


# ---------------------------------------------------------------------------
# plain functions
# ---------------------------------------------------------------------------


def _cast(t: Optional[torch.Tensor], dtype):
    return None if t is None else t.to(dtype)


def linear(p: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, p.weight.to(x.dtype), _cast(p.bias, x.dtype))


def layer_norm(p: Optional[nn.LayerNorm], x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis with fp32 statistics whatever x's dtype;
    p=None normalises without an affine transform."""
    w = b = None
    if p is not None:
        w, b = p.weight.float(), p.bias.float()
    return F.layer_norm(x.float(), (x.shape[-1],), w, b, eps).to(x.dtype)


def mlp(p: Mlp, x: torch.Tensor, approx_gelu: bool = False) -> torch.Tensor:
    """fc1 -> GELU (exact erf, or tanh with approx_gelu) -> fc2."""
    h = F.gelu(linear(p.fc1, x), approximate="tanh" if approx_gelu else "none")
    return linear(p.fc2, h)


def conv2d(p: nn.Conv2d, x: torch.Tensor, stride=1, padding=0) -> torch.Tensor:
    """NCHW convolution with the module's weight cast to x's dtype."""
    return F.conv2d(x, p.weight.to(x.dtype), _cast(p.bias, x.dtype), stride, padding)


def drop_path_masks(n: int, count: int, rate: float, generator: torch.Generator,
                    device) -> torch.Tensor:
    """(count, n) fp32 per-sample Bernoulli(1 - rate) keep masks for
    `count` residual branches, drawn from `generator` (on `device`)."""
    keep = torch.full((count, n), 1.0 - rate, device=device)
    return torch.bernoulli(keep, generator=generator)


def drop_path(x: torch.Tensor, keep: torch.Tensor, rate: float) -> torch.Tensor:
    """Stochastic depth (counterpart of ops/layers.py::drop_path): x times a
    per-sample keep mask over the leading axis, scaled by 1/keep_prob. The
    mask is an input, drawn before any activation checkpoint, so the
    recomputed forward drops the same samples."""
    shape = (x.shape[0],) + (1,) * (x.ndim - 1)
    return x * (keep.reshape(shape) / (1.0 - rate)).to(x.dtype)


def attention(
    p: Attention,
    x: torch.Tensor,
    rope_cos: Optional[torch.Tensor] = None,
    rope_sin: Optional[torch.Tensor] = None,
    *,
    ln_eps: float = 1e-5,
    impl: str = "auto",
    kv_valid=None,
    allow_bounded: bool = True,
) -> torch.Tensor:
    """Multi-head self-attention over (B, N, C) tokens: fused qkv, optional
    per-head-dim q/k LayerNorm, RoPE on q and k from (N, head_dim) tables.

    The fixed-max softmax is used when qk-norm is present and allow_bounded
    holds: after the norm, |q.k|/sqrt(D) <= sqrt(D)*(max|g_q|+max|b_q|)*
    (max|g_k|+max|b_k|), which checkpoint loading checks against the
    kernel's clamp (utils/validation)."""
    B, N, C = x.shape
    H = p.num_heads
    qkv = linear(p.qkv, x).reshape(B, N, 3, H, C // H)
    q, k, v = qkv.unbind(2)  # (B, N, H, D) views
    if p.q_norm is not None:
        q = layer_norm(p.q_norm, q, ln_eps)
        k = layer_norm(p.k_norm, k, ln_eps)
    if rope_cos is not None:
        q = apply_rope(q, rope_cos, rope_sin)
        k = apply_rope(k, rope_cos, rope_sin)
    bounded = allow_bounded and p.q_norm is not None
    o = scaled_dot_product_attention(
        q, k, v, impl=impl, kv_valid=kv_valid, bounded_logits=bounded
    )
    return linear(p.proj, o.reshape(B, N, C))


def block(
    p: Block,
    x: torch.Tensor,
    rope_cos: Optional[torch.Tensor] = None,
    rope_sin: Optional[torch.Tensor] = None,
    *,
    ln_eps: float = 1e-5,
    attn_impl: str = "auto",
    kv_valid=None,
    allow_bounded: bool = True,
    approx_gelu: bool = False,
    drop_path_rate: float = 0.0,
    drop_path_keep: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """x += DP(LS1(Attn(LN(x), rope))); x += DP(LS2(MLP(LN(x)))), where DP
    is stochastic depth, active only when `drop_path_keep` (2, x.shape[0]
    keep masks, drop_path_masks) is given and drop_path_rate > 0."""
    use_dp = drop_path_rate > 0.0 and drop_path_keep is not None
    h = attention(
        p.attn, layer_norm(p.norm1, x, ln_eps), rope_cos, rope_sin,
        ln_eps=ln_eps, impl=attn_impl, kv_valid=kv_valid,
        allow_bounded=allow_bounded,
    )
    if p.ls1 is not None:
        h = h * p.ls1.gamma.to(h.dtype)
    if use_dp:
        h = drop_path(h, drop_path_keep[0], drop_path_rate)
    x = x + h
    h = mlp(p.mlp, layer_norm(p.norm2, x, ln_eps), approx_gelu=approx_gelu)
    if p.ls2 is not None:
        h = h * p.ls2.gamma.to(h.dtype)
    if use_dp:
        h = drop_path(h, drop_path_keep[1], drop_path_rate)
    return x + h


def patch_embed(p: PatchEmbed, x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C_in) channels-last images -> (B, N, D) patch tokens."""
    H, W = x.shape[1:3]
    ps = p.patch_size
    if H % ps or W % ps:
        raise ValueError(f"image size {(H, W)} not divisible by patch size {ps}")
    y = conv2d(p.proj, x.permute(0, 3, 1, 2), stride=ps)  # (B, D, gh, gw)
    return y.flatten(2).transpose(1, 2)
