"""DINOv2 ViT patch embedder (counterpart of omnivggt_tpu/models/dinov2.py).

Conv patchify, cls token plus the learned pos embed (bicubic antialiased
interpolation to the patch grid), register tokens inserted after the
pos-embed add, `depth` pre-LN blocks (LayerScale, LN eps 1e-6, no qk-norm,
no RoPE; the feed-forward of `cfg.ffn_layer`: "mlp", "swiglu" or
"swiglufused"), final LayerNorm; returns the normalised patch tokens.

With `pad_tokens` the token count is padded to a multiple of 8 (1374 ->
1376 at 518 px) and the pad tokens are masked out as keys through a static
`kv_valid`, as the JAX package does; the valid tokens' outputs are the
unpadded computation's, and the masked running-max variant of the packed
attention kernel stays on the inference path.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from omnivggt_tpu_torch.config import DinoV2Config
from omnivggt_tpu_torch.ops import layers as L
from omnivggt_tpu_torch.ops.resize import interpolate


class DinoVisionTransformer(nn.Module):
    """Parameters under the reference's names: patch_embed.proj, cls_token,
    pos_embed, register_tokens, blocks.{i}.*, norm."""

    def __init__(self, cfg: DinoV2Config):
        super().__init__()
        self.cfg = cfg
        C = cfg.embed_dim
        self.patch_embed = L.PatchEmbed(cfg.patch_size, cfg.in_chans, C)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, C))
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.num_patches + 1, C))
        if cfg.num_register_tokens:
            self.register_tokens = nn.Parameter(torch.zeros(1, cfg.num_register_tokens, C))
        else:
            self.register_tokens = None
        self.blocks = nn.ModuleList(
            L.Block(
                C, cfg.num_heads, mlp_ratio=cfg.mlp_ratio,
                init_values=cfg.init_values, qk_norm=cfg.qk_norm, ffn_layer=cfg.ffn_layer,
            )
            for _ in range(cfg.depth)
        )
        self.norm = nn.LayerNorm(C, eps=cfg.ln_eps)


def interpolate_pos_embed(
    pos_embed: torch.Tensor, grid_h: int, grid_w: int,
    antialias: bool = True, offset: float = 0.0,
) -> torch.Tensor:
    """Resample the (1, 1+M*M, D) learned pos embed to a (grid_h, grid_w)
    patch grid with torch bicubic semantics; the cls entry passes through."""
    if offset:
        raise NotImplementedError(
            "interpolate_offset != 0 (the reference's historical scale-factor "
            "kludge) is not implemented; the OmniVGGT checkpoint uses offset 0"
        )
    n = pos_embed.shape[1] - 1
    if grid_h * grid_w == n and grid_h == grid_w:
        return pos_embed
    M = math.isqrt(n)
    if M * M != n:
        raise ValueError(f"pos embed is not square: {n}")
    patch_pe = pos_embed[:, 1:].reshape(1, M, M, -1)
    patch_pe = interpolate(
        patch_pe, (grid_h, grid_w), mode="bicubic", align_corners=False,
        antialias=antialias,
    ).reshape(1, grid_h * grid_w, -1)
    return torch.cat([pos_embed[:, :1], patch_pe], dim=1)


def apply(
    p: DinoVisionTransformer,
    images: torch.Tensor,
    *,
    attn_impl: str = "auto",
    shard=None,
    approx_gelu: bool = False,
    int8_dense=False,
    int8_qk: bool = False,
    pad_tokens: bool = True,
) -> torch.Tensor:
    """(B, H, W, 3) channels-last, mean/std-normalised images -> (B, gh*gw, D)
    final-LayerNorm'd patch tokens, in the images' dtype. int8_dense (a
    trunk_quant mode) and int8_qk are the blocks' fast modes. shard: an
    AttnShard (the rows strategy) for the blocks' attention."""
    cfg = p.cfg
    B, H, W, _ = images.shape
    gh, gw = H // cfg.patch_size, W // cfg.patch_size
    dtype = images.dtype

    x = L.patch_embed(p.patch_embed, images)  # (B, N, D)
    cls = p.cls_token.to(dtype).expand(B, 1, cfg.embed_dim)
    x = torch.cat([cls, x], dim=1)
    x = x + interpolate_pos_embed(
        p.pos_embed.float(), gh, gw,
        antialias=cfg.interpolate_antialias, offset=cfg.interpolate_offset,
    ).to(dtype)
    if p.register_tokens is not None:
        reg = p.register_tokens.to(dtype).expand(B, cfg.num_register_tokens, cfg.embed_dim)
        x = torch.cat([x[:, :1], reg, x[:, 1:]], dim=1)

    n_valid = x.shape[1]
    n_pad = (-n_valid) % 8 if pad_tokens else 0
    if n_pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, n_pad))
    for blk in p.blocks:
        x = L.block(
            blk, x, ln_eps=cfg.ln_eps, attn_impl=attn_impl, shard=shard,
            kv_valid=n_valid if n_pad else None, approx_gelu=approx_gelu,
            int8_dense=int8_dense, int8_qk=int8_qk,
        )
    x = L.layer_norm(p.norm, x, cfg.ln_eps)
    return L.run_forward_hooks(p, (images,), x[:, 1 + cfg.num_register_tokens : n_valid])
