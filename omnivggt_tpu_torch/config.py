"""Frozen configuration dataclasses for the OmniVGGT model family.

Counterpart of omnivggt_tpu/config.py: the same fields and defaults, so a
configuration means the same model in both packages; dtypes resolve to
torch dtypes. One field is the port's own: `OmniVGGTConfig.global_attention`
("full", the default and the JAX package's only model, or "frame_causal",
StreamVGGT's frame-causal global attention over a key/value cache, which
the JAX package does not have).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class DinoV2Config:
    """DINOv2 ViT backbone used as the patch embedder (vit_large defaults)."""

    img_size: int = 518
    patch_size: int = 14
    in_chans: int = 3
    embed_dim: int = 1024
    depth: int = 24
    num_heads: int = 16
    mlp_ratio: float = 4.0
    num_register_tokens: int = 4
    init_values: float = 1.0
    ln_eps: float = 1e-6
    qk_norm: bool = False
    ffn_layer: str = "mlp"
    interpolate_antialias: bool = True
    interpolate_offset: float = 0.0

    @property
    def num_patches(self) -> int:
        g = self.img_size // self.patch_size
        return g * g


def vit_small(**kw) -> DinoV2Config:
    return DinoV2Config(embed_dim=384, depth=12, num_heads=6, **kw)


def vit_base(**kw) -> DinoV2Config:
    return DinoV2Config(embed_dim=768, depth=12, num_heads=12, **kw)


def vit_large(**kw) -> DinoV2Config:
    return DinoV2Config(embed_dim=1024, depth=24, num_heads=16, **kw)


def vit_giant2(**kw) -> DinoV2Config:
    return DinoV2Config(embed_dim=1536, depth=40, num_heads=24, **kw)


@dataclasses.dataclass(frozen=True)
class AggregatorConfig:
    """Alternating frame/global attention aggregator with modality injection."""

    img_size: int = 518
    patch_size: int = 14
    embed_dim: int = 1024
    depth: int = 24
    num_heads: int = 16
    mlp_ratio: float = 4.0
    num_register_tokens: int = 4
    qkv_bias: bool = True
    proj_bias: bool = True
    ffn_bias: bool = True
    # "dinov2_vitl14_reg" | "dinov2_vitb14_reg" | "dinov2_vits14_reg" |
    # "dinov2_vitg2_reg" | "conv"
    patch_embed: str = "dinov2_vitl14_reg"
    aa_order: Tuple[str, ...] = ("frame", "global")
    qk_norm: bool = True
    rope_freq: float = 100.0
    init_values: float = 0.01
    ln_eps: float = 1e-5
    pose_hidden_dim: int = 9
    drop_path_rate: float = 0.0

    @property
    def patch_start_idx(self) -> int:
        return 1 + self.num_register_tokens

    @property
    def num_groups(self) -> int:
        return self.depth + 1

    @property
    def backbone(self) -> DinoV2Config:
        factories = {
            "dinov2_vitl14_reg": vit_large,
            "dinov2_vitb14_reg": vit_base,
            "dinov2_vits14_reg": vit_small,
            "dinov2_vitg2_reg": vit_giant2,
        }
        if self.patch_embed not in factories:
            raise ValueError(f"not a ViT patch embed: {self.patch_embed}")
        return factories[self.patch_embed](
            img_size=self.img_size,
            patch_size=self.patch_size,
            num_register_tokens=self.num_register_tokens,
        )


@dataclasses.dataclass(frozen=True)
class CameraHeadConfig:
    """Iterative camera pose refinement head."""

    dim_in: int = 2048
    trunk_depth: int = 4
    num_heads: int = 16
    mlp_ratio: float = 4.0
    init_values: float = 0.01
    target_dim: int = 9  # absT_quaR_FoV
    num_iterations: int = 4
    trans_act: str = "linear"
    quat_act: str = "linear"
    fl_act: str = "relu"
    ln_eps: float = 1e-5
    adaln_eps: float = 1e-6


@dataclasses.dataclass(frozen=True)
class DPTHeadConfig:
    """DPT dense-prediction head."""

    dim_in: int = 2048
    patch_size: int = 14
    output_dim: int = 4
    activation: str = "inv_log"
    conf_activation: str = "expp1"
    features: int = 256
    out_channels: Tuple[int, ...] = (256, 512, 1024, 1024)
    intermediate_layer_idx: Tuple[int, ...] = (4, 11, 17, 23)
    pos_embed: bool = True
    feature_only: bool = False
    down_ratio: int = 1
    frames_chunk_size: int = 8
    ln_eps: float = 1e-5
    quant: str = "none"


@dataclasses.dataclass(frozen=True)
class OmniVGGTConfig:
    """Top-level model: aggregator + camera head + depth head + point head."""

    img_size: int = 518
    patch_size: int = 14
    embed_dim: int = 1024
    aggregator: AggregatorConfig = dataclasses.field(default_factory=AggregatorConfig)
    camera_head: CameraHeadConfig = dataclasses.field(default_factory=CameraHeadConfig)
    depth_head: DPTHeadConfig = dataclasses.field(
        default_factory=lambda: DPTHeadConfig(output_dim=2, activation="exp")
    )
    point_head: DPTHeadConfig = dataclasses.field(
        default_factory=lambda: DPTHeadConfig(output_dim=4, activation="inv_log")
    )
    # aggregator trunk compute dtype; the heads run in head_dtype (fp32, as
    # the reference runs its heads outside autocast)
    compute_dtype: str = "bfloat16"
    head_dtype: str = "float32"
    # tanh-form GELU in the trunk instead of the exact erf form
    approx_gelu: bool = False
    trunk_quant: str = "none"
    attn_quant: str = "none"
    head_quant: str = "none"
    # fixed-max softmax for qk-normed attention; checkpoint loading checks
    # the weight-dependent logit bound (utils/validation) and turns it off
    # for weights that break it
    bounded_attn_logits: bool = True
    # the port's own: "full" (every frame attends to every frame of the
    # scene) or "frame_causal" (StreamVGGT, arXiv 2507.11539: frame t's
    # tokens attend to frames 0..t, and the camera head's trunk likewise;
    # models/stream.py keeps the earlier frames' keys and values)
    global_attention: str = "full"

    def __post_init__(self):
        agg = dataclasses.replace(
            self.aggregator,
            img_size=self.img_size,
            patch_size=self.patch_size,
            embed_dim=self.embed_dim,
        )
        object.__setattr__(self, "aggregator", agg)
        object.__setattr__(
            self,
            "camera_head",
            dataclasses.replace(self.camera_head, dim_in=2 * self.embed_dim),
        )
        for name in ("depth_head", "point_head"):
            object.__setattr__(
                self,
                name,
                dataclasses.replace(
                    getattr(self, name),
                    dim_in=2 * self.embed_dim,
                    patch_size=self.patch_size,
                    quant=self.head_quant,
                ),
            )
        if self.trunk_quant not in ("none", "int8", "int8_ln"):
            raise ValueError(
                "trunk_quant must be 'none', 'int8', or 'int8_ln', "
                f"got {self.trunk_quant!r}"
            )
        if self.attn_quant not in ("none", "int8"):
            raise ValueError(
                f"attn_quant must be 'none' or 'int8', got {self.attn_quant!r}"
            )
        if self.head_quant not in ("none", "int8"):
            raise ValueError(
                f"head_quant must be 'none' or 'int8', got {self.head_quant!r}"
            )
        if self.global_attention not in ("full", "frame_causal"):
            raise ValueError(
                "global_attention must be 'full' or 'frame_causal', "
                f"got {self.global_attention!r}"
            )

    @property
    def trunk_dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    @property
    def heads_dtype(self) -> torch.dtype:
        return getattr(torch, self.head_dtype)


def tiny_test_config(
    img_size: int = 28,
    embed_dim: int = 64,
    depth: int = 2,
    num_heads: int = 2,
    patch_embed: str = "conv",
) -> OmniVGGTConfig:
    """A small config for CPU tests: conv patch embed, few blocks, tiny dims."""
    layer_idx = tuple(
        min(i, depth - 1) for i in (0, max(depth // 2 - 1, 0), depth - 2, depth - 1)
    )
    return OmniVGGTConfig(
        img_size=img_size,
        embed_dim=embed_dim,
        aggregator=AggregatorConfig(
            embed_dim=embed_dim,
            depth=depth,
            num_heads=num_heads,
            patch_embed=patch_embed,
        ),
        camera_head=CameraHeadConfig(dim_in=2 * embed_dim, trunk_depth=2, num_heads=2),
        depth_head=DPTHeadConfig(
            dim_in=2 * embed_dim,
            output_dim=2,
            activation="exp",
            features=16,
            out_channels=(16, 32, 64, 64),
            intermediate_layer_idx=layer_idx,
        ),
        point_head=DPTHeadConfig(
            dim_in=2 * embed_dim,
            output_dim=4,
            activation="inv_log",
            features=16,
            out_channels=(16, 32, 64, 64),
            intermediate_layer_idx=layer_idx,
        ),
        compute_dtype="float32",
    )
