"""OmniVGGT: aggregator + camera head + depth head + point head
(counterpart of omnivggt_tpu/models/omnivggt.py).

`apply` returns the reference's prediction dict with channels-last layouts:
pose_enc (B,S,9), pose_enc_list (iters,B,S,9), depth (B,S,H,W,1),
depth_conf (B,S,H,W), world_points (B,S,H,W,3), world_points_conf
(B,S,H,W), images (B,S,H,W,3). The aggregator trunk runs in
`config.compute_dtype` (bf16 by default) and the heads in
`config.head_dtype` (fp32); only the layers the heads read are kept.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from omnivggt_tpu_torch.config import OmniVGGTConfig
from omnivggt_tpu_torch.models import aggregator as agg
from omnivggt_tpu_torch.models import camera_head as chead
from omnivggt_tpu_torch.models import dpt_head as dhead
from omnivggt_tpu_torch.models.aggregator import AuxInputs
from omnivggt_tpu_torch.ops import layers as L
from omnivggt_tpu_torch.utils.device import resolve_device


def needed_layers(cfg: OmniVGGTConfig):
    """Sorted union of the aggregator layers the heads read: the last layer
    (camera head) and the DPT heads' intermediate_layer_idx."""
    layers = {cfg.aggregator.depth - 1}
    layers.update(cfg.depth_head.intermediate_layer_idx)
    layers.update(cfg.point_head.intermediate_layer_idx)
    return tuple(sorted(layers))


def _uniform_(t: torch.Tensor, bound: float, gen: torch.Generator):
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=gen)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Random weights with the JAX package's init distributions (torch's
    own defaults for linear and conv layers), drawn from `generator`."""
    gen = generator
    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            fan_in = m.weight[0].numel()
            _uniform_(m.weight, 1.0 / math.sqrt(fan_in), gen)
            if m.bias is not None:
                _uniform_(m.bias, 1.0 / math.sqrt(fan_in), gen)
        elif isinstance(m, nn.ConvTranspose2d):
            _uniform_(m.weight, 1.0 / math.sqrt(m.weight[0].numel()), gen)
            m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, L.LayerScale):
            m.gamma.fill_(m.init_values)
    for name, prm in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("camera_token", "register_token"):
            prm.normal_(generator=gen).mul_(1e-6)
        elif leaf == "pos_embed":
            prm.normal_(generator=gen).mul_(0.02)
        elif leaf in ("cls_token", "register_tokens", "depth_placeholder", "empty_pose_tokens"):
            prm.zero_()
        elif ".camera_adapters." in f".{name}":
            prm.zero_()  # zero-initialised adapters


class OmniVGGT(nn.Module):
    """The model's parameters under the reference's state-dict names, with a
    reference-style call: model(images, extrinsics=..., intrinsics=...,
    depth=..., mask=..., depth_gt_index=[...], camera_gt_index=[...])."""

    def __init__(
        self,
        config: Optional[OmniVGGTConfig] = None,
        *,
        device=None,
        seed: Optional[int] = 0,
    ):
        """Builds the model on `device` (default "cuda"; raises without a
        CUDA device, so the CPU runs only with device="cpu") with random
        weights from `seed` (seed=None leaves them uninitialised, for
        loading a checkpoint)."""
        super().__init__()
        self.config = cfg = config or OmniVGGTConfig()
        if cfg.trunk_quant != "none" or cfg.attn_quant != "none":
            raise NotImplementedError("int8 trunk / attention modes are not ported")
        with torch.device("meta"):
            self.aggregator = agg.Aggregator(cfg.aggregator)
            self.camera_head = chead.CameraHead(cfg.camera_head)
            self.depth_head = dhead.DPTHead(cfg.depth_head)
            self.point_head = dhead.DPTHead(cfg.point_head)
        device = resolve_device(device)
        self.to_empty(device=device)
        if seed is not None:
            gen = torch.Generator(device=device)
            gen.manual_seed(seed)
            init_weights(self, gen)

    @classmethod
    def from_safetensors(cls, path: str, config: Optional[OmniVGGTConfig] = None, device=None):
        """Load a reference safetensors checkpoint strictly; the fixed-max
        softmax is turned off when the weights break its logit bound."""
        import dataclasses

        from omnivggt_tpu_torch.checkpoint import load_safetensors
        from omnivggt_tpu_torch.utils.validation import check_bounded_logits_safe

        config = config or OmniVGGTConfig()
        model = cls(config, device=device, seed=None)
        load_safetensors(model, path)
        head_dim = config.embed_dim // config.aggregator.num_heads
        if config.bounded_attn_logits and not check_bounded_logits_safe(model, head_dim):
            model.config = dataclasses.replace(config, bounded_attn_logits=False)
        return model

    def forward(
        self,
        images,
        extrinsics=None,
        intrinsics=None,
        depth=None,
        mask=None,
        depth_gt_index: Optional[List[int]] = None,
        camera_gt_index: Optional[List[int]] = None,
        attn_impl: str = "auto",
    ):
        device = next(self.parameters()).device
        images = torch.as_tensor(images, device=device)
        if images.ndim == 4:
            images = images[None]
        aux = make_aux(
            images.shape[1], extrinsics, intrinsics, depth, mask,
            depth_gt_index, camera_gt_index, device=device,
        )
        return apply(self, images, self.config, aux, attn_impl=attn_impl)


def apply(
    model: OmniVGGT,
    images: torch.Tensor,
    cfg: OmniVGGTConfig,
    aux: Optional[AuxInputs] = None,
    *,
    attn_impl: str = "auto",
    pad_tokens: bool = True,
    remat: bool = False,
    train_generator: Optional[torch.Generator] = None,
):
    """Full forward pass on (B, S, H, W, 3) (or (S, H, W, 3)) channels-last
    images in [0, 1]. Returns the prediction dict (fp32 but `images`).

    remat: recompute each aggregator layer pair in the backward.
    train_generator: a generator on the images' device that enables the
    aggregator's stochastic depth at cfg.aggregator.drop_path_rate (None:
    deterministic eval)."""
    if images.ndim == 4:
        images = images[None]
    B, S, H, W, _ = images.shape
    layers, patch_start_idx = agg.apply(
        model.aggregator, images, aux,
        output_layers=needed_layers(cfg),
        dtype=cfg.trunk_dtype,
        attn_impl=attn_impl,
        allow_bounded=cfg.bounded_attn_logits,
        approx_gelu=cfg.approx_gelu,
        pad_tokens=pad_tokens,
        remat=remat,
        train_generator=train_generator,
        drop_path_rate=cfg.aggregator.drop_path_rate,
    )
    pose_enc_list = chead.apply(
        model.camera_head, layers[cfg.aggregator.depth - 1].to(cfg.heads_dtype)
    )
    predictions = {"pose_enc": pose_enc_list[-1], "pose_enc_list": pose_enc_list}
    for name, head, key in (
        ("depth_head", model.depth_head, "depth"),
        ("point_head", model.point_head, "world_points"),
    ):
        hcfg = getattr(cfg, name)
        preds, conf = dhead.apply(
            head, [layers[i] for i in hcfg.intermediate_layer_idx], (H, W),
            patch_start_idx, dtype=cfg.heads_dtype,
        )
        predictions[key] = preds
        predictions[f"{key}_conf"] = conf
    predictions["images"] = images
    return predictions


def make_aux(
    S: int,
    extrinsics=None,
    intrinsics=None,
    depth=None,
    mask=None,
    depth_gt_index: Optional[Sequence[int]] = None,
    camera_gt_index: Optional[Sequence[int]] = None,
    device=None,
) -> Optional[AuxInputs]:
    """AuxInputs from reference-style index lists (None without any GT)."""
    cam_mask = None
    if camera_gt_index is not None and len(camera_gt_index) > 0:
        if extrinsics is None or intrinsics is None:
            raise ValueError(
                "camera_gt_index requires extrinsics and intrinsics (frames "
                "marked as having camera GT but no camera arrays were given)"
            )
        cam_mask = np.zeros((S,), bool)
        cam_mask[np.asarray(camera_gt_index)] = True
    d_mask = None
    if depth_gt_index is not None and len(depth_gt_index) > 0:
        if depth is None:
            raise ValueError(
                "depth_gt_index requires a depth array (frames marked as "
                "having depth GT but no depth was given)"
            )
        if mask is None:
            raise ValueError(
                "depth_gt_index requires a validity mask alongside depth "
                "(pass mask=np.ones(...) if every depth pixel is valid)"
            )
        d_mask = np.zeros((S,), bool)
        d_mask[np.asarray(depth_gt_index)] = True
    if cam_mask is None and d_mask is None:
        return None

    def t(x):
        return None if x is None else torch.as_tensor(x, device=device)

    return AuxInputs(
        extrinsics=t(extrinsics),
        intrinsics=t(intrinsics),
        depth=t(depth),
        depth_valid=t(mask),
        camera_mask=t(cam_mask),
        depth_mask=t(d_mask),
    )
