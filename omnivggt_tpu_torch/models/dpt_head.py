"""DPT dense-prediction head: depth or point maps with confidence
(counterpart of omnivggt_tpu/models/dpt_head.py).

Per level: LayerNorm -> 1x1 projection -> sinusoidal UV pos-embed (x0.1) ->
resize (4x / 2x transposed conv, identity, stride-2 conv); then the
RefineNet fusion pyramid, a bilinear align_corners=True upsample to full
resolution, the output convs, and the activation split into values and
confidence. Runs NCHW inside (nn.Conv2d / nn.ConvTranspose2d) and returns
channels-last like the JAX package. Frames go through in chunks of
`frames_chunk_size`, which bounds the full-resolution activation memory.

The 3x3 convolutions with a narrow output (`_conv3x3`) can go two other
ways, both off by default as in the JAX package, whose TPU measurements had
them lose end to end (this card's own times are in PERF.md):
OMNIVGGT_PALLAS_HEAD_CONVS=1 routes the eligible ones (on the flagship only
`output_conv2[0]`, 128 -> 32 at full resolution) through the hand-written
Hopper kernel (ops/kernels/conv3x3.py; the variable keeps the JAX package's
name; forward only, so a model whose weights require grad must be called
under no_grad or inference_mode with it), and OMNIVGGT_S2D_HEAD_CONVS=1 through the space-to-depth rewrite
(`L.conv2d_s2d`). `quant="int8"` (config.head_quant) runs the heavy 3x3
convolutions W8A8 and keeps the library convolution for them.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F
from torch import nn

from omnivggt_tpu_torch.config import DPTHeadConfig
from omnivggt_tpu_torch.ops import layers as L
from omnivggt_tpu_torch.ops.activations import activate_head
from omnivggt_tpu_torch.ops.kernels.conv3x3 import conv3x3_eligible, conv3x3_folded

_S2D_HEAD_CONVS = os.environ.get("OMNIVGGT_S2D_HEAD_CONVS", "0") != "0"
_PALLAS_HEAD_CONVS = os.environ.get("OMNIVGGT_PALLAS_HEAD_CONVS", "0") != "0"


def _conv3x3(p, x, int8=False, relu=False):
    """3x3 pad-1 convolution (+ the ReLU that follows it, fused into the
    kernel when that path is taken), through the Hopper kernel or the
    space-to-depth rewrite when enabled and eligible. The flag alone
    decides, as in the JAX package: `conv3x3_folded` launches its kernel on
    a CUDA tensor (and raises when a gradient is asked of it, being forward
    only) and computes its plain version on a CPU tensor. The output is
    NCHW whatever x's layout, as the library convolution's on the head's
    NCHW tensors, so what follows runs as with the flag off."""
    if _PALLAS_HEAD_CONVS and not int8 and conv3x3_eligible(x.shape, p.weight.shape):
        return conv3x3_folded(p, x, relu=relu, memory_format=torch.contiguous_format)
    if _S2D_HEAD_CONVS and x.shape[-2] % 2 == 0 and x.shape[-1] % 2 == 0:
        y = L.conv2d_s2d(p, x, int8=int8)
    else:
        y = L.conv2d(p, x, padding=1, int8=int8)
    return F.relu(y) if relu else y


class ResidualConvUnit(nn.Module):
    def __init__(self, f: int):
        super().__init__()
        self.conv1 = nn.Conv2d(f, f, 3, padding=1)
        self.conv2 = nn.Conv2d(f, f, 3, padding=1)


class FeatureFusionBlock(nn.Module):
    def __init__(self, f: int, has_residual: bool = True):
        super().__init__()
        self.out_conv = nn.Conv2d(f, f, 1)
        self.resConfUnit1 = ResidualConvUnit(f) if has_residual else None
        self.resConfUnit2 = ResidualConvUnit(f)


class Scratch(nn.Module):
    def __init__(self, cfg: DPTHeadConfig):
        super().__init__()
        f = cfg.features
        for i, c in enumerate(cfg.out_channels, start=1):
            setattr(self, f"layer{i}_rn", nn.Conv2d(c, f, 3, padding=1, bias=False))
        self.refinenet1 = FeatureFusionBlock(f)
        self.refinenet2 = FeatureFusionBlock(f)
        self.refinenet3 = FeatureFusionBlock(f)
        self.refinenet4 = FeatureFusionBlock(f, has_residual=False)
        self.output_conv1 = nn.Conv2d(f, f if cfg.feature_only else f // 2, 3, padding=1)
        if not cfg.feature_only:
            self.output_conv2 = nn.Sequential(
                nn.Conv2d(f // 2, 32, 3, padding=1), nn.ReLU(), nn.Conv2d(32, cfg.output_dim, 1)
            )


class DPTHead(nn.Module):
    """Parameters under the reference's names (depth_head.* / point_head.*)."""

    def __init__(self, cfg: DPTHeadConfig):
        super().__init__()
        self.cfg = cfg
        oc = cfg.out_channels
        self.norm = nn.LayerNorm(cfg.dim_in)
        self.projects = nn.ModuleList(nn.Conv2d(cfg.dim_in, c, 1) for c in oc)
        self.resize_layers = nn.ModuleList([
            nn.ConvTranspose2d(oc[0], oc[0], 4, stride=4),
            nn.ConvTranspose2d(oc[1], oc[1], 2, stride=2),
            nn.Identity(),
            nn.Conv2d(oc[3], oc[3], 3, stride=2, padding=1),
        ])
        self.scratch = Scratch(cfg)


def _rcu(p: ResidualConvUnit, x, int8=False):
    # the reference's ResidualConvUnit applies an in-place ReLU to its
    # input, so its skip connection adds relu(x), not x
    xr = F.relu(x)
    out = F.relu(L.conv2d(p.conv1, xr, padding=1, int8=int8))
    return L.conv2d(p.conv2, out, padding=1, int8=int8) + xr


def _fusion(p: FeatureFusionBlock, x, residual=None, size=None, int8=False):
    if residual is not None:
        x = x + _rcu(p.resConfUnit1, residual, int8=int8)
    x = _rcu(p.resConfUnit2, x, int8=int8)
    if size is None:
        size = (x.shape[-2] * 2, x.shape[-1] * 2)
    x = F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=True)
    return L.conv2d(p.out_conv, x)


def _uv_pos_embed(width: int, height: int, dim: int, aspect_ratio: float, device,
                  omega_0: float = 100.0) -> torch.Tensor:
    """(dim, height, width) sinusoidal embedding of the diagonal-normalised
    UV grid, computed in float64 on `device` (the JAX package builds the
    same table in numpy, _uv_pos_embed_np; at full resolution a host-built
    table would cost a 137 MB host-to-device copy per call)."""
    f64 = dict(dtype=torch.float64, device=device)
    diag = (aspect_ratio**2 + 1.0) ** 0.5
    span_x, span_y = aspect_ratio / diag, 1.0 / diag
    xs = torch.linspace(-span_x * (width - 1) / width, span_x * (width - 1) / width, width, **f64)
    ys = torch.linspace(-span_y * (height - 1) / height, span_y * (height - 1) / height, height, **f64)
    vv, uu = torch.meshgrid(ys, xs, indexing="ij")  # (height, width)
    half = dim // 2
    omega = 1.0 / omega_0 ** (torch.arange(half // 2, **f64) / (half / 2.0))

    def sincos(pos):
        out = pos.reshape(-1, 1) * omega
        return torch.cat([out.sin(), out.cos()], dim=1)

    emb = torch.cat([sincos(uu), sincos(vv)], dim=-1).float()
    return emb.reshape(height, width, dim).permute(2, 0, 1)


def _apply_pos_embed(x: torch.Tensor, img_w: int, img_h: int, ratio: float = 0.1):
    """x: (K, C, h, w)."""
    c, h, w = x.shape[1:]
    return x + (_uv_pos_embed(w, h, c, img_w / img_h, x.device) * ratio).to(x.dtype)


def _forward_frames(p: DPTHead, tokens4, patch_hw, img_hw, quant="none"):
    """tokens4: 4 levels of (K, n_patch, dim_in) tokens -> (K, C_out, H, W)
    raw head output (or features when cfg.feature_only). quant="int8" runs
    the heavy 3x3 convolutions W8A8; the 1x1 projections, the resize
    layers and the last regression convolution stay in the head dtype."""
    cfg = p.cfg
    q8 = quant == "int8"
    ph, pw = patch_hw
    H, W = img_hw
    levels = []
    for lvl, x in enumerate(tokens4):
        x = L.layer_norm(p.norm, x, cfg.ln_eps)
        x = x.transpose(1, 2).reshape(x.shape[0], cfg.dim_in, ph, pw)
        x = L.conv2d(p.projects[lvl], x)
        if cfg.pos_embed:
            x = _apply_pos_embed(x, W, H)
        if lvl in (0, 1):
            deconv = p.resize_layers[lvl]
            x = F.conv_transpose2d(
                x, deconv.weight.to(x.dtype), deconv.bias.to(x.dtype), stride=deconv.stride
            )
        elif lvl == 3:
            x = L.conv2d(p.resize_layers[3], x, stride=2, padding=1)
        levels.append(x)

    s = p.scratch
    l1, l2, l3, l4 = [
        L.conv2d(getattr(s, f"layer{i + 1}_rn"), levels[i], padding=1, int8=q8)
        for i in range(4)
    ]
    out = _fusion(s.refinenet4, l4, size=l3.shape[-2:], int8=q8)
    out = _fusion(s.refinenet3, out, l3, size=l2.shape[-2:], int8=q8)
    out = _fusion(s.refinenet2, out, l2, size=l1.shape[-2:], int8=q8)
    out = _fusion(s.refinenet1, out, l1, int8=q8)
    out = _conv3x3(s.output_conv1, out, int8=q8)
    if _PALLAS_HEAD_CONVS and not q8 and not cfg.feature_only:
        # the kernel stages its input by TMA, channels innermost: convert
        # here, where the tensor is a third of the size it has after the
        # upsample; the upsample and the pos-embed add keep the layout, and
        # the kernel writes its output NCHW
        out = out.contiguous(memory_format=torch.channels_last)

    target = (int(ph * cfg.patch_size / cfg.down_ratio), int(pw * cfg.patch_size / cfg.down_ratio))
    out = F.interpolate(out, size=target, mode="bilinear", align_corners=True)
    if cfg.pos_embed:
        out = _apply_pos_embed(out, W, H)
    if cfg.feature_only:
        return out
    out = _conv3x3(s.output_conv2[0], out, int8=q8, relu=True)
    return L.conv2d(s.output_conv2[2], out)


def apply(p: DPTHead, layers, images_hw, patch_start_idx: int, dtype=torch.float32,
          quant=None):
    """Run the head on the 4 aggregated layers it reads.

    Args:
        layers: 4 tensors (B, S, P, dim_in), in any dtype (typically the
            bf16 trunk's); each chunk of frames is cast to `dtype` right
            before its compute.
        images_hw: (H, W) of the input images.
        dtype: the head's compute dtype (config.head_dtype); the activation
            split always runs in fp32.
        quant: "none" or "int8" (config.head_quant); None takes the head's
            own cfg.quant.

    Returns:
        (preds (B, S, H, W, output_dim - 1), conf (B, S, H, W)), fp32; or
        features (B, S, H', W', features) when cfg.feature_only.
    """
    cfg = p.cfg
    quant = cfg.quant if quant is None else quant
    H, W = images_hw
    ph, pw = H // cfg.patch_size, W // cfg.patch_size
    B, S = layers[0].shape[:2]
    toks = [t[:, :, patch_start_idx:].reshape(B * S, ph * pw, cfg.dim_in) for t in layers]
    K = B * S
    chunk = min(cfg.frames_chunk_size or K, K)
    outs = [
        _forward_frames(p, [t[i : i + chunk].to(dtype) for t in toks], (ph, pw), (H, W), quant)
        for i in range(0, K, chunk)
    ]
    out = torch.cat(outs).permute(0, 2, 3, 1)  # (K, H, W, C) channels-last
    if cfg.feature_only:
        return out.reshape(B, S, *out.shape[1:])
    preds, conf = activate_head(
        out.float(), activation=cfg.activation, conf_activation=cfg.conf_activation
    )
    return L.run_forward_hooks(
        p, (layers,), (preds.reshape(B, S, *preds.shape[1:]), conf.reshape(B, S, *conf.shape[1:]))
    )
