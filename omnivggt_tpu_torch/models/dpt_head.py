"""DPT dense-prediction head: depth or point maps with confidence
(counterpart of omnivggt_tpu/models/dpt_head.py).

Per level: LayerNorm -> 1x1 projection -> sinusoidal UV pos-embed (x0.1) ->
resize (4x / 2x transposed conv, identity, stride-2 conv); then the
RefineNet fusion pyramid, a bilinear align_corners=True upsample to full
resolution, the output convs, and the activation split into values and
confidence. The tensors are (K, C, H, W) channels-last throughout (the
tokens' reshape is a channels-last view, and every operation after keeps
that layout), so the final permute to (K, H, W, C), the JAX package's
layout, is a view. Frames go through in chunks of `frames_chunk_size`,
which bounds the full-resolution activation memory.

Every convolution goes through `_conv`, which sends each one the
tensor-core kernel takes (ops/kernels/conv_tf32x3.py: a CUDA fp32 tensor
that autograd does not record, a 3x3 pad-1 or 1x1 stride-1 weight, cout a
multiple of 16) to `conv2d_tf32x3`, fp32-accurate by three TF32 products,
and the rest to the library; on the flagship 28 of a head's 32 a chunk take
the kernel (the 4 projections, the 4 layerN_rn, the 14 residual-unit
convolutions, the 4 fusion out_convs, output_conv1, output_conv2[0]), and
the two transposed convolutions, the stride-2 resize and output_conv2[2]
(32 -> 2 or 4) stay on the library, as does everything in bf16, under
`quant="int8"`, in training and on the CPU. `conv_counts` reads the
routes taken.

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
from omnivggt_tpu_torch.ops.kernels import conv_tf32x3 as CT
from omnivggt_tpu_torch.ops.kernels.conv3x3 import conv3x3_eligible, conv3x3_folded

_S2D_HEAD_CONVS = os.environ.get("OMNIVGGT_S2D_HEAD_CONVS", "0") != "0"
_PALLAS_HEAD_CONVS = os.environ.get("OMNIVGGT_PALLAS_HEAD_CONVS", "0") != "0"


def _conv(p, x, stride=1, padding=0, relu=False, int8=False, quantised=False):
    """A convolution of the head (+ the ReLU that follows it, fused into
    the kernel when it takes the convolution): `conv2d_tf32x3` where
    `CT.eligible` accepts it and the head is not quantised (`quantised`:
    a head under quant="int8", whose other convolutions keep the library's
    too), else the library's (W8A8 when `int8`). Counted on
    `_conv.kernel_convs` / `_conv.library_convs`."""
    if not (int8 or quantised) and CT.eligible(p, x, stride, padding):
        _conv.kernel_convs += 1
        return CT.conv2d_tf32x3(p, x, padding, relu=relu)
    _conv.library_convs += 1
    y = L.conv2d(p, x, stride=stride, padding=padding, int8=int8)
    return F.relu(y) if relu else y


_conv.kernel_convs = 0
_conv.library_convs = 0


def conv_counts(since=None) -> dict:
    """The head convolutions run so far, {"kernel_convs", "library_convs"}
    (the transposed ones counted with the library's; `conv3x3_folded`'s,
    under OMNIVGGT_PALLAS_HEAD_CONVS, in neither: its own `launches` count
    them); with `since` (an earlier reading) the ones run after it."""
    now = {"kernel_convs": _conv.kernel_convs, "library_convs": _conv.library_convs}
    return now if since is None else {k: v - since[k] for k, v in now.items()}


def _conv3x3(p, x, int8=False, relu=False):
    """3x3 pad-1 convolution (+ the ReLU that follows it, fused into the
    kernel when that path is taken), through the Hopper kernel or the
    space-to-depth rewrite when enabled and eligible, else `_conv`. The
    flag alone decides, as in the JAX package: `conv3x3_folded` launches
    its kernel on a CUDA tensor (and raises when a gradient is asked of
    it, being forward only) and computes its plain version on a CPU
    tensor; its output is NCHW whatever x's layout."""
    if _PALLAS_HEAD_CONVS and not int8 and conv3x3_eligible(x.shape, p.weight.shape):
        return conv3x3_folded(p, x, relu=relu, memory_format=torch.contiguous_format)
    if _S2D_HEAD_CONVS and x.shape[-2] % 2 == 0 and x.shape[-1] % 2 == 0:
        _conv.library_convs += 1
        y = L.conv2d_s2d(p, x, int8=int8)
        return F.relu(y) if relu else y
    return _conv(p, x, padding=1, relu=relu, int8=int8)


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
    out = _conv(p.conv1, xr, padding=1, relu=True, int8=int8)
    return _conv(p.conv2, out, padding=1, int8=int8) + xr


def _fusion(p: FeatureFusionBlock, x, residual=None, size=None, int8=False):
    if residual is not None:
        x = x + _rcu(p.resConfUnit1, residual, int8=int8)
    x = _rcu(p.resConfUnit2, x, int8=int8)
    if size is None:
        size = (x.shape[-2] * 2, x.shape[-1] * 2)
    x = F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=True)
    return _conv(p.out_conv, x, quantised=int8)


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
        x = x.reshape(x.shape[0], ph, pw, cfg.dim_in).permute(0, 3, 1, 2)  # channels-last
        x = _conv(p.projects[lvl], x, quantised=q8)
        if cfg.pos_embed:
            x = _apply_pos_embed(x, W, H)
        if lvl in (0, 1):
            deconv = p.resize_layers[lvl]
            _conv.library_convs += 1
            x = F.conv_transpose2d(
                x, deconv.weight.to(x.dtype), deconv.bias.to(x.dtype), stride=deconv.stride
            )
        elif lvl == 3:
            x = _conv(p.resize_layers[3], x, stride=2, padding=1, quantised=q8)
        levels.append(x)

    s = p.scratch
    l1, l2, l3, l4 = [
        _conv(getattr(s, f"layer{i + 1}_rn"), levels[i], padding=1, int8=q8)
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
    return _conv(s.output_conv2[2], out, quantised=q8)


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
