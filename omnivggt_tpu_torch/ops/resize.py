"""Image resizing with torch.nn.functional.interpolate semantics.

Counterpart of omnivggt_tpu/ops/resize.py, whose weight-matrix resize was
written to reproduce F.interpolate (bilinear with align_corners=True for the
DPT pyramid, bicubic with antialias for the DINOv2 pos-embed); here the port
calls F.interpolate itself. The public function keeps the JAX package's
channels-last layout.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def interpolate(
    x: torch.Tensor,
    size,
    mode: str = "bilinear",
    align_corners: bool = True,
    antialias: bool = False,
) -> torch.Tensor:
    """Resize (..., H, W, C) channels-last images to `size` = (H_out, W_out),
    in fp32, returning x's dtype."""
    H, W, C = x.shape[-3:]
    if tuple(size) == (H, W):
        return x
    lead = x.shape[:-3]
    y = x.reshape(-1, H, W, C).permute(0, 3, 1, 2).float()
    y = F.interpolate(
        y, size=tuple(size), mode=mode,
        align_corners=None if antialias else align_corners, antialias=antialias,
    )
    return y.permute(0, 2, 3, 1).reshape(*lead, *size, C).to(x.dtype)
