"""Axial 2D rotary position embeddings as precomputed tables.

Counterpart of omnivggt_tpu/ops/rope.py. The head dim D is split in half:
the first D/2 features rotate with the y coordinate, the last D/2 with x;
within each half, rotate-half splits at D/4. Special tokens (camera and
registers) take position 0 and patch positions are shifted by +1, so index
0 is the identity rotation for them. Only the rotate-half concatenate form
is used; the JAX package's bf16 signed-permutation matmul is a TPU lane
trick that gives the same bits.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch


def make_positions(grid_h: int, grid_w: int, patch_start_idx: int = 0) -> np.ndarray:
    """(patch_start_idx + grid_h*grid_w, 2) int32 (y, x) positions: zeros for
    the special tokens, then the row-major patch grid shifted by +1."""
    y = np.arange(grid_h, dtype=np.int32)
    x = np.arange(grid_w, dtype=np.int32)
    yy, xx = np.meshgrid(y, x, indexing="ij")
    pos = np.stack([yy.reshape(-1), xx.reshape(-1)], axis=-1) + (1 if patch_start_idx else 0)
    if patch_start_idx:
        pos = np.concatenate([np.zeros((patch_start_idx, 2), np.int32), pos], axis=0)
    return pos


@lru_cache(maxsize=32)
def _tables_np(
    grid_h: int, grid_w: int, patch_start_idx: int, head_dim: int, frequency: float
) -> Tuple[np.ndarray, np.ndarray]:
    positions = make_positions(grid_h, grid_w, patch_start_idx)  # (N, 2)
    d_axis = head_dim // 2
    exponents = np.arange(0, d_axis, 2, dtype=np.float64) / d_axis
    inv_freq = 1.0 / (frequency**exponents)  # (d_axis/2,)

    cos_parts, sin_parts = [], []
    for axis in (0, 1):  # y then x
        angles = positions[:, axis].astype(np.float64)[:, None] * inv_freq[None, :]
        angles = np.concatenate([angles, angles], axis=-1)  # (N, d_axis)
        cos_parts.append(np.cos(angles))
        sin_parts.append(np.sin(angles))
    cos = np.concatenate(cos_parts, axis=-1).astype(np.float32)  # (N, head_dim)
    sin = np.concatenate(sin_parts, axis=-1).astype(np.float32)
    return cos, sin


def rope_tables(
    grid_h: int,
    grid_w: int,
    patch_start_idx: int,
    head_dim: int,
    frequency: float = 100.0,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, head_dim) fp32 cos/sin tables for one frame's token sequence."""
    cos, sin = _tables_np(grid_h, grid_w, patch_start_idx, head_dim, float(frequency))
    return torch.from_numpy(cos).to(device), torch.from_numpy(sin).to(device)


def _rotate_half_per_axis(x: torch.Tensor) -> torch.Tensor:
    """Rotate-half applied independently to the y-half and x-half of the
    last dim."""
    q = x.shape[-1] // 4
    y1, y2, x1, x2 = x.split(q, dim=-1)
    return torch.cat([-y2, y1, -x2, x1], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (B, N, H, D) queries or keys; cos, sin: (N, D) tables (tiled when
    the sequence spans several frames). Computes in x's dtype."""
    cos = cos.to(x.dtype)[None, :, None, :]
    sin = sin.to(x.dtype)[None, :, None, :]
    return x * cos + _rotate_half_per_axis(x) * sin


def tile_tables(cos: torch.Tensor, sin: torch.Tensor, repeats: int):
    """Tile per-frame tables along the sequence for S-frame global attention."""
    return cos.repeat(repeats, 1), sin.repeat(repeats, 1)
