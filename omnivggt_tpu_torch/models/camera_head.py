"""Iterative camera pose refinement head (counterpart of
omnivggt_tpu/models/camera_head.py).

Takes the camera token (index 0) of the last aggregated layer and runs
`num_iterations` of adaLN-modulated refinement through a small transformer
trunk, predicting a delta on the 9-dim absT_quaR_FoV encoding each time
(the previous estimate is detached between iterations). Under a
frame-causal stream (models/stream.StreamState) the head runs one frame: in
each iteration and trunk layer its pose token attends to the earlier
frames' cached keys and values of that iteration and layer, and to its own.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from omnivggt_tpu_torch.config import CameraHeadConfig
from omnivggt_tpu_torch.ops import layers as L
from omnivggt_tpu_torch.ops.activations import activate_pose


class CameraHead(nn.Module):
    """Parameters under the reference's names (camera_head.*)."""

    def __init__(self, cfg: CameraHeadConfig):
        super().__init__()
        self.cfg = cfg
        D = cfg.dim_in
        self.trunk = nn.ModuleList(
            L.Block(D, cfg.num_heads, mlp_ratio=cfg.mlp_ratio, init_values=cfg.init_values)
            for _ in range(cfg.trunk_depth)
        )
        self.token_norm = nn.LayerNorm(D)
        self.trunk_norm = nn.LayerNorm(D)
        self.empty_pose_tokens = nn.Parameter(torch.zeros(1, 1, cfg.target_dim))
        self.embed_pose = nn.Linear(cfg.target_dim, D)
        self.poseLN_modulation = nn.Sequential(nn.SiLU(), nn.Linear(D, 3 * D))
        self.pose_branch = L.Mlp(D, D // 2, cfg.target_dim)


def apply(p: CameraHead, tokens_last: torch.Tensor, num_valid_frames=None,
          stream=None) -> torch.Tensor:
    """tokens_last: (B, S, P, 2C) final aggregated layer, in the head dtype.
    num_valid_frames: an int or an integer scalar tensor; the trunk attends
    across the S frame tokens, so padded frames (bucketed serving) are
    masked out of its keys. stream: a StreamState and one frame (B = S =
    1): the trunk attends over the stream's camera cache, which this call
    fills at the frame's slot. Returns (num_iterations, B, S, 9) fp32
    activated pose encodings."""
    L.run_forward_pre_hooks(p, (tokens_last,))
    cfg = p.cfg
    pose_tokens = L.layer_norm(p.token_norm, tokens_last[:, :, 0], cfg.ln_eps)
    B, S, _ = pose_tokens.shape
    normed = L.layer_norm(None, pose_tokens, cfg.adaln_eps)
    modulation = p.poseLN_modulation[1]

    pred = None
    activated = []
    for it in range(cfg.num_iterations):
        if it == 0:
            prev = p.empty_pose_tokens.to(pose_tokens.dtype).expand(B, S, cfg.target_dim)
        else:
            prev = pred.detach()
        mod = L.linear(modulation, F.silu(L.linear(p.embed_pose, prev)))
        shift, scale, gate = mod.chunk(3, dim=-1)
        x = gate * (normed * (1 + scale) + shift) + pose_tokens
        for j, blk in enumerate(p.trunk):
            x = L.block(blk, x, ln_eps=cfg.ln_eps, kv_valid=num_valid_frames,
                        kv_cache=None if stream is None else stream.camera_layer(it, j))
        h = L.linear(p.pose_branch.fc1, L.layer_norm(p.trunk_norm, x, cfg.ln_eps))
        delta = L.linear(p.pose_branch.fc2, F.gelu(h))
        pred = delta if it == 0 else pred + delta
        activated.append(
            activate_pose(
                pred.float(), trans_act=cfg.trans_act, quat_act=cfg.quat_act,
                fl_act=cfg.fl_act,
            )
        )
    return L.run_forward_hooks(p, (tokens_last,), torch.stack(activated))
