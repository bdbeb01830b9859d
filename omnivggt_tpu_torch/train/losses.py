"""Training losses (counterpart of omnivggt_tpu/train/losses.py).

  - camera loss: L1 on the 9-dim absT_quaR_FoV encoding against the
    scene-normalised ground truth, summed over the camera head's refinement
    iterates with weight gamma^(T-1-t) (the last iterate weighs 1); frames
    without camera GT can be masked out (`valid`), and the normalisation
    then rebases to the first valid camera;
  - dense losses (depth, world points): confidence-weighted L1,
        conf * |pred - gt| - alpha * log(conf)
    averaged over valid pixels.

All reductions are mask-aware and safe for empty masks. Each loss divides
by a count over the whole batch (frames with camera GT, valid pixels).

The invariant of training over processes (parallel/mesh.py), which every
layout keeps:
  - each process's loss is its share: its own scenes (data axis) and its
    own frames (seq axis) over the whole batch's counts (`global_count`
    sums a count over every data x seq process);
  - the shares summed over all processes equal the single-device loss;
  - every parameter gradient is summed over all processes (train/step.py);
  - every seq gather under autograd has a seq reduce-scatter as its
    backward (parallel/collectives.seq_gather): every process's gradient
    of a shard, summed in rank order.
The camera head runs in every seq process on every frame's camera token,
so its iterates are whole everywhere: with the seq axis over processes
(`mesh`) the camera loss takes its error on this process's frames of them,
after rebasing the GT on the gathered cameras of the whole scene; the
dense losses take this process's frames of the outputs.
"""

from __future__ import annotations

import torch

from omnivggt_tpu_torch.models.aggregator import rebased_extrinsics
from omnivggt_tpu_torch.utils import geometry as G


def _count(x: torch.Tensor, global_count) -> torch.Tensor:
    x = x.float()
    return (x if global_count is None else global_count(x)).clamp_min(1.0)


def camera_loss(pose_enc_list, gt_extrinsics, gt_intrinsics, image_size_hw,
                gamma: float = 0.8, valid=None, global_count=None, mesh=None) -> torch.Tensor:
    """pose_enc_list: (T, B, S, 9) iterates; gt: (B, S, 3, 4) / (B, S, 3, 3);
    valid: optional (S,) or (B, S) frame mask. mesh: with its seq axis over
    processes the GT and valid are this process's frames and the iterates
    every frame's (module docstring)."""
    B, S = gt_extrinsics.shape[:2]
    dev = pose_enc_list.device
    if mesh is not None and mesh.seq_processes:
        pose_enc_list = pose_enc_list[:, :, mesh.seq_rank * S:(mesh.seq_rank + 1) * S]
    if valid is None:
        gt_norm = rebased_extrinsics(gt_extrinsics.float(), None, mesh)
        gt_enc = G.extri_intri_to_pose_encoding(gt_norm, gt_intrinsics.float(), image_size_hw)
        w_frame = torch.ones((B, S), device=dev)
    else:
        valid = torch.as_tensor(valid, device=dev)
        if valid.ndim == 1:
            valid = valid[None].expand(B, S)
        valid = valid.bool()
        m4 = valid[:, :, None, None]
        ex = torch.where(m4, gt_extrinsics.float(), torch.eye(3, 4, device=dev))
        K = torch.where(m4, gt_intrinsics.float(), torch.eye(3, device=dev))
        gt_enc = G.extri_intri_to_pose_encoding(rebased_extrinsics(ex, valid, mesh), K,
                                                image_size_hw)
        w_frame = valid.float()
    T = pose_enc_list.shape[0]
    weights = gamma ** torch.arange(T - 1, -1, -1, device=dev, dtype=torch.float32)
    err = (pose_enc_list - gt_enc[None]).abs().mean(dim=-1)  # (T, B, S)
    denom = _count(w_frame.sum(), global_count)
    per_iter = (err * w_frame[None]).sum(dim=(1, 2)) / denom
    return (weights * per_iter).sum()


def conf_weighted_l1(pred, conf, gt, valid, alpha: float = 0.2,
                     global_count=None) -> torch.Tensor:
    """conf * |pred - gt| - alpha * log(conf) over valid pixels.
    pred: (..., C); conf: (...); gt: (..., C); valid: (...)."""
    err = (pred - gt).abs().sum(dim=-1)
    loss = conf * err - alpha * torch.log(conf)
    return (loss * valid).sum() / _count(valid.sum(), global_count)


def total_loss(predictions, batch, image_size_hw, *, w_camera: float = 1.0,
               w_depth: float = 1.0, w_point: float = 1.0, global_count=None,
               mesh=None) -> dict:
    """Camera, depth and point losses and their weighted sum ("total") from
    a prediction dict and a batch with keys extrinsics (B,S,3,4),
    intrinsics (B,S,3,3), depth (B,S,H,W,1), depth_valid (B,S,H,W),
    world_points (B,S,H,W,3); optionally camera_valid (S,) and point_valid
    (B,S,H,W), which defaults to depth_valid. global_count: sums a count
    over the processes (None: this batch is the whole batch). mesh: with
    its seq axis over processes, the batch and the dense predictions are
    this process's frames, pose_enc_list every frame's."""
    losses = {
        "camera": camera_loss(
            predictions["pose_enc_list"], batch["extrinsics"], batch["intrinsics"],
            image_size_hw, valid=batch.get("camera_valid"), global_count=global_count,
            mesh=mesh,
        ),
        "depth": conf_weighted_l1(
            predictions["depth"], predictions["depth_conf"], batch["depth"], batch["depth_valid"],
            global_count=global_count,
        ),
        "point": conf_weighted_l1(
            predictions["world_points"], predictions["world_points_conf"],
            batch["world_points"], batch.get("point_valid", batch["depth_valid"]),
            global_count=global_count,
        ),
    }
    losses["total"] = (
        w_camera * losses["camera"] + w_depth * losses["depth"] + w_point * losses["point"]
    )
    return losses
