"""Camera geometry on tensors (counterpart of omnivggt_tpu/utils/geometry.py).

  - quaternion codec, scalar-last XYZW, best-conditioned matrix -> quaternion
    with sign standardisation;
  - closed-form SE3 inverse;
  - the 9-dim absT_quaR_FoV pose codec;
  - depth unprojection to camera and world points;
  - the Colmap <-> OpenCV principal-point conventions (numpy).
"""

from __future__ import annotations

import numpy as np
import torch


def quat_to_mat(quaternions: torch.Tensor) -> torch.Tensor:
    """Scalar-last (x, y, z, w) quaternions (..., 4) -> rotations (..., 3, 3)."""
    i, j, k, r = quaternions.unbind(-1)
    two_s = 2.0 / (quaternions * quaternions).sum(-1)
    o = torch.stack(
        [
            1 - two_s * (j * j + k * k),
            two_s * (i * j - k * r),
            two_s * (i * k + j * r),
            two_s * (i * j + k * r),
            1 - two_s * (i * i + k * k),
            two_s * (j * k - i * r),
            two_s * (i * k - j * r),
            two_s * (j * k + i * r),
            1 - two_s * (i * i + j * j),
        ],
        dim=-1,
    )
    return o.reshape(quaternions.shape[:-1] + (3, 3))


def _sqrt_positive_part(x: torch.Tensor) -> torch.Tensor:
    """sqrt(max(0, x)) with a zero subgradient at x == 0."""
    positive = x > 0
    return torch.where(positive, torch.sqrt(torch.where(positive, x, 1.0)), 0.0)


def standardize_quaternion(quaternions: torch.Tensor) -> torch.Tensor:
    """Flip the sign so the real (last) component is non-negative."""
    return torch.where(quaternions[..., 3:4] < 0, -quaternions, quaternions)


def mat_to_quat(matrix: torch.Tensor) -> torch.Tensor:
    """Rotations (..., 3, 3) -> scalar-last quaternions (..., 4): all four
    candidates are formed and the best-conditioned one is kept."""
    if matrix.shape[-2:] != (3, 3):
        raise ValueError(f"Invalid rotation matrix shape {tuple(matrix.shape)}.")
    m00, m01, m02, m10, m11, m12, m20, m21, m22 = matrix.reshape(
        matrix.shape[:-2] + (9,)
    ).unbind(-1)
    q_abs = _sqrt_positive_part(
        torch.stack(
            [
                1.0 + m00 + m11 + m22,
                1.0 + m00 - m11 - m22,
                1.0 - m00 + m11 - m22,
                1.0 - m00 - m11 + m22,
            ],
            dim=-1,
        )
    )
    # candidate quaternions (r, i, j, k order) scaled by each of r, i, j, k
    quat_by_rijk = torch.stack(
        [
            torch.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], dim=-1),
            torch.stack([m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20], dim=-1),
            torch.stack([m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21], dim=-1),
            torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2], dim=-1),
        ],
        dim=-2,
    )
    candidates = quat_by_rijk / (2.0 * q_abs[..., None].clamp_min(0.1))
    best = q_abs.argmax(dim=-1)
    out = torch.gather(
        candidates, -2, best[..., None, None].expand(*best.shape, 1, 4)
    )[..., 0, :]
    return standardize_quaternion(out[..., [1, 2, 3, 0]])  # rijk -> ijkr


def closed_form_inverse_se3(se3: torch.Tensor) -> torch.Tensor:
    """Invert (..., 3|4, 4) SE3 matrices: [R^T | -R^T t] over [0 0 0 1]."""
    if se3.shape[-2:] not in ((4, 4), (3, 4)):
        raise ValueError(f"se3 must be (...,4,4) or (...,3,4), got {tuple(se3.shape)}.")
    R = se3[..., :3, :3]
    T = se3[..., :3, 3:]
    Rt = R.transpose(-1, -2)
    top = torch.cat([Rt, -Rt @ T], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def expand_extrinsic_to_homog(extrinsics: torch.Tensor) -> torch.Tensor:
    """Pad (..., 3, 4) extrinsics to homogeneous (..., 4, 4)."""
    bottom = torch.zeros_like(extrinsics[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([extrinsics, bottom], dim=-2)


def normalize_extrinsics(extrinsics: torch.Tensor) -> torch.Tensor:
    """Rebase (B, S, 3, 4) world-to-camera extrinsics to the first camera
    and divide translations by the mean distance of the others to it (no
    rescale when S == 1)."""
    S = extrinsics.shape[1]
    homog = expand_extrinsic_to_homog(extrinsics)
    new = homog @ closed_form_inverse_se3(homog[:, 0])[:, None]
    if S > 1:
        centers = new[:, :, :3, 3]
        dist = torch.linalg.norm(centers - centers[:, :1], dim=-1)[:, 1:]
        scale = dist.mean(dim=1, keepdim=True).clamp_min(1e-6)
        new = torch.cat([new[:, :, :3, :3], (new[:, :, :3, 3] / scale[..., None])[..., None]], dim=-1)
    return new[:, :, :3]


def extri_intri_to_pose_encoding(
    extrinsics: torch.Tensor,
    intrinsics: torch.Tensor,
    image_size_hw,
    pose_encoding_type: str = "absT_quaR_FoV",
) -> torch.Tensor:
    """(B,S,3,4) w2c extrinsics + (B,S,3,3) intrinsics -> (B,S,9)
    [T(3), quat xyzw(4), fov_h, fov_w], fp32."""
    if pose_encoding_type != "absT_quaR_FoV":
        raise NotImplementedError(pose_encoding_type)
    quat = mat_to_quat(extrinsics[..., :3, :3])
    H, W = image_size_hw
    fov_h = 2 * torch.atan((H / 2) / intrinsics[..., 1, 1])
    fov_w = 2 * torch.atan((W / 2) / intrinsics[..., 0, 0])
    return torch.cat(
        [extrinsics[..., :3, 3], quat, fov_h[..., None], fov_w[..., None]], dim=-1
    ).float()


def pose_encoding_to_extri_intri(
    pose_encoding: torch.Tensor,
    image_size_hw,
    pose_encoding_type: str = "absT_quaR_FoV",
    build_intrinsics: bool = True,
):
    """(B,S,9) pose encoding -> (B,S,3,4) extrinsics and, optionally,
    (B,S,3,3) intrinsics with the principal point at the image centre."""
    if pose_encoding_type != "absT_quaR_FoV":
        raise NotImplementedError(pose_encoding_type)
    T = pose_encoding[..., :3]
    R = quat_to_mat(pose_encoding[..., 3:7])
    extrinsics = torch.cat([R, T[..., None]], dim=-1)
    intrinsics = None
    if build_intrinsics:
        H, W = image_size_hw
        fy = (H / 2.0) / torch.tan(pose_encoding[..., 7] / 2.0)
        fx = (W / 2.0) / torch.tan(pose_encoding[..., 8] / 2.0)
        zeros, ones = torch.zeros_like(fx), torch.ones_like(fx)
        intrinsics = torch.stack(
            [
                torch.stack([fx, zeros, ones * (W / 2)], dim=-1),
                torch.stack([zeros, fy, ones * (H / 2)], dim=-1),
                torch.stack([zeros, zeros, ones], dim=-1),
            ],
            dim=-2,
        )
    return extrinsics, intrinsics


def depth_to_cam_coords_points(depth_map: torch.Tensor, intrinsic: torch.Tensor) -> torch.Tensor:
    """Pinhole unprojection: (H, W) depth + (3, 3) K -> (H, W, 3) camera coords."""
    H, W = depth_map.shape
    fu, fv = intrinsic[0, 0], intrinsic[1, 1]
    cu, cv = intrinsic[0, 2], intrinsic[1, 2]
    u = torch.arange(W, dtype=depth_map.dtype, device=depth_map.device)[None, :]
    v = torch.arange(H, dtype=depth_map.dtype, device=depth_map.device)[:, None]
    x_cam = (u - cu) * depth_map / fu
    y_cam = (v - cv) * depth_map / fv
    return torch.stack([x_cam, y_cam, depth_map], dim=-1).float()


def depth_to_world_coords_points(
    depth_map: torch.Tensor,
    extrinsic: torch.Tensor,
    intrinsic: torch.Tensor,
    z_far: float = 100.0,
    eps: float = 1e-8,
):
    """(H, W) depth + (3, 4) w2c extrinsic + (3, 3) K -> world points, camera
    points and a valid mask."""
    point_mask = depth_map > eps
    if z_far > 0:
        point_mask = point_mask & (depth_map < z_far)
    cam_coords = depth_to_cam_coords_points(depth_map, intrinsic)
    cam_to_world = closed_form_inverse_se3(extrinsic[None])[0]
    R = cam_to_world[:3, :3]
    t = cam_to_world[:3, 3]
    return cam_coords @ R.T + t, cam_coords, point_mask


def unproject_depth_map_to_point_map(depth_map, extrinsics_cam, intrinsics_cam) -> np.ndarray:
    """(S, H, W[, 1]) depth + (S, 3, 4) + (S, 3, 3) -> (S, H, W, 3) world
    points as numpy. Accepts numpy arrays or tensors."""
    depth_map = torch.as_tensor(depth_map)
    if depth_map.ndim == 4:
        depth_map = depth_map[..., 0]
    extrinsics_cam = torch.as_tensor(extrinsics_cam, device=depth_map.device)
    intrinsics_cam = torch.as_tensor(intrinsics_cam, device=depth_map.device)
    world = [
        depth_to_world_coords_points(d, e, k)[0]
        for d, e, k in zip(depth_map, extrinsics_cam, intrinsics_cam)
    ]
    return torch.stack(world).cpu().numpy()


def colmap_to_opencv_intrinsics(K: np.ndarray) -> np.ndarray:
    """Shift the principal point by -0.5 px (Colmap pixel-centre convention ->
    OpenCV)."""
    K = np.array(K, copy=True)
    K[..., 0, 2] -= 0.5
    K[..., 1, 2] -= 0.5
    return K


def opencv_to_colmap_intrinsics(K: np.ndarray) -> np.ndarray:
    K = np.array(K, copy=True)
    K[..., 0, 2] += 0.5
    K[..., 1, 2] += 0.5
    return K
