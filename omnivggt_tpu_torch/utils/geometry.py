"""Camera geometry on tensors (counterpart of omnivggt_tpu/utils/geometry.py).

  - quaternion codec, scalar-last XYZW, best-conditioned matrix -> quaternion
    with sign standardisation;
  - closed-form SE3 inverse;
  - the 9-dim absT_quaR_FoV pose codec;
  - depth unprojection to camera and world points;
  - the Colmap <-> OpenCV principal-point conventions (numpy);
  - point maps: normalize_pointcloud, geotrf (homogeneous transforms),
    find_reciprocal_matches (scipy KD-trees, host) and
    get_med_dist_between_poses.
"""

from __future__ import annotations

from typing import Optional

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


def normalize_pointcloud(
    pts: torch.Tensor,
    norm_mode: str = "avg_dis",
    valid: Optional[torch.Tensor] = None,
    ret_factor: bool = False,
):
    """Divide (B, ..., 3) point maps by a per-batch distance statistic over
    their valid points: norm_mode is "<avg|median|sqrt>_<dis|log1p|warp-log1p>".
    median takes the lower of the two middle values (torch.nanmedian's);
    warp-log1p also rescales each point by log1p(d) / d first."""
    if pts.ndim < 3 or pts.shape[-1] != 3:
        raise ValueError(f"points must be (B, ..., 3); got {tuple(pts.shape)}")
    mode, dis_mode = norm_mode.split("_")
    B = pts.shape[0]
    flat = pts.reshape(B, -1, 3)
    vmask = (valid.reshape(B, -1).bool() if valid is not None
             else torch.ones(flat.shape[:2], dtype=torch.bool, device=pts.device))

    dis = torch.linalg.vector_norm(torch.where(vmask[..., None], flat, 0.0), dim=-1)
    if dis_mode == "log1p":
        dis = torch.log1p(dis)
    elif dis_mode == "warp-log1p":
        log_dis = torch.log1p(dis)
        warp = log_dis / dis.clamp(min=1e-8)
        pts = pts * warp.reshape(pts.shape[:-1])[..., None]
        dis = log_dis
    elif dis_mode != "dis":
        raise ValueError(f"bad {dis_mode=}")

    nnz = vmask.sum(dim=1)
    if mode == "avg":
        factor = (dis * vmask).sum(dim=1) / (nnz + 1e-8)
    elif mode == "median":
        sorted_dis = torch.where(vmask, dis, torch.inf).sort(dim=1).values
        idx = ((nnz - 1) // 2).clamp(min=0)
        factor = sorted_dis.gather(1, idx[:, None])[:, 0]
    elif mode == "sqrt":
        factor = ((torch.sqrt(dis) * vmask).sum(dim=1) / (nnz + 1e-8)) ** 2
    else:
        raise ValueError(f"bad {mode=}")

    factor = factor.clamp(min=1e-8).reshape((B,) + (1,) * (pts.ndim - 1))
    res = pts / factor
    if ret_factor:
        return res, factor
    return res


def find_reciprocal_matches(P1: np.ndarray, P2: np.ndarray):
    """Mutual nearest neighbours between two (N, 3) point sets through
    scipy's KD-trees: (reciprocal_in_P2 bool (N2,), nn2_in_P1 int (N2,),
    the number of matches)."""
    from scipy.spatial import KDTree

    tree1, tree2 = KDTree(P1), KDTree(P2)
    _, nn1_in_P2 = tree2.query(P1, workers=-1)
    _, nn2_in_P1 = tree1.query(P2, workers=-1)
    reciprocal_in_P2 = nn1_in_P2[nn2_in_P1] == np.arange(len(nn2_in_P1))
    return reciprocal_in_P2, nn2_in_P1, int(reciprocal_in_P2.sum())


def get_med_dist_between_poses(poses) -> float:
    """The median distance between the camera centres (translations) of
    4x4 or 3x4 poses."""
    from scipy.spatial.distance import pdist

    return float(np.median(pdist([np.asarray(p)[:3, 3] for p in poses])))


def geotrf(Trf, pts, ncol: Optional[int] = None, norm: float = 0):
    """Apply a (batched) transform to points (..., 2|3): a rotation plus
    translation when Trf is one column wider than the points, a linear map
    when square; `norm` projects onto the z = norm plane."""
    Trf = torch.as_tensor(Trf)
    pts = torch.as_tensor(pts)
    output_shape = pts.shape[:-1]
    ncol = ncol or pts.shape[-1]

    if Trf.ndim >= 3:
        n = Trf.ndim - 2
        if Trf.shape[:n] != pts.shape[:n]:
            raise ValueError("batch size does not match")
        Trf = Trf.reshape(-1, Trf.shape[-2], Trf.shape[-1])
        if pts.ndim > Trf.ndim:
            pts = pts.reshape(Trf.shape[0], -1, pts.shape[-1])
        elif pts.ndim == 2:
            pts = pts[:, None, :]

    if pts.shape[-1] + 1 == Trf.shape[-1]:
        T = Trf.transpose(-1, -2)
        pts = pts @ T[..., :-1, :] + T[..., -1:, :]
    elif pts.shape[-1] == Trf.shape[-1]:
        pts = pts @ Trf.transpose(-1, -2)
    else:
        pts = (Trf @ pts.permute(*range(pts.ndim - 1, -1, -1))).transpose(-1, -2)

    if norm:
        pts = pts / pts[..., -1:]
        if norm != 1:
            pts = pts * norm

    return pts[..., :ncol].reshape(*output_shape, ncol)
