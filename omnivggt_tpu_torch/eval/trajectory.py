"""Trajectory evaluation: ATE (Sim3-aligned APE RMSE) and RPE (relative pose
error, translation + rotation RMSE) (counterpart of
omnivggt_tpu/eval/trajectory.py; the same metrics).

The metrics match evo's definitions (`ape -r translation --align
--correct_scale`, `rpe -r translation/angle_deg --delta 1`): Umeyama Sim(3)
alignment + APE, and delta-1 RPE. Also the TUM trajectory I/O
(`timestamp tx ty tz qx qy qz qw` per line) and the dataset trajectory
loaders. numpy on the host; the quaternion codec is the port's own
utils/geometry on CPU tensors; matplotlib is imported inside plot_trajectory.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np

import torch

from omnivggt_tpu_torch.utils import geometry as G


def umeyama_sim3(src: np.ndarray, dst: np.ndarray, with_scale: bool = True):
    """Least-squares Sim(3): find (s, R, t) minimising ||dst - (s R src + t)||.

    Args:
        src, dst: (N, 3).
    Returns:
        (s, R, t).
    """
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs**2).sum() / len(src)
        s = np.trace(np.diag(D) @ S) / max(var_s, 1e-12)
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def _positions_from_c2w(poses_c2w: np.ndarray) -> np.ndarray:
    return poses_c2w[:, :3, 3]


def align_sim3(pred_c2w: np.ndarray, gt_c2w: np.ndarray, correct_scale: bool = True):
    """Sim(3)-align predicted poses to GT (evo's align=True, correct_scale=True):
    positions -> s R p + t, orientations -> R @ R_i. Returns aligned (N,4,4)."""
    p, g = _positions_from_c2w(pred_c2w), _positions_from_c2w(gt_c2w)
    s, R, t = umeyama_sim3(p, g, with_scale=correct_scale)
    out = pred_c2w.copy()
    out[:, :3, 3] = (s * (R @ p.T)).T + t
    out[:, :3, :3] = R @ pred_c2w[:, :3, :3]
    return out


def ate_rmse(
    pred_c2w: np.ndarray, gt_c2w: np.ndarray, correct_scale: bool = True
) -> float:
    """Absolute trajectory error: RMSE of translation after Sim(3) (or SE(3))
    alignment. Poses are (N, 4, 4) camera-to-world."""
    aligned = align_sim3(pred_c2w, gt_c2w, correct_scale=correct_scale)
    err = _positions_from_c2w(aligned) - _positions_from_c2w(gt_c2w)
    return float(np.sqrt(np.mean(np.sum(err**2, axis=-1))))


def rpe(
    pred_c2w: np.ndarray, gt_c2w: np.ndarray, delta: int = 1
) -> Tuple[float, float]:
    """Relative pose error with frame delta: (trans RMSE, rot RMSE in deg)."""
    def rel(poses):
        return np.stack(
            [np.linalg.inv(poses[i]) @ poses[i + delta] for i in range(len(poses) - delta)]
        )

    rp, rg = rel(pred_c2w), rel(gt_c2w)
    err = np.stack([np.linalg.inv(a) @ b for a, b in zip(rp, rg)])
    trans_err = np.linalg.norm(err[:, :3, 3], axis=-1)
    cos_angle = np.clip((np.trace(err[:, :3, :3], axis1=1, axis2=2) - 1) / 2, -1, 1)
    rot_err_deg = np.rad2deg(np.arccos(cos_angle))
    return (
        float(np.sqrt(np.mean(trans_err**2))),
        float(np.sqrt(np.mean(rot_err_deg**2))),
    )


def eval_metrics(
    pred_c2w: np.ndarray, gt_c2w: np.ndarray
) -> Dict[str, float]:
    """The reference's headline trio: Sim3-aligned ATE RMSE + delta-1 RPE
    translation/rotation RMSE.

    The reference's evo RPE calls also pass align=True + correct_scale=True:
    the Sim3 scale rescales the relative translations,
    so RPE is computed on the *aligned* prediction here too (rotation RPE is
    invariant to the alignment; translation RPE is not)."""
    aligned = align_sim3(pred_c2w, gt_c2w, correct_scale=True)
    err = _positions_from_c2w(aligned) - _positions_from_c2w(gt_c2w)
    ate = float(np.sqrt(np.mean(np.sum(err**2, axis=-1))))
    rpe_t, rpe_r = rpe(aligned, gt_c2w, delta=1)
    return {"ate_rmse": ate, "rpe_trans_rmse": rpe_t, "rpe_rot_rmse_deg": rpe_r}


def pose_auc(
    pred_c2w: np.ndarray, gt_c2w: np.ndarray, thresholds=(5, 10, 30)
) -> Dict[str, float]:
    """AUC of max(rotation err, normalised translation-angle err) under
    thresholds in degrees (the pose AUC@30 style metric)."""
    n = len(pred_c2w)
    errs = []
    for i in range(n):
        for j in range(i + 1, n):
            rel_p = np.linalg.inv(pred_c2w[i]) @ pred_c2w[j]
            rel_g = np.linalg.inv(gt_c2w[i]) @ gt_c2w[j]
            dR = rel_p[:3, :3] @ rel_g[:3, :3].T
            ang = np.rad2deg(
                np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1))
            )
            tp, tg = rel_p[:3, 3], rel_g[:3, 3]
            denom = np.linalg.norm(tp) * np.linalg.norm(tg)
            if denom > 1e-8:
                tang = np.rad2deg(
                    np.arccos(np.clip(tp @ tg / denom, -1, 1))
                )
            else:
                tang = 0.0
            errs.append(max(ang, tang))
    errs = np.sort(np.asarray(errs))
    out = {}
    for th in thresholds:
        # normalised area under the cumulative accuracy curve up to threshold
        xs = np.linspace(0, th, 100)
        acc = np.array([np.mean(errs <= e) for e in xs])
        out[f"auc@{th}"] = float(np.trapezoid(acc, x=xs / th))
    return out


# ---------------------------------------------------------------------------
# TUM-format trajectory I/O
# ---------------------------------------------------------------------------


def save_trajectory_tum_format(poses_c2w: np.ndarray, path: str, timestamps=None):
    """Write `timestamp tx ty tz qx qy qz qw` lines. The quaternions are
    formed in float32, as the JAX package forms them."""
    if timestamps is None:
        timestamps = np.arange(len(poses_c2w), dtype=np.float64)
    rot = torch.as_tensor(np.asarray(poses_c2w)[:, :3, :3], dtype=torch.float32)
    quats = G.mat_to_quat(rot).numpy()
    with open(path, "w") as f:
        for ts, pose, q in zip(timestamps, poses_c2w, quats):
            t = pose[:3, 3]
            f.write(
                f"{ts} {t[0]} {t[1]} {t[2]} {q[0]} {q[1]} {q[2]} {q[3]}\n"
            )


def load_trajectory_tum_format(path: str):
    """Read TUM lines -> (poses_c2w (N,4,4), timestamps (N,))."""
    data = np.loadtxt(path)
    if data.ndim == 1:
        data = data[None]
    ts = data[:, 0]
    t = data[:, 1:4]
    q = data[:, 4:8]  # qx qy qz qw (scalar-last, matches our codec)
    R = G.quat_to_mat(torch.from_numpy(q.astype(np.float32))).numpy()
    poses = np.tile(np.eye(4), (len(data), 1, 1))
    poses[:, :3, :3] = R
    poses[:, :3, 3] = t
    return poses, ts


# ---------------------------------------------------------------------------
# Dataset trajectory loaders: Sintel / Replica / TUM / TartanAir ->
# camera-to-world (N, 4, 4) + timestamps
# ---------------------------------------------------------------------------


def load_replica_traj(gt_file: str):
    """Replica traj.txt: one flattened 3x4 or 4x4 c2w matrix per line."""
    raw = np.loadtxt(gt_file)
    assert raw.shape[1] in (12, 16), f"unexpected row width {raw.shape[1]}"
    poses = np.tile(np.eye(4), (len(raw), 1, 1))
    poses[:, : raw.shape[1] // 4, :] = raw.reshape(len(raw), -1, 4)
    ts = np.arange(len(raw), dtype=float)
    return poses, ts


def load_sintel_traj(gt_dir: str):
    """Sintel camdata folder of .cam files (world-to-camera extrinsics);
    inverted to camera-to-world and mean-centred like the reference."""
    from omnivggt_tpu_torch.data.image_io import cam_read

    files = sorted(
        os.path.join(gt_dir, f) for f in os.listdir(gt_dir) if f.endswith(".cam")
    )
    ts = np.array(
        [float(os.path.basename(f)[:-4].split("_")[-1]) for f in files]
    )
    poses = []
    for f in files:
        _, N = cam_read(f)
        w2c = np.eye(4)
        w2c[:3, :4] = N
        poses.append(np.linalg.inv(w2c))
    poses = np.stack(poses)
    poses[:, :3, 3] -= poses[:, :3, 3].mean(0, keepdims=True)
    return poses, ts


def load_traj(
    gt_traj_file: str,
    traj_format: str = "sintel",
    skip: int = 0,
    stride: int = 1,
    num_frames=None,
):
    """Load a GT trajectory in any supported format as c2w (N,4,4) +
    timestamps, with skip/stride/limit."""
    if traj_format == "replica":
        poses, ts = load_replica_traj(gt_traj_file)
    elif traj_format == "sintel":
        poses, ts = load_sintel_traj(gt_traj_file)
    elif traj_format in ("tum", "tartanair"):
        poses, ts = load_trajectory_tum_format(gt_traj_file)
    else:
        raise NotImplementedError(traj_format)
    poses, ts = poses[skip::stride], ts[skip::stride]
    if num_frames is not None:
        poses, ts = poses[:num_frames], ts[:num_frames]
    return poses, ts


def load_timestamps(time_file: str, traj_format: str = "replica"):
    if traj_format in ("tum", "tartanair"):
        with open(time_file) as f:
            return [float(x.split(" ")[0]) for x in f if not x.startswith("#")]
    return None


# ---------------------------------------------------------------------------
# Plotting + result aggregation
# ---------------------------------------------------------------------------


def plot_trajectory(
    pred_c2w: np.ndarray,
    gt_c2w: Optional[np.ndarray] = None,
    title: str = "",
    filename: str = "traj.png",
    align: bool = True,
    correct_scale: bool = True,
):
    """2D plot in the best-variance plane, GT dashed gray, prediction blue."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    p = _positions_from_c2w(pred_c2w)
    g = _positions_from_c2w(gt_c2w) if gt_c2w is not None else None
    if g is not None and align:
        s, R, t = umeyama_sim3(p, g, with_scale=correct_scale)
        p = (s * (R @ p.T)).T + t

    basis = g if g is not None else p
    order = np.argsort(np.var(basis, axis=0))
    i1, i2 = order[-1], order[-2]  # two highest-variance axes

    fig, ax = plt.subplots(figsize=(8, 8))
    ax.set_title(title)
    if g is not None:
        ax.plot(g[:, i1], g[:, i2], "--", color="gray", label="Ground Truth")
    ax.plot(p[:, i1], p[:, i2], "-", color="blue", label="Predicted")
    ax.set_xlabel("xyz"[i1])
    ax.set_ylabel("xyz"[i2])
    ax.legend()
    ax.set_aspect("equal", adjustable="datalim")
    fig.savefig(filename, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return filename


def write_metrics_file(metrics: dict, path: str, seq: str = ""):
    """Write an eval-metric text file compatible with extract_metrics."""
    with open(path, "w") as f:
        f.write(f"seq: {seq}\n")
        f.write("APE w.r.t. translation part (m)\n")
        f.write(f"  rmse {metrics['ate_rmse']:.6f}\n")
        f.write("RPE w.r.t. translation part (m)\n")
        f.write(f"  rmse {metrics['rpe_trans_rmse']:.6f}\n")
        f.write("RPE w.r.t. rotation angle in degrees (deg)\n")
        f.write(f"  rmse {metrics['rpe_rot_rmse_deg']:.6f}\n")


def extract_metrics(file_path: str):
    """Parse (ate, rpe_trans, rpe_rot) rmse values out of an eval text file."""
    import re

    with open(file_path) as f:
        content = f.read()
    pats = [
        r"APE w\.r\.t\. translation part \(m\).*?rmse\s+([0-9.]+)",
        r"RPE w\.r\.t\. translation part \(m\).*?rmse\s+([0-9.]+)",
        r"RPE w\.r\.t\. rotation angle in degrees \(deg\).*?rmse\s+([0-9.]+)",
    ]
    vals = []
    for pat in pats:
        m = re.search(pat, content, re.DOTALL)
        vals.append(float(m.group(1)) if m else 0.0)
    return tuple(vals)


def process_directory(directory: str):
    """Collect (seq, ate, rpe_trans, rpe_rot) from every *_metric.txt below
    `directory`."""
    results = []
    for root, _, files in os.walk(directory):
        for file in sorted(files):
            if file.endswith("_metric.txt"):
                # strip whichever metric suffix the file actually carries
                seq = file[: -len("_eval_metric.txt")] if file.endswith(
                    "_eval_metric.txt"
                ) else file[: -len("_metric.txt")]
                results.append(
                    (seq, *extract_metrics(os.path.join(root, file)))
                )
    return results


def calculate_averages(results):
    if not results:
        return 0.0, 0.0, 0.0
    n = len(results)
    return (
        sum(r[1] for r in results) / n,
        sum(r[2] for r in results) / n,
        sum(r[3] for r in results) / n,
    )
