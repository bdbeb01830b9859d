"""View selection: pairwise camera-distance ranking for training-data
sampling (counterpart of omnivggt_tpu/data/view_selection.py), in numpy.

distance(i, j) = rotation_angle(R_i, R_j) / 180 + lambda_t * ||t_i - t_j||,
optionally with camera centres divided by their mean norm, then a stable
argsort per row (nearest first). trace(R_i^T R_j) for all pairs is one
(N, 9) @ (9, N) product.
"""

from __future__ import annotations

import numpy as np


def pairwise_extrinsic_distance(extrinsics: np.ndarray, lambda_t: float = 1.0) -> np.ndarray:
    """(N, 4, 4) or (N, 3, 4) extrinsics -> (N, N) float32 distances."""
    R = np.asarray(extrinsics[:, :3, :3], np.float32)
    t = np.asarray(extrinsics[:, :3, 3], np.float32)
    Rf = R.reshape(-1, 9)
    traces = Rf @ Rf.T
    rot = np.degrees(np.arccos(np.clip((traces - 1) / 2, -1.0, 1.0))) / 180.0
    sq = (t**2).sum(-1)
    d2 = sq[:, None] - 2 * t @ t.T + sq[None, :]
    return (rot + lambda_t * np.sqrt(np.maximum(d2, 0.0))).astype(np.float32)


def compute_ranking(extrinsics, lambda_t: float = 1.0, normalize: bool = True):
    """(ranking (N, N) int, dists (N, N)) with rows sorted nearest-first."""
    ex = np.array(extrinsics, np.float32)
    if normalize:
        avg_scale = np.linalg.norm(ex[:, :3, 3], axis=1).mean()
        # pure-rotation captures have every centre at the origin
        ex[:, :3, 3] /= avg_scale if avg_scale > 0 else 1.0
    dists = pairwise_extrinsic_distance(ex, lambda_t)
    return np.argsort(dists, axis=1, kind="stable"), dists
