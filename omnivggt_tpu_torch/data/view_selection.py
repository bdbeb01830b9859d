"""View selection: pairwise camera-distance ranking for training-data
sampling (counterpart of omnivggt_tpu/data/view_selection.py), in numpy.

distance(i, j) = rotation_angle(R_i, R_j) / 180 + lambda_t * ||t_i - t_j||,
optionally with camera centres divided by their mean norm, then a stable
argsort per row (nearest first). trace(R_i^T R_j) for all pairs is one
(N, 9) @ (9, N) product; `row_chunk` computes the rows in chunks to bound
the memory for N in the thousands.
"""

from __future__ import annotations

import numpy as np


def rotation_angle_deg(R1: np.ndarray, R2: np.ndarray) -> np.ndarray:
    """Geodesic angle in degrees between two rotation matrices (3, 3)."""
    R = np.asarray(R1).T @ np.asarray(R2)
    return np.degrees(np.arccos(np.clip((np.trace(R) - 1) / 2, -1.0, 1.0)))


def pairwise_extrinsic_distance(
    extrinsics: np.ndarray, lambda_t: float = 1.0, row_chunk: int = 0
) -> np.ndarray:
    """(N, 4, 4) or (N, 3, 4) extrinsics -> (N, N) float32 distances.

    row_chunk > 0 that divides N (and is below it): the rows are computed
    row_chunk at a time, as the JAX package's lax.map does."""
    R = np.asarray(extrinsics[:, :3, :3], np.float32)
    t = np.asarray(extrinsics[:, :3, 3], np.float32)
    Rf = R.reshape(-1, 9)
    sq = (t**2).sum(-1)

    def rows(Rf_chunk, t_chunk):
        traces = Rf_chunk @ Rf.T  # (c, N)
        rot = np.degrees(np.arccos(np.clip((traces - 1) / 2, -1.0, 1.0))) / 180.0
        d2 = (t_chunk**2).sum(-1)[:, None] - 2 * t_chunk @ t.T + sq[None, :]
        return (rot + lambda_t * np.sqrt(np.maximum(d2, 0.0))).astype(np.float32)

    N = R.shape[0]
    if row_chunk and N > row_chunk and N % row_chunk == 0:
        return np.concatenate(
            [rows(Rf[i : i + row_chunk], t[i : i + row_chunk]) for i in range(0, N, row_chunk)]
        )
    return rows(Rf, t)


def compute_ranking(extrinsics, lambda_t: float = 1.0, normalize: bool = True):
    """(ranking (N, N) int, dists (N, N)) with rows sorted nearest-first.

    This is also the body that the JAX package jits as `_ranking_impl`: the
    optional normalisation of the camera centres by their mean norm, the
    distances, and the argsort."""
    ex = np.array(extrinsics, np.float32)
    if normalize:
        avg_scale = np.linalg.norm(ex[:, :3, 3], axis=1).mean()
        # pure-rotation captures have every centre at the origin
        ex[:, :3, 3] /= avg_scale if avg_scale > 0 else 1.0
    dists = pairwise_extrinsic_distance(ex, lambda_t)
    return np.argsort(dists, axis=1, kind="stable"), dists
