"""Scene building: meshes from point maps, camera markers, and a
connected-component sky heuristic (counterpart of omnivggt_tpu/viz/scene.py;
the same bytes).

pts3d_to_mesh (grid triangulation of an H x W point map with per-face
colours), camera markers, the CAM_COLORS palette, and the HSV +
largest-connected-component sky segmentation. Everything exports through the
dependency-free GLB writer. OpenCV and scipy are imported inside
segment_sky_hsv_cc only.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from omnivggt_tpu_torch.viz.glb import camera_frustum_mesh, write_glb

CAM_COLORS = [
    (255, 0, 0), (0, 0, 255), (0, 255, 0), (255, 0, 255), (255, 204, 0),
    (0, 204, 204), (128, 255, 255), (255, 128, 255), (255, 255, 128),
    (0, 0, 0), (128, 128, 128),
]

OPENGL = np.diag([1.0, -1.0, -1.0, 1.0])


def pts3d_to_mesh(img: np.ndarray, pts3d: np.ndarray, valid: Optional[np.ndarray] = None):
    """Triangulate an (H, W, 3) point map into a double-sided mesh with
    per-face colors from `img`; faces touching invalid points are dropped.

    Returns dict(vertices (N,3), faces (F,3), face_colors (F,3) float [0,1]).
    """
    H, W, _ = img.shape
    assert img.shape == pts3d.shape
    vertices = pts3d.reshape(-1, 3)

    idx = np.arange(len(vertices)).reshape(H, W)
    tl = idx[:-1, :-1].ravel()
    tr = idx[:-1, 1:].ravel()
    bl = idx[1:, :-1].ravel()
    br = idx[1:, 1:].ravel()
    faces = np.concatenate(
        [
            np.c_[tl, tr, bl],
            np.c_[bl, tr, tl],  # backward copy cancels face culling
            np.c_[tr, bl, br],
            np.c_[br, bl, tr],
        ],
        axis=0,
    )
    face_colors = np.concatenate(
        [
            img[:-1, :-1].reshape(-1, 3),
            img[:-1, :-1].reshape(-1, 3),
            img[1:, 1:].reshape(-1, 3),
            img[1:, 1:].reshape(-1, 3),
        ],
        axis=0,
    )
    if valid is not None:
        ok = valid.ravel()[faces].all(axis=-1)
        faces, face_colors = faces[ok], face_colors[ok]
    return dict(vertices=vertices, faces=faces, face_colors=face_colors)


def cat_meshes(meshes: List[dict]) -> dict:
    vertices = np.concatenate([m["vertices"] for m in meshes])
    offsets = np.cumsum([0] + [len(m["vertices"]) for m in meshes[:-1]])
    faces = np.concatenate([m["faces"] + o for m, o in zip(meshes, offsets)])
    face_colors = np.concatenate([m["face_colors"] for m in meshes])
    return dict(vertices=vertices, faces=faces, face_colors=face_colors)


class SceneViz:
    """Accumulates point clouds, point-map meshes, and camera markers, then
    exports one GLB (the artifact is the file, viewable with any glTF
    viewer)."""

    def __init__(self):
        self.points: List[np.ndarray] = []
        self.point_colors: List[np.ndarray] = []
        self.meshes: List[Tuple[np.ndarray, np.ndarray, Tuple[int, int, int]]] = []

    def add_pointcloud(self, pts3d, color, mask=None):
        pts3d = np.asarray(pts3d).reshape(-1, 3)
        color = np.asarray(color)
        if color.ndim >= 2:
            color = color.reshape(-1, 3)
        else:
            color = np.broadcast_to(color, (len(pts3d), 3))
        if mask is not None:
            mask = np.asarray(mask).reshape(-1)
            pts3d, color = pts3d[mask], color[mask]
        if np.issubdtype(color.dtype, np.floating):
            color = (np.clip(color, 0, 1) * 255).astype(np.uint8)
        self.points.append(pts3d.astype(np.float32))
        self.point_colors.append(color)
        return self

    def add_mesh(self, img, pts3d, valid=None):
        m = pts3d_to_mesh(np.asarray(img), np.asarray(pts3d), valid)
        mean_color = m["face_colors"].mean(0)
        if np.issubdtype(mean_color.dtype, np.floating) and mean_color.max() <= 1:
            mean_color = mean_color * 255
        self.meshes.append(
            (m["vertices"].astype(np.float32), m["faces"].astype(np.uint32),
             tuple(int(c) for c in mean_color))
        )
        return self

    def add_camera(self, pose_c2w, focal=None, color=None, image=None, imsize=None,
                   cam_size: float = 0.03):
        i = len(self.meshes)
        color = color or CAM_COLORS[i % len(CAM_COLORS)]
        verts, faces = camera_frustum_mesh(np.asarray(pose_c2w), cam_size * 20)
        self.meshes.append((verts, faces, tuple(color)))
        return self

    def save_glb(self, path: str) -> str:
        pts = (
            np.concatenate(self.points)
            if self.points
            else np.zeros((0, 3), np.float32)
        )
        cols = (
            np.concatenate(self.point_colors)
            if self.point_colors
            else np.zeros((0, 3), np.uint8)
        )
        write_glb(path, pts, cols, self.meshes)
        return path


def segment_sky_hsv_cc(image: np.ndarray) -> np.ndarray:
    """The reference's sky heuristic: blue/luminous-gray HSV ranges,
    morphological opening, keep the largest connected components.
    Returns (H, W) bool, True = sky."""
    import cv2
    from scipy import ndimage

    img = np.asarray(image)
    if np.issubdtype(img.dtype, np.floating):
        img = np.uint8(255 * img.clip(min=0, max=1))
    hsv = cv2.cvtColor(img, cv2.COLOR_RGB2HSV)

    # the reference converts its RGB array with COLOR_BGR2HSV (channels
    # swapped) and thresholds swapped-hue [0, 30]; swapping R<->B
    # reflects hue about 120 on OpenCV's 0-180 scale, so the equivalent range
    # on a correctly-converted image is real hue [90, 120]
    mask = cv2.inRange(hsv, np.array([90, 0, 100]), np.array([120, 255, 255])).astype(bool)
    mask |= (hsv[:, :, 1] < 10) & (hsv[:, :, 2] > 150)
    mask |= (hsv[:, :, 1] < 30) & (hsv[:, :, 2] > 180)
    mask |= (hsv[:, :, 1] < 50) & (hsv[:, :, 2] > 220)

    kernel = np.ones((5, 5), np.uint8)
    mask2 = ndimage.binary_opening(mask, structure=kernel)

    _, labels, stats, _ = cv2.connectedComponentsWithStats(
        mask2.astype(np.uint8), connectivity=8
    )
    if stats.shape[0] <= 1:
        return np.zeros(mask.shape, bool)
    cc_sizes = stats[1:, cv2.CC_STAT_AREA]
    order = cc_sizes.argsort()[::-1]
    selection = []
    i = 0
    while i < len(order) and cc_sizes[order[i]] > cc_sizes[order[0]] / 2:
        selection.append(1 + order[i])
        i += 1
    return np.isin(labels, selection)
