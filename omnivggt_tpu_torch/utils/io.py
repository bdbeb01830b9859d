"""Artifact saving helpers (poses, focals, intrinsics, confidences, depth
colormaps, RGB frames, dynamic masks) (counterpart of omnivggt_tpu/utils/io.py;
the same files). numpy; PIL and OpenCV imported inside the helpers that
write images."""

from __future__ import annotations

import os

import numpy as np


def save_tum_poses(traj_c2w: np.ndarray, path: str):
    from omnivggt_tpu_torch.eval.trajectory import save_trajectory_tum_format

    save_trajectory_tum_format(np.asarray(traj_c2w), path)
    return traj_c2w


def save_focals(focals, path: str):
    np.savetxt(path, np.asarray(focals), fmt="%.6f")
    return focals


def save_intrinsics(K_raw, path: str):
    K = np.asarray(K_raw).reshape(-1, 9)
    np.savetxt(path, K, fmt="%.6f")
    return K_raw


def save_conf_maps(conf, path: str):
    for i, c in enumerate(np.asarray(conf)):
        np.save(os.path.join(path, f"conf_{i}.npy"), c)
    return conf


def save_rgb_imgs(imgs, path: str):
    """imgs: (S, H, W, 3) float [0,1]; writes frame_%04d.png."""
    import cv2

    for i, img in enumerate(np.asarray(imgs)):
        bgr = img[..., ::-1]
        cv2.imwrite(os.path.join(path, f"frame_{i:04d}.png"), bgr * 255)
    return imgs


def save_dynamic_masks(masks, path: str):
    import cv2

    for i, m in enumerate(np.asarray(masks)):
        cv2.imwrite(
            os.path.join(path, f"dynamic_mask_{i}.png"),
            (m * 255).astype(np.uint8),
        )
    return masks


def save_depth_maps(depth_maps, path: str):
    """Per-frame JET-colormapped PNG + raw .npy + an animated GIF."""
    import cv2
    from PIL import Image

    images = []
    for i, d in enumerate(np.asarray(depth_maps)):
        d = np.squeeze(d)
        colored = cv2.applyColorMap(
            np.clip(d * 255, 0, 255).astype(np.uint8), cv2.COLORMAP_JET
        )
        img_path = os.path.join(path, f"frame_{i:04d}.png")
        cv2.imwrite(img_path, colored)
        images.append(Image.open(img_path))
        np.save(os.path.join(path, f"frame_{i:04d}.npy"), d)
    if images:
        images[0].save(
            os.path.join(path, "_depth_maps.gif"),
            save_all=True, append_images=images[1:], duration=100, loop=0,
        )
    return depth_maps


def save_images_from_tensor(images, save_dir: str = "frames", prefix: str = "frame"):
    """(1, S, H, W, 3) or (S, H, W, 3) float [0,1] -> PNGs."""
    from PIL import Image

    os.makedirs(save_dir, exist_ok=True)
    arr = np.asarray(images)
    if arr.ndim == 5:
        arr = arr[0]
    for i, img in enumerate(arr):
        Image.fromarray((img * 255).astype(np.uint8)).save(
            os.path.join(save_dir, f"{prefix}_{i}.png")
        )
