"""Image / camera / depth folder loading and preprocessing, on the host
(counterpart of omnivggt_tpu/data/loader.py; same numpy outputs).

  - images sorted, png/jpg/jpeg; RGBA composited onto white; PIL bicubic
    resize to width 518 with the height rounded to a multiple of 14, then
    centre-cropped to at most 518;
  - depth from `{basename}.npy` (non-finite -> 0) or `{basename}.png`
    (transposed, as the reference reads it); values > max_depth or < 1e-5
    zeroed; nearest-neighbour resize, same crop;
  - camera `{basename}.txt`: 3 rows of a 3x4 camera-to-world matrix, then 3
    rows of a 3x3 intrinsics matrix; intrinsics follow the resize and crop;
    the extrinsic is inverted to world-to-camera;
  - frames without camera or depth get zero placeholders; the index lists
    name the frames that have ground truth.

PIL and OpenCV are imported where they are used, so importing this module
needs neither.
"""

from __future__ import annotations

import glob
import os
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

TARGET_SIZE = 518
PATCH = 14


def _load_rgb(path: str):
    from PIL import Image

    img = Image.open(path)
    if img.mode == "RGBA":
        background = Image.new("RGBA", img.size, (255, 255, 255, 255))
        img = Image.alpha_composite(background, img)
    return img.convert("RGB")


def load_camera_from_txt(camera_path: str):
    """3x4 camera-to-world extrinsic + 3x3 intrinsic from a text file;
    (None, None) for a malformed file."""
    try:
        with open(camera_path) as f:
            lines = [
                line.strip() for line in f
                if line.strip() and not line.strip().startswith("#")
            ]
        if len(lines) < 6:
            return None, None
        extrinsic = np.array([[float(x) for x in lines[i].split()] for i in range(3)], np.float32)
        intrinsic = np.array([[float(x) for x in lines[i].split()] for i in range(3, 6)], np.float32)
        if extrinsic.shape != (3, 4) or intrinsic.shape != (3, 3):
            return None, None
        return extrinsic, intrinsic
    except (ValueError, OSError):
        return None, None


def _invert_c2w(extrinsic_c2w: np.ndarray) -> np.ndarray:
    R = extrinsic_c2w[:3, :3]
    t = extrinsic_c2w[:3, 3]
    return np.concatenate([R.T, (-R.T @ t)[:, None]], axis=1).astype(np.float32)


def _load_depth(depth_folder: str, basename: str, max_depth: float):
    import cv2

    for ext in (".npy", ".png"):
        path = os.path.join(depth_folder, basename + ext)
        if not os.path.exists(path):
            continue
        if ext == ".npy":
            depthmap = np.load(path).astype(np.float32)
            depthmap[~np.isfinite(depthmap)] = 0
        else:
            depthmap = cv2.imread(path, cv2.IMREAD_UNCHANGED).astype(np.float32)
            depthmap = depthmap.T  # as the reference reads it
            depthmap = np.nan_to_num(depthmap, nan=0.0)
        depthmap[depthmap > max_depth] = 0
        depthmap[depthmap < 1e-5] = 0
        return depthmap
    return None


def _resize_image_depth_and_intrinsic(image, depthmap, intrinsics, target_size: int, patch: int):
    """Width -> target_size, height rounded to a multiple of `patch` and
    centre-cropped to at most target_size; intrinsics rescaled and the
    principal point shifted by the crop (counterpart of
    omnivggt_tpu/data/cropping.resize_image_depth_and_intrinsic)."""
    from PIL import Image

    W, H = image.size
    new_w = target_size
    new_h = round(H * (new_w / W) / patch) * patch
    sx, sy = new_w / W, new_h / H
    image = image.resize((new_w, new_h), Image.BICUBIC)
    if depthmap is not None:
        import cv2

        depthmap = cv2.resize(depthmap, (new_w, new_h), interpolation=cv2.INTER_NEAREST)
    K = None
    if intrinsics is not None:
        K = np.asarray(intrinsics).copy()
        K[0, 0] *= sx
        K[1, 1] *= sy
        K[0, 2] *= sx
        K[1, 2] *= sy
    if new_h > target_size:
        crop_y = (new_h - target_size) // 2
        image = image.crop((0, crop_y, new_w, crop_y + target_size))
        if depthmap is not None:
            depthmap = depthmap[crop_y : crop_y + target_size]
        if K is not None:
            K[1, 2] -= crop_y
    return image, depthmap, K


def load_images_and_cameras(
    image_folder: str,
    camera_folder: Optional[str] = None,
    depth_folder: Optional[str] = None,
    target_size: int = TARGET_SIZE,
    max_depth: float = 100.0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray, List[int], List[int]]:
    """Load a scene folder. Returns channels-last numpy: images (S, H, W, 3)
    in [0, 1]; extrinsics (1, S, 3, 4) w2c; intrinsics (1, S, 3, 3); depths
    (1, S, H, W, 1); masks (1, S, H, W); depth_indices; camera_indices."""
    image_paths = sorted(glob.glob(os.path.join(image_folder, "*")))
    image_paths = [p for p in image_paths if p.lower().endswith((".png", ".jpg", ".jpeg"))]
    if not image_paths:
        raise ValueError(f"no .png/.jpg/.jpeg images found under {image_folder!r}")

    imgs, extrinsics_l, intrinsics_l, depths_l, masks_l = [], [], [], [], []
    depth_indices: List[int] = []
    camera_indices: List[int] = []
    for idx, img_path in enumerate(image_paths):
        basename = Path(img_path).stem
        img = _load_rgb(img_path)
        depthmap = (
            _load_depth(depth_folder, basename, max_depth) if depth_folder is not None else None
        )
        has_depth = depthmap is not None

        extrinsic = intrinsic = None
        if camera_folder is not None:
            cam_path = os.path.join(camera_folder, f"{basename}.txt")
            if os.path.exists(cam_path):
                extrinsic, intrinsic = load_camera_from_txt(cam_path)
        has_camera = extrinsic is not None and intrinsic is not None

        img, depthmap, intrinsic = _resize_image_depth_and_intrinsic(
            img, depthmap, intrinsic if has_camera else None, target_size, PATCH
        )
        arr = np.asarray(img, np.float32) / 255.0
        imgs.append(arr)

        if has_depth:
            depth_indices.append(idx)
            mask = depthmap > 1e-5
        else:
            depthmap = np.zeros(arr.shape[:2], np.float32)
            mask = np.zeros_like(depthmap, bool)
        depths_l.append(depthmap)
        masks_l.append(mask)

        if has_camera:
            camera_indices.append(idx)
            extrinsic = _invert_c2w(extrinsic)
        else:
            extrinsic = np.zeros((3, 4), np.float32)
            intrinsic = np.zeros((3, 3), np.float32)
        extrinsics_l.append(extrinsic)
        intrinsics_l.append(intrinsic)

    images = np.stack(imgs)
    depthmaps = np.stack(depths_l)[None, ..., None].astype(np.float32)
    masks = np.stack(masks_l)[None].astype(np.float32)
    extrinsics = np.stack(extrinsics_l)[None].astype(np.float32)
    intrinsics = np.stack(intrinsics_l)[None].astype(np.float32)
    return images, extrinsics, intrinsics, depthmaps, masks, depth_indices, camera_indices


def _pad_centered(arr: np.ndarray, h: int, w: int) -> np.ndarray:
    dh, dw = h - arr.shape[0], w - arr.shape[1]
    return np.pad(
        arr, ((dh // 2, dh - dh // 2), (dw // 2, dw - dw // 2), (0, 0)), constant_values=1.0
    )


def load_and_preprocess_images(image_path_list: List[str], mode: str = "crop") -> np.ndarray:
    """Quick-start loader: (N, H, W, 3) float32 in [0, 1]; mixed shapes are
    padded with white to the largest."""
    from PIL import Image

    if len(image_path_list) == 0:
        raise ValueError("At least 1 image is required")
    if mode not in ("crop", "pad"):
        raise ValueError("Mode must be either 'crop' or 'pad'")

    images = []
    for image_path in sorted(image_path_list):
        img = _load_rgb(image_path)
        width, height = img.size
        if mode == "pad" and width < height:
            new_height = TARGET_SIZE
            new_width = round(width * (new_height / height) / PATCH) * PATCH
        else:
            new_width = TARGET_SIZE
            new_height = round(height * (new_width / width) / PATCH) * PATCH
        img = img.resize((new_width, new_height), Image.Resampling.BICUBIC)
        arr = np.asarray(img, np.float32) / 255.0
        if mode == "crop" and new_height > TARGET_SIZE:
            start_y = (new_height - TARGET_SIZE) // 2
            arr = arr[start_y : start_y + TARGET_SIZE]
        if mode == "pad":
            arr = _pad_centered(arr, max(TARGET_SIZE, arr.shape[0]), max(TARGET_SIZE, arr.shape[1]))
        images.append(arr)

    max_h = max(a.shape[0] for a in images)
    max_w = max(a.shape[1] for a in images)
    return np.stack([_pad_centered(a, max_h, max_w) for a in images])
