"""Dataset format readers: ScanNet scenes and CO3D sequences (counterpart
of omnivggt_tpu/data/formats.py).

Each reader returns the tuple that `data/loader.load_images_and_cameras`
returns, (images, extrinsics w2c, intrinsics, depthmaps, masks,
depth_indices, camera_indices), through the same resize / crop / intrinsic
rescale (`data/cropping.resize_image_depth_and_intrinsic`), so every source
is preprocessed alike:

  - ScanNet (extracted layout): color/*.jpg, depth/*.png (16-bit
    millimetres), pose/*.txt (4x4 camera-to-world, OpenCV axes; invalid
    poses hold inf), intrinsic/intrinsic_color.txt (4x4).
  - CO3D: <category>/frame_annotations.jgz (a gzipped JSON list) with each
    frame's image and depth paths and its PyTorch3D camera (row vectors,
    `x_cam = x_world @ R + T`, axes +x left / +y up, focal length and
    principal point in NDC). Converted to OpenCV pixel-space w2c matrices;
    the 16-bit depth is decoded by image_io.load_16bit_png_depth and scaled
    by the annotation's scale_adjustment.

`detect_scene_format` lets SceneDataset mix formats in one training root.
Host-side numpy; PIL (and cv2, through the cropping) are imported by the
functions that read files.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
from typing import List, Optional, Tuple

import numpy as np

from omnivggt_tpu_torch.data.cropping import resize_image_depth_and_intrinsic
from omnivggt_tpu_torch.data.loader import PATCH, TARGET_SIZE

SceneArrays = Tuple[
    np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray,
    List[int], List[int],
]


def _stack_scene(imgs, exs, Ks, depths, masks, d_idx, c_idx) -> SceneArrays:
    return (
        np.stack(imgs),
        np.stack(exs)[None].astype(np.float32),
        np.stack(Ks)[None].astype(np.float32),
        np.stack(depths)[None, ..., None].astype(np.float32),
        np.stack(masks)[None].astype(np.float32),
        d_idx,
        c_idx,
    )


def _preprocess_frame(img, depth: Optional[np.ndarray], K: Optional[np.ndarray],
                      target_size: int):
    """The canonical geometry op for image + depth + intrinsics (shared with
    the folder loader)."""
    img, depth, K = resize_image_depth_and_intrinsic(
        img, depth, K, target_size=target_size, patch=PATCH
    )
    arr = np.asarray(img, np.float32) / 255.0
    if depth is None:
        depth = np.zeros(arr.shape[:2], np.float32)
        mask = np.zeros(arr.shape[:2], bool)
    else:
        mask = depth > 1e-5
    return arr, depth.astype(np.float32), mask, K


# ---------------------------------------------------------------------------
# ScanNet
# ---------------------------------------------------------------------------


def is_scannet_scene(scene_dir: str) -> bool:
    return os.path.isdir(os.path.join(scene_dir, "color")) and os.path.isdir(
        os.path.join(scene_dir, "pose")
    )


def load_scannet_scene(
    scene_dir: str,
    target_size: int = TARGET_SIZE,
    stride: int = 1,
    max_frames: Optional[int] = None,
    max_depth: float = 100.0,
    depth_scale: float = 1000.0,
) -> SceneArrays:
    """Read an extracted ScanNet scene (color/ depth/ pose/ intrinsic/).

    Depth PNGs are 16-bit millimetres at the depth sensor's resolution; they
    are nearest-resized to the colour resolution (PIL, mode 'F') before the
    canonical crop so the pixel grids align. Poses are 4x4 camera-to-world
    in OpenCV axes; a frame whose pose has non-finite entries (ScanNet's
    invalid marker) keeps its image but has no camera GT."""
    import PIL.Image

    def frame_id(p):
        stem = os.path.splitext(os.path.basename(p))[0]
        return int(stem) if stem.isdigit() else stem

    color_paths = [
        p for p in glob.glob(os.path.join(scene_dir, "color", "*"))
        if p.lower().endswith((".jpg", ".jpeg", ".png"))
    ]
    # filter before sorting: a stray non-numeric file must not mix int and
    # str sort keys
    numeric = all(isinstance(frame_id(p), int) for p in color_paths)
    color_paths = sorted(color_paths, key=frame_id if numeric else str)
    color_paths = color_paths[::stride]
    if max_frames:
        color_paths = color_paths[:max_frames]
    if not color_paths:
        raise ValueError(f"no colour frames under {scene_dir}/color")

    K_path = os.path.join(scene_dir, "intrinsic", "intrinsic_color.txt")
    K_base = None
    if os.path.exists(K_path):
        K_base = np.loadtxt(K_path, dtype=np.float64)[:3, :3]

    imgs, exs, Ks, depths, masks = [], [], [], [], []
    d_idx: List[int] = []
    c_idx: List[int] = []
    for i, cpath in enumerate(color_paths):
        stem = os.path.splitext(os.path.basename(cpath))[0]
        img = PIL.Image.open(cpath).convert("RGB")

        depth = None
        dpath = os.path.join(scene_dir, "depth", f"{stem}.png")
        if os.path.exists(dpath):
            d = np.asarray(PIL.Image.open(dpath))
            if d.dtype != np.uint16 and d.max() <= 255:
                # 8-bit files (fixtures) are taken as raw units
                d = d.astype(np.uint16)
            depth = d.astype(np.float32) / depth_scale
            depth[~np.isfinite(depth)] = 0.0
            depth[(depth > max_depth) | (depth < 1e-5)] = 0.0
            if depth.shape != (img.height, img.width):
                depth = np.asarray(
                    PIL.Image.fromarray(depth).resize((img.width, img.height), PIL.Image.NEAREST)
                )

        pose_c2w = None
        ppath = os.path.join(scene_dir, "pose", f"{stem}.txt")
        if os.path.exists(ppath) and K_base is not None:
            P = np.loadtxt(ppath, dtype=np.float64)
            if P.shape == (4, 4) and np.isfinite(P).all():
                pose_c2w = P

        has_cam = pose_c2w is not None
        arr, depth, mask, K_scaled = _preprocess_frame(
            img, depth, K_base.copy() if has_cam else None, target_size
        )
        imgs.append(arr)
        depths.append(depth)
        masks.append(mask)
        if mask.any():
            d_idx.append(i)
        if has_cam:
            c_idx.append(i)
            exs.append(np.linalg.inv(pose_c2w)[:3].astype(np.float32))  # w2c
            Ks.append(np.asarray(K_scaled, np.float32))
        else:
            exs.append(np.zeros((3, 4), np.float32))
            Ks.append(np.zeros((3, 3), np.float32))
    return _stack_scene(imgs, exs, Ks, depths, masks, d_idx, c_idx)


# ---------------------------------------------------------------------------
# CO3D
# ---------------------------------------------------------------------------


def is_co3d_sequence(seq_dir: str) -> bool:
    # a CO3D category holds other directories (set_lists/, eval_batches/)
    # beside frame_annotations.jgz: a sequence also has images/
    parent = os.path.dirname(os.path.abspath(seq_dir))
    return os.path.exists(os.path.join(parent, "frame_annotations.jgz")) and os.path.isdir(
        os.path.join(seq_dir, "images")
    )


def _pt3d_ndc_to_pixel_K(focal: np.ndarray, principal: np.ndarray, H: int, W: int,
                         fmt: str) -> np.ndarray:
    """PyTorch3D NDC intrinsics -> OpenCV pixel K.

    PyTorch3D NDC: +x left, +y up; "ndc_isotropic" scales both axes by half
    the shorter image side, "ndc_norm_image_bounds" scales x by W/2 and y by
    H/2 (CO3D v2 uses isotropic)."""
    if fmt == "ndc_norm_image_bounds":
        sx, sy = W / 2.0, H / 2.0
    else:  # "ndc_isotropic"
        sx = sy = min(H, W) / 2.0
    fx = focal[0] * sx
    fy = focal[1] * sy
    cx = W / 2.0 - principal[0] * sx
    cy = H / 2.0 - principal[1] * sy
    return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], dtype=np.float64)


def _pt3d_pose_to_opencv_w2c(R: np.ndarray, T: np.ndarray) -> np.ndarray:
    """PyTorch3D row-vector world->camera (x_cam = x_world @ R + T, axes
    +x left / +y up / +z forward) -> OpenCV column-vector w2c 3x4."""
    flip = np.diag([-1.0, -1.0, 1.0])
    return np.concatenate([flip @ R.T, (flip @ T)[:, None]], axis=1)


# a category's frame_annotations.jgz covers hundreds of sequences and can
# hold ~100k frame records: parse it once and index it by sequence
_CO3D_ANN_CACHE: dict = {}


def _load_co3d_annotations(ann_path: str) -> dict:
    key = (ann_path, os.path.getmtime(ann_path))
    if key not in _CO3D_ANN_CACHE:
        while len(_CO3D_ANN_CACHE) >= 4:  # bound host memory: a few categories
            _CO3D_ANN_CACHE.pop(next(iter(_CO3D_ANN_CACHE)))
        with gzip.open(ann_path, "rt") as f:
            annotations = json.load(f)
        by_seq: dict = {}
        for a in annotations:
            by_seq.setdefault(a.get("sequence_name"), []).append(a)
        _CO3D_ANN_CACHE[key] = by_seq
    return _CO3D_ANN_CACHE[key]


def load_co3d_sequence(
    seq_dir: str,
    target_size: int = TARGET_SIZE,
    stride: int = 1,
    max_frames: Optional[int] = None,
    max_depth: float = 100.0,
    use_depth: bool = True,
) -> SceneArrays:
    """Read one CO3D sequence directory (<root>/<category>/<sequence>).

    Cameras come from the category's frame_annotations.jgz; every annotated
    frame has camera GT, so camera_indices covers every frame. Depth is
    optional (CO3D's depth PNGs are sparse), masked by the annotation's
    mask when it has one."""
    import PIL.Image

    from omnivggt_tpu_torch.data.image_io import load_16bit_png_depth

    seq_dir = os.path.abspath(seq_dir)
    category_dir = os.path.dirname(seq_dir)
    root = os.path.dirname(category_dir)
    seq_name = os.path.basename(seq_dir)
    ann_path = os.path.join(category_dir, "frame_annotations.jgz")
    by_seq = _load_co3d_annotations(ann_path)

    frames = list(by_seq.get(seq_name, ()))
    if not frames:
        raise ValueError(f"sequence {seq_name!r} not found in {ann_path}")
    frames.sort(key=lambda a: a.get("frame_number", 0))
    frames = frames[::stride]
    if max_frames:
        frames = frames[:max_frames]

    imgs, exs, Ks, depths, masks = [], [], [], [], []
    d_idx: List[int] = []
    c_idx: List[int] = []
    for i, a in enumerate(frames):
        img = PIL.Image.open(os.path.join(root, a["image"]["path"])).convert("RGB")
        H, W = a["image"]["size"]

        vp = a["viewpoint"]
        K = _pt3d_ndc_to_pixel_K(
            np.asarray(vp["focal_length"], np.float64),
            np.asarray(vp["principal_point"], np.float64),
            H, W, vp.get("intrinsics_format", "ndc_isotropic"),
        )
        w2c = _pt3d_pose_to_opencv_w2c(
            np.asarray(vp["R"], np.float64), np.asarray(vp["T"], np.float64)
        )

        depth = None
        dinfo = a.get("depth") if use_depth else None
        if dinfo and dinfo.get("path"):
            dpath = os.path.join(root, dinfo["path"])
            if os.path.exists(dpath):
                depth = load_16bit_png_depth(dpath) * float(dinfo.get("scale_adjustment", 1.0))
                mpath = dinfo.get("mask_path")
                if mpath and os.path.exists(os.path.join(root, mpath)):
                    m = np.asarray(PIL.Image.open(os.path.join(root, mpath))).astype(np.float32)
                    depth = depth * (m > 0.5 * m.max() if m.max() else m > 0)
                depth[~np.isfinite(depth)] = 0.0
                depth[(depth > max_depth) | (depth < 1e-5)] = 0.0

        arr, depth, mask, K_scaled = _preprocess_frame(img, depth, K, target_size)
        imgs.append(arr)
        depths.append(depth)
        masks.append(mask)
        if mask.any():
            d_idx.append(i)
        c_idx.append(i)
        exs.append(w2c.astype(np.float32))
        Ks.append(np.asarray(K_scaled, np.float32))
    return _stack_scene(imgs, exs, Ks, depths, masks, d_idx, c_idx)


def detect_scene_format(scene_dir: str) -> str:
    """"scannet" | "co3d" | "folder" (the reference example layout)."""
    if is_scannet_scene(scene_dir):
        return "scannet"
    if is_co3d_sequence(scene_dir):
        return "co3d"
    return "folder"


def load_scene(
    scene_dir: str,
    target_size: int = TARGET_SIZE,
    stride: int = 1,
    max_frames: Optional[int] = None,
    max_depth: float = 100.0,
    **kwargs,
) -> SceneArrays:
    """The format-dispatching scene reader: every format returns the loader's
    tuple, and stride / max_frames / max_depth apply to every format alike
    (a mixed root must not subsample some formats and not others)."""
    fmt = detect_scene_format(scene_dir)
    if fmt == "scannet":
        return load_scannet_scene(
            scene_dir, target_size=target_size, stride=stride,
            max_frames=max_frames, max_depth=max_depth, **kwargs,
        )
    if fmt == "co3d":
        return load_co3d_sequence(
            scene_dir, target_size=target_size, stride=stride,
            max_frames=max_frames, max_depth=max_depth, **kwargs,
        )
    if kwargs:
        raise TypeError(f"unsupported options for folder scenes: {kwargs}")
    from omnivggt_tpu_torch.data.loader import load_images_and_cameras

    def opt(sub):
        p = os.path.join(scene_dir, sub)
        return p if os.path.isdir(p) else None

    out = load_images_and_cameras(
        os.path.join(scene_dir, "images"),
        camera_folder=opt("cameras"),
        depth_folder=opt("depths"),
        target_size=target_size,
        max_depth=max_depth,
    )
    if stride == 1 and max_frames is None:
        return out
    # the folder loader has no stride: apply the frame limits after the
    # load and remap the GT index lists to the kept positions
    images, ex, K, depths, masks, d_idx, c_idx = out
    keep = list(range(0, images.shape[0], stride))
    if max_frames is not None:
        keep = keep[:max_frames]
    pos = {orig: i for i, orig in enumerate(keep)}
    return (
        images[keep],
        ex[:, keep],
        K[:, keep],
        depths[:, keep],
        masks[:, keep],
        [pos[i] for i in d_idx if i in pos],
        [pos[i] for i in c_idx if i in pos],
    )
