"""Image / depth / camera / flow / video IO, on the host (counterpart of
omnivggt_tpu/data/image_io.py; same outputs).

Sintel-format binary readers (float tag 202021.25), EXR-capable cv2 imread,
long-edge resize + 16px-aligned centre crop, folder/list/video loading with
fps subsampling, dynamic-mask loading, segmentation-mask dilation, and
mask-overlay GIF export.

All outputs are numpy channels-last; `load_images` returns per-frame dicts with
`img` (1, H, W, 3) float32 in [0, 1], `true_shape`, `mask`, `dynamic_mask`.

PIL and OpenCV are imported inside the functions that use them: importing
the module and the Sintel readers need neither.
"""

from __future__ import annotations

import os
from typing import List, Optional, Union

import numpy as np
import torch

TAG_FLOAT = 202021.25  # Sintel binary-format magic


# ---------------------------------------------------------------------------
# Sintel binary formats
# ---------------------------------------------------------------------------


def _check_tag(f, name):
    check = np.fromfile(f, dtype=np.float32, count=1)[0]
    if check != TAG_FLOAT:
        raise ValueError(f"{name}: wrong tag {check} (expected {TAG_FLOAT})")


def depth_read(filename: str) -> np.ndarray:
    """Sintel .dpt depth file -> (H, W) float32."""
    with open(filename, "rb") as f:
        _check_tag(f, "depth_read")
        width = int(np.fromfile(f, dtype=np.int32, count=1)[0])
        height = int(np.fromfile(f, dtype=np.int32, count=1)[0])
        if not (0 < width and 0 < height and 1 < width * height < 100000000):
            raise ValueError(f"depth_read: bad size {width}x{height}")
        return np.fromfile(f, dtype=np.float32, count=-1).reshape(height, width)


def cam_read(filename: str):
    """Sintel .cam file -> (intrinsic (3,3), extrinsic (3,4)) float64."""
    with open(filename, "rb") as f:
        _check_tag(f, "cam_read")
        M = np.fromfile(f, dtype="float64", count=9).reshape(3, 3)
        N = np.fromfile(f, dtype="float64", count=12).reshape(3, 4)
    return M, N


def flow_read(filename: str):
    """Sintel .flo optical flow -> (u, v) float32 arrays."""
    with open(filename, "rb") as f:
        _check_tag(f, "flow_read")
        width = int(np.fromfile(f, dtype=np.int32, count=1)[0])
        height = int(np.fromfile(f, dtype=np.int32, count=1)[0])
        if not (0 < width and 0 < height and 1 < width * height < 100000000):
            raise ValueError(f"flow_read: bad size {width}x{height}")
        tmp = np.fromfile(f, dtype=np.float32, count=-1).reshape(height, width * 2)
    return tmp[:, 0::2], tmp[:, 1::2]


# ---------------------------------------------------------------------------
# cv2-backed IO
# ---------------------------------------------------------------------------


def imread_cv2(path: str, options=None) -> np.ndarray:
    """Read an image (EXR supported via IMREAD_ANYDEPTH) as RGB / raw array."""
    import cv2

    if options is None:
        options = cv2.IMREAD_COLOR
    if path.endswith((".exr", "EXR")):
        options = cv2.IMREAD_ANYDEPTH
    img = cv2.imread(path, options)
    if img is None:
        raise IOError(f"Could not load image={path} with {options=}")
    if img.ndim == 3:
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    return img


def rgb_to_uint8(ftensor, true_shape=None) -> np.ndarray:
    """Float/normalised image (a tensor or an array) -> display uint8 RGB."""
    if isinstance(ftensor, torch.Tensor):
        ftensor = ftensor.detach().cpu()
        if ftensor.dtype == torch.bfloat16:
            ftensor = ftensor.float()
        ftensor = ftensor.numpy()
    arr = np.asarray(ftensor)
    if arr.ndim == 3 and arr.shape[0] == 3:
        arr = arr.transpose(1, 2, 0)
    if true_shape is not None:
        H, W = true_shape
        arr = arr[:H, :W]
    if arr.dtype != np.uint8:
        if arr.min() < 0:  # assume mean/std normalised around 0
            arr = arr / 2 + 0.5
        arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
    return arr


# ---------------------------------------------------------------------------
# Resize / crop (DUSt3R conventions)
# ---------------------------------------------------------------------------


def _resize_pil_image(img, long_edge_size: int, nearest=False):
    import PIL.Image

    S = max(img.size)
    if S > long_edge_size:
        interp = PIL.Image.NEAREST if nearest else PIL.Image.LANCZOS
    else:
        interp = PIL.Image.BICUBIC
    new_size = tuple(int(round(x * long_edge_size / S)) for x in img.size)
    return img.resize(new_size, interp)


def crop_img(img, size: int, square_ok=False, nearest=False, crop=True):
    """Resize the long edge to `size` (short edge for 224) then centre-crop to
    a 16px-aligned box."""
    import PIL.Image

    W1, H1 = img.size
    if size == 224:
        img = _resize_pil_image(img, round(size * max(W1 / H1, H1 / W1)), nearest=nearest)
        W, H = img.size
        cx, cy = W // 2, H // 2
        half = min(cx, cy)
        return img.crop((cx - half, cy - half, cx + half, cy + half))
    img = _resize_pil_image(img, size, nearest=nearest)
    W, H = img.size
    cx, cy = W // 2, H // 2
    halfw, halfh = ((2 * cx) // 16) * 8, ((2 * cy) // 16) * 8
    if not square_ok and W == H:
        halfh = 3 * halfw // 4
    if crop:
        return img.crop((cx - halfw, cy - halfh, cx + halfw, cy + halfh))
    return img.resize((2 * halfw, 2 * halfh), PIL.Image.LANCZOS)


# ---------------------------------------------------------------------------
# Folder / list / video loading
# ---------------------------------------------------------------------------

_IMG_EXT = (".jpg", ".jpeg", ".png")
_VID_EXT = (".mp4", ".avi", ".mov")


def _frame_dict(img, idx: int, instance: str) -> dict:
    arr = np.asarray(img, np.float32)[None] / 255.0  # (1, H, W, 3)
    return {
        "img": arr,
        "true_shape": np.int32([img.size[::-1]]),
        "idx": idx,
        "instance": instance,
        "mask": ~(arr.sum(-1) <= 0.01),
    }


def load_images(
    folder_or_list: Union[str, List[str]],
    size: int,
    square_ok: bool = False,
    verbose: bool = True,
    dynamic_mask_root: Optional[str] = None,
    crop: bool = True,
    fps: float = 0,
    num_frames: Optional[int] = 110,
) -> List[dict]:
    """Load every image/video in a folder or path list, resized/cropped to
    `size`; videos are subsampled to `fps` and capped at `num_frames`."""
    import PIL.Image
    from PIL.ImageOps import exif_transpose

    if isinstance(folder_or_list, str):
        if os.path.isdir(folder_or_list):
            root, content = folder_or_list, sorted(os.listdir(folder_or_list))
        else:
            root, content = "", [folder_or_list]
    elif isinstance(folder_or_list, list):
        root, content = "", folder_or_list
    else:
        raise ValueError(f"Bad input {folder_or_list!r}")

    content = sorted(content, key=lambda x: x.split("/")[-1])
    frames: List[dict] = []
    for path in content:
        full_path = os.path.join(root, path)
        lower = path.lower()
        if lower.endswith(_IMG_EXT):
            img = exif_transpose(PIL.Image.open(full_path)).convert("RGB")
            img = crop_img(img, size, square_ok=square_ok, crop=crop)
            d = _frame_dict(img, len(frames), full_path)
            d["dynamic_mask"] = _load_dynamic_mask(
                full_path, dynamic_mask_root, size, square_ok, d["mask"]
            )
            frames.append(d)
            if verbose:
                print(f" - Adding {path} -> {img.size[0]}x{img.size[1]}")
        elif lower.endswith(_VID_EXT):
            frames.extend(
                _load_video_frames(
                    full_path, size, square_ok, crop, fps, num_frames,
                    start_idx=len(frames), verbose=verbose,
                )
            )
    if not frames:
        raise AssertionError("No images found at " + (root or str(folder_or_list)))
    return frames


def _load_dynamic_mask(full_path, dynamic_mask_root, size, square_ok, static_mask):
    import PIL.Image

    if dynamic_mask_root is not None:
        mask_path = os.path.join(dynamic_mask_root, os.path.basename(full_path))
    else:  # Sintel dataset layout
        mask_path = full_path.replace("final", "dynamic_label_perfect").replace(
            "clean", "dynamic_label_perfect"
        )
    if os.path.exists(mask_path):
        m = PIL.Image.open(mask_path).convert("L")
        m = crop_img(m, size, square_ok=square_ok)
        dyn = (np.asarray(m, np.float32)[None] / 255.0) > 0.99
        if dyn.sum() < 0.8 * dyn.size:  # static if >80% flagged dynamic
            return dyn
    return np.zeros_like(static_mask)


def _load_video_frames(path, size, square_ok, crop, fps, num_frames, start_idx, verbose):
    import cv2
    import PIL.Image

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        print(f"Error opening video file {path}")
        return []
    video_fps = cap.get(cv2.CAP_PROP_FPS)
    total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    if video_fps == 0:
        cap.release()
        return []
    interval = max(1, int(round(video_fps / fps))) if fps > 0 else 1
    indices = list(range(0, total, interval))
    if num_frames is not None:
        indices = indices[:num_frames]
    if verbose:
        print(f" - video fps {video_fps}, interval {interval}, frames {len(indices)}")

    out = []
    for fi in indices:
        cap.set(cv2.CAP_PROP_POS_FRAMES, fi)
        ret, frame = cap.read()
        if not ret:
            break
        img = PIL.Image.fromarray(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
        img = crop_img(img, size, square_ok=square_ok, crop=crop)
        d = _frame_dict(img, start_idx + len(out), f"{path}_frame_{fi}")
        d["dynamic_mask"] = np.zeros_like(d["mask"])
        out.append(d)
    cap.release()
    return out


# ---------------------------------------------------------------------------
# CO3D-style depth IO + filtering
# ---------------------------------------------------------------------------


def load_16bit_png_depth(depth_png: str) -> np.ndarray:
    """16-bit PNG whose bits are a packed float16 depth map -> (H, W) float32
    (the CO3D convention)."""
    import PIL.Image

    with PIL.Image.open(depth_png) as depth_pil:
        depth = (
            np.frombuffer(np.array(depth_pil, dtype=np.uint16), dtype=np.float16)
            .astype(np.float32)
            .reshape((depth_pil.size[1], depth_pil.size[0]))
        )
    return depth


def read_depth(path: str, scale_adjustment: float = 1.0) -> np.ndarray:
    """Depth from .exr (first channel; >1e9 zeroed) or CO3D 16-bit .png, scaled
    and sanitised (non-finite -> 0)."""
    if path.lower().endswith(".exr"):
        import cv2

        d = cv2.imread(path, cv2.IMREAD_ANYCOLOR | cv2.IMREAD_ANYDEPTH)
        if d is None:
            raise IOError(f"could not read {path}")
        if d.ndim == 3:
            d = d[..., 0]
        d = d.astype(np.float32)
        d[d > 1e9] = 0.0
    elif path.lower().endswith(".png"):
        d = load_16bit_png_depth(path)
    else:
        raise ValueError(f'unsupported depth file name "{path}"')
    d = d * scale_adjustment
    d[~np.isfinite(d)] = 0.0
    return d


def threshold_depth_map(
    depth_map: Optional[np.ndarray],
    max_percentile: float = 99,
    min_percentile: float = 1,
    max_depth: float = -1,
) -> Optional[np.ndarray]:
    """Zero out depth outliers: optional absolute clamp, then percentile-based
    upper/lower cutoffs (nan-aware)."""
    if depth_map is None:
        return None
    depth_map = np.array(depth_map, copy=True)
    if max_depth > 0:
        depth_map[depth_map > max_depth] = 0.0
    hi = np.nanpercentile(depth_map, max_percentile) if max_percentile > 0 else None
    lo = np.nanpercentile(depth_map, min_percentile) if min_percentile > 0 else None
    if hi is not None and hi > 0:
        depth_map[depth_map > hi] = 0.0
    if lo is not None and lo > 0:
        depth_map[depth_map < lo] = 0.0
    return depth_map


# ---------------------------------------------------------------------------
# Mask post-processing
# ---------------------------------------------------------------------------


def enlarge_seg_masks(folder: str, kernel_size: int = 5, prefix: str = "dynamic_mask"):
    """Dilate every `{prefix}_*.png` mask in `folder`, writing
    `enlarged_{prefix}_*.png`."""
    import glob

    import cv2

    kernel = np.ones((kernel_size, kernel_size), np.uint8)
    for p in sorted(glob.glob(os.path.join(folder, f"{prefix}_*.png"))):
        mask = cv2.imread(p, cv2.IMREAD_GRAYSCALE)
        enlarged = cv2.dilate(mask, kernel, iterations=1)
        cv2.imwrite(p.replace(prefix, f"enlarged_{prefix}"), enlarged)


def save_overlay_gif(
    folder: str,
    img_format: str = "frame_*.png",
    mask_format: str = "dynamic_mask_*.png",
    output_path: str = "_overlaied.gif",
    alpha: float = 0.45,
):
    """Blend masks over frames and write an animated GIF."""
    import glob

    import PIL.Image

    img_paths = sorted(glob.glob(os.path.join(folder, img_format)))
    mask_paths = sorted(glob.glob(os.path.join(folder, mask_format)))
    frames = []
    color = np.array([30, 144, 255], np.float32)
    for ip, mp in zip(img_paths, mask_paths):
        img = np.asarray(PIL.Image.open(ip).convert("RGB"), np.float32)
        mask = np.asarray(PIL.Image.open(mp).convert("L"), np.float32)[..., None] / 255.0
        blend = img * (1 - alpha * mask) + color * (alpha * mask)
        frames.append(PIL.Image.fromarray(blend.astype(np.uint8)))
    if frames:
        frames[0].save(
            os.path.join(folder, output_path),
            save_all=True, append_images=frames[1:], duration=100, loop=0,
        )
