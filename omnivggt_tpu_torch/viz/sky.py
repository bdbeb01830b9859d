"""Sky segmentation (counterpart of omnivggt_tpu/viz/sky.py; the same masks).

The default is an HSV heuristic: a pixel is sky if it is bright and either
low-saturation (white/overcast sky) or blue-hued, weighted toward the upper
image region. If an ONNX runtime and a model file are both already on disk
(`skyseg.onnx`, or the path in OMNIVGGT_SKYSEG_ONNX), the u2net-style ONNX
path is used instead; nothing is fetched.

Masks are cached as PNGs per image folder. Returned masks are 255 = non-sky,
0 = sky. OpenCV is imported inside the functions, so the module imports where
OpenCV is not installed; the functions then raise ImportError.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np


def _hsv_sky_mask(img_rgb: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 RGB -> (H, W) uint8 mask, 255 = non-sky."""
    import cv2

    hsv = cv2.cvtColor(img_rgb, cv2.COLOR_RGB2HSV)
    h, s, v = hsv[..., 0].astype(np.float32), hsv[..., 1] / 255.0, hsv[..., 2] / 255.0

    bright = v > 0.55
    washed = s < 0.25  # white / overcast sky
    blue = (h > 90) & (h < 135) & (s > 0.15)  # OpenCV hue in [0,180)
    skyish = bright & (washed | blue)

    # weight toward the upper part of the frame: sky rarely starts at the bottom
    H = img_rgb.shape[0]
    row_frac = np.arange(H, dtype=np.float32)[:, None] / max(H - 1, 1)
    skyish &= row_frac < 0.75

    # clean up with a small morphological opening
    mask = skyish.astype(np.uint8) * 255
    kernel = np.ones((5, 5), np.uint8)
    mask = cv2.morphologyEx(mask, cv2.MORPH_OPEN, kernel)
    mask = cv2.morphologyEx(mask, cv2.MORPH_CLOSE, kernel)
    return 255 - mask  # non-sky = 255


def _onnx_sky_mask(image_path: str, session) -> Optional[np.ndarray]:
    """The u2net-style ONNX path: 320x320 ImageNet-normalised input, the
    output min-max rescaled, < 32 -> non-sky."""
    import cv2

    image = cv2.imread(image_path)
    if image is None:
        return None
    x = cv2.resize(image, (320, 320))
    x = cv2.cvtColor(x, cv2.COLOR_BGR2RGB).astype(np.float32)
    x = (x / 255 - [0.485, 0.456, 0.406]) / [0.229, 0.224, 0.225]
    x = x.transpose(2, 0, 1)[None].astype(np.float32)
    out = session.run([session.get_outputs()[0].name], {session.get_inputs()[0].name: x})
    out = np.asarray(out).squeeze()
    out = (out - out.min()) / max(out.max() - out.min(), 1e-8) * 255
    out = cv2.resize(out.astype(np.uint8), (image.shape[1], image.shape[0]))
    mask = np.zeros_like(out)
    mask[out < 32] = 255
    return mask


def _get_onnx_session():
    """ONNX session when both onnxruntime and the model file exist; the
    model path defaults to ./skyseg.onnx and can be overridden with
    OMNIVGGT_SKYSEG_ONNX."""
    path = os.environ.get("OMNIVGGT_SKYSEG_ONNX", "skyseg.onnx")
    try:
        import onnxruntime

        if os.path.exists(path):
            return onnxruntime.InferenceSession(path)
    except ImportError:
        pass
    return None


def sky_masks_for_folder(
    image_folder: str, target_hw: Tuple[int, int],
    cache_dir: Optional[str] = None, limit: Optional[int] = None,
) -> np.ndarray:
    """(S, H, W) float array of masks (255 = non-sky) for the sorted images in
    `image_folder`, resized to target_hw, cached as PNGs under
    `{cache_dir}/sky_masks/`. `limit` masks only the first S images: the
    folder can hold more stills than the predictions cover."""
    import cv2

    H, W = target_hw
    names = sorted(
        n for n in os.listdir(image_folder)
        if n.lower().endswith((".png", ".jpg", ".jpeg"))
    )
    if limit is not None:
        names = names[:limit]
    session = _get_onnx_session()
    masks = []
    for name in names:
        cached = None
        cache_path = None
        if cache_dir is not None:
            cache_path = os.path.join(cache_dir, "sky_masks", name)
            if os.path.exists(cache_path):
                cached = cv2.imread(cache_path, cv2.IMREAD_GRAYSCALE)
        if cached is None:
            path = os.path.join(image_folder, name)
            if session is not None:
                cached = _onnx_sky_mask(path, session)
            if cached is None:
                img = cv2.imread(path)
                img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
                cached = _hsv_sky_mask(img)
            if cache_path is not None:
                os.makedirs(os.path.dirname(cache_path), exist_ok=True)
                cv2.imwrite(cache_path, cached)
        if cached.shape != (H, W):
            cached = cv2.resize(cached, (W, H))
        masks.append(cached)
    return np.asarray(masks, np.float32)
