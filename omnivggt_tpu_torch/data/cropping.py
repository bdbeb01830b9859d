"""Joint image + depthmap + intrinsics rescaling and cropping, on the host
(counterpart of omnivggt_tpu/data/cropping.py; same outputs).

Rescale so the output covers a target resolution, centre-crop by a scale
fraction, principal-point-centred cropping, and the colmap-convention
intrinsic adjustment that goes with each geometric op.

PIL and OpenCV are imported inside the functions that use them, so importing
this module needs neither.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from omnivggt_tpu_torch.utils.geometry import (
    colmap_to_opencv_intrinsics,
    opencv_to_colmap_intrinsics,
)


def _as_pil(image):
    import PIL.Image

    if not isinstance(image, PIL.Image.Image):
        image = PIL.Image.fromarray(np.asarray(image))
    return image


def camera_matrix_of_crop(
    input_camera_matrix: np.ndarray,
    input_resolution,
    output_resolution,
    scaling: float = 1.0,
    offset_factor: float = 0.5,
    offset=None,
) -> np.ndarray:
    """Intrinsics for a scaled + cropped view (colmap pixel-centre convention
    during the scale)."""
    margins = np.asarray(input_resolution) * scaling - np.asarray(output_resolution)
    assert np.all(margins >= 0.0), "crop larger than the scaled image"
    if offset is None:
        offset = offset_factor * margins
    K = opencv_to_colmap_intrinsics(np.asarray(input_camera_matrix, np.float64).copy())
    K[:2, :] *= scaling
    K[:2, 2] -= offset
    return colmap_to_opencv_intrinsics(K)


def rescale_image_depthmap(
    image,
    depthmap: Optional[np.ndarray],
    camera_intrinsics: np.ndarray,
    output_resolution,
    force: bool = True,
):
    """Jointly rescale (image, depth, K) so the result covers
    output_resolution (W, H). Lanczos when shrinking, bicubic when growing,
    nearest for depth."""
    import cv2
    import PIL.Image

    image = _as_pil(image)
    input_resolution = np.array(image.size)  # (W, H)
    output_resolution = np.array(output_resolution)
    if depthmap is not None:
        assert tuple(depthmap.shape[:2]) == image.size[::-1]

    scale_final = float(max(output_resolution / input_resolution)) + 1e-8
    if scale_final >= 1 and not force:
        return image, depthmap, camera_intrinsics
    out_res = np.floor(input_resolution * scale_final).astype(int)

    resample = PIL.Image.LANCZOS if scale_final < 1 else PIL.Image.BICUBIC
    image = image.resize(tuple(out_res), resample)
    if depthmap is not None:
        depthmap = cv2.resize(depthmap, tuple(out_res), interpolation=cv2.INTER_NEAREST)
    K = camera_matrix_of_crop(camera_intrinsics, input_resolution, out_res, scaling=scale_final)
    return image, depthmap, K


def center_crop_image_depthmap(
    image,
    depthmap: Optional[np.ndarray],
    camera_intrinsics: np.ndarray,
    crop_scale: float,
):
    """Centre-crop to a `crop_scale` fraction; shifts the principal point."""
    assert 0 < crop_scale <= 1
    image = _as_pil(image)
    input_resolution = np.array(image.size)
    if depthmap is not None:
        assert tuple(depthmap.shape[:2]) == image.size[::-1]

    out_res = np.floor(input_resolution * crop_scale).astype(int)
    margins = input_resolution - out_res
    l, t = (margins / 2).astype(int)
    r, b = l + out_res[0], t + out_res[1]

    image = image.crop((l, t, r, b))
    if depthmap is not None:
        depthmap = depthmap[t:b, l:r]
    K = np.asarray(camera_intrinsics).copy()
    K[0, 2] -= l
    K[1, 2] -= t
    return image, depthmap, K


def crop_image_depthmap(image, depthmap, camera_intrinsics, crop_bbox):
    """Crop by an explicit (l, t, r, b) box; principal point shifts by (l, t)."""
    image = _as_pil(image)
    l, t, r, b = crop_bbox
    image = image.crop((l, t, r, b))
    if depthmap is not None:
        depthmap = depthmap[t:b, l:r]
    K = np.asarray(camera_intrinsics).copy()
    K[0, 2] -= l
    K[1, 2] -= t
    return image, depthmap, K


def bbox_from_intrinsics_in_out(
    input_camera_matrix, output_camera_matrix, output_resolution
) -> Tuple[int, int, int, int]:
    out_w, out_h = output_resolution
    l = int(round(input_camera_matrix[0, 2] - output_camera_matrix[0, 2]))
    t = int(round(input_camera_matrix[1, 2] - output_camera_matrix[1, 2]))
    return (l, t, l + out_w, t + out_h)


def resize_image_depth_and_intrinsic(
    image,
    depthmap: Optional[np.ndarray],
    intrinsics: Optional[np.ndarray],
    target_size: int = 518,
    patch: int = 14,
):
    """The folder loader's geometry: width -> target_size, height rounded to
    a multiple of `patch` and centre-cropped to <= target_size; intrinsics
    (when given) rescaled and the principal point shifted by the crop."""
    import PIL.Image

    image = _as_pil(image)
    W, H = image.size
    new_w = target_size
    new_h = round(H * (new_w / W) / patch) * patch
    sx, sy = new_w / W, new_h / H
    image = image.resize((new_w, new_h), PIL.Image.BICUBIC)
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


def crop_image_depth_and_intrinsic_by_pp(
    image,
    depthmap: Optional[np.ndarray],
    intrinsics: np.ndarray,
    output_resolution,
):
    """Crop a (W_out, H_out) window centred on the principal point, clamped to
    the image bounds; shifts the principal point accordingly."""
    image = _as_pil(image)
    W, H = image.size
    out_w, out_h = output_resolution
    cx, cy = float(intrinsics[0, 2]), float(intrinsics[1, 2])
    l = int(np.clip(round(cx - out_w / 2), 0, max(W - out_w, 0)))
    t = int(np.clip(round(cy - out_h / 2), 0, max(H - out_h, 0)))
    return crop_image_depthmap(image, depthmap, intrinsics, (l, t, l + out_w, t + out_h))
