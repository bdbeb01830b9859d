"""The port's image I/O, cropping and artifact-saving helpers against the JAX
package's on seeded arrays and files: every function of data/cropping.py,
data/image_io.py and utils/io.py, and geometry's intrinsics conventions.
Exactly equal (arrays, images and the bytes of the files written)."""

import os
from pathlib import Path

import cv2
import numpy as np
import PIL.Image
import pytest
import torch

from omnivggt_tpu.data import cropping as JCR
from omnivggt_tpu.data import image_io as JIO
from omnivggt_tpu.utils import geometry as JG
from omnivggt_tpu.utils import io as JUIO
from omnivggt_tpu_torch.data import cropping as TCR
from omnivggt_tpu_torch.data import image_io as TIO
from omnivggt_tpu_torch.utils import geometry as TG
from omnivggt_tpu_torch.utils import io as TUIO


def _assert_same(got, want):
    """Equal outputs: PIL images by size and pixels, arrays by dtype and
    values, tuples element by element."""
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
    elif isinstance(want, PIL.Image.Image):
        assert isinstance(got, PIL.Image.Image) and got.size == want.size
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    elif want is None:
        assert got is None
    else:
        assert np.asarray(got).dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(got, want)


def _inputs(seed=1, hw=(60, 80)):
    rng = np.random.default_rng(seed)
    img = (rng.uniform(size=(*hw, 3)) * 255).astype(np.uint8)
    depth = rng.uniform(0.1, 10, size=hw).astype(np.float32)
    K = np.array([[70.0, 0, 41.0], [0, 72.0, 31.0], [0, 0, 1]], np.float32)
    return img, depth, K


def test_intrinsics_conventions():
    K = np.random.default_rng(0).normal(size=(4, 3, 3))
    for name in ("colmap_to_opencv_intrinsics", "opencv_to_colmap_intrinsics"):
        _assert_same(getattr(TG, name)(K), getattr(JG, name)(K))
        _assert_same(getattr(TG, name)(K[0]), getattr(JG, name)(K[0]))


CROPS = {
    "camera_matrix_of_crop": lambda m, img, d, K: m.camera_matrix_of_crop(
        K, (80, 60), (64, 48), scaling=0.9),
    "camera_matrix_of_crop offset": lambda m, img, d, K: m.camera_matrix_of_crop(
        K, (80, 60), (40, 30), offset=(3, 4)),
    "rescale shrink": lambda m, img, d, K: m.rescale_image_depthmap(img, d, K, (40, 30)),
    "rescale grow": lambda m, img, d, K: m.rescale_image_depthmap(
        PIL.Image.fromarray(img), d, K, (120, 100)),
    "rescale not forced": lambda m, img, d, K: m.rescale_image_depthmap(
        img, None, K, (120, 100), force=False),
    "center crop": lambda m, img, d, K: m.center_crop_image_depthmap(img, d, K, 0.7),
    "center crop no depth": lambda m, img, d, K: m.center_crop_image_depthmap(img, None, K, 1.0),
    "crop bbox": lambda m, img, d, K: m.crop_image_depthmap(img, d, K, (5, 7, 50, 40)),
    "bbox from intrinsics": lambda m, img, d, K: m.bbox_from_intrinsics_in_out(
        K, K - np.array([[0, 0, 4.4], [0, 0, 2.6], [0, 0, 0]], np.float32), (32, 24)),
    "resize wide": lambda m, img, d, K: m.resize_image_depth_and_intrinsic(img, d, K, 56, 14),
    "resize tall, cropped": lambda m, img, d, K: m.resize_image_depth_and_intrinsic(
        np.ascontiguousarray(img.transpose(1, 0, 2)), np.ascontiguousarray(d.T), K, 42, 14),
    "resize image only": lambda m, img, d, K: m.resize_image_depth_and_intrinsic(
        img, None, None, 28),
    "crop by pp": lambda m, img, d, K: m.crop_image_depth_and_intrinsic_by_pp(img, d, K, (40, 30)),
    "crop by pp clamped": lambda m, img, d, K: m.crop_image_depth_and_intrinsic_by_pp(
        img, d, np.array([[70.0, 0, 75.0], [0, 72, 2.0], [0, 0, 1]]), (40, 30)),
}


@pytest.mark.parametrize("case", list(CROPS))
def test_cropping_matches_jax(case):
    img, depth, K = _inputs()
    got = CROPS[case](TCR, img, depth.copy(), K.copy())
    want = CROPS[case](JCR, img, depth.copy(), K.copy())
    _assert_same(got, want)


def _write_sintel(root: Path):
    rng = np.random.default_rng(0)
    depth = rng.uniform(0.1, 50, size=(12, 17)).astype(np.float32)
    with open(root / "d.dpt", "wb") as f:
        np.float32(TIO.TAG_FLOAT).tofile(f)
        np.int32(17).tofile(f)
        np.int32(12).tofile(f)
        depth.tofile(f)
    M = np.array([[100.0, 0, 8], [0, 110, 6], [0, 0, 1]])
    N = np.concatenate([np.eye(3), rng.normal(size=(3, 1))], axis=1)
    with open(root / "c.cam", "wb") as f:
        np.float32(TIO.TAG_FLOAT).tofile(f)
        M.tofile(f)
        N.tofile(f)
    uv = rng.normal(size=(12, 34)).astype(np.float32)
    with open(root / "f.flo", "wb") as f:
        np.float32(TIO.TAG_FLOAT).tofile(f)
        np.int32(17).tofile(f)
        np.int32(12).tofile(f)
        uv.tofile(f)
    with open(root / "bad.dpt", "wb") as f:
        np.float32(1.0).tofile(f)
    return depth, M, N, uv


def test_sintel_readers_roundtrip_and_match_jax(tmp_path):
    depth, M, N, uv = _write_sintel(tmp_path)
    _assert_same(TIO.depth_read(str(tmp_path / "d.dpt")), depth)
    _assert_same(TIO.cam_read(str(tmp_path / "c.cam")), (M, N))
    _assert_same(TIO.flow_read(str(tmp_path / "f.flo")), (uv[:, 0::2], uv[:, 1::2]))
    for fn, name in (("depth_read", "d.dpt"), ("cam_read", "c.cam"), ("flow_read", "f.flo")):
        _assert_same(getattr(TIO, fn)(str(tmp_path / name)), getattr(JIO, fn)(str(tmp_path / name)))
        with pytest.raises(ValueError, match="wrong tag"):
            getattr(TIO, fn)(str(tmp_path / "bad.dpt"))


def test_imread_and_rgb_to_uint8(tmp_path):
    img, _, _ = _inputs(2, (9, 11))
    cv2.imwrite(str(tmp_path / "a.png"), img)
    for opts in (None, cv2.IMREAD_GRAYSCALE):
        _assert_same(TIO.imread_cv2(str(tmp_path / "a.png"), opts),
                     JIO.imread_cv2(str(tmp_path / "a.png"), opts))
    with pytest.raises(IOError):
        TIO.imread_cv2(str(tmp_path / "missing.png"))
    x = np.random.default_rng(3).uniform(-1, 1, size=(3, 9, 11)).astype(np.float32)
    for arr, shape in ((x, None), (x, (5, 7)), (np.abs(x).transpose(1, 2, 0), None), (img, (4, 4))):
        _assert_same(TIO.rgb_to_uint8(arr, shape), JIO.rgb_to_uint8(arr, shape))
    # a tensor, as the JAX function takes a jnp array
    _assert_same(TIO.rgb_to_uint8(torch.from_numpy(x)), JIO.rgb_to_uint8(x))
    _assert_same(TIO.rgb_to_uint8(torch.from_numpy(x).to(torch.bfloat16)),
                 JIO.rgb_to_uint8(torch.from_numpy(x).to(torch.bfloat16).float().numpy()))


@pytest.mark.parametrize("size,square_ok,crop,nearest,hw", [
    (512, False, True, False, (300, 400)), (224, False, True, False, (300, 400)),
    (64, False, True, False, (50, 50)), (64, True, True, False, (50, 50)),
    (48, False, False, False, (60, 90)), (48, False, True, True, (90, 60)),
])
def test_crop_img_matches_jax(size, square_ok, crop, nearest, hw):
    img = PIL.Image.fromarray(_inputs(4, hw)[0])
    _assert_same(TIO.crop_img(img.copy(), size, square_ok, nearest, crop),
                 JIO.crop_img(img.copy(), size, square_ok, nearest, crop))


def _assert_frames_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for key in w:
            if isinstance(w[key], np.ndarray):
                _assert_same(g[key], w[key])
            else:
                assert g[key] == w[key]


def test_load_images_matches_jax(tmp_path):
    """A seeded folder of stills (png, jpg; one RGBA), a dynamic-mask root, a
    video (MJPG .avi) subsampled by fps and capped, and the path-list input."""
    rng = np.random.default_rng(5)
    folder = tmp_path / "frames"
    masks = tmp_path / "masks"
    folder.mkdir()
    masks.mkdir()
    for i, (h, w) in enumerate(((60, 80), (64, 48), (50, 70))):
        ext = "jpg" if i == 1 else "png"
        PIL.Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8)).save(folder / f"{i}.{ext}")
    PIL.Image.fromarray(rng.integers(0, 255, (40, 40, 4), np.uint8), "RGBA").save(folder / "3.png")
    dyn = np.zeros((60, 80), np.uint8)
    dyn[10:30, 20:50] = 255
    PIL.Image.fromarray(dyn).save(masks / "0.png")
    PIL.Image.fromarray(np.full((50, 70), 255, np.uint8)).save(masks / "2.png")  # > 80%: static
    writer = cv2.VideoWriter(str(folder / "v.avi"), cv2.VideoWriter_fourcc(*"MJPG"), 10.0, (40, 30))
    for i in range(7):
        writer.write(np.full((30, 40, 3), 30 * i, np.uint8))
    writer.release()
    (folder / "notes.txt").write_text("not an image")

    for kw in (dict(size=64, dynamic_mask_root=str(masks)),
               dict(size=224, fps=5, num_frames=2), dict(size=48, crop=False, num_frames=None)):
        got = TIO.load_images(str(folder), verbose=False, **kw)
        _assert_frames_equal(got, JIO.load_images(str(folder), verbose=False, **kw))
    assert got[-1]["instance"].endswith("v.avi_frame_6")
    paths = [str(folder / "2.png"), str(folder / "0.png")]
    _assert_frames_equal(TIO.load_images(paths, 64, verbose=False),
                         JIO.load_images(paths, 64, verbose=False))
    _assert_frames_equal(TIO.load_images(paths[0], 64, verbose=False),
                         JIO.load_images(paths[0], 64, verbose=False))
    with pytest.raises(AssertionError, match="No images found"):
        TIO.load_images(str(masks.parent / "empty_dir_does_not_exist"), 64, verbose=False)
    with pytest.raises(ValueError):
        TIO.load_images(3, 64)


def test_depth_io_and_thresholds(tmp_path):
    rng = np.random.default_rng(6)
    depth16 = rng.uniform(0.5, 20, (9, 13)).astype(np.float16)
    depth16[0, 0] = np.inf
    PIL.Image.fromarray(depth16.view(np.uint16)).save(tmp_path / "d.png")
    _assert_same(TIO.load_16bit_png_depth(str(tmp_path / "d.png")),
                 JIO.load_16bit_png_depth(str(tmp_path / "d.png")))
    _assert_same(TIO.read_depth(str(tmp_path / "d.png"), 0.5),
                 JIO.read_depth(str(tmp_path / "d.png"), 0.5))
    assert TIO.read_depth(str(tmp_path / "d.png"))[0, 0] == 0.0
    with pytest.raises(ValueError, match="unsupported"):
        TIO.read_depth(str(tmp_path / "d.jpg"))
    d = rng.uniform(0, 10, (20, 20)).astype(np.float32)
    d[3, 3] = np.nan
    for kw in ({}, dict(max_depth=8.0), dict(max_percentile=0, min_percentile=5),
               dict(max_percentile=90, min_percentile=0)):
        _assert_same(TIO.threshold_depth_map(d, **kw), JIO.threshold_depth_map(d, **kw))
    assert TIO.threshold_depth_map(None) is None


def test_mask_files_match_jax(tmp_path):
    rng = np.random.default_rng(7)
    dirs = {name: tmp_path / name for name in ("port", "jax")}
    for d in dirs.values():
        d.mkdir()
        for i in range(2):
            frame = rng.integers(0, 255, (12, 16, 3), np.uint8)
            mask = (rng.uniform(size=(12, 16)) > 0.8).astype(np.uint8) * 255
            PIL.Image.fromarray(frame).save(d / f"frame_{i}.png")
            PIL.Image.fromarray(mask).save(d / f"dynamic_mask_{i}.png")
        rng = np.random.default_rng(7)  # the same files in both folders
    TIO.enlarge_seg_masks(str(dirs["port"]))
    JIO.enlarge_seg_masks(str(dirs["jax"]))
    TIO.save_overlay_gif(str(dirs["port"]))
    JIO.save_overlay_gif(str(dirs["jax"]))
    names = sorted(os.listdir(dirs["port"]))
    assert names == sorted(os.listdir(dirs["jax"]))
    assert "_overlaied.gif" in names and "enlarged_dynamic_mask_1.png" in names
    for name in names:
        assert (dirs["port"] / name).read_bytes() == (dirs["jax"] / name).read_bytes(), name


def test_save_helpers_match_jax(tmp_path):
    """Every artifact helper of utils/io.py writes the JAX package's bytes."""
    rng = np.random.default_rng(8)
    q = rng.normal(size=(4, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    poses = np.tile(np.eye(4), (4, 1, 1))
    x, y, z, w = q.T
    poses[:, :3, :3] = np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
        2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
        2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1).reshape(4, 3, 3)
    poses[:, :3, 3] = rng.normal(size=(4, 3))
    imgs = rng.uniform(size=(2, 8, 10, 3)).astype(np.float32)
    calls = [
        ("save_tum_poses", poses, "traj.txt"),
        ("save_focals", rng.uniform(100, 200, 4), "focals.txt"),
        ("save_intrinsics", rng.normal(size=(4, 3, 3)), "K.txt"),
        ("save_conf_maps", rng.uniform(size=(2, 5, 6)), "."),
        ("save_rgb_imgs", imgs, "."),
        ("save_dynamic_masks", rng.uniform(size=(2, 8, 10)) > 0.5, "."),
        ("save_depth_maps", rng.uniform(size=(2, 8, 10, 1)), "."),
    ]
    for side, mod in (("port", TUIO), ("jax", JUIO)):
        root = tmp_path / side
        for fn, arg, target in calls:
            (root / fn).mkdir(parents=True)
            out = getattr(mod, fn)(arg, str(root / fn / target))
            assert out is arg
        mod.save_images_from_tensor(imgs[None], str(root / "tensor"), prefix="f")
    for path in sorted((tmp_path / "jax").rglob("*")):
        if path.is_file():
            mine = tmp_path / "port" / path.relative_to(tmp_path / "jax")
            assert mine.read_bytes() == path.read_bytes(), path.name
