"""The port's dataset format readers (omnivggt_tpu_torch/data/formats.py)
and SceneDataset over them, against the JAX package's.

Both packages read the same fixture files, written by tests/test_formats.py's
writers: ScanNet (an invalid pose, depth at half the colour resolution), CO3D
in both intrinsics formats (also with a scale_adjustment and a mask), and the
example folder layout. Every output of load_scene is compared: arrays within
1e-6, index lists equal.
"""

import gzip
import json
import os
import shutil

import numpy as np
import pytest
from PIL import Image

from omnivggt_tpu.data import augmentation as JA
from omnivggt_tpu.data import dataset as JD
from omnivggt_tpu.data import formats as JF
from omnivggt_tpu_torch.data import augmentation as TA
from omnivggt_tpu_torch.data import dataset as TD
from omnivggt_tpu_torch.data import formats as TF
from tests.test_formats import _write_co3d, _write_scannet
from tests.test_torch_train import _write_scene

TARGET = 28


def _assert_scene_equal(got, want):
    assert len(got) == len(want) == 7
    for i, (a, b) in enumerate(zip(got[:5], want[:5])):
        assert a.shape == b.shape and a.dtype == b.dtype, i
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6, err_msg=str(i))
    assert list(got[5]) == list(want[5]) and list(got[6]) == list(want[6])


def _edit_co3d(seq, scale_adjustment):
    """Give every frame of the fixture's annotations a scale_adjustment and
    a mask PNG (the left half masked out)."""
    cat = os.path.dirname(seq)
    root = os.path.dirname(cat)
    ann = os.path.join(cat, "frame_annotations.jgz")
    with gzip.open(ann, "rt") as f:
        frames = json.load(f)
    for a in frames:
        H, W = a["image"]["size"]
        m = np.full((H, W), 255, np.uint8)
        m[:, : W // 2] = 0
        mpath = a["depth"]["path"].replace("depths", "masks")
        os.makedirs(os.path.dirname(os.path.join(root, mpath)), exist_ok=True)
        Image.fromarray(m).save(os.path.join(root, mpath))
        a["depth"].update(scale_adjustment=scale_adjustment, mask_path=mpath)
    with gzip.open(ann, "wt") as f:
        json.dump(frames, f)


def _scene(tmp_path, kind):
    root = str(tmp_path)
    if kind == "scannet":
        return _write_scannet(root)[0]
    if kind == "folder":
        _write_scene(tmp_path / "folder", seed=2)
        return str(tmp_path / "folder")
    fmt = "ndc_norm_image_bounds" if kind.endswith("bounds") else "ndc_isotropic"
    seq = _write_co3d(root, fmt)[0]
    if kind.startswith("co3d_masked"):
        _edit_co3d(seq, 2.5)
    return seq


KINDS = ["scannet", "co3d_isotropic", "co3d_bounds", "co3d_masked_bounds", "folder"]
FORMAT = {"scannet": "scannet", "folder": "folder"}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("limits", [{}, {"stride": 2}, {"max_frames": 1}, {"stride": 2, "max_frames": 1}],
                         ids=["all", "stride2", "max1", "stride2-max1"])
def test_load_scene_matches_jax(tmp_path, kind, limits):
    scene = _scene(tmp_path, kind)
    fmt = TF.detect_scene_format(scene)
    assert fmt == JF.detect_scene_format(scene) == FORMAT.get(kind, "co3d")
    got = TF.load_scene(scene, target_size=TARGET, **limits)
    _assert_scene_equal(got, JF.load_scene(scene, target_size=TARGET, **limits))
    if kind == "scannet" and not limits:
        # the invalid pose keeps its frame's image and depth, without camera GT
        assert got[6] == [0, 1] and got[5] == [0, 1, 2] and not got[1][0, 2].any()


def test_scannet_frame_ids_sort_numerically_or_as_strings(tmp_path):
    """Numeric ids sort as numbers (10 after 2); one stray non-numeric name
    makes every id sort as a string."""
    scene = _write_scannet(str(tmp_path))[0]
    for sub, ext in (("color", "jpg"), ("depth", "png"), ("pose", "txt")):
        for src, dst in (("0", "10"), ("1", "11")):
            shutil.copy(os.path.join(scene, sub, f"{src}.{ext}"),
                        os.path.join(scene, sub, f"{dst}.{ext}"))
    got = TF.load_scene(scene, target_size=TARGET)
    _assert_scene_equal(got, JF.load_scene(scene, target_size=TARGET))
    # numeric order 0, 1, 2 (the invalid pose), 10, 11
    assert got[6] == [0, 1, 3, 4]
    shutil.copy(os.path.join(scene, "color", "2.jpg"), os.path.join(scene, "color", "extra.jpg"))
    got = TF.load_scene(scene, target_size=TARGET)
    _assert_scene_equal(got, JF.load_scene(scene, target_size=TARGET))
    # string order 0, 1, 10, 11, 2, extra (no pose file: no camera)
    assert got[6] == [0, 1, 2, 3]


def test_co3d_helpers_and_annotation_cache(tmp_path):
    rng = np.random.default_rng(4)
    for fmt in ("ndc_isotropic", "ndc_norm_image_bounds"):
        f, p = rng.uniform(1, 3, 2), rng.uniform(-0.1, 0.1, 2)
        np.testing.assert_array_equal(TF._pt3d_ndc_to_pixel_K(f, p, 48, 64, fmt),
                                      JF._pt3d_ndc_to_pixel_K(f, p, 48, 64, fmt))
    R, T = np.linalg.qr(rng.normal(size=(3, 3)))[0], rng.normal(size=3)
    np.testing.assert_array_equal(TF._pt3d_pose_to_opencv_w2c(R, T),
                                  JF._pt3d_pose_to_opencv_w2c(R, T))
    # one parse a category, at most four categories kept
    TF._CO3D_ANN_CACHE.clear()
    for i in range(6):
        ann = tmp_path / f"cat{i}" / "frame_annotations.jgz"
        ann.parent.mkdir()
        with gzip.open(ann, "wt") as f:
            json.dump([{"sequence_name": "s", "frame_number": 0}], f)
        by_seq = TF._load_co3d_annotations(str(ann))
        assert TF._load_co3d_annotations(str(ann)) is by_seq and list(by_seq) == ["s"]
        assert len(TF._CO3D_ANN_CACHE) == min(i + 1, 4)
    with pytest.raises(TypeError, match="unsupported options"):
        TF.load_scene(_scene(tmp_path, "folder"), use_depth=False)


def _mixed_roots(tmp_path):
    """Two training roots that mix formats: ScanNet beside an example
    folder, and a CO3D category whose sequence sits beside a ScanNet scene."""
    a = tmp_path / "a"
    _write_scannet(str(a))
    _write_scene(a / "folder", seed=3)
    b = tmp_path / "b"
    seq = _write_co3d(str(b), "ndc_isotropic")[0]
    _write_scannet(os.path.dirname(seq))
    return a, b / "plant"


def test_scene_dataset_over_mixed_roots_matches_jax(tmp_path):
    kw = dict(views_per_sample=2, target_size=TARGET, seed=5)
    for root in _mixed_roots(tmp_path):
        ds_t, ds_j = TD.SceneDataset(str(root), **kw), JD.SceneDataset(str(root), **kw)
        assert ds_t.scene_dirs == ds_j.scene_dirs and len(ds_t) == 2
        assert {TF.detect_scene_format(d) for d in ds_t.scene_dirs} in (
            {"scannet", "folder"}, {"scannet", "co3d"})
        for _ in range(4):
            a, b = ds_t.sample(), ds_j.sample()
            assert a.keys() == b.keys()
            for key in a:
                np.testing.assert_allclose(np.asarray(a[key], np.float64),
                                           np.asarray(b[key], np.float64), atol=1e-5, err_msg=key)


def test_scene_dataset_augments_after_the_draws(tmp_path):
    """With augmentation the rng draws one seed a sample after the views and
    masks, as the JAX package does: every array but the images stays equal
    to the JAX package's augmented samples, sample after sample; the images
    stay in [0, 1] and differ from the unaugmented ones."""
    root = _mixed_roots(tmp_path)[0]
    kw = dict(views_per_sample=2, target_size=TARGET, seed=6)
    ds_t = TD.SceneDataset(str(root), augment=TA.make_augmentation(gau_blur=True), **kw)
    ds_j = JD.SceneDataset(str(root), augment=JA.make_augmentation(gau_blur=True), **kw)
    # the first sample draws its views and masks before the augmentation's
    # seed, so its views are the unaugmented dataset's first sample's
    c = TD.SceneDataset(str(root), **kw).sample()
    for i in range(3):
        a, b = ds_t.sample(), ds_j.sample()
        if i == 0:
            assert a["images"].shape == c["images"].shape
            assert not np.array_equal(a["images"], c["images"])
        for key in a:
            if key != "images":
                np.testing.assert_allclose(np.asarray(a[key], np.float64),
                                           np.asarray(b[key], np.float64), atol=1e-5, err_msg=key)
        assert a["images"].dtype == np.float32
        assert 0.0 <= a["images"].min() and a["images"].max() <= 1.0
