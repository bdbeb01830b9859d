"""The port's scene outputs against the JAX package's on the same inputs: the
GLB writer and exporter in every filtering mode, the server's GLB
(`_glb_from_preds`), scene meshes, the viewer's payload and /data, sky masks
(HSV with cache and limit, and the ONNX branch with a stub runtime), and the
tiny model end to end through both CLIs with --save_glb. Bytes equal where
the inputs are identical; where each package decodes the pose and unprojects
the depth itself, the tolerances are stated at each test."""

import importlib.util
import io
import sys
import types
import urllib.error
import urllib.request
from pathlib import Path

import cv2
import numpy as np
import pytest

import omnivggt_tpu
from omnivggt_tpu import serving as JS
from omnivggt_tpu.models import omnivggt as JM
from omnivggt_tpu.utils import platform as JPlatform
from omnivggt_tpu.viz import glb as JG
from omnivggt_tpu.viz import scene as JScene
from omnivggt_tpu.viz import server as JSrv
from omnivggt_tpu.viz import sky as JSky
from omnivggt_tpu_torch import inference as TInf
from omnivggt_tpu_torch import serving as TS
from omnivggt_tpu_torch.viz import glb as TG
from omnivggt_tpu_torch.viz import scene as TScene
from omnivggt_tpu_torch.viz import server as TSrv
from omnivggt_tpu_torch.viz import sky as TSky
from tests.torch_port_util import (
    free_port, glb_meshes, random_cameras, read_glb, tiny_pair,
)

REPO = Path(__file__).resolve().parents[1]
S, H, W = 3, 14, 18


def _preds(seed=0):
    """Batch-free numpy predictions as the CLI hands them to the exporter:
    near-black top rows and near-white bottom rows for the background masks,
    and a few confidences at 0 (under the 1e-5 floor)."""
    rng = np.random.default_rng(seed)
    ext, K = random_cameras(rng, 1, S)
    images = rng.uniform(size=(S, H, W, 3)).astype(np.float32)
    images[:, :2] = 0.02
    images[:, -2:] = 0.99
    out = {"images": images, "extrinsic": ext[0], "intrinsic": K[0]}
    for key in ("world_points", "world_points_from_depth"):
        out[key] = rng.normal(size=(S, H, W, 3)).astype(np.float32)
    out["depth"] = rng.uniform(0.5, 3.0, (S, H, W, 1)).astype(np.float32)
    for key in ("world_points_conf", "depth_conf"):
        conf = rng.uniform(1.0, 3.0, (S, H, W)).astype(np.float32)
        conf[:, 5, :4] = 0.0
        out[key] = conf
    return out


def _sky_folder(root: Path, n=S, h=H, w=W, seed=3):
    """n PNGs: a bright blue sky over a dark ground, with noise."""
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    for i in range(n):
        img = np.empty((h, w, 3), np.uint8)
        img[: h // 2] = (255, 200, 150)  # BGR: bright blue
        img[h // 2 :] = (20, 60, 40)
        img = np.clip(img + rng.integers(-12, 12, img.shape), 0, 255).astype(np.uint8)
        cv2.imwrite(str(root / f"{i:02d}.png"), img)
    return root


def test_write_glb_bytes_equal(tmp_path):
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(50, 3)).astype(np.float32)
    cols = rng.integers(0, 256, (50, 3), np.uint8)
    meshes = [TG.camera_frustum_mesh(np.eye(4), 1.5) + ((255, 0, 0),),
              (rng.normal(size=(5, 3)), np.array([[0, 1, 2], [2, 3, 4]]), (0, 10, 200))]
    for p, m in ((pts[:0], meshes), (pts, None), (pts, meshes)):
        got, want = io.BytesIO(), io.BytesIO()
        TG.write_glb(got, p, cols[: len(p)], m)
        JG.write_glb(want, p, cols[: len(p)], m)
        assert got.getvalue() == want.getvalue()
    TG.write_glb(str(tmp_path / "a.glb"), pts, cols, meshes)  # a path, not a stream
    assert (tmp_path / "a.glb").read_bytes() == want.getvalue()


def test_camera_frustum_mesh_equal():
    rng = np.random.default_rng(2)
    ext, _ = random_cameras(rng, 1, 2)
    for i, scale in enumerate((0.3, 2.0)):
        c2w = np.linalg.inv(np.concatenate([ext[0, i], [[0, 0, 0, 1]]]).astype(np.float64))
        for n_sides in (4, 8):
            gv, gf = TG.camera_frustum_mesh(c2w, scale, n_sides)
            wv, wf = JG.camera_frustum_mesh(c2w, scale, n_sides)
            assert gv.dtype == wv.dtype and gf.dtype == wf.dtype
            np.testing.assert_array_equal(gv, wv)
            np.testing.assert_array_equal(gf, wf)
    assert TG._rainbow(0.37) == JG._rainbow(0.37)
    np.testing.assert_array_equal(TG._rot("x", 30), JG._rot("x", 30))
    np.testing.assert_array_equal(
        TG.get_opengl_conversion_matrix(), JG.get_opengl_conversion_matrix())


GLB_MODES = {
    "pointmap conf 0": dict(prediction_mode="Predicted Pointmap", conf_thres=0.0),
    "pointmap conf 25": dict(prediction_mode="Predicted Pointmap", conf_thres=25.0),
    "pointmap conf 50": dict(prediction_mode="Predicted Pointmap", conf_thres=50.0),
    "depth conf 0": dict(prediction_mode="Depth", conf_thres=0.0),
    "depth conf 25": dict(prediction_mode="Depth", conf_thres=25.0),
    "depth conf 50": dict(prediction_mode="Depth", conf_thres=50.0),
    "conf None": dict(conf_thres=None),
    "frame 1": dict(filter_by_frames="1: frame"),
    "bad frame filter": dict(filter_by_frames="x"),
    "black bg": dict(mask_black_bg=True, conf_thres=0.0),
    "white bg": dict(mask_white_bg=True, conf_thres=0.0),
    "both bg": dict(mask_black_bg=True, mask_white_bg=True),
    "no cameras": dict(show_cam=False),
    "empty": dict(conf_thres=50.0, empty=True),
    "sky": dict(mask_sky=True, conf_thres=10.0),
}


@pytest.mark.parametrize("mode", list(GLB_MODES))
def test_predictions_to_glb_bytes_equal(tmp_path, mode):
    kw = dict(GLB_MODES[mode])
    preds = _preds()
    if kw.pop("empty", False):
        for key in ("world_points_conf", "depth_conf"):
            preds[key] = np.zeros_like(preds[key])
    if kw.get("mask_sky"):
        kw["image_folder"] = str(_sky_folder(tmp_path / "images", n=S + 2))
    paths = {}
    for name, mod in (("port", TG), ("jax", JG)):
        out = tmp_path / name
        out.mkdir()
        extra = {"target_dir": str(out)} if kw.get("mask_sky") else {}
        paths[name] = mod.predictions_to_glb(preds, str(out / "scene.glb"), **kw, **extra)
    got, want = (Path(paths[k]).read_bytes() for k in ("port", "jax"))
    assert got == want
    meshes = glb_meshes(got)
    n_cams = 0 if mode == "no cameras" else 1 if mode == "frame 1" else S
    assert len(meshes) == 1 + n_cams
    if mode == "empty":  # one placeholder point, aligned with the scene
        assert meshes[0].shape == (1, 3)
    if kw.get("mask_sky"):  # the port cached its own masks, one per predicted frame
        assert len(list((tmp_path / "port" / "sky_masks").iterdir())) == S


def _served_preds(seed=4, S_=3, hw=(14, 18)):
    """A served request's numpy answer (pose_enc, not extrinsics) plus its
    images, with pose encodings that decode to valid cameras."""
    rng = np.random.default_rng(seed)
    h, w = hw
    q = rng.normal(size=(S_, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    pose_enc = np.concatenate(
        [rng.normal(size=(S_, 3)), q, rng.uniform(0.6, 1.4, (S_, 2))], -1).astype(np.float32)
    out = {"pose_enc": pose_enc, "images": rng.uniform(size=(S_, h, w, 3)).astype(np.float32),
           "depth": rng.uniform(0.5, 3.0, (S_, h, w, 1)).astype(np.float32),
           "world_points": rng.normal(size=(S_, h, w, 3)).astype(np.float32)}
    for key in ("depth_conf", "world_points_conf"):
        out[key] = rng.uniform(1.0, 3.0, (S_, h, w)).astype(np.float32)
    return out


@pytest.mark.parametrize("mode", ["Predicted Pointmap", "Depth"])
def test_glb_from_preds_matches_jax(mode):
    """Pointmap: bytes equal (the pose decode feeds only the frusta and the
    alignment, and both packages decode it to the same float32 bits). Depth:
    the two packages' float32 unprojection (tan in the focal length) may
    differ in the last bits, so the same kept count and positions within
    1e-5 relative."""
    preds = _served_preds()
    kw = dict(conf_thres=25.0, prediction_mode=mode, mask_black_bg=True)
    got = TS._glb_from_preds(preds, 14, 18, **kw)
    want = JS._glb_from_preds(preds, 14, 18, **kw)
    if mode == "Predicted Pointmap":
        assert got == want
    got_m, want_m = glb_meshes(got), glb_meshes(want)
    assert [m.shape for m in got_m] == [m.shape for m in want_m]
    for g, w in zip(got_m, want_m):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5 * np.abs(w).max())


def test_scene_meshes_equal(tmp_path):
    rng = np.random.default_rng(5)
    img = rng.uniform(size=(6, 7, 3)).astype(np.float32)
    pts = rng.normal(size=(6, 7, 3)).astype(np.float32)
    valid = rng.uniform(size=(6, 7)) > 0.2
    for v in (None, valid):
        got, want = TScene.pts3d_to_mesh(img, pts, v), JScene.pts3d_to_mesh(img, pts, v)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])
    meshes = [JScene.pts3d_to_mesh(img, pts, valid), JScene.pts3d_to_mesh(img[:3], pts[:3])]
    for key, arr in TScene.cat_meshes(meshes).items():
        np.testing.assert_array_equal(arr, JScene.cat_meshes(meshes)[key])

    def build(mod):
        viz = mod.SceneViz()
        viz.add_pointcloud(pts, img, mask=valid)
        viz.add_pointcloud(pts[:2], (255, 0, 0))
        viz.add_mesh(img, pts, valid)
        viz.add_camera(np.eye(4))
        viz.add_camera(np.eye(4), color=(1, 2, 3))
        return Path(viz.save_glb(str(tmp_path / f"{mod.__name__}.glb"))).read_bytes()

    assert build(TScene) == build(JScene)
    assert (Path(TScene.SceneViz().save_glb(str(tmp_path / "e.glb"))).read_bytes()
            == Path(JScene.SceneViz().save_glb(str(tmp_path / "f.glb"))).read_bytes())

    sky_img = cv2.cvtColor(cv2.imread(str(_sky_folder(tmp_path / "sky", n=1, h=40, w=48)
                                          / "00.png")), cv2.COLOR_BGR2RGB)
    for image in (sky_img, sky_img.astype(np.float32) / 255, np.zeros_like(sky_img)):
        np.testing.assert_array_equal(TScene.segment_sky_hsv_cc(image),
                                      JScene.segment_sky_hsv_cc(image))
    assert TScene.segment_sky_hsv_cc(sky_img)[:10].all()


def test_viewer_payload_equal():
    rng = np.random.default_rng(6)
    preds = _preds(7)
    ext = preds["extrinsic"]
    for aspect in (1.0, W / H):
        np.testing.assert_array_equal(TSrv.camera_quads(ext, 2.5, aspect),
                                      JSrv.camera_quads(ext, 2.5, aspect))
        for g, w in zip(TSrv.camera_wire_segments(ext, 2.5, aspect),
                        JSrv.camera_wire_segments(ext, 2.5, aspect)):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    assert TSrv.camera_quads(ext[:0], 1.0).shape == (0, 4, 3)
    assert [a.shape for a in TSrv.camera_wire_segments(ext[:0], 1.0)] == [(0, 2, 3)] * 2
    for max_h in (64, 5):
        atlas, shape = TSrv.thumbnail_atlas(preds["images"], max_h)
        want_atlas, want_shape = JSrv.thumbnail_atlas(preds["images"], max_h)
        assert shape == want_shape
        np.testing.assert_array_equal(atlas, want_atlas)
    n = S * H * W
    segs, cols = TSrv.camera_wire_segments(ext, 1.0)
    args = (rng.normal(size=(n, 3)), rng.integers(0, 256, (n, 3)), rng.uniform(size=n),
            np.repeat(np.arange(S), H * W), S, segs, cols)
    atlas, shape = TSrv.thumbnail_atlas(preds["images"])
    assert TSrv.build_payload(*args) == JSrv.build_payload(*args)
    extra = dict(cam_poses=rng.normal(size=(S, 6)), cam_quads=TSrv.camera_quads(ext, 1.0),
                 atlas=atlas, thumb_shape=shape)
    assert TSrv.build_payload(*args, **extra) == JSrv.build_payload(*args, **extra)


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
        return r.status, r.headers["Content-Type"], r.read()


@pytest.mark.parametrize("use_point_map", [False, True])
def test_serve_scene_data_matches_jax(use_point_map):
    preds = _preds(8)
    kw = dict(init_conf_threshold=30.0, background_mode=True, use_point_map=use_point_map,
              mask_black_bg=True)
    ports = free_port(), free_port()
    thread = TSrv.serve_scene(preds, port=ports[0], **kw)
    JSrv.serve_scene(preds, port=ports[1], **kw)
    try:
        assert thread.is_alive()
        status, ctype, page = _get(ports[0], "/")
        assert status == 200 and ctype == "text/html"
        assert b'value="30"' in page and b'id="mblack" type="checkbox" checked' in page
        got, want = _get(ports[0], "/data"), _get(ports[1], "/data")
        assert got[:2] == (200, "application/octet-stream") and got[2] == want[2]
        with pytest.raises(urllib.error.HTTPError) as exc:
            _get(ports[0], "/nope")
        assert exc.value.code == 404
    finally:
        thread.httpd.shutdown()
        thread.httpd.server_close()
    thread.join(timeout=10)
    assert not thread.is_alive()


def test_sky_masks_for_folder_equal(tmp_path):
    folder = _sky_folder(tmp_path / "images", n=4, h=20, w=24)
    for limit, hw in ((None, (20, 24)), (3, (10, 12))):
        caches = tmp_path / f"port{limit}", tmp_path / f"jax{limit}"
        got = TSky.sky_masks_for_folder(str(folder), hw, cache_dir=str(caches[0]), limit=limit)
        want = JSky.sky_masks_for_folder(str(folder), hw, cache_dir=str(caches[1]), limit=limit)
        assert got.dtype == want.dtype and got.shape == (limit or 4, *hw)
        np.testing.assert_array_equal(got, want)
        assert sorted(p.name for p in (caches[0] / "sky_masks").iterdir()) == sorted(
            p.name for p in (caches[1] / "sky_masks").iterdir())
        # the second call reads the cache
        np.testing.assert_array_equal(
            TSky.sky_masks_for_folder(str(folder), hw, cache_dir=str(caches[0]), limit=limit), got)
    assert (got[:, :3] == 0).mean() > 0.9 and (got[:, -3:] == 255).all()
    img = cv2.cvtColor(cv2.imread(str(folder / "00.png")), cv2.COLOR_BGR2RGB)
    np.testing.assert_array_equal(TSky._hsv_sky_mask(img), JSky._hsv_sky_mask(img))
    np.testing.assert_array_equal(
        TSky.sky_masks_for_folder(str(folder), (20, 24)),
        JSky.sky_masks_for_folder(str(folder), (20, 24)))


def test_sky_onnx_branch_with_stub_runtime(tmp_path, monkeypatch):
    """The ONNX path against a stubbed onnxruntime, in both packages: the
    same masks, one run per image, the PNG cache; without the model file the
    session is None and the HSV heuristic runs."""
    folder = _sky_folder(tmp_path / "images", n=2, h=40, w=48)
    runs = []

    class _FakeSession:
        def __init__(self, path):
            self.path = path

        def get_inputs(self):
            return [types.SimpleNamespace(name="input.1")]

        def get_outputs(self):
            return [types.SimpleNamespace(name="out")]

        def run(self, out_names, feeds):
            x = feeds["input.1"]
            assert x.shape == (1, 3, 320, 320) and x.dtype == np.float32
            runs.append(float(x.sum()))
            sal = np.zeros((1, 1, 320, 320), np.float32)
            sal[:, :, :160] = 1.0  # the top half is sky
            return [sal]

    fake = types.ModuleType("onnxruntime")
    fake.InferenceSession = _FakeSession
    monkeypatch.setitem(sys.modules, "onnxruntime", fake)
    model = tmp_path / "skyseg.onnx"
    model.write_bytes(b"stub")
    monkeypatch.setenv("OMNIVGGT_SKYSEG_ONNX", str(model))
    assert TSky._get_onnx_session().path == str(model)

    got = TSky.sky_masks_for_folder(str(folder), (40, 48), cache_dir=str(tmp_path / "port"))
    port_runs = list(runs)
    want = JSky.sky_masks_for_folder(str(folder), (40, 48), cache_dir=str(tmp_path / "jax"))
    assert len(port_runs) == 2 and runs[2:] == port_runs
    np.testing.assert_array_equal(got, want)
    assert (got[:, :10] == 0).all() and (got[:, -10:] == 255).all()
    again = TSky.sky_masks_for_folder(str(folder), (40, 48), cache_dir=str(tmp_path / "port"))
    assert len(runs) == 4
    np.testing.assert_array_equal(again, got)

    monkeypatch.setenv("OMNIVGGT_SKYSEG_ONNX", str(tmp_path / "missing.onnx"))
    assert TSky._get_onnx_session() is None
    monkeypatch.setitem(sys.modules, "onnxruntime", None)
    monkeypatch.setenv("OMNIVGGT_SKYSEG_ONNX", str(model))
    assert TSky._get_onnx_session() is None


def test_cli_glb_matches_jax_cli(tmp_path, monkeypatch):
    """The tiny model end to end through the port's CLI and the JAX CLI
    (inference.py) with --save_glb at --conf_threshold 0, on the same weights
    (the port's seed-0 init, which is what --tiny builds, carried to the JAX
    model by the bridge). At 0 only conf > 1e-5 filters, so the kept counts
    are equal; positions (depth unprojection, then the first camera's
    alignment) within the module tolerance 5e-4."""
    from PIL import Image

    rng = np.random.default_rng(9)
    images = tmp_path / "scene" / "images"
    images.mkdir(parents=True)
    for i in range(3):
        Image.fromarray(rng.integers(0, 255, (60, 80, 3), np.uint8)).save(images / f"{i}.png")
    common = ["--image_folder", str(images), "--tiny", "--no_viewer", "--save_glb",
              "--conf_threshold", "0", "--target_size", "56"]
    TInf.main([*common, "--device", "cpu", "--glb_path", str(tmp_path / "port.glb")])

    jcfg, _, params, _ = tiny_pair(seed=0)
    monkeypatch.setattr(omnivggt_tpu, "OmniVGGT", lambda cfg: JM.OmniVGGT(cfg, params))
    monkeypatch.setattr(JPlatform, "_CACHE_DIR", str(tmp_path / "xla_cache"))
    monkeypatch.setattr(sys, "argv", ["inference.py", *common, "--glb_path",
                                      str(tmp_path / "jax.glb")])
    spec = importlib.util.spec_from_file_location("jax_inference_cli", REPO / "inference.py")
    jax_cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_cli)
    jax_cli.main()

    got, want = ((tmp_path / f"{k}.glb").read_bytes() for k in ("port", "jax"))
    read_glb(got)
    got_m, want_m = glb_meshes(got), glb_meshes(want)
    assert len(got_m) == 1 + 3 and [m.shape for m in got_m] == [m.shape for m in want_m]
    for g, w in zip(got_m, want_m):
        np.testing.assert_allclose(g, w, atol=5e-4, rtol=1e-4)
