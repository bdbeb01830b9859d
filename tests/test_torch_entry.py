"""Entry points of the PyTorch port: it imports and runs without JAX (and
without PIL, OpenCV, matplotlib and onnxruntime), the chip smoke test
refuses a machine without CUDA, the scene loader matches the JAX package's,
the CLI runs end to end (the GLB and the viewer too), and safetensors load
strictly."""

import os
import subprocess
import sys
import threading
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from omnivggt_tpu.data import loader as JLoad
from omnivggt_tpu_torch import config as TC
from omnivggt_tpu_torch.data import loader as TLoad
from omnivggt_tpu_torch.models import omnivggt as TM
from tests.torch_port_util import free_port, read_glb

REPO = Path(__file__).resolve().parents[1]

_GUARD = r"""
import importlib, pkgutil, sys
import numpy as np
BLOCKED = ("jax", "omnivggt_tpu", "PIL", "cv2", "matplotlib", "onnxruntime")
for name in BLOCKED:
    sys.modules[name] = None         # any `import jax` (PIL, cv2, ...) now raises ImportError
import torch
import omnivggt_tpu_torch
for m in pkgutil.walk_packages(omnivggt_tpu_torch.__path__, "omnivggt_tpu_torch."):
    importlib.import_module(m.name)
from omnivggt_tpu_torch.config import tiny_test_config
from omnivggt_tpu_torch.eval.trajectory import eval_metrics
from omnivggt_tpu_torch.models.omnivggt import OmniVGGT
from omnivggt_tpu_torch.serving import _glb_from_preds
from omnivggt_tpu_torch.utils.geometry import pose_encoding_to_extri_intri
from omnivggt_tpu_torch.viz.server import build_payload, camera_wire_segments
model = OmniVGGT(tiny_test_config(), device="cpu", seed=0)
with torch.inference_mode():
    out = model(torch.rand(2, 28, 28, 3))
assert out["depth"].shape == (1, 2, 28, 28, 1) and torch.isfinite(out["depth"]).all()
# the scene outputs run on numpy alone: the GLB, the viewer's payload, the metrics
preds = {k: v[0].float().numpy() for k, v in out.items() if k != "pose_enc_list"}
for mode in ("Predicted Pointmap", "Depth"):
    assert _glb_from_preds(preds, 28, 28, conf_thres=25.0, prediction_mode=mode)[:4] == b"glTF"
ext = pose_encoding_to_extri_intri(out["pose_enc"], (28, 28))[0][0].numpy()
segs, seg_cols = camera_wire_segments(ext, 1.0)
n = 2 * 28 * 28
payload = build_payload(preds["world_points"].reshape(-1, 3), np.zeros((n, 3), np.uint8),
                        preds["world_points_conf"].reshape(-1), np.repeat(np.arange(2.0), n // 2),
                        2, segs, seg_cols)
assert int.from_bytes(payload[:4], "little") == n
E = np.tile(np.eye(4), (2, 1, 1))
E[:, :3] = ext
c2w = np.linalg.inv(E)
gt = c2w.copy()
gt[:, :3, 3] += 0.1
assert all(np.isfinite(v) for v in eval_metrics(c2w, gt).values())
bad = [m for m in sys.modules if m.split(".")[0] in BLOCKED + ("jaxlib",) and sys.modules[m] is not None]
assert not bad, bad
print("ok")
"""


def _env():
    env = dict(os.environ, PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="")
    env.pop("JAX_PLATFORMS", None)
    return env


def test_port_imports_and_runs_without_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _GUARD], cwd=REPO, env=_env(), capture_output=True, text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_chip_smoke_refuses_a_machine_without_cuda(tmp_path):
    """No CUDA: a clear message, a non-zero exit, and no result line, both
    from the checkout and from a directory holding chip_smoke.py alone."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((REPO / "chip_smoke.py").read_text())
    for cwd, script in ((REPO, "chip_smoke.py"), (tmp_path, str(lone))):
        env = _env()
        if cwd == tmp_path:
            env.pop("PYTHONPATH")
        proc = subprocess.run(
            [sys.executable, script], cwd=cwd, env=env, capture_output=True, text=True,
            timeout=300,
        )
        assert proc.returncode != 0
        assert "no CUDA device" in proc.stderr
        assert '"ok"' not in proc.stdout


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """Three frames (RGB, RGBA, JPEG), a camera for two of them and depth
    (.npy) for one; plus a tall image outside the scene for the quick-start
    loader's mixed-shape padding."""
    from PIL import Image

    root = tmp_path_factory.mktemp("scene")
    for d in ("images", "cameras", "depth"):
        (root / d).mkdir()
    rng = np.random.default_rng(0)
    Image.fromarray(rng.integers(0, 255, (60, 80, 3), np.uint8)).save(root / "images" / "a.png")
    Image.fromarray(rng.integers(0, 255, (60, 80, 4), np.uint8), "RGBA").save(root / "images" / "b.png")
    Image.fromarray(rng.integers(0, 255, (60, 80, 3), np.uint8)).save(root / "images" / "c.jpg")
    Image.fromarray(rng.integers(0, 255, (90, 50, 3), np.uint8)).save(root / "tall.jpg")
    for name in ("a", "c"):
        c2w = np.eye(4)[:3]
        c2w[:, 3] = rng.normal(size=3)
        K = np.array([[70.0, 0, 40], [0, 70, 30], [0, 0, 1]])
        (root / "cameras" / f"{name}.txt").write_text(
            "\n".join(" ".join(str(x) for x in row) for row in (*c2w, *K))
        )
    np.save(root / "depth" / "a.npy", rng.uniform(0.5, 5, (60, 80)).astype(np.float32))
    return root


def test_loader_matches_jax(scene):
    kw = dict(camera_folder=str(scene / "cameras"), depth_folder=str(scene / "depth"))
    got = TLoad.load_images_and_cameras(str(scene / "images"), target_size=56, **kw)
    want = JLoad.load_images_and_cameras(str(scene / "images"), target_size=56, **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    paths = sorted(str(p) for p in (scene / "images").iterdir()) + [str(scene / "tall.jpg")]
    for mode in ("crop", "pad"):
        np.testing.assert_array_equal(
            TLoad.load_and_preprocess_images(paths, mode), JLoad.load_and_preprocess_images(paths, mode)
        )
    with pytest.raises(ValueError):
        TLoad.load_images_and_cameras(str(scene / "cameras"))


def test_inference_cli_tiny(scene, capsys):
    from omnivggt_tpu_torch import inference

    folder = str(scene / "images")
    preds = inference.main([
        "--image_folder", folder, "--camera_folder", str(scene / "cameras"),
        "--depth_folder", str(scene / "depth"), "--tiny", "--no_viewer", "--target_size", "56",
        "--device", "cpu",
    ])
    assert preds["depth"].shape == (3, 28, 28, 1)
    assert preds["world_points_from_depth"].shape == (3, 28, 28, 3)
    assert preds["extrinsic"].shape == (3, 3, 4) and preds["intrinsic"].shape == (3, 3, 3)
    # random weights may predict a zero field of view (an infinite focal
    # length in `intrinsic`, in both packages); everything else is finite
    assert all(np.isfinite(v).all() for k, v in preds.items() if k != "intrinsic")
    # --save_glb writes <parent of the image folder>/scene.glb; without
    # --no_viewer the viewer serves the predictions (--background_mode: on a
    # daemon thread, so main returns)
    port = free_port()
    capsys.readouterr()
    preds = inference.main([
        "--image_folder", folder, "--tiny", "--save_glb", "--background_mode", "--port", str(port),
        "--target_size", "56", "--device", "cpu", "--conf_threshold", "10",
    ])
    glb = scene / "scene.glb"
    assert f"saved {glb}" in capsys.readouterr().out
    gltf, _ = read_glb(glb.read_bytes())
    assert len(gltf["meshes"]) == 1 + 3  # the points, one frustum per frame
    viewers = [t for t in threading.enumerate() if getattr(t, "httpd", None)
               and t.httpd.server_address[1] == port]
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=30) as r:
            assert r.status == 200 and b"<canvas" in r.read()
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/data", timeout=30) as r:
            data = r.read()
        assert int.from_bytes(data[:4], "little") == preds["depth"][..., 0].size
    finally:
        for t in viewers:
            t.httpd.shutdown()
            t.httpd.server_close()
    assert len(viewers) == 1
    with pytest.raises(SystemExit, match="multiple of the 14-px patch"):
        inference.main(["--image_folder", folder, "--tiny", "--no_viewer", "--target_size", "50"])
    # the default device is cuda, and there is none here: a clear error, no
    # quiet fall-back to the CPU
    with pytest.raises(RuntimeError, match="no CUDA device"):
        inference.main(["--image_folder", folder, "--tiny", "--no_viewer", "--target_size", "56"])


def test_model_defaults_to_cuda():
    """OmniVGGT() builds on cuda, so without a CUDA device it raises; the
    CPU runs only when asked for."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default builds there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.OmniVGGT(TC.tiny_test_config())
    assert next(TM.OmniVGGT(TC.tiny_test_config(), device="cpu").parameters()).device.type == "cpu"


def test_from_safetensors_is_strict(tmp_path):
    from safetensors.torch import save_file

    cfg = TC.tiny_test_config()
    src = TM.OmniVGGT(cfg, device="cpu", seed=3)
    sd = {k: v.contiguous() for k, v in src.state_dict().items()}
    # reference buffers the loader drops, as the JAX converter does
    sd["aggregator._resnet_mean"] = torch.zeros(1, 3, 1, 1)
    sd["aggregator.rope.freq"] = torch.zeros(4)
    path = tmp_path / "model.safetensors"
    save_file(sd, str(path))
    model = TM.OmniVGGT.from_safetensors(str(path), cfg, device="cpu")
    for (n, a), b in zip(src.state_dict().items(), model.state_dict().values()):
        assert torch.equal(a, b), n
    assert model.config.bounded_attn_logits

    for bad in ({k: v for k, v in sd.items() if k != "camera_head.trunk_norm.weight"},
                {**sd, "aggregator.unexpected": torch.zeros(1)}):
        save_file(bad, str(path))
        with pytest.raises(RuntimeError):
            TM.OmniVGGT.from_safetensors(str(path), cfg, device="cpu")

    # q-norm weights that break the logit bound turn the fixed-max softmax off
    sd2 = dict(sd)
    sd2["aggregator.frame_blocks.0.attn.q_norm.weight"] = sd2["aggregator.frame_blocks.0.attn.q_norm.weight"] * 100
    save_file(sd2, str(path))
    assert not TM.OmniVGGT.from_safetensors(str(path), cfg, device="cpu").config.bounded_attn_logits
