"""The port's trajectory evaluation against the JAX package's: the metrics
(within 1e-6), TUM / Replica / Sintel trajectory files, the metrics-file
helpers and the plot, and the eval tool in both modes against the JAX tool
(tools/eval_trajectory.py): file vs file, and the tiny model on a seeded
scene folder on the same weights."""

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest

from omnivggt_tpu.eval import trajectory as JT
from omnivggt_tpu.models import omnivggt as JM
from omnivggt_tpu.utils import platform as JPlatform
from omnivggt_tpu_torch.eval import trajectory as TT
from omnivggt_tpu_torch.tools import eval_trajectory as TTool
from tests.torch_port_util import random_cameras, tiny_pair

REPO = Path(__file__).resolve().parents[1]


def _c2w(seed, n=6, noise=0.0, base=None):
    """n camera-to-world poses; with `base`, those poses moved by `noise`."""
    rng = np.random.default_rng(seed)
    if base is None:
        ext, _ = random_cameras(rng, 1, n)
        E = np.tile(np.eye(4), (n, 1, 1))
        E[:, :3] = ext[0]
        return np.linalg.inv(E)
    out = base.copy()
    out[:, :3, 3] = 1.7 * base[:, :3, 3] + noise * rng.normal(size=(n, 3)) + 0.3
    ang = noise * rng.normal(size=n)
    rot = np.tile(np.eye(3), (n, 1, 1))
    rot[:, 0, 0] = rot[:, 1, 1] = np.cos(ang)
    rot[:, 0, 1], rot[:, 1, 0] = -np.sin(ang), np.sin(ang)
    out[:, :3, :3] = base[:, :3, :3] @ rot
    return out


def _assert_dicts_close(got, want, tol=1e-6):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=tol, atol=tol, err_msg=k)


@pytest.mark.parametrize("noise", [0.0, 0.05, 0.5])
def test_metrics_match_jax(noise):
    gt = _c2w(0)
    pred = _c2w(1, noise=noise, base=gt)
    _assert_dicts_close(TT.eval_metrics(pred, gt), JT.eval_metrics(pred, gt))
    _assert_dicts_close(TT.pose_auc(pred, gt), JT.pose_auc(pred, gt))
    _assert_dicts_close(TT.pose_auc(pred, gt, (1, 3)), JT.pose_auc(pred, gt, (1, 3)))
    for scale in (True, False):
        np.testing.assert_allclose(TT.ate_rmse(pred, gt, scale), JT.ate_rmse(pred, gt, scale),
                                   rtol=1e-6, atol=1e-6)
        for g, w in zip(TT.umeyama_sim3(pred[:, :3, 3], gt[:, :3, 3], scale),
                        JT.umeyama_sim3(pred[:, :3, 3], gt[:, :3, 3], scale)):
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(TT.align_sim3(pred, gt, scale), JT.align_sim3(pred, gt, scale),
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(TT.rpe(pred, gt, 2), JT.rpe(pred, gt, 2), rtol=1e-6, atol=1e-6)
    if noise == 0.0:  # a similarity of the ground truth is aligned exactly
        assert TT.eval_metrics(pred, gt)["ate_rmse"] < 1e-9


def test_tum_roundtrip_matches_jax(tmp_path):
    poses = _c2w(2, n=5)
    ts = np.arange(5) * 0.5 + 10
    TT.save_trajectory_tum_format(poses, str(tmp_path / "port.txt"), ts)
    JT.save_trajectory_tum_format(poses, str(tmp_path / "jax.txt"), ts)
    TT.save_trajectory_tum_format(poses[:1], str(tmp_path / "one.txt"))
    for name in ("port.txt", "jax.txt"):
        got, got_ts = TT.load_trajectory_tum_format(str(tmp_path / name))
        want, want_ts = JT.load_trajectory_tum_format(str(tmp_path / name))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(got_ts, ts)
        np.testing.assert_allclose(got, poses, atol=1e-6)  # float32 quaternions
        np.testing.assert_array_equal(got_ts, want_ts)
    one, one_ts = TT.load_trajectory_tum_format(str(tmp_path / "one.txt"))
    assert one.shape == (1, 4, 4) and one_ts.tolist() == [0.0]


def _write_sintel_cams(root: Path, c2w):
    root.mkdir()
    for i, pose in enumerate(c2w):
        w2c = np.linalg.inv(pose)
        with open(root / f"frame_{i + 1:04d}.cam", "wb") as f:
            np.float32(202021.25).tofile(f)
            np.diag([100.0, 100.0, 1.0]).tofile(f)
            w2c[:3].astype(np.float64).tofile(f)


@pytest.mark.parametrize("fmt", ["tum", "tartanair", "replica", "replica4x4", "sintel"])
def test_trajectory_loaders_match_jax(tmp_path, fmt):
    poses = _c2w(3, n=7)
    path = tmp_path / "traj.txt"
    if fmt in ("tum", "tartanair"):
        JT.save_trajectory_tum_format(poses, str(path))
    elif fmt.startswith("replica"):
        rows = poses[:, :3] if fmt == "replica" else poses
        np.savetxt(path, rows.reshape(len(poses), -1))
    else:
        path = tmp_path / "cams"
        _write_sintel_cams(path, poses)
    fmt = fmt.replace("4x4", "")
    for kw in ({}, dict(skip=1, stride=2), dict(num_frames=3)):
        got = TT.load_traj(str(path), fmt, **kw)
        want = JT.load_traj(str(path), fmt, **kw)
        np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(got[1], want[1])
    if fmt == "sintel":  # mean-centred camera-to-world
        np.testing.assert_allclose(got[0][:, :3, :3], poses[:3, :3, :3], atol=1e-9)
    assert TT.load_timestamps(str(path), fmt) == JT.load_timestamps(str(path), fmt)
    with pytest.raises(NotImplementedError):
        TT.load_traj(str(path), "kitti")


def test_metrics_files_and_plot(tmp_path):
    metrics = {"ate_rmse": 0.125, "rpe_trans_rmse": 0.0625, "rpe_rot_rmse_deg": 1.5}
    (tmp_path / "a").mkdir()
    TT.write_metrics_file(metrics, str(tmp_path / "a" / "s1_eval_metric.txt"), seq="s1")
    JT.write_metrics_file(metrics, str(tmp_path / "jax.txt"), seq="s1")
    assert (tmp_path / "a" / "s1_eval_metric.txt").read_text() == (tmp_path / "jax.txt").read_text()
    TT.write_metrics_file({**metrics, "ate_rmse": 0.5}, str(tmp_path / "a" / "s2_metric.txt"))
    assert TT.extract_metrics(str(tmp_path / "jax.txt")) == (0.125, 0.0625, 1.5)
    assert TT.process_directory(str(tmp_path / "a")) == JT.process_directory(str(tmp_path / "a"))
    results = TT.process_directory(str(tmp_path / "a"))
    assert [r[0] for r in results] == ["s1", "s2"]
    assert TT.calculate_averages(results) == JT.calculate_averages(results)
    assert TT.calculate_averages([]) == (0.0, 0.0, 0.0)
    gt = _c2w(4)
    pred = _c2w(5, noise=0.1, base=gt)
    for kw in (dict(gt_c2w=gt), dict(gt_c2w=None), dict(gt_c2w=gt, align=False)):
        out = tmp_path / f"plot{len(kw)}{kw.get('align', '')}.png"
        assert TT.plot_trajectory(pred, filename=str(out), title="t", **kw) == str(out)
        assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def _jax_tool(monkeypatch, tmp_path, argv, capsys):
    """Run tools/eval_trajectory.py's main with argv; returns its JSON."""
    monkeypatch.setattr(JPlatform, "_CACHE_DIR", str(tmp_path / "xla_cache"))
    monkeypatch.setattr(sys, "argv", ["eval_trajectory.py", *argv])
    spec = importlib.util.spec_from_file_location(
        "jax_eval_trajectory", REPO / "tools" / "eval_trajectory.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    capsys.readouterr()
    tool.main()
    out = capsys.readouterr().out
    return json.loads(out[: out.rindex("}") + 1])


def test_eval_tool_files_match_jax_tool(tmp_path, monkeypatch, capsys):
    """Mode 1: a TUM prediction against a Replica ground truth, with skip /
    stride, the metrics file and the plot."""
    gt = _c2w(6, n=9)
    pred = _c2w(7, n=9, noise=0.05, base=gt)
    TT.save_trajectory_tum_format(pred, str(tmp_path / "pred.txt"))
    np.savetxt(tmp_path / "gt.txt", gt[:, :3].reshape(9, -1))
    argv = ["--pred", str(tmp_path / "pred.txt"), "--gt", str(tmp_path / "gt.txt"),
            "--gt_format", "replica", "--skip", "1", "--stride", "2"]
    capsys.readouterr()
    got = TTool.main([*argv, "--out", str(tmp_path / "m.txt"), "--plot", str(tmp_path / "p.png")])
    printed = capsys.readouterr().out
    want = _jax_tool(monkeypatch, tmp_path, [*argv, "--out", str(tmp_path / "jm.txt")], capsys)
    report = json.loads(printed[: printed.rindex("}") + 1])
    assert report["seq"] == want["seq"] == "pred.txt" and report["frames"] == want["frames"] == 4
    _assert_dicts_close(got, {k: v for k, v in want.items() if k not in ("seq", "frames")})
    assert (tmp_path / "m.txt").read_text() == (tmp_path / "jm.txt").read_text()
    assert (tmp_path / "p.png").exists()
    with pytest.raises(SystemExit, match="need --pred/--gt"):
        TTool.main(["--pred", str(tmp_path / "pred.txt")])


def _metric_tolerance(model, images, gt_c2w, entry_tol=5e-4):
    """How far each metric may move when every pose_enc entry of the port's
    forward moves by up to `entry_tol`: the sum over entries of the change
    when one entry moves by entry_tol (a first-order bound), doubled for the
    second-order terms."""
    import torch

    from omnivggt_tpu_torch.utils.geometry import pose_encoding_to_extri_intri

    with torch.inference_mode():
        enc = model(images)["pose_enc"].double()

    def metrics(e):
        w2c, _ = pose_encoding_to_extri_intri(e, images.shape[1:3])
        pred = TTool._expand_c2w(w2c[0].numpy())
        return {**TT.eval_metrics(pred, gt_c2w), **TT.pose_auc(pred, gt_c2w)}

    tol = dict.fromkeys(metrics(enc), 0.0)
    for idx in np.ndindex(*enc.shape):
        up, down = enc.clone(), enc.clone()
        up[idx] += entry_tol
        down[idx] -= entry_tol
        m_up, m_down = metrics(up), metrics(down)
        for k in tol:  # twice the change for one step of entry_tol
            tol[k] += abs(m_up[k] - m_down[k])
    return tol


def test_eval_tool_model_matches_jax_tool(tmp_path, monkeypatch, capsys):
    """Mode 2: the tiny model on a seeded scene folder with GT cameras for
    every frame, the port on --device cpu and the JAX tool on the same
    weights (the port's seed-0 init, carried across by the bridge). The two
    forwards agree on pose_enc within the module tolerance 5e-4
    (tests/test_torch_slice.py); each metric is held to how far it moves
    when every pose_enc entry moves by up to 5e-4 (_metric_tolerance)."""
    from PIL import Image

    from omnivggt_tpu_torch.data.loader import load_images_and_cameras

    rng = np.random.default_rng(10)
    images, cams = tmp_path / "scene" / "images", tmp_path / "scene" / "cameras"
    images.mkdir(parents=True)
    cams.mkdir()
    c2w = _c2w(11, n=4)
    for i in range(4):
        Image.fromarray(rng.integers(0, 255, (28, 28, 3), np.uint8)).save(images / f"{i}.png")
        K = np.array([[30.0, 0, 14], [0, 30, 14], [0, 0, 1]])
        (cams / f"{i}.txt").write_text(
            "\n".join(" ".join(str(x) for x in row) for row in (*c2w[i, :3], *K)))
    argv = ["--image_folder", str(images), "--gt_cameras", str(cams), "--tiny",
            "--target_size", "28"]
    got = TTool.main([*argv, "--device", "cpu"])
    _, _, params, model = tiny_pair(seed=0)
    cls = JM.OmniVGGT
    monkeypatch.setattr(JM, "OmniVGGT", lambda cfg: cls(cfg, params))
    want = _jax_tool(monkeypatch, tmp_path, argv, capsys)
    assert want["frames"] == 4 and want["seq"] == "images"
    loaded, ex, *_ = load_images_and_cameras(str(images), str(cams), target_size=28)
    tol = _metric_tolerance(model, loaded, TTool._expand_c2w(ex[0]))
    for k, v in got.items():
        assert np.isfinite(v) and abs(v - want[k]) <= tol[k] + 1e-6, (k, v, want[k], tol[k])

    (cams / "3.txt").unlink()
    with pytest.raises(SystemExit, match="GT cameras cover 3/4"):
        TTool.main([*argv, "--device", "cpu"])
    with pytest.raises(SystemExit, match="needs --gt_cameras"):
        TTool.main(["--image_folder", str(images), "--device", "cpu"])
    # model mode defaults to cuda, and there is none here: no quiet CPU run
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TTool.main(argv)
