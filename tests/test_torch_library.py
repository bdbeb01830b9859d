"""The library surface of the PyTorch port against the JAX package on the
CPU: flops_estimate (exactly equal), sharded_attention_roofline (equal on
the same explicit rates), Timer / force / trace, the pytree helpers,
guard_predictions and enable_nan_debugging, the four point-map geometry
functions (1e-6 / 1e-5; the KD-tree matches exactly), SwiGLU blocks and a
SwiGLU DINOv2 (5e-4, the module tolerance), aa_order=("global", "frame")
through the whole model (5e-4), the top-level API, the serving example, and
TF32 kept off: inside the forward whatever the global switches, and after
every command-line entry point."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from omnivggt_tpu import checkpoint as JCk
from omnivggt_tpu import config as JC
from omnivggt_tpu.models import dinov2 as JD
from omnivggt_tpu.models import omnivggt as JM
from omnivggt_tpu.ops import layers as JL
from omnivggt_tpu.utils import geometry as JG
from omnivggt_tpu.utils import profiling as JP
from omnivggt_tpu.utils import pytree as JT
from omnivggt_tpu.utils import validation as JV
from omnivggt_tpu_torch import config as TC
from omnivggt_tpu_torch.checkpoint import StateDictEmitter
from omnivggt_tpu_torch.models import dinov2 as TD
from omnivggt_tpu_torch.models import omnivggt as TM
from omnivggt_tpu_torch.ops import layers as TL
from omnivggt_tpu_torch.utils import geometry as TG
from omnivggt_tpu_torch.utils import platform as TPl
from omnivggt_tpu_torch.utils import profiling as TP
from omnivggt_tpu_torch.utils import pytree as TT
from omnivggt_tpu_torch.utils import validation as TV
from tests.torch_port_util import ATOL, assert_outputs_close, gt_inputs, t, tiny_pair


# ---------------------------------------------------------------------------
# profiling
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["default", "default_conv", "tiny"])
@pytest.mark.parametrize("S", [1, 8, 64])
@pytest.mark.parametrize("hw", [None, (280, 518)])
def test_flops_estimate_equals_jax(which, S, hw):
    kw = {"aggregator": dataclasses.replace(JC.AggregatorConfig(), patch_embed="conv")}
    jcfg = {"default": JC.OmniVGGTConfig(), "default_conv": JC.OmniVGGTConfig(**kw),
            "tiny": JC.tiny_test_config()}[which]
    tkw = {"aggregator": dataclasses.replace(TC.AggregatorConfig(), patch_embed="conv")}
    tcfg = {"default": TC.OmniVGGTConfig(), "default_conv": TC.OmniVGGTConfig(**tkw),
            "tiny": TC.tiny_test_config()}[which]
    H, W = hw or (None, None)
    assert TP.flops_estimate(tcfg, S, H, W) == JP.flops_estimate(jcfg, S, H, W)
    if which == "default" and S == 8 and hw is None:
        assert round(TP.flops_estimate(tcfg, S) / 1e12, 3) == 45.171


def test_sharded_attention_roofline_equals_jax():
    rates = dict(ici_bytes_per_s=2e11, flash_flops_per_s=4e14, flash_int8_flops_per_s=6e14,
                 matmul_flops_per_s=7e14)
    for n_dev in (4, 8):
        assert TP.sharded_attention_roofline(n_dev, **rates) == JP.sharded_attention_roofline(
            n_dev, **rates)
    with pytest.raises(TypeError):
        TP.sharded_attention_roofline(8)  # no rate is assumed


def test_timer_force_trace(tmp_path):
    x = torch.arange(6.0).reshape(2, 3).bfloat16()
    forced = TP.force({"a": [x, 1], "b": (x.float(),)})
    assert isinstance(forced["a"][0], np.ndarray) and forced["a"][0].dtype == np.float32
    assert forced["a"][1] == 1 and isinstance(forced["b"], tuple)
    timer = TP.Timer()
    for _ in range(2):
        with timer.section("mm") as s:
            s.set(x.float() @ x.float().t())
    assert timer.counts == {"mm": 2} and timer.totals["mm"] > 0
    assert "x2" in timer.report()
    with TP.recording(), TP.trace(str(tmp_path / "tr")) as prof:
        with TP.span("my-range"):
            (x.float() @ x.float().t()).sum()
    assert any(e.key == "my-range" for e in prof.key_averages())
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "my-range" for e in events)


def test_profile_forward_tiny(tmp_path, capsys):
    from omnivggt_tpu_torch.tools import profile_forward

    out = profile_forward.main(["--tiny", "--device", "cpu", "--size", "28", "--views", "2",
                                "--logdir", str(tmp_path)])
    assert out["flops"] == JP.flops_estimate(JC.tiny_test_config(), 2, 28, 28)
    assert os.path.exists(tmp_path / "trace.json") and "TFLOP/s" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# pytree, validation
# ---------------------------------------------------------------------------


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def test_pytree_helpers_match_jax():
    rng = np.random.default_rng(0)
    samples = [
        {"images": rng.normal(size=(n, 4, 3)).astype(np.float32), "idx": np.asarray(i),
         "name": f"s{i}", "pair": (rng.normal(size=(1, 2)), np.ones((2, 5)))}
        for i, n in enumerate((2, 3))
    ]
    for lists in (False, True):
        want = JT.collate_with_cat(samples, lists=lists)
        got = TT.collate_with_cat(samples, lists=lists)
        got_t = TT.to_numpy(TT.collate_with_cat(TT.to_device(samples, "cpu"), lists=lists))
        for g in (got, got_t):
            assert jax.tree.structure(_np_tree(g)) == jax.tree.structure(_np_tree(want))
            for a, b in zip(jax.tree.leaves(_np_tree(g)), jax.tree.leaves(_np_tree(want))):
                np.testing.assert_array_equal(a, b)
    moved = TT.to_cpu({"a": [np.ones(2)], "b": "x"})
    assert isinstance(moved["a"][0], torch.Tensor) and moved["b"] == "x"

    preds = {"pose_enc_list": [rng.normal(size=(2, 3, 9))] * 2, "depth": rng.normal(size=(2, 3, 4)),
             "other": rng.normal(size=(2, 1))}
    want = JT.select_first_batch(preds, dtype=np.float32)
    got = TT.select_first_batch(TT.to_device(preds, "cpu"), dtype=np.float32)
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(np.asarray(TT.to_numpy(got[k])), np.asarray(want[k]))

    arr = rng.normal(size=(2, 3, 4, 3)).astype(np.float32)
    mask = rng.uniform(size=(2, 3, 4)) > 0.3
    for m in (mask, None):
        for nd in (999, 3):
            np.testing.assert_array_equal(
                TT.invalid_to_nans(t(arr), None if m is None else t(m), nd).numpy(),
                np.asarray(JT.invalid_to_nans(jnp.asarray(arr), m, nd)))
            z_t, n_t = TT.invalid_to_zeros(t(arr), None if m is None else t(m), nd)
            z_j, n_j = JT.invalid_to_zeros(jnp.asarray(arr), m, nd)
            np.testing.assert_array_equal(z_t.numpy(), np.asarray(z_j))
            np.testing.assert_array_equal(np.asarray(n_t), np.asarray(n_j))

    bad = arr.copy()
    bad[0, 0, 0, 0], bad[1, 0, 0, 1] = np.nan, np.inf
    for x in (arr, bad):
        want = JT.check_valid_array(x, "pts")
        assert TT.check_valid_array(t(x), "pts") == want == TT.check_valid_array(x, "pts")
    assert TV.check_valid_array is TT.check_valid_array


def test_guard_predictions_matches_jax():
    rng = np.random.default_rng(1)
    preds = {"depth": rng.normal(size=(1, 2, 4, 4, 1)).astype(np.float32),
             "pose_enc": rng.normal(size=(1, 2, 9)).astype(np.float32), "note": "x"}
    assert TV.guard_predictions(TT.to_device(preds, "cpu")) == JV.guard_predictions(preds) == []
    preds["depth"][0, 1, 2, 3, 0] = np.nan
    preds["pose_enc"][0, 0, 0] = -np.inf
    want = JV.guard_predictions(preds)
    assert TV.guard_predictions(TT.to_device(preds, "cpu")) == want and len(want) == 2
    with pytest.raises(TV.ValidationError, match="non-finite predictions"):
        TV.guard_predictions(TT.to_device(preds, "cpu"), raise_on_error=True)


def test_enable_nan_debugging_raises_at_the_block():
    """A NaN in a weight of frame block 1 raises at a module of that block
    (before the heads); switched off, the hook is gone and the forward
    returns the NaN."""
    from torch.nn.modules import module as nn_module

    _, _, _, model = tiny_pair(seed=0)
    images = torch.rand(2, 28, 28, 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.aggregator.frame_blocks[1].attn.qkv.weight[0, 0] = float("nan")
    n_hooks = len(nn_module._global_forward_hooks)
    TV.enable_nan_debugging()
    try:
        assert len(nn_module._global_forward_hooks) == n_hooks + 1
        assert torch.is_anomaly_enabled()
        with pytest.raises(FloatingPointError, match="NaN in the output of Attention") as info:
            model(images)
        block = model.aggregator.frame_blocks[1]
        assert any(info.value.module is m for m in block.modules())
    finally:
        TV.enable_nan_debugging(False)
    assert len(nn_module._global_forward_hooks) == n_hooks and not torch.is_anomaly_enabled()
    assert torch.isnan(model(images)["depth"]).any()


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("norm_mode", ["avg_dis", "avg_log1p", "avg_warp-log1p", "median_dis",
                                       "sqrt_dis", "median_log1p"])
@pytest.mark.parametrize("with_valid", [False, True])
def test_normalize_pointcloud_matches_jax(norm_mode, with_valid):
    rng = np.random.default_rng(2)
    pts = rng.normal(size=(3, 5, 6, 3)).astype(np.float32) * 4
    valid = rng.uniform(size=(3, 5, 6)) > 0.4 if with_valid else None
    want, wf = JG.normalize_pointcloud(jnp.asarray(pts), norm_mode, valid, ret_factor=True)
    got, gf = TG.normalize_pointcloud(t(pts), norm_mode, None if valid is None else t(valid),
                                      ret_factor=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(gf.numpy(), np.asarray(wf), atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(TG.normalize_pointcloud(t(pts), norm_mode).numpy(),
                               np.asarray(JG.normalize_pointcloud(jnp.asarray(pts), norm_mode)),
                               atol=1e-6, rtol=1e-5)


def test_geometry_helpers_match_jax():
    rng = np.random.default_rng(3)
    P1, P2 = rng.normal(size=(200, 3)), rng.normal(size=(150, 3))
    for a, b in zip(TG.find_reciprocal_matches(P1, P2), JG.find_reciprocal_matches(P1, P2)):
        np.testing.assert_array_equal(a, b)
    poses = [np.eye(4) + np.pad(rng.normal(size=(3, 1)), ((0, 1), (3, 0))) for _ in range(5)]
    assert TG.get_med_dist_between_poses(poses) == JG.get_med_dist_between_poses(poses)

    T = rng.normal(size=(4, 4)).astype(np.float32)
    T[3] = [0, 0, 0, 1]
    Tb = rng.normal(size=(2, 4, 4)).astype(np.float32)
    cases = [
        (T, rng.normal(size=(7, 3)), {}),
        (T[:3, :3], rng.normal(size=(7, 3)), {}),
        (Tb, rng.normal(size=(2, 5, 6, 3)), {}),
        (Tb, rng.normal(size=(2, 3)), {}),
        (T, rng.normal(size=(4, 3)), {"norm": 1}),
        (T, rng.normal(size=(4, 3)), {"norm": 2.0, "ncol": 2}),
    ]
    for Trf, pts, kw in cases:
        pts = pts.astype(np.float32)
        np.testing.assert_allclose(TG.geotrf(t(Trf), t(pts), **kw).numpy(),
                                   np.asarray(JG.geotrf(Trf, pts, **kw)), atol=1e-6, rtol=1e-5)


# ---------------------------------------------------------------------------
# SwiGLU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ffn_layer", ["swiglu", "swiglufused"])
@pytest.mark.parametrize("trunk_quant", ["none", "int8"])
def test_swiglu_block_matches_jax(ffn_layer, trunk_quant):
    dim, heads = 64, 2
    p = jax.tree.map(np.asarray, jax.jit(
        lambda k: JL.block_init(k, dim, heads, init_values=0.5, ffn_layer=ffn_layer)
    )(jax.random.PRNGKey(0)))
    blk = TL.Block(dim, heads, init_values=0.5, ffn_layer=ffn_layer)
    e = StateDictEmitter()
    e.block("b", p)
    blk.load_state_dict(e.state_dict(strip_prefix="b."), strict=True)
    hidden = int(dim * 4.0)
    want_hidden = JL.swiglu_hidden_fused(hidden) if ffn_layer == "swiglufused" else hidden
    assert blk.mlp.w3.in_features == want_hidden == TL.swiglu_hidden_fused(hidden) or ffn_layer == "swiglu"
    x = np.random.default_rng(4).normal(size=(2, 10, dim)).astype(np.float32)
    ref = jax.jit(lambda p, x: JL.block(p, x, num_heads=heads, int8_dense=trunk_quant))(p, x)
    with torch.no_grad():
        out = TL.block(blk, t(x), int8_dense=trunk_quant)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=1e-4)


@pytest.mark.parametrize("ffn_layer", ["swiglu", "swiglufused"])
def test_swiglu_dinov2_matches_jax(ffn_layer):
    """A 2-block SwiGLU DINOv2 with the port's seeded weights, handed to the
    JAX package through its own converter (`_dinov2(..., swiglu=True)`)."""
    kw = dict(img_size=28, embed_dim=64, depth=2, num_heads=2, ffn_layer=ffn_layer)
    jcfg, tcfg = JC.DinoV2Config(**kw), TC.DinoV2Config(**kw)
    vit = TD.DinoVisionTransformer(tcfg)
    TM.init_weights(vit, torch.Generator().manual_seed(0))
    sd = {f"d.{k}": v.detach().numpy() for k, v in vit.state_dict().items()}
    c = JCk._Consumer(sd)
    params = JCk._dinov2(c, "d", tcfg.depth, tcfg.num_register_tokens, swiglu=True)
    assert not c.sd  # every tensor consumed
    assert np.asarray(params["blocks"]["mlp"]["w12"]["w"]).shape[-1] == 2 * vit.blocks[0].mlp.w3.in_features
    x = np.random.default_rng(5).normal(size=(2, 28, 42, 3)).astype(np.float32)
    ref = jax.jit(JD.apply, static_argnums=2)(params, jnp.asarray(x), jcfg)
    with torch.no_grad():
        out = TD.apply(vit, t(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=1e-4)


def test_unknown_ffn_layer_raises():
    with pytest.raises(NotImplementedError):
        TL.Block(64, 2, ffn_layer="moe")


# ---------------------------------------------------------------------------
# the model: aa_order, the top-level API, TF32
# ---------------------------------------------------------------------------


def test_aa_order_global_first_matches_jax():
    jcfg, tcfg, params, model = tiny_pair(seed=0)
    order = ("global", "frame")
    jcfg = dataclasses.replace(jcfg, aggregator=dataclasses.replace(jcfg.aggregator, aa_order=order))
    tcfg2 = dataclasses.replace(tcfg, aggregator=dataclasses.replace(tcfg.aggregator, aa_order=order))
    flipped = TM.OmniVGGT(tcfg2, device="cpu", seed=None)
    flipped.load_state_dict(model.state_dict(), strict=True)
    rng = np.random.default_rng(6)
    images = rng.uniform(size=(1, 3, 28, 28, 3)).astype(np.float32)
    kw = gt_inputs(rng, 3, 28, camera_gt_index=[0], depth_gt_index=[2])
    out_j = jax.jit(lambda p, x, aux: JM.apply(p, x, jcfg, aux))(
        params, jnp.asarray(images), JM.make_aux(3, **kw))
    with torch.inference_mode():
        out_t = flipped.eval()(images[0], **kw)
        default = model(images[0], **kw)
    assert_outputs_close(out_j, out_t)
    assert not torch.equal(out_t["depth"], default["depth"])  # the order matters


def test_top_level_api_names():
    import omnivggt_tpu as jpkg
    import omnivggt_tpu_torch as pkg
    from omnivggt_tpu_torch import data, serving
    from omnivggt_tpu_torch.data import dataset, loader, streaming
    from omnivggt_tpu_torch.models import aggregator

    where = {"OmniVGGT": TM, "AuxInputs": aggregator, "InferenceSession": serving, "serve": serving,
             "load_images_and_cameras": loader, "load_and_preprocess_images": loader,
             "SceneDataset": dataset, "ShardedSampleStream": streaming}
    for name, mod in where.items():
        assert getattr(pkg, name) is getattr(mod, name), name
        assert hasattr(jpkg, name), name
    for name in jpkg.__all__:
        assert getattr(pkg, name) is (getattr(TC, name) if hasattr(TC, name) else TM.OmniVGGT)
    assert data.loader is loader
    with pytest.raises(AttributeError):
        pkg.not_a_name


def test_serve_example_tiny():
    from omnivggt_tpu_torch.examples import serve

    preds, glb = serve.main(["--tiny"])
    assert preds["depth"].shape == (3, 28, 28, 1) and glb[:4] == b"glTF"


@pytest.fixture
def tf32_on():
    """Both TF32 switches on, as a caller may set them; restored after."""
    saved = TPl.tf32_switches()
    TPl.set_tf32(True)
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def test_forward_runs_without_tf32_whatever_the_switches(tf32_on, monkeypatch):
    """Inside OmniVGGT.forward every F.conv2d (the DPT heads) and F.linear
    (the camera head, the trunk) sees both switches off; the caller's
    switches are back on after it."""
    seen = []

    def spy(real):
        def fn(*a, **kw):
            seen.append((real.__name__, TPl.tf32_switches()))
            return real(*a, **kw)
        return fn

    monkeypatch.setattr(F, "conv2d", spy(F.conv2d))
    monkeypatch.setattr(F, "linear", spy(F.linear))
    _, _, _, model = tiny_pair(seed=0)
    with torch.inference_mode():
        model(torch.rand(2, 28, 28, 3))
    names = {n for n, _ in seen}
    assert {"conv2d", "linear"} <= names
    assert all(s == (False, False) for _, s in seen)
    assert TPl.tf32_switches() == (True, True)


def _scene(root):
    from tests.test_torch_train import _write_scene

    if not root.exists():
        _write_scene(root, n=2)
    return root


CLIS = ["inference", "train", "eval_trajectory", "make_shards", "convert_checkpoint",
        "profile_forward", "quickstart", "serve_example"]


@pytest.mark.parametrize("cli", CLIS)
def test_every_entry_point_turns_tf32_off(cli, tf32_on, tmp_path):
    import importlib

    scene = _scene(tmp_path / "scenes" / "a")
    tiny = ["--tiny", "--device", "cpu"]
    if cli == "inference":
        argv = ["--image_folder", str(scene / "images"), "--no_viewer", "--target_size", "28", *tiny]
        mod = "omnivggt_tpu_torch.inference"
    elif cli == "train":
        argv = ["--data_root", str(scene.parent), "--steps", "1", "--views", "2",
                "--target_size", "28", "--ckpt_dir", str(tmp_path / "run"), *tiny]
        mod = "omnivggt_tpu_torch.tools.train"
    elif cli == "eval_trajectory":
        traj = tmp_path / "t.txt"
        traj.write_text("\n".join(f"{i} {i * 0.1} 0 0 0 0 0 1" for i in range(4)))
        argv = ["--pred", str(traj), "--gt", str(traj)]
        mod = "omnivggt_tpu_torch.tools.eval_trajectory"
    elif cli == "make_shards":
        argv = ["--data_root", str(scene.parent), "--out", str(tmp_path / "shards"),
                "--num_samples", "1", "--views", "2", "--target_size", "28"]
        mod = "omnivggt_tpu_torch.tools.make_shards"
    elif cli == "convert_checkpoint":
        src = tmp_path / "ref.safetensors"
        from omnivggt_tpu_torch.checkpoint import write_safetensors

        write_safetensors(str(src), TM.OmniVGGT(TC.tiny_test_config(), device="cpu").state_dict())
        argv = [str(src), str(tmp_path / "out"), "--head_dtype", "float32", *tiny]
        mod = "omnivggt_tpu_torch.tools.convert_checkpoint"
    elif cli == "profile_forward":
        argv = ["--size", "28", "--views", "1", "--logdir", str(tmp_path / "tr"), *tiny]
        mod = "omnivggt_tpu_torch.tools.profile_forward"
    elif cli == "quickstart":
        argv = [str(scene / "images"), "--target_size", "28", "--out", str(tmp_path / "s.glb"), *tiny]
        mod = "omnivggt_tpu_torch.examples.quickstart"
    else:
        argv = ["--tiny"]
        mod = "omnivggt_tpu_torch.examples.serve"
    importlib.import_module(mod).main(argv)
    assert TPl.tf32_switches() == (False, False)


def test_ensure_platform_needs_cuda_unless_the_cpu_is_asked_for(tf32_on):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TPl.ensure_platform()
    assert TPl.ensure_platform("cpu") == torch.device("cpu")
    assert TPl.tf32_switches() == (False, False)
    with TPl.exact_fp32():
        TPl.set_tf32(True)  # a change inside the block does not outlive it
    assert TPl.tf32_switches() == (False, False)
