"""Module parity of the PyTorch port with the JAX package: DINOv2, the
aggregator (with and without GT injection), the camera head, a DPT head;
plus the weight bridge both ways and the bf16 trunk cast. Weights come from
the JAX package's init; tolerance: the JAX suite's module ATOL (5e-4)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from omnivggt_tpu import checkpoint as JCk
from omnivggt_tpu import config as JC
from omnivggt_tpu.models import aggregator as JA
from omnivggt_tpu.models import camera_head as JCH
from omnivggt_tpu.models import dinov2 as JD
from omnivggt_tpu.models import dpt_head as JDH
from omnivggt_tpu.models import omnivggt as JM
from omnivggt_tpu_torch import config as TC
from omnivggt_tpu_torch.checkpoint import StateDictEmitter, cast_trunk_params
from omnivggt_tpu_torch.models import aggregator as TA
from omnivggt_tpu_torch.models import camera_head as TCH
from omnivggt_tpu_torch.models import dinov2 as TD
from omnivggt_tpu_torch.models import dpt_head as TDH
from omnivggt_tpu_torch.models import omnivggt as TM
from tests.torch_port_util import ATOL, gt_inputs, jax_init, t, tiny_pair


def _noisy(tree, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: (x + scale * rng.normal(size=x.shape)).astype(np.float32), tree)


def _close(out_t, out_j, atol=ATOL):
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), atol=atol, rtol=1e-4)


@pytest.fixture(scope="module")
def tiny():
    return tiny_pair(seed=0)


@pytest.mark.parametrize("hw", [(28, 28), (28, 42)])
def test_dinov2(hw):
    """Embed 128, depth 2, 2 heads at 28 px: the pos-embed is bicubically
    resampled for the non-square grid, and pad_tokens pads 1+4+gh*gw tokens
    to a multiple of 8 with a static valid-key prefix."""
    jcfg = JC.DinoV2Config(img_size=28, embed_dim=128, depth=2, num_heads=2)
    tcfg = TC.DinoV2Config(img_size=28, embed_dim=128, depth=2, num_heads=2)
    p = _noisy(jax_init(JD.init, 0, jcfg), 0)
    vit = TD.DinoVisionTransformer(tcfg)
    e = StateDictEmitter()
    e.dinov2("d", p, tcfg.depth)
    vit.load_state_dict(e.state_dict(strip_prefix="d."), strict=True)
    x = np.random.default_rng(1).normal(size=(2, *hw, 3)).astype(np.float32)
    for pad in (True, False):
        ref = jax.jit(JD.apply, static_argnums=2, static_argnames="pad_tokens")(
            p, jnp.asarray(x), jcfg, pad_tokens=pad
        )
        out = TD.apply(vit, t(x), pad_tokens=pad)
        assert out.shape == (2, (hw[0] // 14) * (hw[1] // 14), 128)
        _close(out, ref)


@pytest.mark.parametrize("gt", ["none", "camera", "depth", "both"])
def test_aggregator(tiny, gt):
    jcfg, tcfg, params, model = tiny
    rng = np.random.default_rng(2)
    S = 3
    images = rng.uniform(size=(1, S, 28, 28, 3)).astype(np.float32)
    kw = gt_inputs(
        rng, S, 28,
        camera_gt_index=[0, 2] if gt in ("camera", "both") else None,
        depth_gt_index=[1] if gt in ("depth", "both") else None,
    )
    aux_j = JM.make_aux(S, **kw)
    aux_t = TM.make_aux(S, **kw)
    layers = (0, 1)
    buf = jax.jit(
        lambda p, x, aux: JA.apply(p, x, jcfg.aggregator, aux, output_layers=layers)[0]
    )(params["aggregator"], jnp.asarray(images), aux_j)
    psi_j = jcfg.aggregator.patch_start_idx
    outs, psi_t = TA.apply(model.aggregator, t(images), aux_t, output_layers=layers)
    assert psi_j == psi_t
    for i, layer in enumerate(layers):
        _close(outs[layer], buf[i])


def test_masked_normalize_extrinsics_and_depth():
    rng = np.random.default_rng(3)
    from tests.torch_port_util import random_cameras

    ext, _ = random_cameras(rng, 2, 4)
    mask = np.array([[False, True, True, True], [True, False, False, False]])
    _close(TA.masked_normalize_extrinsics(t(ext), t(mask)),
           JA.masked_normalize_extrinsics(jnp.asarray(ext), jnp.asarray(mask)), atol=1e-5)
    depth = rng.uniform(0.5, 5, size=(2, 4, 6, 6, 1)).astype(np.float32)
    valid = (rng.uniform(size=(2, 4, 6, 6)) > 0.3).astype(np.float32)
    fmask = np.array([[True, False, True, False], [False, False, False, False]])
    _close(TA.masked_normalize_depth(t(depth), t(valid), t(fmask)),
           JA.masked_normalize_depth(jnp.asarray(depth), jnp.asarray(valid), jnp.asarray(fmask)),
           atol=1e-5)


def test_camera_head(tiny):
    jcfg, tcfg, params, model = tiny
    ch = _noisy(params["camera_head"], 4)
    e = StateDictEmitter()
    e.blocks("trunk", ch["trunk"], tcfg.camera_head.trunk_depth)
    for name in ("token_norm", "trunk_norm"):
        e.norm(name, ch[name])
    e.raw("empty_pose_tokens", ch["empty_pose_tokens"])
    e.linear("embed_pose", ch["embed_pose"])
    e.linear("poseLN_modulation.1", ch["poseLN_modulation"])
    e.linear("pose_branch.fc1", ch["pose_branch"]["fc1"])
    e.linear("pose_branch.fc2", ch["pose_branch"]["fc2"])
    head = TCH.CameraHead(tcfg.camera_head)
    head.load_state_dict(e.state_dict(), strict=True)
    tokens = np.random.default_rng(5).normal(size=(2, 3, 9, 128)).astype(np.float32)
    ref = jax.jit(JCH.apply, static_argnums=2)(ch, jnp.asarray(tokens), jcfg.camera_head)
    out = TCH.apply(head, t(tokens))
    assert out.shape == (4, 2, 3, 9)
    _close(out, ref)


@pytest.mark.parametrize("chunk", [8, 2])
def test_dpt_head(chunk):
    """A DPT head on 5 frames, whole and in chunks of 2 (ragged last chunk)."""
    kw = dict(dim_in=64, output_dim=4, activation="inv_log", features=16,
              out_channels=(16, 32, 64, 64), intermediate_layer_idx=(0, 1, 2, 3),
              frames_chunk_size=chunk)
    jcfg, tcfg = JC.DPTHeadConfig(**kw), TC.DPTHeadConfig(**kw)
    p = _noisy(jax_init(JDH.init, 6, jcfg), 6)
    head = TDH.DPTHead(tcfg)
    e = StateDictEmitter()
    e.dpt_head("h", p)
    head.load_state_dict(e.state_dict(strip_prefix="h."), strict=True)
    psi, hw = 5, (28, 42)
    P = psi + (hw[0] // 14) * (hw[1] // 14)
    buf = np.random.default_rng(7).normal(size=(4, 1, 5, P, 64)).astype(np.float32)
    pts_j, conf_j = jax.jit(JDH.apply, static_argnums=(2, 3, 4, 5))(
        p, jnp.asarray(buf), jcfg, hw, psi, (0, 1, 2, 3)
    )
    pts_t, conf_t = TDH.apply(head, [t(b) for b in buf], hw, psi)
    assert pts_t.shape == (1, 5, *hw, 3) and conf_t.shape == (1, 5, *hw)
    _close(pts_t, pts_j)
    _close(conf_t, conf_j)


def test_uv_pos_embed_matches_numpy_table():
    for w, h, c in ((37, 37, 128), (6, 4, 16)):
        ref = JDH._uv_pos_embed_np(w, h, c, 518 / 392)
        out = TDH._uv_pos_embed(w, h, c, 518 / 392, "cpu").permute(1, 2, 0)
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-6)


def test_state_dict_round_trips_through_convert_state_dict(tiny):
    """Port state_dict -> numpy -> the JAX package's strict converter gives
    back the original JAX parameters leaf for leaf: the port uses the
    reference's state-dict names, with nothing missing or left over."""
    jcfg, tcfg, params, model = tiny
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    back = JCk.convert_state_dict(sd, jcfg)
    leaves_a = jax.tree_util.tree_leaves_with_path(params)
    leaves_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in leaves_a] == [p for p, _ in leaves_b]
    for (path, a), (_, b) in zip(leaves_a, leaves_b):
        np.testing.assert_array_equal(np.asarray(b), a, err_msg=jax.tree_util.keystr(path))


def test_dinov2_state_dict_round_trips():
    """The DINOv2 embedder's names, through the JAX package's strict
    converter for that part (_dinov2)."""
    cfg = TC.DinoV2Config(img_size=28, embed_dim=128, depth=2, num_heads=2)
    p = jax_init(JD.init, 2, JC.DinoV2Config(img_size=28, embed_dim=128, depth=2, num_heads=2))
    vit = TD.DinoVisionTransformer(cfg)
    e = StateDictEmitter()
    e.dinov2("d", p, cfg.depth)
    vit.load_state_dict(e.state_dict(strip_prefix="d."), strict=True)
    c = JCk._Consumer({f"d.{k}": v.numpy() for k, v in vit.state_dict().items()})
    back = JCk._dinov2(c, "d", cfg.depth, cfg.num_register_tokens)
    assert not c.sd
    for a, b in zip(jax.tree.leaves(p), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(b), a)


def test_cast_trunk_params_matches_jax(tiny):
    """bf16 storage for the same trunk leaves as the JAX package's cast:
    everything in the aggregator but LayerNorms and the DINOv2 pos_embed.
    Each port tensor's is-bf16 flag goes through the strict converter onto
    the JAX tree's structure and is held against the JAX cast's dtypes."""
    jcfg, tcfg, params, _ = tiny
    model = cast_trunk_params(TM.OmniVGGT(tcfg, device="cpu", seed=0))
    flags = {
        k: np.full(v.shape, float(v.dtype == torch.bfloat16), np.float32)
        for k, v in model.state_dict().items()
    }
    got = JCk.convert_state_dict(flags, jcfg)
    want = JCk.cast_trunk_params(params)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert np.all(np.asarray(a) == float(b.dtype == jnp.bfloat16))
    assert any(v.dtype == torch.bfloat16 for v in model.state_dict().values())


def test_init_weights_is_seeded():
    """Random init from a torch.Generator: the same seed gives the same
    weights, another seed other weights; LayerScale, LayerNorm and the
    zero-initialised adapters take their fixed values."""
    cfg = TC.tiny_test_config()
    a, b, c = (TM.OmniVGGT(cfg, device="cpu", seed=s) for s in (0, 0, 1))
    for (n, x), y, z in zip(a.state_dict().items(), b.state_dict().values(), c.state_dict().values()):
        assert torch.equal(x, y), n
    assert not torch.equal(a.aggregator.frame_blocks[0].attn.qkv.weight,
                           c.aggregator.frame_blocks[0].attn.qkv.weight)
    blk = a.aggregator.frame_blocks[0]
    assert torch.all(blk.ls1.gamma == cfg.aggregator.init_values)
    assert torch.all(blk.norm1.weight == 1) and torch.all(blk.norm1.bias == 0)
    assert all(torch.all(m.weight == 0) for m in a.aggregator.camera_adapters)
    bound = 1 / np.sqrt(cfg.embed_dim)
    assert blk.attn.qkv.weight.abs().max() <= bound


def test_unported_modes_raise():
    """The int8 modes and SwiGLU DINOv2 blocks build now; an ffn_layer no
    package knows and values outside the config's contract keep raising."""
    from omnivggt_tpu_torch.models import dinov2 as TD

    fast = dataclasses.replace(
        TC.tiny_test_config(), trunk_quant="int8", attn_quant="int8", head_quant="int8"
    )
    assert TM.OmniVGGT(fast, device="cpu").config.depth_head.quant == "int8"
    with torch.device("meta"):
        vit = TD.DinoVisionTransformer(dataclasses.replace(TC.vit_small(), ffn_layer="swiglu"))
        assert vit.blocks[0].mlp.w12.out_features == 2 * 4 * 384
        with pytest.raises(NotImplementedError):
            TD.DinoVisionTransformer(dataclasses.replace(TC.vit_small(), ffn_layer="moe"))
    with pytest.raises(ValueError):
        TC.OmniVGGTConfig(attn_quant="int4")
