"""Op-level parity of the PyTorch port with the JAX package: RoPE, layers,
attention, resize, activations, camera geometry, the logit-bound check.
Same numpy inputs and weights through both, fp32, tolerance 1e-5."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from omnivggt_tpu.ops import activations as JAct
from omnivggt_tpu.ops import layers as JL
from omnivggt_tpu.ops import resize as JR
from omnivggt_tpu.ops import rope as JRope
from omnivggt_tpu.utils import geometry as JG
from omnivggt_tpu.utils import validation as JV
from omnivggt_tpu_torch.checkpoint import StateDictEmitter
from omnivggt_tpu_torch.ops import activations as TAct
from omnivggt_tpu_torch.ops import layers as TL
from omnivggt_tpu_torch.ops import resize as TR
from omnivggt_tpu_torch.ops import rope as TRope
from omnivggt_tpu_torch.utils import geometry as TG
from omnivggt_tpu_torch.utils import validation as TV
from tests.torch_port_util import random_cameras, t, to_np

OP_ATOL = 1e-5
DIM, HEADS = 64, 4


def _noisy(tree, rng, scale=0.1):
    """Perturb every leaf so LayerNorm affines, LayerScale and biases are
    not at their identity init."""
    return jax.tree.map(lambda x: (x + scale * rng.normal(size=x.shape)).astype(np.float32), tree)


def _block_pair(seed, qk_norm, init_values=0.3):
    rng = np.random.default_rng(seed)
    p = to_np(JL.block_init(
        jax.random.PRNGKey(seed), DIM, HEADS, init_values=init_values, qk_norm=qk_norm
    ))
    p = _noisy(p, rng)
    blk = TL.Block(DIM, HEADS, init_values=init_values, qk_norm=qk_norm)
    e = StateDictEmitter()
    e.block("b", p)
    blk.load_state_dict(e.state_dict(strip_prefix="b."), strict=True)
    return p, blk


def _close(out_t, out_j, atol=OP_ATOL):
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), atol=atol, rtol=1e-5)


def test_rope_tables_and_apply():
    cos_j, sin_j = JRope.rope_tables(3, 5, 5, 32, 100.0)
    cos_t, sin_t = TRope.rope_tables(3, 5, 5, 32, 100.0)
    np.testing.assert_array_equal(cos_t.numpy(), np.asarray(cos_j))
    np.testing.assert_array_equal(sin_t.numpy(), np.asarray(sin_j))
    x = np.random.default_rng(0).normal(size=(2, 20, 3, 32)).astype(np.float32)
    _close(TRope.apply_rope(t(x), cos_t, sin_t), JRope.apply_rope(jnp.asarray(x), cos_j, sin_j))
    tc, ts = TRope.tile_tables(cos_t, sin_t, 3)
    jc, js = JRope.tile_tables(cos_j, sin_j, 3)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_layer_norm_linear_and_mlp():
    p, blk = _block_pair(1, qk_norm=False)
    x = np.random.default_rng(1).normal(size=(2, 7, DIM)).astype(np.float32) * 3 + 1
    _close(TL.layer_norm(blk.norm1, t(x), 1e-6), JL.layer_norm(p["norm1"], jnp.asarray(x), 1e-6))
    _close(TL.layer_norm(None, t(x), 1e-5), JL.layer_norm(None, jnp.asarray(x), 1e-5))
    _close(TL.linear(blk.attn.qkv, t(x)), JL.linear(p["attn"]["qkv"], jnp.asarray(x)))
    for approx in (False, True):
        _close(
            TL.mlp(blk.mlp, t(x), approx_gelu=approx),
            JL.mlp(p["mlp"], jnp.asarray(x), approx_gelu=approx),
        )


@pytest.mark.parametrize("kv_valid", [None, 9, "tensor"])
def test_attention_with_qk_norm_and_rope(kv_valid):
    p, blk = _block_pair(2, qk_norm=True)
    N = 13
    x = np.random.default_rng(2).normal(size=(2, N, DIM)).astype(np.float32)
    cos, sin = TRope.rope_tables(2, 4, 5, DIM // HEADS)
    kv_j = jnp.int32(9) if kv_valid == "tensor" else kv_valid
    kv_t = torch.tensor(9) if kv_valid == "tensor" else kv_valid
    ref = JL.attention(
        p["attn"], jnp.asarray(x), jnp.asarray(cos.numpy()), jnp.asarray(sin.numpy()),
        num_heads=HEADS, impl="xla", kv_valid=kv_j,
    )
    out = TL.attention(blk.attn, t(x), cos, sin, impl="plain", kv_valid=kv_t)
    _close(out, ref)


@pytest.mark.parametrize("qk_norm", [False, True])
def test_block(qk_norm):
    p, blk = _block_pair(3, qk_norm=qk_norm)
    x = np.random.default_rng(3).normal(size=(3, 13, DIM)).astype(np.float32)
    cos, sin = TRope.rope_tables(2, 4, 5, DIM // HEADS)
    rope_j = (jnp.asarray(cos.numpy()), jnp.asarray(sin.numpy())) if qk_norm else (None, None)
    rope_t = (cos, sin) if qk_norm else (None, None)
    for approx in (False, True):
        ref = JL.block(p, jnp.asarray(x), *rope_j, num_heads=HEADS, approx_gelu=approx)
        _close(TL.block(blk, t(x), *rope_t, approx_gelu=approx), ref)


def test_patch_embed_and_conv2d():
    rng = np.random.default_rng(4)
    p = _noisy(to_np(JL.patch_embed_init(jax.random.PRNGKey(4), 7, 3, 16)), rng)
    pe = TL.PatchEmbed(7, 3, 16)
    e = StateDictEmitter()
    e.conv("proj", p["proj"])
    pe.load_state_dict(e.state_dict(), strict=True)
    x = rng.uniform(size=(2, 21, 14, 3)).astype(np.float32)
    _close(TL.patch_embed(pe, t(x)), JL.patch_embed(p, jnp.asarray(x), 7))
    with pytest.raises(ValueError):
        TL.patch_embed(pe, t(x[:, :20]))
    conv = _noisy(to_np(JL.conv_init(jax.random.PRNGKey(5), 3, 3, 4, 6)), rng)
    mod = torch.nn.Conv2d(4, 6, 3)
    e = StateDictEmitter()
    e.conv("c", conv)
    mod.load_state_dict(e.state_dict(strip_prefix="c."))
    y = rng.normal(size=(2, 9, 8, 4)).astype(np.float32)
    ref = JL.conv2d(conv, jnp.asarray(y), stride=(2, 2), padding=((1, 1), (1, 1)))
    out = TL.conv2d(mod, t(y).permute(0, 3, 1, 2), stride=2, padding=1).permute(0, 2, 3, 1)
    _close(out, ref)


@pytest.mark.parametrize(
    "mode,align,antialias,in_hw,out_hw",
    [
        ("bicubic", False, True, (5, 5), (3, 4)),   # DINOv2 pos-embed: downscale
        ("bicubic", False, True, (4, 4), (7, 9)),   # and upscale
        ("bilinear", True, False, (3, 4), (6, 8)),  # DPT fusion pyramid
        ("bilinear", True, False, (6, 5), (14, 14)),
    ],
)
def test_interpolate(mode, align, antialias, in_hw, out_hw):
    x = np.random.default_rng(5).normal(size=(2, *in_hw, 3)).astype(np.float32)
    ref = JR.interpolate(jnp.asarray(x), out_hw, mode=mode, align_corners=align, antialias=antialias)
    out = TR.interpolate(t(x), out_hw, mode=mode, align_corners=align, antialias=antialias)
    _close(out, ref)


@pytest.mark.parametrize(
    "activation", ["norm_exp", "norm", "exp", "relu", "inv_log", "xy_inv_log", "sigmoid", "linear"]
)
@pytest.mark.parametrize("conf_activation", ["expp1", "expp0", "sigmoid"])
def test_activate_head(activation, conf_activation):
    x = np.random.default_rng(6).normal(size=(2, 3, 5, 4)).astype(np.float32)
    ref = JAct.activate_head(jnp.asarray(x), activation, conf_activation)
    out = TAct.activate_head(t(x), activation, conf_activation)
    for a, b in zip(out, ref):
        _close(a, b)


def test_activate_pose():
    x = np.random.default_rng(7).normal(size=(2, 3, 9)).astype(np.float32)
    for acts in (("linear", "linear", "relu"), ("inv_log", "exp", "linear")):
        _close(TAct.activate_pose(t(x), *acts), JAct.activate_pose(jnp.asarray(x), *acts))


def test_pose_codec_and_quaternions():
    rng = np.random.default_rng(8)
    ext, K = random_cameras(rng, 2, 5)
    enc_j = JG.extri_intri_to_pose_encoding(jnp.asarray(ext), jnp.asarray(K), (28, 42))
    enc_t = TG.extri_intri_to_pose_encoding(t(ext), t(K), (28, 42))
    _close(enc_t, enc_j)
    e_j, k_j = JG.pose_encoding_to_extri_intri(enc_j, (28, 42))
    e_t, k_t = TG.pose_encoding_to_extri_intri(enc_t, (28, 42))
    _close(e_t, e_j)
    _close(k_t, k_j)
    np.testing.assert_allclose(e_t.numpy(), ext, atol=1e-5)  # the codec round-trips
    # the four branches of the best-conditioned quaternion pick
    for R in (np.eye(3), np.diag([1.0, -1, -1]), np.diag([-1.0, 1, -1]), np.diag([-1.0, -1, 1])):
        R = R.astype(np.float32)
        _close(TG.mat_to_quat(t(R)), JG.mat_to_quat(jnp.asarray(R)))
    q = rng.normal(size=(4, 4)).astype(np.float32)
    _close(TG.quat_to_mat(t(q)), JG.quat_to_mat(jnp.asarray(q)))


def test_se3_inverse_and_unprojection():
    rng = np.random.default_rng(9)
    ext, K = random_cameras(rng, 1, 3)
    _close(TG.closed_form_inverse_se3(t(ext)), JG.closed_form_inverse_se3(jnp.asarray(ext)))
    homog = TG.expand_extrinsic_to_homog(t(ext))
    np.testing.assert_allclose(
        (homog @ TG.closed_form_inverse_se3(t(ext))).numpy(), np.broadcast_to(np.eye(4), (1, 3, 4, 4)),
        atol=1e-5,
    )
    depth = rng.uniform(0.5, 5, size=(3, 6, 7, 1)).astype(np.float32)
    ref = JG.unproject_depth_map_to_point_map(depth, ext[0], K[0])
    out = TG.unproject_depth_map_to_point_map(depth, ext[0], K[0])
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)
    w_j, c_j, m_j = JG.depth_to_world_coords_points(jnp.asarray(depth[0, ..., 0]), jnp.asarray(ext[0, 0]), jnp.asarray(K[0, 0]))
    w_t, c_t, m_t = TG.depth_to_world_coords_points(t(depth[0, ..., 0]), t(ext[0, 0]), t(K[0, 0]))
    _close(w_t, w_j)
    _close(c_t, c_j)
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))


def test_qk_logit_bound_matches_jax():
    """The bound that gates the fixed-max softmax, on the same weights."""
    p, blk = _block_pair(10, qk_norm=True)
    head_dim = DIM // HEADS
    assert TV.qk_logit_bound(blk, head_dim) == pytest.approx(JV.qk_logit_bound(p, head_dim), rel=1e-6)
    assert TV.check_bounded_logits_safe(blk, head_dim)
    with torch.no_grad():
        blk.attn.q_norm.weight.mul_(30)
    p["attn"]["q_norm"]["scale"] = p["attn"]["q_norm"]["scale"] * 30
    assert TV.qk_logit_bound(blk, head_dim) == pytest.approx(JV.qk_logit_bound(p, head_dim), rel=1e-6)
    assert not TV.check_bounded_logits_safe(blk, head_dim)
    assert not JV.check_bounded_logits_safe(p, head_dim)
