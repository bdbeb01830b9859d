"""The certified fast serving modes of the port against the JAX package on
the CPU, at a tiny size: the forward under every ladder candidate config,
int8 attention scores and the streaming kernel through the model, padded
frames (num_valid_frames) and the DPT heads' probe flags. The ladder
itself is in tests/test_torch_ladder.py.

The tiny model here has the JAX package's init as its weights: the int8
forms are held to 5e-4, which assumes both packages put every quantised
value on the same grid point, and on these weights they do.
"""

import functools

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from omnivggt_tpu.models import dpt_head as JDH
from omnivggt_tpu.models import omnivggt as JM
from omnivggt_tpu.ops import attention as JA
from omnivggt_tpu_torch import config as TC
from omnivggt_tpu_torch.models import dpt_head as TDH
from omnivggt_tpu_torch.models import omnivggt as TM
from omnivggt_tpu_torch.ops import attention as TA
from omnivggt_tpu_torch.train import step as TTS
from tests.torch_port_util import ATOL, OUTPUT_KEYS, pallas_interpret, t, tiny_pair

# bf16 heads: both packages round every head activation to bf16 (8 bits of
# significand), but not at the same places (torch's interpolation and
# convolutions accumulate in fp32 and round once; the JAX head rounds after
# each primitive). The dense outputs leave the head through fp32
# activations and agree to 4e-3. pose_enc is the bf16 camera head's own
# output: two bf16 values that differ, differ by a whole bf16 step, so its
# tolerance is one step at the largest entry of the reference,
# 2^(floor(log2 max|pose_enc|) - 7): 2^-6 = 1.5625e-2 on the tiny model,
# whose pose_enc reaches 2.41 (the readings are one step at [1, 2), 7.8e-3)
BF16_HEAD_ATOL = {"depth": 4e-3, "depth_conf": 4e-3,
                  "world_points": 4e-3, "world_points_conf": 4e-3}


def _bf16_step(ref) -> float:
    """The spacing of bf16 values at the largest magnitude in ref."""
    return float(2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7))


# the ladder's candidates, most aggressive first, the upgrades it probes,
# and the fallback
CANDIDATES = {
    "int8": dict(head_dtype="bfloat16", approx_gelu=True, trunk_quant="int8"),
    "int8_ln": dict(head_dtype="bfloat16", approx_gelu=True, trunk_quant="int8_ln"),
    "bf16_tanh": dict(head_dtype="bfloat16", approx_gelu=True),
    "bf16": dict(head_dtype="bfloat16"),
    "parity": dict(),
    "int8_fp32_heads": dict(approx_gelu=True, trunk_quant="int8"),
    "int8_all": dict(approx_gelu=True, trunk_quant="int8", attn_quant="int8", head_quant="int8"),
    "head_quant": dict(head_quant="int8"),
}


@pytest.fixture(scope="module")
def pair():
    return tiny_pair(seed=0, weights="jax")


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(0).uniform(size=(1, 3, 28, 28, 3)).astype(np.float32)


def _port(pair, images, modes, nv=None, attn_impl="auto"):
    _, tcfg, _, model = pair
    nv_t = None if nv is None else torch.tensor(nv, dtype=torch.int32)
    with torch.no_grad():
        return TM.apply(model, t(images), dataclasses.replace(tcfg, **modes),
                        attn_impl=attn_impl, num_valid_frames=nv_t)


@functools.lru_cache(maxsize=None)
def _jax_forward(jc, attn_impl):
    """The JAX forward under one config, jitted once per module run (the
    tests share it across their cases)."""
    return jax.jit(lambda p, x, n: JM.apply(p, x, jc, attn_impl=attn_impl, num_valid_frames=n))


def _both(pair, images, modes, nv=None, attn_impl="auto"):
    jcfg, _, params, _ = pair
    jc = dataclasses.replace(jcfg, **modes)
    nv_j = None if nv is None else jnp.int32(nv)
    with pallas_interpret():
        out_j = _jax_forward(jc, attn_impl)(params, jnp.asarray(images), nv_j)
    return out_j, _port(pair, images, modes, nv, attn_impl)


def _assert_close(out_j, out_t, modes, valid=None):
    for key in OUTPUT_KEYS:
        a, b = np.asarray(out_j[key])[:, :valid], out_t[key].numpy()[:, :valid]
        atol = ATOL
        if modes.get("head_dtype") == "bfloat16":
            atol = _bf16_step(a) if key == "pose_enc" else BF16_HEAD_ATOL[key]
        np.testing.assert_allclose(b, a, atol=atol, rtol=1e-4, err_msg=key)


@pytest.mark.parametrize("name", list(CANDIDATES))
def test_forward_under_each_candidate_matches_jax(pair, images, name):
    """The tiny model under every config the ladder can try or return:
    5e-4 with fp32 heads, the int8 modes included (both packages land on
    the same int8 grids, so the quantisation error is common to them);
    bf16 heads to a few bf16 steps."""
    modes = CANDIDATES[name]
    out_j, out_t = _both(pair, images, modes)
    _assert_close(out_j, out_t, modes)
    if name != "parity":
        # the mode does something: the output moved off the parity forward
        parity = _port(pair, images, {})
        assert max(float((out_t[k] - parity[k]).abs().max()) for k in OUTPUT_KEYS) > 0


@pytest.mark.parametrize(
    "modes,weights",
    [(dict(attn_quant="int8"), "jax"),
     (dict(attn_quant="int8", trunk_quant="int8", approx_gelu=True), "jax"),
     (dict(attn_quant="int8", trunk_quant="int8", approx_gelu=True), "port")],
    ids=["attn_quant", "attn_and_trunk_quant", "attn_and_trunk_quant-port_weights"])
@pytest.mark.parametrize("nv", [None, 2])
def test_int8_scores_through_the_model_match_jax(pair, images, modes, weights, nv):
    """attn_impl="flash": every attention of the tiny model (head dim 32)
    runs the head-major kernel's int8 form, Pallas in interpret mode there
    and the plain int8 version here, with padded frames left out of the
    quantisers' scales (nv = 2 of 3 frames). Also on the port's own seed-0
    init (weights="port"), whose int8 steps land where XLA's jitted
    multiplication by fp32(1/127) puts them only since the port multiplies
    too (a true division read pose 1.24e-2 there)."""
    if weights == "port":
        pair = tiny_pair(seed=0, weights="port")
    out_j, out_t = _both(pair, images, modes, nv=nv, attn_impl="flash")
    _assert_close(out_j, out_t, modes, valid=nv)
    # int8 scores are in use: the result differs from the bf16-score forward
    plain = _port(pair, images, {k: v for k, v in modes.items() if k != "attn_quant"},
                  nv=nv, attn_impl="flash")
    assert float((out_t["pose_enc"] - plain["pose_enc"]).abs().max()) > 0


@pytest.mark.parametrize("attn_quant", ["int8"])
def test_stream_flag_routes_global_attention_like_jax(images, attn_quant, monkeypatch):
    """With the stream flag on (and the packed kernel's key budget cut so
    the tiny global attention exceeds it), global attention runs the
    streaming kernel in both packages: head dim 64, bounded softmax, a
    dynamic valid prefix, the int8 form (the bf16 form is held against the
    Pallas kernel in tests/test_torch_serving_kernels.py)."""
    from omnivggt_tpu import config as JC
    from omnivggt_tpu.checkpoint import convert_state_dict

    kw = dict(embed_dim=128, num_heads=2)  # head dim 64: stream-eligible
    jcfg, tcfg = JC.tiny_test_config(**kw), TC.tiny_test_config(**kw)
    model = TM.OmniVGGT(tcfg, device="cpu", seed=1).eval()
    with torch.no_grad():  # LayerScale at 1: the attention outputs count
        for name, prm in model.named_parameters():
            if name.endswith(".gamma"):
                prm.fill_(1.0)
    params = convert_state_dict({k: v.numpy() for k, v in model.state_dict().items()}, jcfg)
    modes = dict(attn_quant=attn_quant)
    for mod, name in ((JA, "_PACKED_MAX_KEYS"), (TA, "PACKED_MAX_KEYS")):
        monkeypatch.setattr(mod, name, 16)
    monkeypatch.setattr(JA, "_STREAM_ATTN", True)
    monkeypatch.setattr(TA, "_STREAM_ATTN", True)
    streamed = []
    stream = TA.flash_attention_packed_stream
    monkeypatch.setattr(TA, "flash_attention_packed_stream",
                        lambda *a, **k: (streamed.append(k.get("qk_int8")), stream(*a, **k))[1])
    jax.clear_caches()  # the dispatch is decided at trace time
    out_j, out_t = _both((jcfg, tcfg, params, model), images, modes, nv=2, attn_impl="flash")
    jax.clear_caches()
    assert streamed == [attn_quant == "int8"] * tcfg.aggregator.depth
    _assert_close(out_j, out_t, modes, valid=2)


@pytest.mark.parametrize("name", ["parity", "int8", "int8_all"])
def test_padded_forward_matches_jax_and_the_unpadded_forward(pair, images, name):
    """num_valid_frames = 2 of 3: the two real frames agree with the JAX
    package's masked forward and, in fp32, with the forward of the two
    frames alone (atol 2e-5, the JAX serving test's), the third frame
    holding other content."""
    modes = CANDIDATES[name]
    out_j, out_t = _both(pair, images, modes, nv=2)
    _assert_close(out_j, out_t, modes, valid=2)
    if modes.get("head_dtype") != "bfloat16":
        alone = _port(pair, images[:, :2], modes)
        for key in OUTPUT_KEYS:
            np.testing.assert_allclose(out_t[key].numpy()[:, :2], alone[key].numpy(),
                                       atol=2e-5, rtol=1e-5, err_msg=key)
    # an int (static) count masks like the device scalar
    jcfg, tcfg, params, model = pair
    with torch.no_grad():
        static = TM.apply(model, t(images), dataclasses.replace(tcfg, **modes), num_valid_frames=2)
    for key in OUTPUT_KEYS:
        np.testing.assert_allclose(static[key].numpy()[:, :2], out_t[key].numpy()[:, :2],
                                   atol=2e-5, err_msg=key)


def test_head_conv_flags_keep_the_jax_names_and_defaults(pair, images, monkeypatch):
    """The two probe flags are off by default under the JAX package's
    variable names; the space-to-depth route gives the plain route's
    output; with the kernel flag on every eligible convolution goes to
    `conv3x3_folded`, with grad mode on as well as off (on the CPU the
    wrapper computes its plain version and launches nothing)."""
    from omnivggt_tpu_torch.ops.kernels import conv3x3 as CK

    assert (TDH._PALLAS_HEAD_CONVS, TDH._S2D_HEAD_CONVS) == (False, False)
    assert (JDH._PALLAS_HEAD_CONVS, JDH._S2D_HEAD_CONVS) == (False, False)
    _, tcfg, _, model = pair
    routed = []
    folded = TDH.conv3x3_folded
    monkeypatch.setattr(TDH, "conv3x3_folded",
                        lambda p, x, relu=False, **kw: (routed.append(torch.is_grad_enabled()),
                                                        folded(p, x, relu=relu, **kw))[1])
    with torch.no_grad():
        base = TM.apply(model, t(images), tcfg)
        monkeypatch.setattr(TDH, "_S2D_HEAD_CONVS", True)
        s2d = TM.apply(model, t(images), tcfg)
        monkeypatch.setattr(TDH, "_S2D_HEAD_CONVS", False)
        assert routed == []
        monkeypatch.setattr(TDH, "_PALLAS_HEAD_CONVS", True)
        flagged = TM.apply(model, t(images), tcfg)
        per_forward = len(routed)
        assert per_forward > 0 and not any(routed)
        # W8A8 head convolutions keep the library route
        TM.apply(model, t(images), dataclasses.replace(tcfg, head_quant="int8"))
        assert len(routed) == per_forward
    # grad mode on (no no_grad around the call): the flag still decides
    with_grad = TM.apply(model, t(images), tcfg)
    assert routed[per_forward:] == [True] * per_forward
    assert CK.conv3x3_folded.launches == 0
    for key in OUTPUT_KEYS:
        np.testing.assert_allclose(s2d[key].numpy(), base[key].numpy(), atol=2e-5, err_msg=key)
        np.testing.assert_array_equal(flagged[key].numpy(), base[key].numpy())
        np.testing.assert_array_equal(with_grad[key].detach().numpy(), base[key].numpy())


def test_training_refuses_the_fast_modes():
    cfg = TC.tiny_test_config()
    for field in ("trunk_quant", "attn_quant", "head_quant"):
        with pytest.raises(ValueError, match="serving-only"):
            TTS.make_train_step(dataclasses.replace(cfg, **{field: "int8"}), None)
