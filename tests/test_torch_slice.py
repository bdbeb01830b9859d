"""The ported inference slice as a whole: the tiny model's forward in the
PyTorch port against omnivggt_tpu.models.omnivggt.apply, for every GT
subset, and with the JAX side running its Pallas flash kernels (interpret
mode) while the port runs the "flash" dispatch (the kernels' plain versions
on the CPU). Tolerance: ATOL 5e-4 / rtol 1e-4 (tests/test_models.py)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from omnivggt_tpu.models import omnivggt as JM
from omnivggt_tpu.ops import attention as JAttn
from omnivggt_tpu_torch.models import omnivggt as TM
from tests.torch_port_util import assert_outputs_close, gt_inputs, pallas_interpret, t, tiny_pair

S = 3


@pytest.fixture(scope="module")
def tiny():
    return tiny_pair(seed=0)


def _images(seed, S=S, hw=28):
    return np.random.default_rng(seed).uniform(size=(1, S, hw, hw, 3)).astype(np.float32)


@pytest.mark.parametrize("gt", ["none", "camera", "depth", "both"])
def test_forward_matches_jax_for_each_gt_subset(tiny, gt):
    jcfg, tcfg, params, model = tiny
    rng = np.random.default_rng(10)
    images = _images(11)
    kw = gt_inputs(
        rng, S, 28,
        camera_gt_index=[0, 1] if gt in ("camera", "both") else None,
        depth_gt_index=[1, 2] if gt in ("depth", "both") else None,
    )
    aux_j = JM.make_aux(S, **kw)
    out_j = jax.jit(lambda p, x, aux: JM.apply(p, x, jcfg, aux))(params, jnp.asarray(images), aux_j)
    with torch.inference_mode():
        # the user-facing entry point: reference-style keywords
        out_t = model(images[0], **{k: v for k, v in kw.items()})
    assert_outputs_close(out_j, out_t)
    np.testing.assert_allclose(
        out_t["pose_enc_list"].numpy(), np.asarray(out_j["pose_enc_list"]), atol=5e-4, rtol=1e-4
    )


@pytest.mark.parametrize(
    "embed_dim,num_heads,kernel",
    [(64, 2, "head-major"), (128, 2, "packed")],
)
def test_forward_matches_jax_flash_kernels(embed_dim, num_heads, kernel):
    """attn_impl="flash" on both sides. D=32 (tiny default) sends the JAX
    package's frame and global attention through the head-major
    _flash_kernel; embed 128 / 2 heads (D=64) through the token-major
    _flash_packed_kernel. GT cameras and depth on some frames."""
    jcfg, tcfg, params, model = tiny_pair(seed=1, embed_dim=embed_dim, num_heads=num_heads)
    D = embed_dim // num_heads
    eligible = JAttn.packed_eligible((S, 9, num_heads, D), 9)
    assert eligible == (kernel == "packed")
    rng = np.random.default_rng(12)
    images = _images(13)
    kw = gt_inputs(rng, S, 28, camera_gt_index=[0, 2], depth_gt_index=[1])
    aux_j = JM.make_aux(S, **kw)
    aux_t = TM.make_aux(S, **kw)
    with pallas_interpret():
        out_j = jax.jit(lambda p, x, aux: JM.apply(p, x, jcfg, aux, attn_impl="flash"))(
            params, jnp.asarray(images), aux_j
        )
    with torch.inference_mode():
        out_t = TM.apply(model, t(images), tcfg, aux_t, attn_impl="flash")
    assert_outputs_close(out_j, out_t)
