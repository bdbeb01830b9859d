"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and go through both packages; the
port's weights come from the JAX package's `init` through
omnivggt_tpu_torch.checkpoint.params_from_jax.
"""

import functools
from unittest import mock

import jax
import jax.experimental.pallas as pl
import numpy as np
import torch

from omnivggt_tpu import config as JC
from omnivggt_tpu.models import omnivggt as JM
from omnivggt_tpu_torch import config as TC
from omnivggt_tpu_torch.checkpoint import params_from_jax
from omnivggt_tpu_torch.models import omnivggt as TM

ATOL = 5e-4  # the JAX suite's module tolerance (tests/test_models.py)
OUTPUT_KEYS = ("pose_enc", "depth", "depth_conf", "world_points", "world_points_conf")


def pallas_interpret():
    """Run every pl.pallas_call in interpret mode, as tests/test_ops.py does."""
    return mock.patch.object(
        pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def t(x):
    return torch.from_numpy(np.array(x))


def jax_init(init_fn, seed, cfg):
    """A JAX package init under one jit (eager init compiles op by op),
    returned as numpy."""
    return to_np(jax.jit(init_fn, static_argnums=1)(jax.random.PRNGKey(seed), cfg))


def tiny_pair(seed=0, **kw):
    """(jax cfg, port cfg, JAX params as numpy, port model loaded from them)
    for tiny_test_config(**kw)."""
    jcfg, tcfg = JC.tiny_test_config(**kw), TC.tiny_test_config(**kw)
    params = jax_init(JM.init, seed, jcfg)
    model = TM.OmniVGGT(tcfg, seed=None)
    model.load_state_dict(params_from_jax(params, tcfg), strict=True)
    return jcfg, tcfg, params, model.eval()


def random_cameras(rng, B, S):
    """World-to-camera extrinsics from random unit quaternions, and pinhole
    intrinsics, as float32 numpy."""
    q = rng.normal(size=(B, S, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    x, y, z, w = np.moveaxis(q, -1, 0)
    R = np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
        2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
        2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y),
    ], -1).reshape(B, S, 3, 3)
    ext = np.concatenate([R, rng.normal(size=(B, S, 3, 1))], axis=-1)
    K = np.zeros((B, S, 3, 3))
    K[..., 0, 0] = rng.uniform(20, 40, size=(B, S))
    K[..., 1, 1] = rng.uniform(20, 40, size=(B, S))
    K[..., 0, 2] = K[..., 1, 2] = 14.0
    K[..., 2, 2] = 1.0
    return ext.astype(np.float32), K.astype(np.float32)


def gt_inputs(rng, S, hw, camera_gt_index=None, depth_gt_index=None):
    """Reference-style GT keyword arguments for S frames of hw x hw."""
    ext, K = random_cameras(rng, 1, S)
    depth = rng.uniform(0.5, 5.0, size=(1, S, hw, hw, 1)).astype(np.float32)
    mask = (rng.uniform(size=(1, S, hw, hw)) > 0.2).astype(np.float32)
    return dict(
        extrinsics=ext, intrinsics=K, depth=depth, mask=mask,
        camera_gt_index=camera_gt_index, depth_gt_index=depth_gt_index,
    )


def assert_outputs_close(out_j, out_t, atol=ATOL, rtol=1e-4):
    for key in OUTPUT_KEYS:
        a, b = np.asarray(out_j[key]), out_t[key].detach().numpy()
        assert a.shape == b.shape, (key, a.shape, b.shape)
        np.testing.assert_allclose(b, a, atol=atol, rtol=rtol, err_msg=key)
