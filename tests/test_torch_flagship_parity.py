"""The port at the flagship's widths against the JAX package, on the CPU.

OmniVGGTConfig()'s widths: embed 1024 and 16 heads, the whole DINOv2 ViT-L
(24 blocks, registers) as patch_embed="dinov2_vitl14_reg" builds it, the
camera head (2048 wide, trunk depth 4) and both DPT heads (features 256,
out_channels 256-1024). The aggregator is cut to depth 4, the DPT heads
reading layers (0, 1, 2, 3); the slow case runs the whole depth of 24 with
the heads at (4, 11, 17, 23). The port's seeded init goes through
omnivggt_tpu.checkpoint.convert_state_dict into the JAX model (strict: every
tensor used once), both forwards run in fp32 on S=2 frames of 140 px with
camera GT on frames 0 and 1 and depth GT on frame 1, and the outputs are
held to the North star's tolerances (the JAX suite's against the torch
reference, tests/test_full_size_parity.py): pose 2e-3, depth 2e-3 / 1e-3,
points 5e-3 / 1e-3.
"""

import gc

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from omnivggt_tpu import config as JC
from omnivggt_tpu.checkpoint import convert_state_dict
from omnivggt_tpu.models import omnivggt as JM
from omnivggt_tpu_torch import config as TC
from omnivggt_tpu_torch.models import omnivggt as TM

S, HW = 2, 140
CAMERA_GT, DEPTH_GT = [0, 1], [1]


def flagship_config(C, depth):
    """OmniVGGTConfig() of package C in fp32, its aggregator cut to `depth`."""
    if depth == 24:
        return C.OmniVGGTConfig(compute_dtype="float32")
    layers = tuple(range(depth))
    return C.OmniVGGTConfig(
        aggregator=C.AggregatorConfig(depth=depth),
        depth_head=C.DPTHeadConfig(output_dim=2, activation="exp", intermediate_layer_idx=layers),
        point_head=C.DPTHeadConfig(output_dim=4, activation="inv_log",
                                   intermediate_layer_idx=layers),
        compute_dtype="float32",
    )


def request(seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(S, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q.T
    R = np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
                  2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
                  2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
                 -1).reshape(S, 3, 3)
    K = np.zeros((1, S, 3, 3))
    K[..., 0, 0] = K[..., 1, 1] = 120.0
    K[..., 0, 2] = K[..., 1, 2] = HW / 2
    K[..., 2, 2] = 1.0
    return {
        "images": rng.uniform(size=(1, S, HW, HW, 3)).astype(np.float32),
        "extrinsics": np.concatenate([R, rng.normal(size=(S, 3, 1))], -1)[None]
        .astype(np.float32),
        "intrinsics": K.astype(np.float32),
        "depth": rng.uniform(0.5, 5.0, size=(1, S, HW, HW, 1)).astype(np.float32),
        "mask": (rng.uniform(size=(1, S, HW, HW)) > 0.2).astype(np.float32),
    }


@pytest.mark.parametrize("depth", [4, pytest.param(24, marks=pytest.mark.slow)])
def test_flagship_widths_match_the_jax_package(depth):
    tcfg, jcfg = flagship_config(TC, depth), flagship_config(JC, depth)
    req = request()
    gt = dict(extrinsics=req["extrinsics"], intrinsics=req["intrinsics"], depth=req["depth"],
              mask=req["mask"], camera_gt_index=CAMERA_GT, depth_gt_index=DEPTH_GT)
    model = TM.OmniVGGT(tcfg, device="cpu", seed=0).eval()
    with torch.inference_mode():
        out_t = TM.apply(model, torch.from_numpy(req["images"]), tcfg, TM.make_aux(S, **gt))
    out_t = {k: out_t[k].numpy() for k in ("pose_enc", "depth", "world_points")}
    params = convert_state_dict({k: v.numpy() for k, v in model.state_dict().items()}, jcfg)
    del model
    gc.collect()
    out_j = JM.apply(params, jnp.asarray(req["images"]), jcfg, JM.make_aux(S, **gt))
    del params
    gc.collect()

    np.testing.assert_allclose(out_t["pose_enc"], np.asarray(out_j["pose_enc"]), atol=2e-3)
    np.testing.assert_allclose(out_t["depth"], np.asarray(out_j["depth"]), atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(out_t["world_points"], np.asarray(out_j["world_points"]),
                               atol=5e-3, rtol=1e-3)
