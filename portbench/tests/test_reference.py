"""The plain reference against the program's plain path on the CPU, at the
tiny test configuration, with the benchmark's seeded weights: every output,
with GT cameras and depth and without, through the conv patch embed and
through a small DINOv2."""

import dataclasses

import numpy as np
import pytest
import torch

from omnivggt_tpu_torch.config import tiny_test_config
from omnivggt_tpu_torch.models import omnivggt as M
from portbench.config import arch_of
from portbench.reference.model import OmniVGGT as Reference
from portbench.weights import make_state_dict

torch.set_num_threads(1)


def _inputs(S, size, seed=0):
    gen = np.random.default_rng(seed)
    ex = np.zeros((1, S, 3, 4), np.float32)
    q = gen.normal(size=(S, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    from scipy.spatial.transform import Rotation

    ex[0, :, :, :3] = Rotation.from_quat(q).as_matrix()
    ex[0, :, :, 3] = gen.normal(size=(S, 3))
    K = np.tile(np.array([[30.0, 0, size / 2], [0, 32.0, size / 2], [0, 0, 1]], np.float32),
                (1, S, 1, 1))
    return {
        "images": gen.random((1, S, size, size, 3), np.float32),
        "extrinsics": ex, "intrinsics": K,
        "depth": (0.5 + 2 * gen.random((1, S, size, size, 1))).astype(np.float32),
        "depth_valid": (gen.random((1, S, size, size)) > 0.1).astype(np.float32),
    }


def _pair(cfg, seed=3):
    arch = arch_of(cfg)
    sd = make_state_dict(arch, seed, "cpu")
    prog = M.OmniVGGT(cfg, device="cpu", seed=None)
    prog.load_state_dict(sd, strict=True)
    ref = Reference(arch)
    ref.load_state_dict(sd, strict=True)
    return prog.eval(), ref.eval()


@pytest.mark.parametrize("embed", ["conv", "dinov2_vits14_reg"])
@pytest.mark.parametrize("gt", ["none", "camera", "camera_depth"])
def test_reference_matches_the_program_plain_path(embed, gt):
    if embed == "conv":
        cfg = tiny_test_config()
    else:  # ViT-S/14 with registers, the tanh GELU
        cfg = dataclasses.replace(tiny_test_config(embed_dim=384, num_heads=6, patch_embed=embed),
                                  approx_gelu=True)
    prog, ref = _pair(cfg)
    S, size = 3, cfg.img_size
    x = {k: torch.from_numpy(v) for k, v in _inputs(S, size).items()}
    cam = torch.tensor([[False, True, True]]) if gt != "none" else None
    dep = torch.tensor([[True, False, True]]) if gt == "camera_depth" else None
    aux = M.make_aux(
        S, x["extrinsics"], x["intrinsics"], x["depth"], x["depth_valid"],
        [0, 2] if dep is not None else None, [1, 2] if cam is not None else None)
    with torch.no_grad():
        got = M.apply(prog, x["images"], cfg, aux, attn_impl="plain")
        want = ref(x["images"], x["extrinsics"], x["intrinsics"], x["depth"], x["depth_valid"],
                   cam, dep)
    for key in ("pose_enc", "pose_enc_list", "depth", "depth_conf", "world_points",
                "world_points_conf"):
        g, w = got[key].double(), want[key].double()
        assert g.shape == w.shape, key
        err = ((g - w).abs() / (w.abs() + 1e-3)).max().item()
        assert err < 1e-4, (key, err)
