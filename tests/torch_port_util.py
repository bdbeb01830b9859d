"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and go through both packages. The
tiny models' weights come, by default, from the port's own seeded init and
reach the JAX package through its loader,
omnivggt_tpu.checkpoint.convert_state_dict (lossless, strict): that costs
no compilation, where the JAX package's `init` under jit compiles for ~25 s
per config and process. `weights="jax"` takes the JAX package's init
instead, bridged with params_from_jax. Once made, a config's weights are
kept for the process, and every test gets a fresh model and a fresh copy of
the params.

The tests run in several worker processes at once, each with one torch
thread: the tiny tensors gain nothing from intra-op threads, and a pool of
threads per worker oversubscribes the cores.
"""

import copy
import functools
import json
import socket
import struct
from unittest import mock

import jax
import jax.experimental.pallas as pl
import numpy as np
import torch

import jax.numpy as jnp

from omnivggt_tpu import config as JC
from omnivggt_tpu.checkpoint import convert_state_dict
from omnivggt_tpu.models import omnivggt as JM
from omnivggt_tpu.models.aggregator import AuxInputs as JAux
from omnivggt_tpu.train import losses as JLS
from omnivggt_tpu_torch import config as TC
from omnivggt_tpu_torch.checkpoint import params_from_jax
from omnivggt_tpu_torch.models import omnivggt as TM
from omnivggt_tpu_torch.models.aggregator import AuxInputs as TAux
from omnivggt_tpu_torch.train import losses as TLS
from omnivggt_tpu_torch.train import step as TTS

torch.set_num_threads(1)

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


@functools.lru_cache(maxsize=None)
def _tiny_weights(seed, weights, kw_items):
    """(port state dict, JAX params as numpy) of tiny_test_config(**kw):
    the port's seeded init (weights="port") or the JAX package's
    (weights="jax"), made once per process."""
    kw = dict(kw_items)
    jcfg, tcfg = JC.tiny_test_config(**kw), TC.tiny_test_config(**kw)
    if weights == "jax":
        params = jax_init(JM.init, seed, jcfg)
        return params_from_jax(params, tcfg), params
    model = TM.OmniVGGT(tcfg, device="cpu", seed=seed)
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    return state, to_np(convert_state_dict({k: v.numpy() for k, v in state.items()}, jcfg))


def tiny_pair(seed=0, weights="port", **kw):
    """(jax cfg, port cfg, JAX params as numpy, port model) for
    tiny_test_config(**kw), the same weights on both sides (see the module
    docstring); a fresh model and a fresh copy of the params each call."""
    jcfg, tcfg = JC.tiny_test_config(**kw), TC.tiny_test_config(**kw)
    state, params = _tiny_weights(seed, weights, tuple(sorted(kw.items())))
    model = TM.OmniVGGT(tcfg, device="cpu", seed=None)
    model.load_state_dict(state, strict=True)
    return jcfg, tcfg, copy.deepcopy(params), model.eval()


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


# training helpers (tests/test_torch_train*.py)

HW = 28


def train_batch(S=2, seed=0):
    """A numpy training batch (B=1) with GT for every frame, and modality
    masks: camera GT kept on frame 0, depth on every frame."""
    rng = np.random.default_rng(seed)
    ex, K = random_cameras(rng, 1, S)
    return {
        "images": rng.uniform(size=(1, S, HW, HW, 3)).astype(np.float32),
        "extrinsics": ex,
        "intrinsics": K,
        "depth": rng.uniform(0.5, 5.0, size=(1, S, HW, HW, 1)).astype(np.float32),
        "depth_valid": (rng.uniform(size=(1, S, HW, HW)) > 0.1).astype(np.float32),
        "world_points": rng.normal(size=(1, S, HW, HW, 3)).astype(np.float32),
        "camera_mask": np.array([True] + [False] * (S - 1)),
        "depth_mask": np.array([True] * S),
    }


def tbatch(batch):
    return TTS.batch_to_device(batch, "cpu")


def grads_of(model):
    return {n: (p.grad if p.grad is not None else torch.zeros_like(p)).clone()
            for n, p in model.named_parameters()}


def assert_trees_close(port: dict, ref: dict, rel: float, floor: float = 0.0):
    """Each leaf within rel x max|reference leaf| (+ floor)."""
    assert port.keys() == ref.keys()
    for name, a in port.items():
        b = ref[name].numpy()
        atol = rel * float(np.abs(b).max()) + floor
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=0, atol=atol, err_msg=name)


def jax_loss_grads(params, jcfg, batch, attn_impl, remat=False):
    aux = JAux(**{k: jnp.asarray(batch[k]) for k in ("extrinsics", "intrinsics", "depth")},
               depth_valid=jnp.asarray(batch["depth_valid"]),
               camera_mask=jnp.asarray(batch["camera_mask"]),
               depth_mask=jnp.asarray(batch["depth_mask"]))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss(p):
        preds = JM.apply(p, jb["images"], jcfg, aux, attn_impl=attn_impl, remat=remat,
                         pad_tokens=False)
        return JLS.total_loss(preds, jb, (HW, HW))["total"]

    value, grads = jax.jit(jax.value_and_grad(loss))(params)
    return float(value), to_np(grads)


def port_loss_grads(model, tcfg, batch, attn_impl, **kw):
    tb = tbatch(batch)
    aux = TAux(extrinsics=tb["extrinsics"], intrinsics=tb["intrinsics"], depth=tb["depth"],
               depth_valid=tb["depth_valid"], camera_mask=tb["camera_mask"],
               depth_mask=tb["depth_mask"])
    model.zero_grad(set_to_none=True)
    preds = TM.apply(model, tb["images"], tcfg, aux, attn_impl=attn_impl, pad_tokens=False, **kw)
    loss = TLS.total_loss(preds, tb, (HW, HW))["total"]
    loss.backward()
    return loss.item(), grads_of(model)


# scene outputs (tests/test_torch_viz.py and the CLI / serving tests)


def free_port():
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def read_glb(data: bytes):
    """(glTF JSON, BIN chunk) of a GLB; asserts the header (magic, version 2,
    the stated length) and the JSON and BIN chunk framing."""
    magic, version, length = struct.unpack_from("<III", data, 0)
    assert (magic, version, length) == (0x46546C67, 2, len(data))
    jlen, jtype = struct.unpack_from("<II", data, 12)
    assert jtype == 0x4E4F534A
    gltf = json.loads(data[20 : 20 + jlen])
    blen, btype = struct.unpack_from("<II", data, 20 + jlen)
    assert btype == 0x004E4942 and 28 + jlen + blen == len(data)
    return gltf, data[28 + jlen :]


def glb_accessor(gltf: dict, bin_chunk: bytes, index: int) -> np.ndarray:
    """One accessor of a GLB as a numpy array ((count, width) or (count,))."""
    acc = gltf["accessors"][index]
    view = gltf["bufferViews"][acc["bufferView"]]
    dtype = {5126: np.float32, 5121: np.uint8, 5125: np.uint32}[acc["componentType"]]
    width = {"VEC3": 3, "VEC4": 4, "SCALAR": 1}[acc["type"]]
    arr = np.frombuffer(bin_chunk, dtype, acc["count"] * width, view["byteOffset"])
    return arr.reshape(acc["count"], width) if width > 1 else arr


def glb_meshes(data: bytes):
    """The POSITION arrays of a GLB's meshes, in order (the point cloud
    first when there is one)."""
    gltf, bin_chunk = read_glb(data)
    return [
        glb_accessor(gltf, bin_chunk, m["primitives"][0]["attributes"]["POSITION"])
        for m in gltf["meshes"]
    ]
