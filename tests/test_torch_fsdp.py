"""ZeRO-2 / FSDP state sharding in the port (omnivggt_tpu_torch/parallel/fsdp.py)
against the JAX package's (omnivggt_tpu/parallel/fsdp.py).

  - spec_for_leaf on a table of shapes;
  - every port tensor's sharded dim against its JAX leaf's spec through the
    bridge (params_from_jax of arrays that number each leaf's sharded
    axis), tiny configs with the stacked DINOv2 and without, 2 and 8 ranks;
  - state_bytes_per_device on the flagship against the JAX count (JAX
    eval_shape, the port on the meta device), each mode at 1, 4 and 8 ranks;
  - the sharded train step: 3 steps on a logical (2, 4) mesh under "none",
    "zero2" and "fsdp" against the JAX package's make_train_step on its 8
    virtual CPU devices (metrics at tests/test_fsdp.py's rtol 2e-4 atol
    1e-6; the largest parameter at its rtol 1e-4 over
    tests/test_torch_train.py's port-vs-JAX floor, 2e-5; every parameter
    within 1e-4, a tenth of one learning-rate step), and against the port's
    own "none" step on the same mesh within 1e-6;
  - sharded_init, the layout of what it holds, and its refusals.
Tiny configs run with min_elems 0, as tests/test_fsdp.py sets
_MIN_SHARD_ELEMS: their leaves are all below the default.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from omnivggt_tpu import config as JC
from omnivggt_tpu.models import omnivggt as JM
from omnivggt_tpu.parallel import fsdp as JF
from omnivggt_tpu.parallel.mesh import make_mesh as jax_make_mesh
from omnivggt_tpu.parallel.mesh import shard_batch as jax_shard_batch
from omnivggt_tpu.parallel.sharding import ModelSharding as JModelSharding
from omnivggt_tpu.train import step as JS
from omnivggt_tpu_torch import config as TC
from omnivggt_tpu_torch.checkpoint import params_from_jax
from omnivggt_tpu_torch.models import omnivggt as TM
from omnivggt_tpu_torch.parallel import collectives as C
from omnivggt_tpu_torch.parallel import fsdp as TF
from omnivggt_tpu_torch.parallel import mesh as PM
from omnivggt_tpu_torch.parallel.sharding import ModelSharding
from omnivggt_tpu_torch.train import step as TS
from tests import torch_port_util as U

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")

AXES = ("data", "seq")


def _port_spec(spec):
    """A JAX PartitionSpec as the port writes it: the sharded dim or None."""
    return None if spec == P() else len(spec) - 1


@pytest.mark.parametrize("shape,n,min_elems", [
    ((24, 4096, 1024), 8, 0), ((256, 256), 8, 0), ((64, 7), 8, 0), ((7, 9), 8, 0),
    ((8, 8), 8, 128), ((), 8, 0), ((24, 3072), 8, None), ((3072,), 8, None), ((24, 1024), 4, None),
    ((1024, 4096), 1, None), ((2, 9, 64), 4, 0), ((6,), 4, 0),
])
def test_spec_for_leaf_matches_jax(shape, n, min_elems):
    assert TF.spec_for_leaf(shape, n, min_elems) == _port_spec(
        JF.spec_for_leaf(shape, n, AXES, min_elems))


@pytest.mark.parametrize("kw", [{}, dict(embed_dim=384, num_heads=6, depth=2,
                                         patch_embed="dinov2_vits14_reg")],
                         ids=["conv", "dinov2"])
@pytest.mark.parametrize("n", [2, 8])
def test_every_tensor_shards_as_its_jax_leaf(kw, n):
    """Each JAX leaf numbered along its sharded axis (0 everywhere when
    replicated), bridged: each port tensor must count up along its own
    sharded dim, chunk for chunk, and be 0 where it is replicated (a
    sharded layer axis would number the layers, and fail that)."""
    jcfg, tcfg = JC.tiny_test_config(**kw), TC.tiny_test_config(**kw)
    shapes = jax.eval_shape(lambda: JM.init(jax.random.PRNGKey(0), jcfg))

    def numbered(leaf):
        spec = JF.spec_for_leaf(leaf.shape, n, AXES, 0)
        if spec == P():
            return np.zeros(leaf.shape, np.float32)
        axis = len(spec) - 1
        idx = np.arange(leaf.shape[axis], dtype=np.float32).reshape(
            [-1 if i == axis else 1 for i in range(len(leaf.shape))])
        return np.broadcast_to(idx, leaf.shape).copy()

    marks = params_from_jax(jax.tree.map(numbered, shapes), tcfg)
    model = TM.OmniVGGT(tcfg, device="meta", seed=None)
    specs = TF.tree_specs(model, n, 0)
    assert specs.keys() == marks.keys()
    n_sharded = 0
    for name, dim in specs.items():
        m = marks[name]
        if dim is None:
            assert torch.all(m == 0), name
            continue
        n_sharded += 1
        want = torch.arange(m.shape[dim], dtype=torch.float32).reshape(
            [-1 if i == dim else 1 for i in range(m.ndim)]).expand(m.shape)
        assert torch.equal(m, want), name
    assert n_sharded > 0.8 * len(specs)


def test_state_bytes_per_device_matches_jax_on_the_flagship():
    """The flagship's parameters and AdamW moments per rank, each mode at
    1, 4 and 8 ranks: the port's count on a meta model equals the JAX
    count on eval_shape of the JAX state, whose optimizer state is the two
    moments and two int32 step counts (on the device in JAX, on the host
    in the port)."""
    cfg = JC.OmniVGGTConfig()
    opt = JS.make_optimizer()
    shapes = jax.eval_shape(lambda: JS.init_state(JM.init(jax.random.PRNGKey(0), cfg), opt))
    opt_leaves = jax.tree.leaves(shapes.opt_state)
    scalars = [x for x in opt_leaves if x.shape == ()]
    assert len(scalars) == 2 and all(x.dtype == jnp.int32 for x in scalars)
    assert len(opt_leaves) - 2 == 2 * len(jax.tree.leaves(shapes.params))
    model = TM.OmniVGGT(TC.OmniVGGTConfig(), device="meta", seed=None)
    for n in (1, 4, 8):
        mesh = jax_make_mesh(data=1, seq=n, devices=jax.devices()[:n])
        for mode in TF.STATE_SHARDING_MODES:
            want = JF.state_bytes_per_device(shapes, mesh, mode) - 8
            assert TF.state_bytes_per_device(model, n, mode) == want, (n, mode)
            assert TF.state_bytes_per_device(model, PM.Mesh(1, n, torch.device("meta")),
                                             mode) == want
    gb = TF.state_bytes_per_device(model, 8, "none") / 1e9
    assert 14 < gb < 15  # 1.217B fp32 parameters and two moments


def _batch(B=2, S=4, hw=28, seed=0):
    rng = np.random.default_rng(seed)
    ex, K = U.random_cameras(rng, B, S)
    return {
        "images": rng.uniform(size=(B, S, hw, hw, 3)).astype(np.float32),
        "extrinsics": ex,
        "intrinsics": K,
        "depth": rng.uniform(0.5, 5.0, size=(B, S, hw, hw, 1)).astype(np.float32),
        "depth_valid": (rng.uniform(size=(B, S, hw, hw)) > 0.2).astype(np.float32),
        "world_points": rng.normal(size=(B, S, hw, hw, 3)).astype(np.float32),
        "camera_mask": np.array([True, False, True, False]),
        "depth_mask": np.array([True, True, False, True]),
    }


def _largest(named):
    return max(named, key=lambda kv: kv[1].numel())


@pytest.fixture(scope="module")
def port_none():
    """The port's "none" step on the logical (2, 4) mesh: 3 steps' metrics
    and the final parameters."""
    _, tcfg, _, model = U.tiny_pair(seed=0)
    return _port_run("none", model.train(), tcfg)


def _port_run(mode, model, tcfg):
    mesh = PM.make_mesh(data=2, seq=4, device="cpu")
    opt = TS.make_optimizer(model, learning_rate=1e-3, warmup_steps=1, total_steps=100)
    state = TF.shard_state(TS.init_state(model, opt), mesh, mode, min_elems=0)
    step = TS.make_train_step(tcfg, opt, ModelSharding(mesh, "allgather"), use_aux_inputs=True,
                              state_sharding=mode)
    batch = PM.shard_batch(mesh, _batch())
    for _ in range(3):
        state, metrics = step(state, batch)
    params = state.layout.full_state_dict() if state.layout is not None else model.state_dict()
    return {k: v.item() for k, v in metrics.items()}, params, state


@pytest.mark.parametrize("mode", TF.STATE_SHARDING_MODES)
def test_sharded_train_step_matches_jax(mode, port_none, monkeypatch):
    """3 steps of make_train_step(sharding=, state_sharding=mode) on the
    same weights and batch in both packages, the JAX side on its 8 virtual
    devices; the port also against its own "none" step."""
    jcfg, tcfg, params, model = U.tiny_pair(seed=0)
    monkeypatch.setattr(JF, "_MIN_SHARD_ELEMS", 0)
    opt = JS.make_optimizer(learning_rate=1e-3, warmup_steps=1, total_steps=100)
    jmesh = jax_make_mesh(data=2, seq=4)
    sharding = JModelSharding(jmesh, global_attn="allgather")
    init = functools.partial(jax.tree.map, jnp.asarray, params)
    state_j = (JS.init_state(init(), opt) if mode == "none"
               else JF.sharded_init(init, opt, jmesh, mode))
    step_j = JS.make_train_step(jcfg, opt, sharding, use_aux_inputs=True, state_sharding=mode)
    batch_j = jax_shard_batch(jmesh, {k: jnp.asarray(v) for k, v in _batch().items()})
    for _ in range(3):
        state_j, m_j = step_j(state_j, batch_j)

    metrics, got, state = _port_run(mode, model.train(), tcfg)
    for key in m_j:
        np.testing.assert_allclose(metrics[key], float(m_j[key]), rtol=2e-4, atol=1e-6,
                                   err_msg=key)
    # parameters: Adam moves an element whose gradient is near zero by a
    # step that the two frameworks' fp32 rounding can change, in every mode,
    # "none" included. The largest leaf reads 1.8e-6 on 2 of its 65536
    # elements (test_fsdp.py's JAX-vs-JAX atol is 1e-6): it gets
    # tests/test_torch_train.py's port-vs-JAX floor, 2e-5 (2% of one 1e-3
    # learning-rate step); every leaf gets a tenth of a step, 1e-4 (5.4e-5
    # read on one element of the zero-initialised camera_adapters.0)
    want = params_from_jax(U.to_np(state_j.params), tcfg)
    name, _ = _largest(want.items())
    np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), rtol=1e-4, atol=2e-5)
    U.assert_trees_close(got, want, rel=0.0, floor=1e-4)

    ref_metrics, ref_params, _ = port_none
    for key, value in ref_metrics.items():
        np.testing.assert_allclose(metrics[key], value, rtol=1e-6, err_msg=key)
    for key, value in ref_params.items():
        torch.testing.assert_close(got[key], value, rtol=1e-6, atol=1e-6)

    # what each mode holds as shards: the moments under zero2 and fsdp, the
    # largest parameter too under fsdp
    big, _ = _largest(got.items())
    if mode == "none":
        assert state.layout is None
        return
    shards = state.layout.shards[big]
    assert len(shards) == 8 and all(s.numel() * 8 == got[big].numel() for s in shards)
    for s in shards:
        assert state.optimizer.adamw.state[s]["exp_avg"].shape == s.shape
    held = dict(model.named_parameters())[big]
    assert held.numel() == (0 if mode == "fsdp" else got[big].numel())


def test_sharded_init_and_refusals():
    """sharded_init builds from the seed and keeps shards whose values are
    the unsharded init's, bitwise; a wrong mode, a mode without a mesh,
    the fused ring in training, and a state laid out for another mode
    are refused."""
    cfg = TC.tiny_test_config()
    mesh = PM.make_mesh(data=2, seq=4, device="cpu")

    def build():
        return TM.OmniVGGT(cfg, device="cpu", seed=0)

    ref = dict(build().named_parameters())
    state = TF.sharded_init(build, TS.make_optimizer, mesh, "fsdp", min_elems=0)
    layout = state.layout
    assert layout.mode == "fsdp" and len(layout.shards) > 0.8 * len(ref)
    for name, shards in layout.shards.items():
        assert torch.equal(torch.cat([s.detach() for s in shards], layout.specs[name]), ref[name])
    # a group a Block, except the camera head's trunk (run once an
    # iteration): one group for the head's call
    assert sorted(layout.block_groups) == sorted(
        n for n, m in state.model.named_modules()
        if type(m).__name__ == "Block" and not n.startswith("camera_head.")) + ["camera_head"]
    assert all(n.startswith("camera_head.") for n in layout.block_groups["camera_head"])
    assert all(n not in layout.rest for names in layout.block_groups.values() for n in names)
    C.reset_calls()
    full = layout.full_state_dict()
    assert all(torch.equal(full[k], v) for k, v in ref.items())
    assert C.calls()["all_gather"] > 0

    with pytest.raises(ValueError, match="state_sharding='zero9'"):
        TF.sharded_init(build, TS.make_optimizer, mesh, "zero9")
    model = build()
    opt = TS.make_optimizer(model)
    with pytest.raises(ValueError, match="needs a ModelSharding"):
        TS.make_train_step(cfg, opt, state_sharding="zero2")
    with pytest.raises(ValueError, match="ring kernels have no backward"):
        TS.make_train_step(cfg, opt, ModelSharding(mesh, "ring_fused"))
    with pytest.raises(ValueError, match="already laid out"):
        TF.shard_state(state, mesh, "zero2")
    step = TS.make_train_step(cfg, opt, ModelSharding(mesh, "allgather"), state_sharding="zero2")
    with pytest.raises(ValueError, match="laid out for state_sharding='fsdp'"):
        step(state, PM.shard_batch(mesh, _batch()))


@pytest.mark.parametrize("mode", ("zero2", "fsdp"))
def test_a_save_holds_one_gathered_tensor_at_a_time(mode, tmp_path, monkeypatch):
    """A checkpoint of a zero2 / fsdp state passes each gathered parameter
    and moment to `place` as soon as it is whole: where it is dropped (a
    process that does not write), no gathered tensor is alive when the
    next gather starts. The file that the writer saves restores into an
    unsharded state equal to the sharded one."""
    import weakref

    from omnivggt_tpu_torch.train import checkpointing as CK

    cfg = TC.tiny_test_config()
    mesh = PM.make_mesh(data=2, seq=4, device="cpu")

    def build():
        return TM.OmniVGGT(cfg, device="cpu", seed=0)

    state = TF.sharded_init(build, TS.make_optimizer, mesh, mode, min_elems=0)
    step = TS.make_train_step(cfg, state.optimizer, ModelSharding(mesh, "allgather"),
                              state_sharding=mode)
    state, _ = step(state, PM.shard_batch(mesh, _batch()))
    gathered, placed, sound = [], [], C.all_gather

    def all_gather(*args, **kwargs):
        alive = [r for r in gathered if r() is not None]
        assert not alive, f"{len(alive)} gathered tensors are alive at the next gather"
        whole = sound(*args, **kwargs)
        gathered.append(weakref.ref(whole))
        return whole

    def drop(t):
        alive = [r for r in gathered if r() is not None and r() is not t]
        assert not alive, f"{len(alive)} other gathered tensors are alive"
        placed.append(t.shape)

    monkeypatch.setattr(C, "all_gather", all_gather)
    state.layout.full_state_dict(drop)
    state.optimizer.state_dict(drop)
    monkeypatch.undo()
    assert len(gathered) >= 2 * len(state.layout.specs) > 0 and len(placed) >= len(gathered)

    path = CK.save_train_state(str(tmp_path), state)
    model = build()
    like = CK.restore_train_state(path, TS.init_state(model, TS.make_optimizer(model)))
    whole = state.layout.full_state_dict()
    assert like.step == 1 and all(torch.equal(v, whole[k]) for k, v in model.state_dict().items())
    moments = like.optimizer.state_dict()["adamw"]["state"]
    for idx, entry in state.optimizer.state_dict()["adamw"]["state"].items():
        assert torch.equal(moments[idx]["exp_avg"], entry["exp_avg"])
