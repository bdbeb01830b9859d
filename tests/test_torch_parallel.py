"""The port's mesh-parallel modules (omnivggt_tpu_torch/parallel/) and the
sharded tiny model against the JAX package on its 8 virtual CPU devices.

Inputs come from a numpy seed and go through both packages. The JAX side
runs its Pallas kernels in interpret mode, the port its plain versions
(CPU tensors). Tolerances: atol 2e-5 for the attention strategies in fp32;
the int8 bodies share their int8 grids (asserted equal to the single-device
quantisers') and are held to 2e-5 of the JAX result where both keep fp32
probabilities; the sharded model within the port's module tolerance (5e-4,
tests/torch_port_util.py).
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import omnivggt_tpu.ops.attention as JA
from omnivggt_tpu.models import omnivggt as JM
from omnivggt_tpu.ops.attention import _attention_xla
from omnivggt_tpu.parallel import attention as jpattn
from omnivggt_tpu.parallel.mesh import make_mesh as jax_make_mesh
from omnivggt_tpu.parallel.mesh import shard_batch as jax_shard_batch
from omnivggt_tpu.parallel.sharding import ModelSharding as JModelSharding
from omnivggt_tpu_torch import serving as TS
from omnivggt_tpu_torch.ops import attention as TA
from omnivggt_tpu_torch.ops.kernels import flash_attention as FK
from omnivggt_tpu_torch.parallel import attention as PA
from omnivggt_tpu_torch.parallel import mesh as PM
from omnivggt_tpu_torch.parallel.sharding import AttnShard, ModelSharding

from tests import torch_port_util as U

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")

REPO = Path(__file__).resolve().parents[1]
ATOL = 2e-5


def _qkv(seed, shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=shape) * scale).astype(np.float32) for _ in range(3)]


def _both(arrays):
    return [jnp.asarray(x) for x in arrays], [torch.from_numpy(x) for x in arrays]


def test_make_mesh_and_placement(monkeypatch):
    mesh = PM.make_mesh(data=2, seq=4, device="cpu")
    assert mesh.shape == {"data": 2, "seq": 4} and mesh.device == torch.device("cpu")
    assert (PM.DATA_AXIS, PM.SEQ_AXIS) == ("data", "seq")
    assert PM.make_mesh(device="cpu").shape == {"data": 1, "seq": 1}
    with pytest.raises(ValueError, match="not divisible by data=2"):
        PM.make_mesh(data=2, device="cpu")
    with pytest.raises(ValueError, match="positive int"):
        PM.make_mesh(seq=0, device="cpu")
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PM.make_mesh(seq=4)
    # ranks as processes: no rendezvous in the environment raises, as does
    # the default CUDA device without one; nothing is left initialised
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PM.multihost_initialize()
    with pytest.raises(ValueError, match="RANK"):
        PM.multihost_initialize(device="cpu", timeout=5)
    assert not torch.distributed.is_initialized()
    assert mesh.group is None and mesh.local_shape == mesh.shape and mesh.local_size == 8
    tree = PM.shard_batch(mesh, {"images": np.zeros((1, 8, 2, 2, 3), np.float32), "n": 3})
    assert isinstance(tree["images"], torch.Tensor) and tree["n"] == 3
    assert PM.frames_sharding(mesh) == (("data", 2), ("seq", 4)) and PM.replicated(mesh) == ()


@pytest.mark.parametrize("strategy", ["allgather", "ring", "ring-bounded", "rows"])
def test_sharded_attention_matches_jax(strategy):
    if strategy == "rows":
        (jq, jk, jv), (tq, tk, tv) = _both(_qkv(1, (8, 21, 2, 16)))
        want = jpattn.rows_sharded_attention(jq, jk, jv, jax_make_mesh(data=2, seq=4),
                                             ("data", "seq"), impl="xla")
        got = PA.rows_sharded_attention(tq, tk, tv, PM.make_mesh(data=2, seq=4, device="cpu"),
                                        ("data", "seq"), impl="plain")
    else:
        (jq, jk, jv), (tq, tk, tv) = _both(_qkv(0, (1, 8 * 37, 4, 32)))
        jmesh, mesh = jax_make_mesh(data=1, seq=8), PM.make_mesh(seq=8, device="cpu")
        if strategy == "allgather":
            want = jpattn.allgather_attention(jq, jk, jv, jmesh, "seq", impl="xla")
            got = PA.allgather_attention(tq, tk, tv, mesh, "seq", impl="plain")
        else:
            bounded = strategy == "ring-bounded"
            want = jpattn.ring_attention(jq, jk, jv, jmesh, "seq", bounded_logits=bounded)
            got = PA.ring_attention(tq, tk, tv, mesh, "seq", bounded_logits=bounded)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(_attention_xla(jq, jk, jv)), atol=ATOL)


def _spy_k_shards(monkeypatch, name):
    """Record what the quantiser `name` returns for the K shards on their
    way to the gather (the calls that carry an amax_reduce)."""
    seen, real = [], getattr(FK, name)

    def spy(x, *args, **kw):
        out = real(x, *args, **kw)
        if kw.get("amax_reduce") is not None:
            seen.append(out)
        return out

    monkeypatch.setattr(FK, name, spy)
    return seen, real


@pytest.mark.parametrize("body", ["inner_q8", "inner_stream_q8"])
def test_allgather_int8_pregather_matches_jax_and_the_whole_arrays_grid(body, monkeypatch):
    """The two pre-gather bodies: each rank's K shard quantised on the max
    over the ranks equals, gathered, the quantiser's grid on the whole K
    (bit for bit), and the output equals the JAX package's."""
    stream = body == "inner_stream_q8"
    # past the packed kernel's key contract, so that an int8 kernel runs;
    # for the head-major body the packed dispatch is switched off instead
    # (as tests/test_parallel.py does), which keeps the shape small
    nl = 384 if stream else 37
    arrays = _qkv(13 if stream else 7, (1, 8 * nl, 2, 64), 0.5 if stream else 1.0)
    (jq, jk, jv), (tq, tk, tv) = _both(arrays)
    JA._sdpa_jit.clear_cache()
    with U.pallas_interpret(), monkeypatch.context() as mp:
        if stream:
            mp.setattr(JA, "_STREAM_ATTN", True)
            mp.setattr(TA, "_STREAM_ATTN", True)
        else:
            mp.setattr(JA, "_PACKED_ATTN", False)
            mp.setattr(TA, "PACKED_MAX_KEYS", 0)
        want = np.asarray(jpattn.allgather_attention(
            jq, jk, jv, jax_make_mesh(data=1, seq=8), "seq", impl="flash",
            bounded_logits=True, qk_int8=True))
        seen, real = _spy_k_shards(mp, "quant_k_token_major" if stream else "quant_per_head")
        got = PA.allgather_attention(tq, tk, tv, PM.make_mesh(seq=8, device="cpu"), "seq",
                                     impl="flash", bounded_logits=True, qk_int8=True)
    JA._sdpa_jit.clear_cache()
    assert len(seen) == 8
    whole = real(tk)
    assert torch.equal(torch.cat([k8 for k8, _ in seen], dim=1), whole[0])
    assert all(torch.equal(scale, whole[1]) for _, scale in seen)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    assert 0 < np.max(np.abs(got.numpy() - np.asarray(_attention_xla(jq, jk, jv)))) < 2e-2


def test_allgather_masked_int8_zeroes_padded_q_rows_as_jax(monkeypatch):
    """inner_masked under qk_int8: garbage in the padded frames' rows (past
    kv_valid, which straddles a shard) must not move the real rows' scales;
    the port's answer on the real rows equals the JAX package's."""
    nv = 200
    arrays = _qkv(11, (1, 8 * 37, 2, 64))
    for x in arrays[:2]:
        x[:, nv:] *= 1000.0
    (jq, jk, jv), (tq, tk, tv) = _both(arrays)
    monkeypatch.setattr(TA, "PACKED_MAX_KEYS", 0)  # an int8 kernel, not the packed bf16 one
    JA._sdpa_jit.clear_cache()
    with U.pallas_interpret(), monkeypatch.context() as mp:
        mp.setattr(JA, "_PACKED_ATTN", False)
        want = np.asarray(jpattn.allgather_attention(
            jq, jk, jv, jax_make_mesh(data=1, seq=8), "seq", impl="flash", kv_valid=nv,
            bounded_logits=True, qk_int8=True))[:, :nv]
    JA._sdpa_jit.clear_cache()
    mesh = PM.make_mesh(seq=8, device="cpu")
    for kv in (nv, torch.tensor(nv, dtype=torch.int32)):
        got = PA.allgather_attention(tq, tk, tv, mesh, "seq", impl="flash", kv_valid=kv,
                                     bounded_logits=True, qk_int8=True)[:, :nv].numpy()
        np.testing.assert_allclose(got, want, atol=ATOL)
    exact = np.asarray(_attention_xla(jq, jk, jv, kv_valid=nv))[:, :nv]
    assert 0 < np.max(np.abs(got - exact)) < 2e-2


def test_allgather_packed_eligible_ignores_int8_as_jax():
    """Where the packed kernel is eligible for (local q, gathered keys) it
    wins over qk_int8 in both packages: no pre-gather, an fp32-exact answer."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(11, (1, 8 * 37, 2, 64)))
    with U.pallas_interpret():
        want = np.asarray(jpattn.allgather_attention(
            jq, jk, jv, jax_make_mesh(data=1, seq=8), "seq", impl="flash",
            bounded_logits=True, qk_int8=True))
    got = PA.allgather_attention(tq, tk, tv, PM.make_mesh(seq=8, device="cpu"), "seq",
                                 impl="flash", bounded_logits=True, qk_int8=True)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(_attention_xla(jq, jk, jv)), atol=ATOL)


def test_attn_shard_dispatch_and_refusals():
    mesh = PM.make_mesh(data=2, seq=4, device="cpu")
    q = torch.zeros((8, 2048, 2, 64))
    sharding = ModelSharding(mesh, "ring_fused")
    assert sharding.frame_attn_shard == AttnShard(mesh, "rows", ("data", "seq"))
    assert sharding.global_attn_shard == AttnShard(mesh, "ring_fused", "seq")
    # the ring strategies always stream; the others resolve on a rank's slice
    assert sharding.global_attn_shard.resolve_impl(q) == "flash"
    assert AttnShard(mesh, "allgather", "seq").resolve_impl(q) == "plain"  # CPU tensors
    assert AttnShard(mesh, "rows").resolve_impl(q, "flash") == "flash"
    for kind in ("ring", "ring_fused"):
        with pytest.raises(NotImplementedError, match="use global_attn='allgather'"):
            AttnShard(mesh, kind, "seq").attend(q, q, q, "auto", kv_valid=3)
    with pytest.raises(ValueError, match="bogus"):
        AttnShard(mesh, "bogus", "seq").attend(q, q, q, "auto")
    with pytest.raises(ValueError, match="rows do not divide"):
        PA.rows_sharded_attention(q[:6], q[:6], q[:6], mesh, ("data", "seq"))


# ---- the slice as a whole: the tiny model under sharding= in both packages ----


@pytest.fixture(scope="module")
def pair():
    return U.tiny_pair(seed=0)


def _jax_sharded(params, jcfg, images, strategy, aux=None, attn_impl="auto"):
    jmesh = jax_make_mesh(data=1, seq=8)
    sharding = JModelSharding(jmesh, global_attn=strategy)
    fwd = jax.jit(lambda p, im, a: JM.apply(p, im, jcfg, a, sharding=sharding,
                                            attn_impl=attn_impl))
    return fwd(params, jax_shard_batch(jmesh, jnp.asarray(images)), aux)


CASES = [("allgather", False, False), ("ring", False, False), ("ring_fused", False, False),
         ("ring", True, False), ("ring_fused", False, True)]


@pytest.mark.parametrize("strategy,with_gt,int8", CASES,
                         ids=["allgather", "ring", "ring_fused", "ring+gt", "ring_fused+int8"])
def test_sharded_tiny_model_matches_jax(pair, strategy, with_gt, int8):
    """Shared weights, the same images (and GT modalities once) through
    `sharding=` on a (1, 8) mesh in both packages; attn_quant="int8" once,
    under ring_fused, where both packages run the int8 ring."""
    jcfg, tcfg, params, model = pair
    rng = np.random.default_rng(2)
    S, hw = 8, 28
    images = rng.uniform(size=(1, S, hw, hw, 3)).astype(np.float32)
    gt = U.gt_inputs(rng, S, hw, [0, 3], [0, 1, 5]) if with_gt else {}
    if int8:
        jcfg = dataclasses.replace(jcfg, attn_quant="int8")
        tcfg = dataclasses.replace(tcfg, attn_quant="int8")
    jaux = JM.make_aux(S, **gt) if with_gt else None
    with U.pallas_interpret():
        want = _jax_sharded(params, jcfg, images, strategy, jaux)
    sharding = ModelSharding(PM.make_mesh(seq=8, device="cpu"), strategy)
    model.config = tcfg
    try:
        with torch.inference_mode():
            got = model(torch.from_numpy(images), **gt, sharding=sharding)
            single = model(torch.from_numpy(images), **gt)
    finally:
        model.config = pair[1]
    U.assert_outputs_close(want, got)
    if int8:  # int8 noise, but present: the mode reached the ring
        assert 0 < (got["pose_enc"] - single["pose_enc"]).abs().max() < 5e-2
    else:
        for key in U.OUTPUT_KEYS:
            torch.testing.assert_close(got[key], single[key], atol=5e-5, rtol=1e-4)


def test_inference_session_under_sharding(pair):
    """A bucketed session under allgather serves a padded request with the
    exact-mode answer; under the ring strategies it serves exact mode only."""
    model = pair[3]
    mesh = PM.make_mesh(seq=4, device="cpu")
    images = np.random.default_rng(4).uniform(size=(5, 28, 28, 3)).astype(np.float32)
    plain = TS.InferenceSession(model, buckets=(4, 8), pad_mode="exact").infer(images)
    bucketed = TS.InferenceSession(model, buckets=(4, 8), sharding=ModelSharding(mesh, "allgather"))
    out = bucketed.infer(images)
    assert (8, 28, 28, False, False, True, 1) in bucketed._served
    for key in U.OUTPUT_KEYS:
        assert out[key].shape[0] == 5
        np.testing.assert_allclose(out[key], plain[key], atol=5e-5, rtol=1e-4)
    ring = ModelSharding(mesh, "ring_fused")
    with pytest.raises(ValueError, match="ring strategies do not support"):
        TS.InferenceSession(model, sharding=ring)
    out = TS.InferenceSession(model, sharding=ring, pad_mode="exact").infer(images[:4])
    for key in U.OUTPUT_KEYS:
        np.testing.assert_allclose(out[key], TS.InferenceSession(
            model, pad_mode="exact").infer(images[:4])[key], atol=5e-5, rtol=1e-4)


def test_packaging_ships_the_kernel_headers():
    """Every file under csrc/ (the sources and the headers they include) is
    matched by the package data, so an installed package can build."""
    import fnmatch
    import tomllib

    data = tomllib.loads((REPO / "pyproject.toml").read_text())
    patterns = data["tool"]["setuptools"]["package-data"]["omnivggt_tpu_torch"]
    files = [f"csrc/{p.name}" for p in (REPO / "omnivggt_tpu_torch" / "csrc").iterdir()]
    assert any(f.endswith(".cuh") for f in files)
    missing = [f for f in files if not any(fnmatch.fnmatch(f, pat) for pat in patterns)]
    assert not missing, missing


def test_dryrun_runs_without_jax():
    """The dry run, in a process where importing jax or the JAX package
    raises: (a) the sharded train step under allgather and under fsdp, (b)
    the four sharded forwards, (c) the flagship's 128-view forward on the
    meta device, (d) the three strategies over two gloo seq processes
    against logical ranks."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['omnivggt_tpu'] = None\n"
        "from omnivggt_tpu_torch.tools import dryrun_multichip\n"
        "sys.exit(dryrun_multichip.main(['--ranks', '4', '--device', 'cpu']))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.count("PASS") == 10 and "FAIL" not in proc.stdout
    assert proc.stdout.count("over 2 gloo processes") == 3
    assert "state_sharding=fsdp" in proc.stdout and "pose_enc (1, 128, 9)" in proc.stdout
