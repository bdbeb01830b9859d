"""The port's ring attention (omnivggt_tpu_torch/ops/kernels/ring_attention.py)
against the JAX package's Pallas ring kernels.

The same inputs, made from a numpy seed, go through the port's wrappers on
CPU tensors (where they compute `ring_attention_plain`) and through
`ring_flash_attention` / `ring_flash_attention_hbm` in Pallas interpret mode
on the 8 virtual CPU devices, at the shapes of tests/test_ring_kernel.py.
Tolerances: fp32 atol 2e-5 between the two packages (both sum in fp32, in
another order); the int8 forms share their grids exactly (asserted) and round
the probabilities to bf16 alike; in bounded mode a probability does not
depend on the tiling and the two are held to 1e-4 of each other, under a
running max it is rounded relative to the max of its own tile (128 keys
there, the shard here) and they are held to 1e-3; both to the JAX test's
own bound (0 < d < 2e-2) of exact attention.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from omnivggt_tpu.ops.attention import _attention_xla
from omnivggt_tpu.ops.pallas import ring_attention as JR
from omnivggt_tpu.ops.pallas.flash_attention import to_bhnd
from omnivggt_tpu_torch.ops.kernels import ring_attention as RK
from omnivggt_tpu_torch.parallel import attention as PA
from omnivggt_tpu_torch.parallel.mesh import make_mesh

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")

N_RANKS = 8
ATOL = 2e-5


def _jax_mesh():
    return Mesh(np.asarray(jax.devices()[:N_RANKS]), ("seq",))


def _qkv(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


# (id, seed, (B, nl, H, D), wrapper, block / chunk arguments, bounded)
CASES = [
    ("one-chunk", 0, (1, 256, 2, 64), "ring_flash_attention", dict(block_q=128, block_k=128), False),
    ("batch-2", 0, (2, 128, 4, 64), "ring_flash_attention", dict(block_q=128, block_k=128), False),
    ("multi-chunk", 1, (1, 512, 1, 64), "ring_flash_attention",
     dict(block_q=128, block_k=256, chunk_q=256), False),
    ("bounded", 5, (1, 256, 1, 64), "ring_flash_attention", dict(block_q=128, block_k=128), True),
    ("bounded-ragged-300", 5, (1, 300, 1, 64), "ring_flash_attention",
     dict(block_q=128, block_k=128), True),
    ("ragged-300", 3, (1, 300, 1, 64), "ring_flash_attention", dict(block_q=128, block_k=128), False),
    ("hbm-ragged-200", 9, (1, 200, 1, 64), "ring_flash_attention_hbm",
     dict(block_q=128, block_k=128), False),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_ring_plain_matches_jax_kernel(case):
    _, seed, (B, nl, H, D), name, kw, bounded = case
    q, k, v = _qkv(seed, (B, N_RANKS * nl, H, D))
    want = np.asarray(getattr(JR, name)(
        *(jnp.asarray(x) for x in (q, k, v)), _jax_mesh(), "seq", interpret=True,
        bounded_logits=bounded, **kw))
    mesh = make_mesh(seq=N_RANKS, device="cpu")
    got = getattr(RK, name)(*(torch.from_numpy(x) for x in (q, k, v)), mesh, "seq",
                            bounded_logits=bounded, **kw)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    exact = np.asarray(_attention_xla(*(jnp.asarray(x) for x in (q, k, v))))
    np.testing.assert_allclose(got.numpy(), exact, atol=ATOL)


def _jax_quant_ring(q, k, v, nl_pad):
    """`_quant_ring` as the kernels' wrappers call it: per device, on the
    head-major, zero-padded shard, under a shard_map over the ring axis,
    jitted as the model runs it (XLA then turns the step's / 127.0 into a
    multiplication by fp32(1/127), as the port computes it)."""
    D = q.shape[-1]
    spec = P(None, "seq", None, None)

    def per_device(q, k, v):
        def prep(x):
            x = to_bhnd(x)
            return jnp.pad(x, ((0, 0), (0, nl_pad - x.shape[1]), (0, 0)))

        q8, k8, v8, c = JR._quant_ring(prep(q), prep(k), prep(v), "seq", D**-0.5)
        return q8[None], k8[None], v8[None], c[None]

    out = P("seq")
    return jax.jit(shard_map(per_device, mesh=_jax_mesh(), in_specs=(spec,) * 3,
                             out_specs=(out,) * 4, check_vma=False))(
        *(jnp.asarray(x) for x in (q, k, v)))


@pytest.mark.parametrize(
    "name,nl,bounded,seed",
    [("ring_flash_attention", 256, True, 7), ("ring_flash_attention", 256, False, 7),
     ("ring_flash_attention_hbm", 200, True, 9)],
    ids=["vmem-bounded", "vmem-running-max", "hbm-ragged-bounded"],
)
def test_int8_ring_grids_equal_and_outputs_close(name, nl, bounded, seed):
    B, H, D = 1, 2 if bounded and nl == 256 else 1, 64
    q, k, v = _qkv(seed, (B, N_RANKS * nl, H, D))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))

    # the grids: int8 values and the (B*H, 2) table, rank by rank
    nl_pad = RK.hbm_ring_padded_len(nl, 128, 128) if name.endswith("hbm") else nl
    jq8, jk8, jv8, jc = (np.asarray(x) for x in _jax_quant_ring(q, k, v, nl_pad))
    q8, k8, v8, c = RK.quant_ring(tq, tk, tv, N_RANKS, D**-0.5)
    for got, want in ((q8, jq8), (k8, jk8), (v8, jv8)):
        # (B, N, H, D) -> (ranks, B*H, nl, D), the JAX kernels' layout
        got = got.reshape(B, N_RANKS, nl, H, D).permute(1, 0, 3, 2, 4).reshape(N_RANKS, B * H, nl, D)
        np.testing.assert_array_equal(got.numpy(), want[:, :, :nl])
        assert not want[:, :, nl:].any()  # the padded rows are zeros
    np.testing.assert_array_equal(c.numpy(), jc)

    kw = dict(block_q=128, block_k=128, bounded_logits=bounded, qk_int8=True)
    want = np.asarray(getattr(JR, name)(
        *(jnp.asarray(x) for x in (q, k, v)), _jax_mesh(), "seq", interpret=True, **kw))
    got = getattr(RK, name)(tq, tk, tv, make_mesh(seq=N_RANKS, device="cpu"), "seq", **kw).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4 if bounded else 1e-3)
    exact = np.asarray(_attention_xla(*(jnp.asarray(x) for x in (q, k, v))))
    assert 0 < np.max(np.abs(got - exact)) < 2e-2


@pytest.mark.parametrize("nl", [9, 200, 256, 512, 1374, 2748, 4096, 16384, 16896, 21984, 28672, 28673])
def test_dispatch_matches_jax(nl, monkeypatch):
    """Both packages send a shard length to the same wrapper and hold the
    same caps."""
    assert RK.hbm_ring_padded_len(nl) == JR.hbm_ring_padded_len(nl)
    assert RK.fits_hbm_ring(nl) == JR.fits_hbm_ring(nl)
    assert (RK.CHUNK_Q, RK.MAX_LOCAL_SEQ, RK.MAX_LOCAL_SEQ_HBM) == (
        JR.CHUNK_Q, JR.MAX_LOCAL_SEQ, JR.MAX_LOCAL_SEQ_HBM)
    # which wrapper takes it: the JAX rule, evaluated here
    chunk = min(JR.CHUNK_Q, nl)
    vmem_ok = (nl <= JR.MAX_LOCAL_SEQ and nl % chunk == 0
               and chunk % min(JR.DEFAULT_BLOCK_Q, chunk) == 0
               and nl % min(JR.DEFAULT_BLOCK_K, nl) == 0)
    called = []
    monkeypatch.setattr(RK, "ring_flash_attention_hbm", lambda *a, **k: called.append("hbm"))
    monkeypatch.setattr(RK, "ring_attention_plain", lambda *a, **k: called.append("vmem"))
    q = torch.zeros((1, 2 * nl, 1, 8))
    RK.ring_flash_attention(q, q, q, make_mesh(seq=2, device="cpu"))
    assert called == (["vmem"] if vmem_ok else ["hbm"])


def test_oversize_shard_raises_and_fused_ring_falls_back_logged(caplog, monkeypatch):
    mesh = make_mesh(seq=2, device="cpu")
    q = torch.zeros((1, 2 * 40960, 1, 8))
    with pytest.raises(ValueError, match="HBM-staged cap"):
        RK.ring_flash_attention(q, q, q, mesh)
    # a tiny cap for the dispatch: the fused entry point then takes the
    # unfused ring, logged and counted, and stays exact
    q, k, v = (torch.from_numpy(x) for x in _qkv(5, (1, N_RANKS * 16, 2, 16)))
    mesh = make_mesh(seq=N_RANKS, device="cpu")
    monkeypatch.setattr(RK, "MAX_LOCAL_SEQ_HBM", 8)
    before = PA.fused_ring_attention.unfused_fallbacks
    with caplog.at_level(logging.WARNING):
        out = PA.fused_ring_attention(q, k, v, mesh, "seq")
    assert any("falling back to the unfused" in r.message for r in caplog.records)
    assert PA.fused_ring_attention.unfused_fallbacks == before + 1
    exact = np.asarray(_attention_xla(*(jnp.asarray(x.numpy()) for x in (q, k, v))))
    np.testing.assert_allclose(out.numpy(), exact, atol=ATOL)


def test_wrappers_take_cpu_tensors_only_by_where_they_lie():
    """A wrapper computes its plain version because its tensors lie on the
    CPU, not because a card is missing: mixed devices are refused."""
    q = torch.zeros((1, 16, 1, 64))
    with pytest.raises(ValueError, match="does not divide"):
        RK.ring_flash_attention(q[:, :15], q[:, :15], q[:, :15], make_mesh(seq=2, device="cpu"))
    assert RK.launches() == {"ring_flash_attention": 0, "ring_flash_attention_hbm": 0}
    meta = torch.zeros((1, 16, 1, 64), device="meta")
    with pytest.raises(ValueError, match="all lie on the CPU or all on CUDA"):
        RK.ring_flash_attention(meta, q, q, make_mesh(seq=2, device="cpu"))
