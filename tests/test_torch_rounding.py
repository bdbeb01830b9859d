"""Where the port rounds as the JAX package does, on the CPU.

- The int8 steps. The JAX model runs jitted, and under jit XLA rewrites
  `jnp.maximum(amax, floor) / 127.0` into a multiplication by fp32(1/127),
  which lands one ulp off a true division for ~4% of inputs; a step one ulp
  off moves every dequantised value and can flip a later round-half tie.
  Each JAX site that forms a step (`ops/layers.py` :117, :121, :234, :238;
  `ops/pallas/flash_attention.py` :241, :1162, :1222, :1229;
  `ops/pallas/ring_attention.py` :485), jitted, is held bitwise equal to
  the port's quantiser on 20,000 steps, with the int8 values it gives.
- P before P @ V. `_attention_xla` rounds its normalised probabilities to
  v's dtype, the Pallas kernels their unnormalised ones (relative to a
  fixed max of 0, or to a tile's running max); the port's plain versions
  round where each counterpart does. On bf16 inputs at the 224 px frame
  shape (2, 261, 4, 64) at most 0.5% of the outputs may differ, each by at
  most one bf16 step at the output's scale. Not in the list: the Pallas
  head-major kernel against the head-major plain version. That kernel
  rounds P as the ring kernels do, but it also forms q * D^-0.5 in bf16
  before Q K^T (inexact at D = 128), folds its row sum into the P @ V
  product through a ones column at D < 128 (a sum of the rounded P) and,
  under a running max, rounds P relative to the max of its own key block:
  the TPU kernel's arithmetic, which the Hopper kernel and its plain
  version do not copy (59% and 6% of the outputs differ at D = 128 and 64).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from omnivggt_tpu.ops import attention as JA
from omnivggt_tpu.ops.pallas import flash_attention as FA
from omnivggt_tpu.ops.pallas import ring_attention as JR
from omnivggt_tpu_torch.ops import attention as TA
from omnivggt_tpu_torch.ops import layers as TL
from omnivggt_tpu_torch.ops.kernels import flash_attention as FK
from omnivggt_tpu_torch.ops.kernels import ring_attention as RK
from omnivggt_tpu_torch.parallel.mesh import make_mesh

ROWS = 20_000
N_RANKS = 4


def _spread(shape, seed, axis):
    """fp32 values whose slices along `axis` (the one the steps run over)
    span six decades of magnitude, so the steps cover many exponents and
    mantissas."""
    rng = np.random.default_rng(seed)
    mag_shape = [1] * len(shape)
    mag_shape[axis] = shape[axis]
    mag = 10.0 ** rng.uniform(-3, 3, size=mag_shape)
    return (rng.normal(size=shape) * mag).astype(np.float32)


def _jax_step(amax, floor):
    return jnp.maximum(amax, floor) / 127.0


# each site: (input shape, the JAX expression (jitted below) and the port's
# quantiser, both returning (int8 values, steps) as numpy in one layout)
def _linear_weights():
    def jax_fn(w):  # layers.py:116-118, w (in, out)
        ws = _jax_step(jnp.max(jnp.abs(w), axis=0, keepdims=True), 1e-12)
        return jnp.round(w / ws).astype(jnp.int8), ws[0]

    def port_fn(w):
        wq, ws = TL._quantise_weight(torch.from_numpy(w).T)
        return wq.T.numpy(), ws.numpy()

    return (16, ROWS), -1, jax_fn, port_fn


def _linear_rows():
    def jax_fn(x):  # layers.py:120-122
        ax = _jax_step(jnp.max(jnp.abs(x), axis=-1, keepdims=True), 1e-12)
        return jnp.round(x / ax).astype(jnp.int8), ax

    def port_fn(x):
        xq, ax = TL._quantise_rows(torch.from_numpy(x))
        return xq.numpy(), ax.numpy()

    return (ROWS, 24), 0, jax_fn, port_fn


def _conv_weights():
    def jax_fn(w):  # layers.py:233-235, w (kh, kw, cin, cout)
        ws = _jax_step(jnp.max(jnp.abs(w), axis=(0, 1, 2)), 1e-12)
        return jnp.round(w / ws).astype(jnp.int8), ws

    def port_fn(w):
        wq, ws = TL._quantise_weight(torch.from_numpy(w).permute(3, 2, 0, 1))
        return wq.permute(2, 3, 1, 0).numpy(), ws.numpy()

    return (3, 3, 2, ROWS), -1, jax_fn, port_fn


def _conv_images():
    def jax_fn(x):  # layers.py:237-239, x (B, H, W, C)
        ax = _jax_step(jnp.max(jnp.abs(x), axis=(1, 2, 3), keepdims=True), 1e-12)
        return jnp.round(x / ax).astype(jnp.int8), ax.reshape(-1)

    def port_fn(x):  # qconv2d_int8's activation quantiser, NCHW
        xf = torch.from_numpy(x).permute(0, 3, 1, 2)
        ax = TL._int8_step(xf.abs().amax(dim=(1, 2, 3), keepdim=True))
        return torch.round(xf / ax).to(torch.int8).permute(0, 2, 3, 1).numpy(), ax.reshape(-1).numpy()

    return (ROWS, 2, 2, 3), 0, jax_fn, port_fn


def _per_head():
    def jax_fn(x):  # pallas/flash_attention.py:241 (_quant_per_head)
        x8, s = FA._quant_per_head(FA.to_bhnd(x))
        return x8, s[:, 0]

    def port_fn(x):
        x8, s = FK.quant_per_head(torch.from_numpy(x))
        return x8.permute(0, 2, 1, 3).reshape(-1, x.shape[1], x.shape[3]).numpy(), s.reshape(-1).numpy()

    return (1, 4, ROWS, 8), 2, jax_fn, port_fn


def _k_token_major():
    def jax_fn(k):  # pallas/flash_attention.py:1162 (quant_k_token_major)
        k8, s = FA.quant_k_token_major(k)
        return k8, s.reshape(-1)

    def port_fn(k):
        k8, s = FK.quant_k_token_major(torch.from_numpy(k))
        return k8.numpy(), s.reshape(-1).numpy()

    return (1, 4, ROWS, 8), 2, jax_fn, port_fn


def _stream_scales(valid):
    def jax_fn(x):  # pallas/flash_attention.py:1216-1229 (q and k alike)
        B, N, H, D = x.shape
        xa = jnp.abs(x)
        if valid is not None:
            xa = jnp.where(jnp.arange(N)[None, :, None, None] < valid, xa, 0.0)
        s = _jax_step(jnp.max(xa, axis=(1, 3)), 1e-30)
        inv = jnp.repeat(1.0 / s, D, axis=-1)[:, None, :]
        x8 = jnp.round(x.reshape(B, N, H * D) * inv)
        if valid is not None:
            x8 = jnp.clip(x8, -127.0, 127.0)
        return x8.astype(jnp.int8).reshape(B, N, H, D), s.reshape(-1)

    def port_fn(x):
        x8, s, _ = FK.quant_token_major(torch.from_numpy(x), valid)
        return x8.numpy(), s.reshape(-1).numpy()

    return (1, 4, ROWS, 8), 2, jax_fn, port_fn


def _ring():
    def jax_fn(q):  # pallas/ring_attention.py:485 (_quant_ring), per device
        D = q.shape[-1]
        spec = P(None, "seq", None, None)
        mesh = Mesh(np.asarray(jax.devices()[:N_RANKS]), ("seq",))

        def per_device(x):
            q8, k8, v8, c = JR._quant_ring(FA.to_bhnd(x), FA.to_bhnd(-x), FA.to_bhnd(x * 3),
                                           "seq", D**-0.5)
            return jnp.concatenate([q8, k8, v8], axis=1)[None], c[None]

        return shard_map(per_device, mesh=mesh, in_specs=(spec,),
                         out_specs=(P("seq"), P("seq")), check_vma=False)(q)

    def port_fn(q):
        B, N, H, D = q.shape
        nl = N // N_RANKS
        x = torch.from_numpy(q)
        q8, k8, v8, c = RK.quant_ring(x, -x, x * 3, N_RANKS, D**-0.5)

        def per_rank(a):  # (B, N, H, D) -> (ranks, B*H, nl, D)
            return a.reshape(B, N_RANKS, nl, H, D).permute(1, 0, 3, 2, 4).reshape(N_RANKS, B * H, nl, D)

        return torch.cat([per_rank(a) for a in (q8, k8, v8)], dim=2).numpy(), c.numpy()

    return (1, 2 * N_RANKS, ROWS, 8), 2, jax_fn, port_fn


SITES = {
    "layers-117-linear-weights": _linear_weights,
    "layers-121-linear-rows": _linear_rows,
    "layers-234-conv-weights": _conv_weights,
    "layers-238-conv-images": _conv_images,
    "pallas-241-quant-per-head": _per_head,
    "pallas-1162-quant-k-token-major": _k_token_major,
    "pallas-1222-stream-q-valid": lambda: _stream_scales(3),
    "pallas-1229-stream-k": lambda: _stream_scales(None),
    "ring-485-quant-ring": _ring,
}


@pytest.mark.parametrize("site", list(SITES))
def test_int8_steps_equal_the_jitted_jax_expressions(site):
    shape, axis, jax_fn, port_fn = SITES[site]()
    x = _spread(shape, len(site), axis)
    want8, want_step = (np.asarray(a) for a in jax.jit(jax_fn)(jnp.asarray(x)))
    got8, got_step = port_fn(x)
    assert want_step.size >= ROWS
    np.testing.assert_array_equal(got_step, want_step)
    np.testing.assert_array_equal(got8, want8)


def _bf16_step(ref) -> float:
    """The spacing of bf16 values at the largest magnitude in ref."""
    return float(2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7))


def _bf16(seed, shape):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=shape) for _ in range(3))
    return [torch.tensor(x * s, dtype=torch.bfloat16) for x, s in ((q, 2.0), (k, 1.0), (v, 1.0))]


def _j(x):
    return jnp.asarray(x.float().numpy(), dtype=jnp.bfloat16)


def _ring_pair(bounded):
    def run(q, k, v):
        mesh = Mesh(np.asarray(jax.devices()[:N_RANKS]), ("seq",))
        want = JR.ring_flash_attention_hbm(_j(q), _j(k), _j(v), mesh, "seq", block_q=128,
                                           block_k=128, bounded_logits=bounded, interpret=True)
        got = RK.ring_flash_attention_hbm(q, k, v, make_mesh(seq=N_RANKS, device="cpu"), "seq",
                                          block_q=128, block_k=128, bounded_logits=bounded)
        return want, got

    return (2, N_RANKS * 66, 4, 64), run


PAIRS = {
    "attention_plain-_attention_xla": lambda: (
        (2, 261, 4, 64),
        lambda q, k, v: (JA._attention_xla(_j(q), _j(k), _j(v)), TA.attention_plain(q, k, v))),
    "attention_blockwise-_attention_blockwise": lambda: (
        (2, 261, 4, 64),
        lambda q, k, v: (JA._attention_blockwise(_j(q), _j(k), _j(v), block_k=128),
                         TA.attention_blockwise(q, k, v, block_k=128))),
    "ring_plain-_ring_hbm_kernel-bounded": lambda: _ring_pair(True),
    "ring_plain-_ring_hbm_kernel-running-max": lambda: _ring_pair(False),
}


@pytest.mark.parametrize("pair", list(PAIRS))
def test_plain_paths_round_p_as_jax(pair):
    """bf16 inputs through a port function and its JAX counterpart: at most
    0.5% of the bf16 outputs differ, each by at most one bf16 step at the
    output's scale (fp32 P @ V, as the plain paths ran before, differs in
    41% of attention_plain's outputs)."""
    shape, run = PAIRS[pair]()
    q, k, v = _bf16(7, shape)
    want, got = run(q, k, v)
    want = np.asarray(want, dtype=np.float32)
    got = got.float().numpy()
    assert got.shape == want.shape
    diff = np.abs(got - want)
    assert (diff > 0).mean() <= 5e-3, (diff > 0).mean()
    assert diff.max() <= _bf16_step(want), (diff.max(), _bf16_step(want))
