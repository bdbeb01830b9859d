"""The port's blockwise attention and its dispatch against the JAX package:
`attention_blockwise` against `_attention_blockwise` (fp32, several key
blocks, kv_valid absent, static and a tensor, within 1e-5), its gradient
against the plain version's autograd, and `resolve_impl` against the JAX
package's on the CPU for a list of shapes (meta tensors: nothing is
allocated)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from omnivggt_tpu.ops import attention as JA
from omnivggt_tpu_torch.ops import attention as TA

ATOL = 1e-5


def _qkv(seed, shape=(2, 200, 3, 16)):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("block_k", [64, 1024])
@pytest.mark.parametrize("kv_valid", [None, 150, "tensor"])
def test_blockwise_matches_jax(kv_valid, block_k):
    q, k, v = _qkv(0)
    kv_t = torch.tensor(150) if kv_valid == "tensor" else kv_valid
    kv_j = jnp.asarray(150, jnp.int32) if kv_valid == "tensor" else kv_valid
    out_t = TA.attention_blockwise(*(torch.tensor(x) for x in (q, k, v)), kv_t, block_k=block_k)
    out_j = JA._attention_blockwise(*(jnp.asarray(x) for x in (q, k, v)), block_k=block_k,
                                    kv_valid=kv_j)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=ATOL, rtol=ATOL)
    # the plain path computes the same function from materialised scores
    plain = TA.attention_plain(*(torch.tensor(x) for x in (q, k, v)), kv_t)
    np.testing.assert_allclose(out_t.numpy(), plain.numpy(), atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("kv_valid", [None, 150, "tensor"])
def test_blockwise_gradient_matches_plain_autograd(kv_valid):
    arrays = _qkv(1)
    kv = torch.tensor(150) if kv_valid == "tensor" else kv_valid
    do = torch.tensor(np.random.default_rng(2).normal(size=arrays[0].shape).astype(np.float32))
    grads = []
    for fn in (lambda *x: TA.attention_blockwise(*x, kv, block_k=64),
               lambda *x: TA.attention_plain(*x, kv)):
        leaves = [torch.tensor(x, requires_grad=True) for x in arrays]
        grads.append(torch.autograd.grad(fn(*leaves), leaves, do))
    for g_b, g_p in zip(*grads):
        np.testing.assert_allclose(g_b.numpy(), g_p.numpy(), atol=ATOL, rtol=ATOL)


def test_sdpa_takes_blockwise_and_auto_streams_long_sequences():
    q, k, v = (torch.tensor(x) for x in _qkv(3))
    ref = TA.attention_plain(q, k, v, 120)
    out = TA.scaled_dot_product_attention(q, k, v, impl="blockwise", kv_valid=120)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=ATOL, rtol=ATOL)
    assert TA.resolve_impl(torch.empty((1, TA.PLAIN_MAX_SEQ + 1, 1, 8), device="meta")) == "blockwise"


# (B, N, H, D): frame and DINOv2 attention at S=8 and S=64, the global
# attention of S=3 and S=8 at 518 px (S=8: 7.7 GB of fp32 scores), the
# length and score-byte edges, a 224 px frame, one long head
SHAPES = [
    (8, 1374, 16, 64), (8, 1376, 16, 64), (64, 1374, 16, 64), (96, 1374, 16, 64),
    (1, 3 * 1374, 16, 64), (1, 8 * 1374, 16, 64), (1, 4096, 16, 64), (1, 4097, 16, 64),
    (119, 4096, 1, 64), (120, 4096, 1, 64), (2, 261, 16, 64), (1, 100_000, 1, 64),
]


@pytest.mark.parametrize("shape", SHAPES)
def test_resolve_impl_picks_what_jax_picks(shape):
    want = {"xla": "plain"}.get(JA.resolve_impl(shape), JA.resolve_impl(shape))
    assert TA.resolve_impl(torch.empty(shape, device="meta")) == want
    if shape == (1, 8 * 1374, 16, 64):
        assert want == "blockwise"
