"""The flash-attention gradient of the PyTorch port against the JAX
package's fused backward.

On the CPU the port's autograd.Function runs its plain versions
(attention_plain with the LSE, attention_backward_plain); the JAX side
runs jax.vjp of FA.flash_attention / FA.flash_attention_packed with every
Pallas kernel in interpret mode, so its gradient goes through
_flash_bwd_dq_kernel and _flash_bwd_dkv_kernel. Tolerance: 2e-5 at fp32
inputs, the JAX suite's kernel tolerance (tests/test_ops.py), for values
of order 1; for larger gradients (q x 40 makes them ~10) it scales with
max|reference|, since ds = p * (dp - delta) cancels and fp32 rounding is
relative. The CUDA kernels are held against the same plain versions on
the card (tests/test_torch_cuda.py, chip_smoke.py).

The model's gradients through the kernels (attn_impl="flash" on both
sides, the JAX side in interpret mode) match leaf by leaf within 1e-4 of
each leaf's max |gradient|.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from omnivggt_tpu.ops.pallas import flash_attention as FA
from omnivggt_tpu_torch.checkpoint import params_from_jax
from omnivggt_tpu_torch.ops.kernels import flash_attention as FK
from tests.torch_port_util import (
    assert_trees_close, jax_loss_grads, pallas_interpret, port_loss_grads, t, tiny_pair,
    train_batch,
)

KERNEL_ATOL = 2e-5


def _inputs(shape, n_keys, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    B, N, H, D = shape
    q = (rng.normal(size=(B, N, H, D)) * scale).astype(np.float32)
    k = rng.normal(size=(B, n_keys, H, D)).astype(np.float32)
    v = rng.normal(size=(B, n_keys, H, D)).astype(np.float32)
    g = rng.normal(size=(B, N, H, D)).astype(np.float32)
    return q, k, v, g


def _port_grads(fn, q, k, v, g, **kw):
    leaves = [t(x).requires_grad_(True) for x in (q, k, v)]
    out = fn(*leaves, **kw)
    out.backward(t(g))
    return out.detach().numpy(), [x.grad.numpy() for x in leaves]


# (wrapper, q shape, n_keys, kv_valid, bounded, q scale)
CASES = {
    "head-major ragged running-max": ("flash_attention", (1, 203, 2, 64), 203, None, False, 1.0),
    "head-major D128 bounded": ("flash_attention", (2, 150, 2, 128), 150, None, True, 1.0),
    "head-major dynamic kv_valid": ("flash_attention", (2, 130, 2, 64), 130, "traced", False, 1.0),
    "packed static kv_valid bounded": ("flash_attention_packed", (3, 107, 4, 16), 107, 77, True, 1.0),
    "bounded clamp saturates": ("flash_attention", (1, 96, 2, 64), 96, None, True, 40.0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_backward_matches_pallas(case):
    """Gradients of the port's wrapper (its autograd.Function) vs jax.vjp
    through the Pallas backward kernels: ragged N, D 64 and 128, dynamic
    and static kv_valid, bounded and running max, and q x 40, where the
    clamp saturates and the gradient passes straight through it."""
    name, shape, n_keys, kv_valid, bounded, scale = CASES[case]
    q, k, v, g = _inputs(shape, n_keys, 0, scale)
    kv_j = jnp.int32(77) if kv_valid == "traced" else kv_valid
    kv_t = torch.tensor(77) if kv_valid == "traced" else kv_valid
    if name == "flash_attention":
        # small blocks: several key and query blocks per head on the TPU side
        fj = lambda a, b, c: FA.flash_attention(  # noqa: E731
            a, b, c, block_q=64, block_k=128, kv_valid=kv_j, bounded_logits=bounded)
    else:
        fj = lambda a, b, c: FA.flash_attention_packed(  # noqa: E731
            a, b, c, kv_valid=kv_j, bounded_logits=bounded)
    with pallas_interpret():
        out_j, vjp = jax.vjp(fj, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        grads_j = vjp(jnp.asarray(g))
    out_t, grads_t = _port_grads(
        getattr(FK, name), q, k, v, g, kv_valid=kv_t, bounded_logits=bounded
    )
    np.testing.assert_allclose(out_t, np.asarray(out_j), atol=KERNEL_ATOL)
    assert all(np.isfinite(x).all() for x in grads_t)
    for label, a, b in zip(("dq", "dk", "dv"), grads_t, grads_j):
        b = np.asarray(b)
        atol = KERNEL_ATOL * max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a, b, atol=atol, err_msg=label)


@pytest.mark.parametrize("bounded", [False, True])
def test_forward_lse_matches_pallas(bounded):
    """attention_plain's LSE vs _flash_forward(..., return_lse=True), the
    TPU kernel's LSE output, with a dynamic kv_valid."""
    q, k, v, _ = _inputs((2, 90, 3, 64), 90, 1)
    with pallas_interpret():
        out_j, lse_j = FA._flash_forward(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 64, 128,
            kv_valid=jnp.int32(61), return_lse=True, bounded=bounded,
        )
    out_t, lse_t = FK.attention_plain(t(q), t(k), t(v), torch.tensor(61), bounded, return_lse=True)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=KERNEL_ATOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j).reshape(2, 3, 90), atol=KERNEL_ATOL)


@pytest.mark.parametrize("fn", ["flash_attention", "flash_attention_packed"])
def test_flash_gradient_equals_plain_autograd(fn):
    """The custom backward (plain on the CPU) equals autograd through the
    plain forward; under no_grad the wrapper saves nothing and counts no
    launch."""
    q, k, v, g = _inputs((2, 70, 2, 32), 70, 2)
    out, grads = _port_grads(getattr(FK, fn), q, k, v, g, kv_valid=50)
    ref_out, ref_grads = _port_grads(FK.attention_plain, q, k, v, g, kv_valid=50)
    np.testing.assert_allclose(out, ref_out, atol=1e-6)
    for a, b in zip(grads, ref_grads):
        np.testing.assert_allclose(a, b, atol=1e-5)
    before = FK.launches()
    with torch.no_grad():
        o = getattr(FK, fn)(*(t(x).requires_grad_(True) for x in (q, k, v)))
    assert o.grad_fn is None and FK.launches() == before


def _bf16_kernel_numerics(q, k, v, o, do, lse, kv_valid, bounded):
    """The backward kernels' rounding, in fp32 on the CPU: ds and p rounded
    to bf16 before their products, the outputs rounded to bf16."""
    scale = q.shape[-1] ** -0.5
    p, ds, dof = FK._backward_terms(q, k, v, o, do, lse, kv_valid, bounded)
    dsb, pb = ds.bfloat16().float(), p.bfloat16().float()
    dq = torch.einsum("bhqk,bkhd->bqhd", dsb, k) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", dsb, q) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", pb, dof)
    return [x.bfloat16().float() for x in (dq, dk, dv)]


def _backward64(q, k, v, o, do, bounded):
    """(lse, dq, dk, dv) in float64 from the same inputs: the exact side."""
    q, k, v, o, do = (x.double() for x in (q, k, v, o, do))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * q.shape[-1] ** -0.5
    s = s.clamp_max(FK.BOUNDED_CLAMP) if bounded else s
    lse = torch.logsumexp(s, dim=-1)
    p = (s - lse[..., None]).exp()
    delta = (do * o).sum(-1).transpose(1, 2)
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", do, v) - delta[..., None])
    scale = q.shape[-1] ** -0.5
    return (lse, torch.einsum("bhqk,bkhd->bqhd", ds, k) * scale,
            torch.einsum("bhqk,bqhd->bkhd", ds, q) * scale, torch.einsum("bhqk,bqhd->bkhd", p, do))


@pytest.mark.parametrize("bounded,q_scale", [(False, 1.0), (True, 1.0), (True, 40.0)])
def test_tolerances_hold_bf16_rounding_and_reject_faults(bounded, q_scale):
    """lse_tolerance and backward_tolerance hold the float64 result (the
    fp32 rounding, with the cancellation of dP - delta where the clamp
    saturates a row) and the kernels' bf16 rounding (emulated), while two
    planted faults fail them: delta = 0 (dq, dk) and the last key tile
    skipped (LSE, dq, dk, dv)."""
    q, k, v, g = (t(x).bfloat16().float() for x in _inputs((1, 700, 2, 64), 700, 6))
    q = (q * q_scale).bfloat16().float()
    o, lse = FK.attention_plain(q, k, v, None, bounded, return_lse=True)
    o = o.bfloat16().float()
    lse_tol = FK.lse_tolerance(q, k, lse)
    lse64, *grads64 = _backward64(q, k, v, o, g, bounded)
    _, lse_cut = FK.attention_plain(q, k, v, 640, bounded, return_lse=True)
    assert ((lse64 - lse.double()).abs() <= lse_tol).all()
    assert ((lse_cut - lse).abs() > lse_tol).any()

    ref = FK.attention_backward_plain(q, k, v, o, g, lse, None, bounded)
    tols = FK.backward_tolerance(q, k, v, o, g, lse, None, bounded)

    def rejected(grads):
        return [bool(((a.double() - r).abs() > tol).any()) for a, r, tol in zip(grads, ref, tols)]

    assert rejected(grads64) == [False] * 3
    assert rejected(_bf16_kernel_numerics(q, k, v, o, g, lse, None, bounded)) == [False] * 3
    assert rejected(_bf16_kernel_numerics(q, k, v, torch.zeros_like(o), g, lse, None, bounded)) \
        == [True, True, False]
    assert rejected(_bf16_kernel_numerics(q, k, v, o, g, lse, 640, bounded)) == [True] * 3


def test_backward_wrappers_take_cuda_tensors_only():
    """On CPU tensors flash_attention_backward takes the plain version; the
    per-kernel wrappers launch or raise, never fall back."""
    q, k, v, g = (t(x) for x in _inputs((1, 20, 1, 64), 20, 3))
    o, lse = FK.attention_plain(q, k, v, return_lse=True)
    plain = FK.attention_backward_plain(q, k, v, o, g, lse)
    for a, b in zip(FK.flash_attention_backward(q, k, v, o, g, lse), plain):
        assert torch.equal(a, b)
    with pytest.raises(TypeError):  # the kernels take bf16, and launch nowhere else
        FK.flash_attention_bwd_dq(q, k, v, o, g, lse)
    with pytest.raises(TypeError):
        FK.flash_attention_bwd_dkv(q, k, v, g, lse, lse)
    qb, kb, vb, ob = (x.to(torch.bfloat16) for x in (q, k, v, o))
    with pytest.raises(ValueError, match="do must be bf16"):
        FK.flash_attention_bwd_dq(qb, kb, vb, ob, g, lse)
    with pytest.raises(ValueError, match="lse/delta"):
        FK.flash_attention_bwd_dkv(qb, kb, vb, g.to(torch.bfloat16), lse, lse[:, :, :5])


# ---------------------------------------------------------------------------
# model gradients through the kernels


@pytest.mark.parametrize("embed_dim,kernel", [(64, "head-major"), (128, "packed")])
def test_model_gradients_match_jax_through_kernels(embed_dim, kernel):
    """jax.grad of total_loss(apply(...)) with attn_impl="flash" (D=32: the
    head-major _flash_kernel and its backward kernels; embed 128 / 2 heads:
    the packed kernel, whose gradient reroutes through the same backward)
    vs loss.backward() through the port's kernel wrappers."""
    jcfg, tcfg, params, model = tiny_pair(seed=1, embed_dim=embed_dim, num_heads=2)
    batch = train_batch(S=2, seed=4)
    with pallas_interpret():
        loss_j, grads_j = jax_loss_grads(params, jcfg, batch, "flash")
    loss_t, grads_t = port_loss_grads(model, tcfg, batch, "flash")
    np.testing.assert_allclose(loss_t, loss_j, rtol=1e-5)
    assert_trees_close(grads_t, params_from_jax(grads_j, tcfg), rel=1e-4, floor=1e-7)


def test_flash_gradients_equal_plain_gradients():
    """On the CPU, loss.backward() through impl="flash" (the autograd
    Function's plain backward) gives autograd's gradients of impl="plain"."""
    _, tcfg, _, model = tiny_pair(seed=2, embed_dim=128, num_heads=2)
    batch = train_batch(S=2, seed=5)
    loss_f, grads_f = port_loss_grads(model, tcfg, batch, "flash")
    loss_p, grads_p = port_loss_grads(model, tcfg, batch, "plain")
    np.testing.assert_allclose(loss_f, loss_p, rtol=1e-6)
    assert_trees_close(grads_f, grads_p, rel=1e-5, floor=1e-8)
