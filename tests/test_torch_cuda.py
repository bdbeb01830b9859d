"""Hopper kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU with nvcc (sm_90a) and skips without
one. This file imports neither JAX nor the JAX package, so it runs on a
machine that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

(`--noconftest`: tests/conftest.py sets up JAX for the CPU suite.)
"""

import numpy as np
import pytest
import torch

from omnivggt_tpu_torch.ops.kernels import flash_attention as FK

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _qkv(shape_q, n_keys, seed, device, scale=1.0):
    rng = np.random.default_rng(seed)
    B, N, H, D = shape_q
    q = rng.normal(size=(B, N, H, D)) * scale
    k = rng.normal(size=(B, n_keys, H, D)) * scale
    v = rng.normal(size=(B, n_keys, H, D))
    return [torch.tensor(x, dtype=torch.bfloat16, device=device) for x in (q, k, v)]


def _check(out, q, k, v, kv_valid, bounded):
    # the plain version in fp32 from the same bf16 inputs; the kernel rounds
    # P to bf16 before P @ V (o within 2^-8 max|v|) and o to bf16 (within
    # 2^-8 |o| <= 2^-8 max|v|): 2^-7 max|v| bounds both
    ref = FK.attention_plain(q.float(), k.float(), v.float(), kv_valid, bounded)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    err = (out.float() - ref).abs().max().item()
    tol = 2.0**-7 * v.float().abs().max().item()
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("bounded", [False, True])
@pytest.mark.parametrize(
    "shape,n_keys,kv_valid",
    [
        ((1, 203, 2, 64), 203, None),
        ((2, 300, 3, 128), 300, None),
        ((2, 130, 2, 64), 130, 77),
        ((1, 64, 1, 64), 64, 64),
        ((3, 100, 2, 64), 257, 200),
    ],
)
def test_kernels_match_plain(cuda, shape, n_keys, kv_valid, bounded):
    q, k, v = _qkv(shape, n_keys, 0, cuda)
    for fn in (FK.flash_attention, FK.flash_attention_packed):
        out = fn(q, k, v, kv_valid=kv_valid, bounded_logits=bounded)
        torch.cuda.synchronize()
        _check(out, q, k, v, kv_valid, bounded)


def test_dynamic_kv_valid_and_strided_inputs(cuda):
    """A device-scalar kv_valid equals the same static count, and strided
    views of a fused qkv tensor are read in place."""
    rng = np.random.default_rng(1)
    B, N, H, D = 2, 150, 4, 64
    qkv = torch.tensor(
        rng.normal(size=(B, N, 3, H, D)), dtype=torch.bfloat16, device=cuda
    )
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    for bounded in (False, True):
        for fn in (FK.flash_attention, FK.flash_attention_packed):
            a = fn(q, k, v, kv_valid=99, bounded_logits=bounded)
            b = fn(q, k, v, kv_valid=torch.tensor(99, device=cuda), bounded_logits=bounded)
            torch.cuda.synchronize()
            assert torch.equal(a, b)
            _check(a, q, k, v, 99, bounded)


def test_bounded_clamp_stays_finite(cuda):
    """Scores far past the clamp saturate instead of overflowing."""
    q, k, v = _qkv((1, 96, 2, 64), 96, 2, cuda)
    q = q * 40
    for fn in (FK.flash_attention, FK.flash_attention_packed):
        out = fn(q, k, v, bounded_logits=True)
        torch.cuda.synchronize()
        assert torch.isfinite(out.float()).all()
        _check(out, q, k, v, None, True)


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    q, k, v = _qkv((1, 64, 2, 64), 64, 3, cuda)
    with pytest.raises(TypeError):
        FK.flash_attention(q.float(), k.float(), v.float())
    q32, k32, v32 = _qkv((1, 64, 2, 32), 64, 3, cuda)
    with pytest.raises(ValueError):
        FK.flash_attention_packed(q32, k32, v32)


def test_launch_counters(cuda):
    q, k, v = _qkv((1, 64, 2, 64), 64, 4, cuda)
    FK.reset_launches()
    FK.flash_attention(q, k, v)
    FK.flash_attention_packed(q, k, v)
    FK.flash_attention_packed(q, k, v)
    FK.attention_plain(q, k, v)
    assert (FK.flash_attention.launches, FK.flash_attention_packed.launches) == (1, 2)
    assert FK.flash_attention_bwd_dq.launches == FK.flash_attention_bwd_dkv.launches == 0


def _check_backward(q, k, v, o, lse, do, kv_valid, bounded, grads):
    """The kernel's LSE against attention_plain's within FK.lse_tolerance,
    and grads (dq, dk, dv) against attention_backward_plain in fp32 from
    the same bf16 inputs and the plain LSE, entry by entry within
    FK.backward_tolerance."""
    f = [x.float() for x in (q, k, v)]
    _, lse_ref = FK.attention_plain(*f, kv_valid, bounded, return_lse=True)
    lse_err = (lse - lse_ref).abs()
    assert (lse_err <= FK.lse_tolerance(q, k, lse_ref, kv_valid)).all(), lse_err.max()
    f += [o.float(), do.float()]
    ref = FK.attention_backward_plain(*f, lse_ref, kv_valid, bounded)
    tols = FK.backward_tolerance(*f, lse_ref, kv_valid, bounded, lse_err=lse_err.max().item())
    for name, g, r, tol in zip(("dq", "dk", "dv"), grads, ref, tols):
        assert g.shape == r.shape and g.dtype == torch.bfloat16, name
        err = (g.float() - r).abs()
        assert (err <= tol).all(), (name, err.max().item(), (err / tol.clamp_min(1e-30)).max().item())


@pytest.mark.parametrize("bounded", [False, True])
@pytest.mark.parametrize(
    "shape,n_keys,kv_valid",
    [
        ((1, 203, 2, 64), 203, None),
        ((2, 300, 3, 128), 300, None),
        ((2, 130, 2, 64), 130, 77),
        ((3, 100, 2, 64), 257, "tensor"),
    ],
)
def test_backward_kernels_match_plain(cuda, shape, n_keys, kv_valid, bounded):
    """The forward's LSE output and both backward kernels against their
    plain versions: ragged N, D 128, static and dynamic kv_valid."""
    if kv_valid == "tensor":
        kv_valid = torch.tensor(200, device=cuda)
    q, k, v = _qkv(shape, n_keys, 5, cuda)
    o, lse = FK._launch(q, k, v, kv_valid, bounded, packed=False, with_lse=True)
    _, lse_ref = FK.attention_plain(q.float(), k.float(), v.float(), kv_valid, bounded,
                                    return_lse=True)
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-5)
    do = torch.randn(o.shape, device=cuda).to(torch.bfloat16)
    before = (FK.flash_attention_bwd_dq.launches, FK.flash_attention_bwd_dkv.launches)
    grads = FK.flash_attention_backward(q, k, v, o, do, lse, kv_valid, bounded)
    torch.cuda.synchronize()
    assert (FK.flash_attention_bwd_dq.launches, FK.flash_attention_bwd_dkv.launches) == (
        before[0] + 1, before[1] + 1)
    _check_backward(q, k, v, o, lse, do, kv_valid, bounded, grads)


def test_backward_clamp_saturation(cuda):
    """q x 40 saturates the bounded clamp: the gradient passes straight
    through it and stays finite."""
    q, k, v = _qkv((1, 96, 2, 64), 96, 6, cuda)
    q = q * 40
    o, lse = FK._launch(q, k, v, None, True, packed=True, with_lse=True)
    do = torch.randn(o.shape, device=cuda).to(torch.bfloat16)
    grads = FK.flash_attention_backward(q, k, v, o, do, lse, None, True)
    torch.cuda.synchronize()
    assert all(torch.isfinite(g.float()).all() for g in grads)
    _check_backward(q, k, v, o, lse, do, None, True, grads)


@pytest.mark.parametrize("packed", [False, True])
def test_autograd_matches_plain_autograd(cuda, packed):
    """loss.backward() through the autograd.Function (forward kernel with
    LSE, both backward kernels) against autograd through the plain
    version, on strided views of a fused qkv tensor; the counters move by
    one launch of each kernel."""
    rng = np.random.default_rng(7)
    B, N, H, D = 2, 150, 4, 64
    qkv = torch.tensor(rng.normal(size=(B, N, 3, H, D)), dtype=torch.bfloat16, device=cuda)
    g = torch.tensor(rng.normal(size=(B, N, H, D)), dtype=torch.float32, device=cuda)
    fn = FK.flash_attention_packed if packed else FK.flash_attention
    leaf = qkv.clone().requires_grad_(True)
    FK.reset_launches()
    out = fn(*leaf.unbind(2), kv_valid=120, bounded_logits=True)
    (out.float() * g).sum().backward()
    torch.cuda.synchronize()
    assert FK.launches() == {
        "flash_attention": int(not packed), "flash_attention_packed": int(packed),
        "flash_attention_bwd_dq": 1, "flash_attention_bwd_dkv": 1,
    }
    # the Function fed the kernels the forward's own o and LSE: its
    # gradients are the plain backward's on them, within the bf16 bounds
    q, k, v = qkv.unbind(2)
    o, lse = FK._launch(q, k, v, 120, True, packed, with_lse=True)
    _check_backward(q, k, v, o, lse, g.to(torch.bfloat16), 120, True, leaf.grad.unbind(2))
    # and the plain backward is autograd's gradient of the plain forward
    ref_leaf = qkv.float().requires_grad_(True)
    ref = FK.attention_plain(*ref_leaf.unbind(2), 120, True)
    (ref * g).sum().backward()
    o32, lse32 = FK.attention_plain(q.float(), k.float(), v.float(), 120, True, return_lse=True)
    plain = FK.attention_backward_plain(q.float(), k.float(), v.float(), o32, g, lse32, 120, True)
    for i, grad in enumerate(plain):
        torch.testing.assert_close(grad, ref_leaf.grad[:, :, i], atol=1e-4, rtol=1e-4)
