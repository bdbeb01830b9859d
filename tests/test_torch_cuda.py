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
    FK.flash_attention.launches = FK.flash_attention_packed.launches = 0
    FK.flash_attention(q, k, v)
    FK.flash_attention_packed(q, k, v)
    FK.flash_attention_packed(q, k, v)
    FK.attention_plain(q, k, v)
    assert (FK.flash_attention.launches, FK.flash_attention_packed.launches) == (1, 2)
