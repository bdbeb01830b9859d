"""The Hopper kernels' plain versions against the Pallas kernels they
replace, run in interpret mode on the CPU, plus the CPU-side contract of
the kernel wrappers and the attention dispatch.

On CPU tensors each wrapper computes its plain version; the CUDA kernels
themselves are checked against the same plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from omnivggt_tpu.ops.pallas import flash_attention as FA
from omnivggt_tpu_torch.ops import attention as TA
from omnivggt_tpu_torch.ops.kernels import build
from omnivggt_tpu_torch.ops.kernels import flash_attention as FK
from tests.torch_port_util import pallas_interpret, t

KERNEL_ATOL = 2e-5  # the JAX suite's own kernel tolerance (tests/test_ops.py)


def _qkv(shape, seed, n_keys=None, scale=1.0):
    rng = np.random.default_rng(seed)
    B, N, H, D = shape
    nk = n_keys or N
    q = (rng.normal(size=(B, N, H, D)) * scale).astype(np.float32)
    k = rng.normal(size=(B, nk, H, D)).astype(np.float32)
    v = rng.normal(size=(B, nk, H, D)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("bounded", [False, True])
@pytest.mark.parametrize(
    "shape,kv_valid",
    [((1, 203, 2, 64), None), ((2, 300, 3, 128), None), ((2, 250, 2, 64), 150)],
)
def test_head_major_plain_matches_pallas(shape, kv_valid, bounded):
    """flash_attention (plain on CPU) vs _flash_forward (the _flash_kernel)
    in interpret mode: ragged N, D 64 and 128, a dynamic kv_valid."""
    q, k, v = _qkv(shape, 0)
    with pallas_interpret():
        ref = FA._flash_forward(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 64, 128,
            kv_valid=None if kv_valid is None else jnp.int32(kv_valid),
            bounded=bounded,
        )
    kv_t = None if kv_valid is None else torch.tensor(kv_valid)
    out = FK.flash_attention(t(q), t(k), t(v), kv_valid=kv_t, bounded_logits=bounded)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=KERNEL_ATOL)


@pytest.mark.parametrize("bounded", [False, True])
@pytest.mark.parametrize("kv_valid", [None, 77, "traced"])
def test_packed_plain_matches_pallas(kv_valid, bounded):
    """flash_attention_packed (plain on CPU) vs the _flash_packed_kernel in
    interpret mode: kv_valid absent, static, and traced (dynamic)."""
    q, k, v = _qkv((3, 107, 4, 16), 1)
    if kv_valid == "traced":
        kv_j, kv_t = jnp.asarray(77, jnp.int32), torch.tensor(77)
    else:
        kv_j = kv_t = kv_valid
    with pallas_interpret():
        ref = FA.flash_attention_packed(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_valid=kv_j,
            bounded_logits=bounded,
        )
    out = FK.flash_attention_packed(t(q), t(k), t(v), kv_valid=kv_t, bounded_logits=bounded)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=KERNEL_ATOL)


@pytest.mark.parametrize("bounded", [False, True])
def test_packed_plain_matches_pallas_head_dim_128(bounded):
    q, k, v = _qkv((1, 45, 2, 128), 2)
    with pallas_interpret():
        ref = FA._flash_packed_forward(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, bounded=bounded
        )
    out = FK.flash_attention_packed(t(q), t(k), t(v), bounded_logits=bounded)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=KERNEL_ATOL)


@pytest.mark.parametrize("kernel", ["flash_attention", "flash_attention_packed"])
def test_bounded_clamp_saturates_like_pallas(kernel):
    """q x 40 pushes scores far past the clamp at 80: both sides saturate
    to the same finite result instead of overflowing."""
    q, k, v = _qkv((1, 96, 2, 64), 3, scale=40.0)
    with pallas_interpret():
        if kernel == "flash_attention":
            ref = FA._flash_forward(
                jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 64, 128, bounded=True
            )
        else:
            ref = FA._flash_packed_forward(
                jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, bounded=True
            )
    out = getattr(FK, kernel)(t(q), t(k), t(v), bounded_logits=True).numpy()
    assert np.isfinite(out).all() and np.isfinite(np.asarray(ref)).all()
    np.testing.assert_allclose(out, np.asarray(ref), atol=KERNEL_ATOL)


def test_plain_attention_matches_xla_attention():
    """The "plain" impl vs the JAX package's _attention_xla, with static
    (sliced) and tensor (masked) kv_valid."""
    from omnivggt_tpu.ops.attention import _attention_xla

    q, k, v = _qkv((2, 90, 2, 32), 4)
    for kv_j, kv_t in ((None, None), (60, 60), (60, torch.tensor(60))):
        ref = np.asarray(_attention_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_j))
        out = TA.scaled_dot_product_attention(t(q), t(k), t(v), impl="plain", kv_valid=kv_t)
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


def test_dispatch(monkeypatch):
    """"auto" is plain on CPU up to PLAIN_MAX_SEQ tokens and blockwise past
    it (tests/test_torch_blockwise.py holds the rule against the JAX
    package's); "flash" takes the packed kernel up to PACKED_MAX_KEYS keys
    and the head-major kernel past it; an impl the port does not have
    raises."""
    q = torch.zeros(1, 2048, 1, 64)
    assert TA.resolve_impl(q, "auto") == "plain"
    assert TA.resolve_impl(torch.zeros(1, 8192, 1, 64, device="meta"), "auto") == "blockwise"
    assert TA.resolve_impl(torch.zeros(1, 4, 1, 64, device="meta"), "auto") == "plain"
    called = []
    monkeypatch.setattr(TA, "flash_attention", lambda *a, **kw: called.append("head_major"))
    monkeypatch.setattr(TA, "flash_attention_packed", lambda *a, **kw: called.append("packed"))
    for nk in (FK.PACKED_MAX_KEYS, FK.PACKED_MAX_KEYS + 1):
        kv = torch.zeros(1, nk, 1, 64)
        TA.scaled_dot_product_attention(q, kv, kv, impl="flash")
    assert called == ["packed", "head_major"]
    with pytest.raises(ValueError):
        TA.scaled_dot_product_attention(q, q, q, impl="xla")


def test_wrappers_never_fall_back_off_the_cpu():
    """Tensors that are neither all on the CPU nor all on CUDA raise instead
    of taking the plain version; the packed kernel's key contract holds on
    every device; plain runs leave the launch counters alone."""
    m = torch.zeros(1, 8, 1, 64, device="meta")
    c = torch.zeros(1, 8, 1, 64)
    for fn in (FK.flash_attention, FK.flash_attention_packed):
        with pytest.raises(ValueError):
            fn(m, m, m)
        with pytest.raises(ValueError):
            fn(c, m, c)
    long_k = torch.zeros(1, FK.PACKED_MAX_KEYS + 1, 1, 64)
    with pytest.raises(ValueError):
        FK.flash_attention_packed(c, long_k, long_k)
    before = (FK.flash_attention.launches, FK.flash_attention_packed.launches)
    FK.flash_attention(c, c, c)
    FK.flash_attention_packed(c, c, c)
    assert (FK.flash_attention.launches, FK.flash_attention_packed.launches) == before


def test_build_is_keyed_by_source_and_needs_nvcc(monkeypatch, tmp_path):
    """The library name carries a hash of the source; without nvcc the build
    raises a clear error (no silent fallback)."""
    path = build.library_path("flash_attention.cu")
    assert path.parent == build.BUILD_DIR and path.suffix == ".so"
    assert path == build.library_path("flash_attention.cu")
    assert "sm_90a" in " ".join(build.NVCC_FLAGS)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build("flash_attention.cu")
