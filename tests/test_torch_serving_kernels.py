"""The serving slice's kernel modules against the JAX package on the CPU:
the three quantisers (int8 values equal), the plain versions of the
head-major int8 kernel, the streaming kernel and the 3x3 convolution kernel
against the Pallas kernels in interpret mode, the W8A8 dense and convolution
layers, the space-to-depth rewrite, and the dispatch order.

On CPU tensors each wrapper computes its plain version; the CUDA kernels
are held against the same plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import contextlib
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from omnivggt_tpu.ops import attention as JA
from omnivggt_tpu.ops import layers as JL
from omnivggt_tpu.ops.pallas import conv3x3 as JCV
from omnivggt_tpu.ops.pallas import flash_attention as FA
from omnivggt_tpu_torch.ops import attention as TA
from omnivggt_tpu_torch.ops import layers as TL
from omnivggt_tpu_torch.ops.kernels import conv3x3 as CK
from omnivggt_tpu_torch.ops.kernels import flash_attention as FK
from tests.torch_port_util import pallas_interpret, t

KERNEL_ATOL = 2e-5  # the JAX suite's own kernel tolerance (tests/test_ops.py)
INT8_TO_EXACT = 5e-3  # the JAX suite's int8-to-exact-attention tolerance
SHAPE = (2, 300, 4, 64)  # 300 % 128 != 0: a ragged final key block on the JAX side
VALID = 211


def _qkv(shape=SHAPE, seed=23):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=shape) * 0.5).astype(np.float32) for _ in range(3)]


def _kv(kv):
    """(JAX traced scalar, port device scalar) for a valid-key count."""
    if kv is None:
        return None, None
    return jnp.int32(kv), torch.tensor(kv, dtype=torch.int32)


def _head_major(x8, B, H):
    """(B*H, N, D) -> (B, N, H, D)."""
    x8 = np.asarray(x8)
    return x8.reshape(B, H, *x8.shape[1:]).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("valid", [None, VALID])
def test_quantisers_give_the_jax_int8_grids(valid):
    """All three quantisers produce the JAX package's int8 values exactly
    (round half to even; the head-major one divides by the scale, the
    token-major ones multiply by its reciprocal), with the rows past
    `valid` left out of the scales and clipped. The JAX side runs jitted,
    as the model runs it (under jit XLA turns the step's / 127.0 into a
    multiplication by fp32(1/127); the port does the same)."""
    q, k, _ = _qkv()
    q[:, VALID:] *= 7.0  # padded rows hold garbage well past the real range
    B, N, H, D = SHAPE
    _, kv_t = _kv(valid)
    x8, scale = jax.jit(lambda x: FA._quant_per_head(FA.to_bhnd(x), valid=valid))(jnp.asarray(q))
    y8, y_scale = FK.quant_per_head(t(q), kv_t)
    assert y8.dtype == torch.int8
    np.testing.assert_array_equal(y8.numpy(), _head_major(x8, B, H))
    np.testing.assert_array_equal(y_scale.numpy(), np.asarray(scale).reshape(B, H))

    # the stream kernel's q grid: round(q * qinv), as its kernel body does
    @jax.jit
    def stream_q(q):
        qa = jnp.abs(q)
        if valid is not None:
            qa = jnp.where(jnp.arange(N)[None, :, None, None] < valid, qa, 0.0)
        q_scale = jnp.maximum(jnp.max(qa, axis=(1, 3)), 1e-30) / 127.0
        qinv = jnp.repeat(1.0 / q_scale, D, axis=-1)[:, None, :]
        r = jnp.round(q.reshape(B, N, H * D) * qinv)
        if valid is not None:
            r = jnp.clip(r, -127.0, 127.0)
        return r, q_scale, 1.0 / q_scale

    r, q_scale, q_inv = stream_q(jnp.asarray(q))
    z8, z_scale, z_inv = FK.quant_token_major(t(q), kv_t)
    np.testing.assert_array_equal(z8.numpy().reshape(B, N, H * D), np.asarray(r).astype(np.int8))
    np.testing.assert_array_equal(z_scale.numpy(), np.asarray(q_scale))
    np.testing.assert_array_equal(z_inv.numpy(), np.asarray(q_inv))
    if valid is None:
        k8, k_scale = jax.jit(FA.quant_k_token_major)(jnp.asarray(k))
        a8, a_scale = FK.quant_k_token_major(t(k))
        np.testing.assert_array_equal(a8.numpy(), np.asarray(k8))
        np.testing.assert_array_equal(a_scale.numpy(), np.asarray(k_scale))
        # the two grids are not interchangeable: a division and a
        # multiplication by the reciprocal round ties differently
        assert a8.shape == (B, N, H * D)


@pytest.mark.parametrize("bounded", [False, True])
@pytest.mark.parametrize("kv", [None, VALID])
def test_head_major_int8_plain_matches_pallas(kv, bounded):
    """flash_attention(qk_int8=True) (plain on the CPU) vs _flash_kernel's
    int8 form in interpret mode: atol 2e-5 (the same int8 grid, fp32
    arithmetic on both sides), and the JAX suite's 5e-3 to exact attention."""
    q, k, v = _qkv()
    kv_j, kv_t = _kv(kv)
    with pallas_interpret():
        ref = FA._flash_forward(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 64, 128, kv_valid=kv_j,
            bounded=bounded, qk_int8=True,
        )
    out = FK.flash_attention(t(q), t(k), t(v), kv_valid=kv_t, bounded_logits=bounded,
                             qk_int8=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=KERNEL_ATOL)
    exact = FK.attention_plain(t(q), t(k), t(v), kv_t)
    np.testing.assert_allclose(out.numpy(), exact.numpy(), atol=INT8_TO_EXACT)
    assert FK.flash_attention_int8.launches == 0  # plain runs are not launches


def test_head_major_int8_takes_a_quantised_k():
    """k_quant: an already quantised K gives the result of quantising it
    inside, in both packages (the JAX pair is head-major (B*H, Nk, D))."""
    q, k, v = _qkv((1, 140, 2, 64), 3)
    k8_j, ks_j = FA._quant_per_head(FA.to_bhnd(jnp.asarray(k)))
    with pallas_interpret():
        ref = FA.flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 64, 128, bounded_logits=True,
            qk_int8=True, k_quant=(k8_j, ks_j),
        )
    k_quant = FK.quant_per_head(t(k))
    np.testing.assert_array_equal(k_quant[0].numpy(), _head_major(k8_j, 1, 2))
    out = FK.flash_attention(t(q), None, t(v), bounded_logits=True, qk_int8=True, k_quant=k_quant)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=KERNEL_ATOL)
    inside = FK.flash_attention(t(q), t(k), t(v), bounded_logits=True, qk_int8=True)
    np.testing.assert_array_equal(out.numpy(), inside.numpy())
    with pytest.raises(ValueError, match="k_quant"):
        FK.flash_attention(t(q), t(k), t(v), k_quant=k_quant)
    with pytest.raises(ValueError, match="k_quant"):
        FK.flash_attention(t(q), t(k), t(v), kv_valid=5, qk_int8=True, k_quant=k_quant)


@pytest.mark.parametrize("qk_int8", [False, True])
@pytest.mark.parametrize("kv", [None, VALID])
def test_stream_plain_matches_pallas(kv, qk_int8):
    """flash_attention_packed_stream (plain on the CPU) vs the
    _flash_packed_stream_kernel in interpret mode, bf16 and int8 forms,
    without a mask (ragged key tail on the JAX side) and with a dynamic
    kv_valid; the valid-prefix contract: masking equals dropping the tail."""
    q, k, v = _qkv()
    kv_j, kv_t = _kv(kv)
    with pallas_interpret():
        ref = FA._flash_packed_stream_forward(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 64, 128, kv_valid=kv_j,
            qk_int8=qk_int8,
        )
    out = FK.flash_attention_packed_stream(t(q), t(k), t(v), kv_valid=kv_t, qk_int8=qk_int8)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=KERNEL_ATOL)
    exact = FK.attention_plain(t(q), t(k), t(v), kv_t)
    np.testing.assert_allclose(out.numpy(), exact.numpy(),
                               atol=INT8_TO_EXACT if qk_int8 else KERNEL_ATOL)
    if kv is not None and not qk_int8:
        dropped = FK.flash_attention_packed_stream(t(q), t(k)[:, :kv], t(v)[:, :kv])
        np.testing.assert_allclose(out.numpy(), dropped.numpy(), atol=KERNEL_ATOL)
    assert FK.flash_attention_packed_stream.launches == 0


def test_stream_takes_a_quantised_k():
    q, k, v = _qkv((1, 140, 2, 64), 4)
    k_quant_j = FA.quant_k_token_major(jnp.asarray(k))
    with pallas_interpret():
        ref = FA.flash_attention_packed_stream(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 64, 128, qk_int8=True,
            k_quant=k_quant_j,
        )
    out = FK.flash_attention_packed_stream(
        t(q), None, t(v), qk_int8=True, k_quant=FK.quant_k_token_major(t(k))
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=KERNEL_ATOL)
    with pytest.raises(ValueError, match="k_quant"):
        FK.flash_attention_packed_stream(t(q), t(k), t(v), k_quant=FK.quant_k_token_major(t(k)))


@pytest.mark.parametrize("kv", [None, 130])
def test_stream_gradient_routes_through_the_head_major_backward(kv, monkeypatch):
    """Under grad the bf16 stream wrapper runs the head-major forward with
    its LSE and the backward kernels (plain versions here), as the JAX
    package routes its AD; the gradients match the JAX package's."""
    q, k, v = _qkv((1, 160, 2, 64), 29)
    kv_j, kv_t = _kv(kv)
    calls = []
    backward = FK.flash_attention_backward
    monkeypatch.setattr(FK, "flash_attention_backward",
                        lambda *a, **kw: (calls.append(a[-1]), backward(*a, **kw))[1])

    with pallas_interpret():
        g_ref = jax.grad(
            lambda q, k, v: jnp.sum(FA.flash_attention_packed_stream(q, k, v, kv_valid=kv_j) ** 2),
            argnums=(0, 1, 2),
        )(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (t(x).requires_grad_(True) for x in (q, k, v))
    (FK.flash_attention_packed_stream(tq, tk, tv, kv_valid=kv_t) ** 2).sum().backward()
    assert calls == [True]  # one backward, in bounded mode
    for a, b in zip((tq, tk, tv), g_ref):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), atol=2e-4, rtol=1e-4)
    for fn in (FK.flash_attention_packed_stream, FK.flash_attention):
        with pytest.raises(ValueError, match="serving-only"):
            fn(tq, tk, tv, qk_int8=True)


def test_stream_contract_and_no_fallback():
    """D == 64 and an even head count, on every device; tensors that are
    neither all on the CPU nor all on CUDA raise instead of taking the
    plain version."""
    c = torch.zeros(1, 8, 2, 64)
    for bad in (torch.zeros(1, 8, 2, 128), torch.zeros(1, 8, 3, 64)):
        with pytest.raises(ValueError, match="head dim 64"):
            FK.flash_attention_packed_stream(bad, bad, bad)
    m = torch.zeros(1, 8, 2, 64, device="meta")
    for int8 in (False, True):
        with pytest.raises(ValueError, match="CPU or all on CUDA"):
            FK.flash_attention_packed_stream(m, m, m, qk_int8=int8)
        with pytest.raises(ValueError, match="CPU or all on CUDA"):
            FK.flash_attention_packed_stream(c, m, c, qk_int8=int8)
    with pytest.raises(ValueError, match="CPU or all on CUDA"):
        FK.flash_attention(m, m, m, qk_int8=True)
    assert set(FK.launches()) >= {"flash_attention_int8", "flash_attention_packed_stream"}


def test_every_forward_form_takes_128_row_query_tiles():
    """The int8 forms run the bf16 form's 128-row query tile: the
    token-major grid's limit (65535 query tiles on grid y) counts 128-row
    tiles for each form, the head-major grid's B * H blocks on grid y."""

    def meta(n, dtype, h=2):
        return torch.empty((1, n, h, 64), dtype=dtype, device="meta")

    bf16, i8 = torch.bfloat16, torch.int8
    most = FK.QUERY_TILE * 65535
    for qk, q_dtype, k_dtype in ((FK.SCORES_BF16, bf16, bf16), (FK.SCORES_INT8_Q_IN, bf16, i8),
                                 (FK.SCORES_INT8, i8, i8)):
        assert FK._check(meta(most, q_dtype), meta(8, k_dtype), meta(8, bf16), True, qk)[1] == most
        with pytest.raises(ValueError, match="grid too large"):
            FK._check(meta(most + 1, q_dtype), meta(8, k_dtype), meta(8, bf16), True, qk)
        FK._check(meta(most + 1, q_dtype), meta(8, k_dtype), meta(8, bf16), False, qk)
        with pytest.raises(ValueError, match="grid too large"):
            FK._check(meta(8, q_dtype, 65536), meta(8, k_dtype, 65536), meta(8, bf16, 65536),
                      False, qk)


def test_int8_forms_pass_the_fault_hook_to_the_kernel(monkeypatch):
    """Both int8 forms take the kernel's kv_head_shift test hook as the bf16
    form does: the launch hands it to the C entry point with the form's
    score code, its per-head scalars and q's and k's strides in elements of
    their own type, and counts itself (the entry point recorded, not run)."""
    calls = []
    monkeypatch.setattr(FK, "_libraries", lambda: (lambda *a: calls.append(a) or 0, None, None, ""))
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    for fn in (FK.flash_attention_int8, FK.flash_attention_packed_stream):
        monkeypatch.setattr(fn, "launches", 0)
    q, k, v = (t(x).to(torch.bfloat16) for x in _qkv())
    B, N, H, D = q.shape
    (q8, q_scale), (k8, k_scale) = FK.quant_per_head(q), FK.quant_per_head(k)
    FK._launch_fwd(FK.flash_attention_int8, q8, k8, v, None, True, FK.MODE_HEAD_MAJOR,
                   qk=FK.SCORES_INT8, c=q_scale * k_scale * D**-0.5, kv_head_shift=1)
    kt8, kt_scale = FK.quant_k_token_major(k)
    _, q_scale, q_inv = FK.quant_token_major(q)
    q8_out = torch.empty(q.shape, dtype=torch.int8)
    FK._launch_fwd(FK.flash_attention_packed_stream, q, kt8.reshape(B, N, H, D), v, VALID, True,
                   FK.MODE_TOKEN_MAJOR, qk=FK.SCORES_INT8_Q_IN, c=q_scale * kt_scale * D**-0.5,
                   qinv=q_inv, q8_out=q8_out, kv_head_shift=1)
    assert FK.flash_attention_int8.launches == FK.flash_attention_packed_stream.launches == 1
    (hm, st) = calls
    token = [N * H * D, H * D, D]
    assert hm[:4] == (FK.MODE_HEAD_MAJOR, 1, D, FK.SCORES_INT8) and hm[-1] == 1
    assert st[:4] == (FK.MODE_TOKEN_MAJOR, 1, D, FK.SCORES_INT8_Q_IN) and st[-1] == 1
    assert list(hm[12]) == token * 4 and list(st[12]) == token * 4
    assert hm[8] is None and hm[10] is None and hm[11] is None  # no LSE, qinv, q8_out
    assert st[9] is not None and st[10] is not None and st[11] == q8_out.data_ptr()
    assert (hm[13:18], st[13:18]) == ((B, H, N, N, N), (B, H, N, N, VALID))


def test_dispatch_order_matches_the_jax_package(monkeypatch):
    """packed (it wins over qk_int8) -> stream when eligible -> head-major,
    the stream flag off by default under the JAX package's variable name."""
    assert TA._STREAM_ATTN is False and JA._STREAM_ATTN is False
    shapes = [((1, 4096, 16, 64), 4096), ((1, 4096, 16, 128), 4096), ((1, 4096, 3, 64), 4096),
              ((8, 1374, 16, 64), 1374)]
    for flag in (False, True):
        monkeypatch.setattr(TA, "_STREAM_ATTN", flag)
        monkeypatch.setattr(JA, "_STREAM_ATTN", flag)
        for shape, nk in shapes:
            for bounded in (False, True):
                assert TA.stream_eligible(shape, nk, bounded) == JA.stream_eligible(shape, nk, bounded)
    called = []
    for name in ("flash_attention", "flash_attention_packed", "flash_attention_packed_stream"):
        monkeypatch.setattr(
            TA, name, lambda *a, _n=name, **kw: called.append((_n, kw.get("qk_int8", False))))
    q = torch.zeros(1, 8, 2, 64)
    short, long = torch.zeros(1, 2048, 2, 64), torch.zeros(1, 2049, 2, 64)
    for kv_len, bounded in ((short, True), (long, True), (long, False)):
        TA.scaled_dot_product_attention(q, kv_len, kv_len, impl="flash", bounded_logits=bounded,
                                        qk_int8=True)
    monkeypatch.setattr(TA, "_STREAM_ATTN", False)
    TA.scaled_dot_product_attention(q, long, long, impl="flash", bounded_logits=True, qk_int8=True)
    assert called == [
        ("flash_attention_packed", False), ("flash_attention_packed_stream", True),
        ("flash_attention", True), ("flash_attention", True),
    ]


# the JAX suite's three cases (tests/test_ops.py): (B, H, W, cin, cout, relu)
CONV_CASES = [(2, 24, 22, 64, 32, False), (1, 16, 18, 128, 64, True), (1, 13, 10, 16, 8, True)]


def _conv_case(case, seed=23):
    B, H, W, cin, cout, relu = case
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, H, W, cin)).astype(np.float32)
    w = (rng.normal(size=(3, 3, cin, cout)) * 0.1).astype(np.float32)
    b = rng.normal(size=(cout,)).astype(np.float32)
    conv = torch.nn.Conv2d(cin, cout, 3, padding=1)
    with torch.no_grad():
        conv.weight.copy_(t(w).permute(3, 2, 0, 1))
        conv.bias.copy_(t(b))
    return x, {"w": jnp.asarray(w), "b": jnp.asarray(b)}, conv


@pytest.mark.parametrize("case", CONV_CASES)
def test_conv3x3_plain_matches_pallas(case):
    """conv3x3_folded (plain on the CPU) vs the Pallas _conv_kernel in
    interpret mode, atol 2e-5; both packages call the same convs eligible."""
    x, p, conv = _conv_case(case)
    relu = case[-1]
    assert JCV.conv3x3_eligible(x.shape, p["w"].shape)
    with pallas_interpret():
        ref = np.asarray(JCV.conv3x3_folded(p, jnp.asarray(x), relu=relu))
    xt = t(x).permute(0, 3, 1, 2)
    assert CK.conv3x3_eligible(xt.shape, conv.weight.shape)
    with torch.no_grad():
        out = CK.conv3x3_folded(conv, xt, relu=relu)
        out_cl = CK.conv3x3_folded(conv, xt.contiguous(memory_format=torch.channels_last), relu)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), ref, atol=KERNEL_ATOL)
    np.testing.assert_allclose(out_cl.permute(0, 2, 3, 1).numpy(), ref, atol=KERNEL_ATOL)
    assert CK.conv3x3_folded.launches == 0


def test_conv3x3_eligibility_and_contract():
    """Which convs the kernel serves: 3x3 with cout <= 64, as in the JAX
    package; ineligible shapes and non-CPU, non-CUDA tensors raise."""
    for x_nhwc, w_hwio in (((1, 12, 10, 16), (1, 1, 16, 8)), ((1, 12, 10, 128), (3, 3, 128, 128)),
                           ((8, 518, 518, 128), (3, 3, 128, 32)), ((8, 296, 296, 256), (3, 3, 256, 128)),
                           ((1, 16, 16, 8), (3, 3, 8, 64)), ((1, 16, 16, 8), (3, 3, 8, 65))):
        B, H, W, cin = x_nhwc
        kh, kw, _, cout = w_hwio
        assert CK.conv3x3_eligible((B, cin, H, W), (cout, cin, kh, kw)) == \
            JCV.conv3x3_eligible(x_nhwc, w_hwio), (x_nhwc, w_hwio)
    wide = torch.nn.Conv2d(8, 128, 3, padding=1)
    with pytest.raises(ValueError, match="ineligible"):
        CK.conv3x3_folded(wide, torch.zeros(1, 8, 4, 4))
    conv = torch.nn.Conv2d(8, 16, 3, padding=1)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        CK.conv3x3_folded(conv, torch.zeros(1, 8, 4, 4, device="meta"))
    with pytest.raises(ValueError, match="channels"):
        CK.conv3x3_folded(conv, torch.zeros(1, 4, 4, 4))


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("case", [CONV_CASES[0], CONV_CASES[1], (1, 12, 10, 16, 8, True)])
def test_conv2d_s2d_matches_jax(case, int8):
    """The space-to-depth rewrite against the JAX package's, and against
    the plain 3x3 convolution it rewrites (atol 2e-5; W8A8: the stride-2
    kernel's zero taps leave the per-channel weight scales unchanged, so
    the int8 grids of both packages agree)."""
    x, p, conv = _conv_case(case, seed=5)
    ref = np.asarray(JL.conv2d_s2d(p, jnp.asarray(x), int8=int8))
    xt = t(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        out = TL.conv2d_s2d(conv, xt, int8=int8)
        direct = TL.conv2d(conv, xt, padding=1, int8=int8)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), ref, atol=KERNEL_ATOL)
    np.testing.assert_allclose(out.numpy(), direct.numpy(), atol=KERNEL_ATOL)
    with pytest.raises(ValueError, match="even"):
        TL.conv2d_s2d(conv, xt[:, :, :-1])


def test_qlinear_int8_is_exact_and_matches_jax():
    """On an integer grid the W8A8 product is exact even at K = 4096, where
    an fp32 product of the same integers is not (127^2 * 4096 > 2^24);
    off the grid it matches the JAX package to fp32 rounding."""
    rng = np.random.default_rng(0)
    K, N = 4096, 24
    lin = torch.nn.Linear(K, N)
    xi = rng.integers(-127, 128, size=(5, K))
    wi = rng.integers(-127, 128, size=(N, K))
    xi[:, 0] = 127  # every row and column reaches 127: the scales are 1
    wi[:, 0] = -127
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(wi).float())
        lin.bias.zero_()
        out = TL.qlinear_int8(lin, torch.from_numpy(xi).float())
    np.testing.assert_array_equal(out.numpy().astype(np.int64), xi @ wi.T)

    x = rng.normal(size=(3, 7, 64)).astype(np.float32)
    w = (rng.normal(size=(64, 40)) * 0.2).astype(np.float32)
    b = rng.normal(size=(40,)).astype(np.float32)
    ref = np.asarray(JL.qlinear_int8({"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x)))
    lin = torch.nn.Linear(64, 40)
    with torch.no_grad():
        lin.weight.copy_(t(w).T)
        lin.bias.copy_(t(b))
        out = TL.dense(lin, t(x), int8=True)
        plain = TL.dense(lin, t(x))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)
    assert 0 < np.abs(out.numpy() - plain.numpy()).max() < 0.1  # quantised, and close
    assert TL._quant_gates("int8") == JL._quant_gates("int8") == (True, True)
    assert TL._quant_gates("int8_ln") == JL._quant_gates("int8_ln") == (True, False)
    assert TL._quant_gates("none") == JL._quant_gates("none") == (False, False)


@pytest.mark.parametrize("stride,padding", [(1, 1), (2, 1), (1, 0)])
def test_qconv2d_int8_matches_jax(stride, padding):
    """The W8A8 convolution (exact integer sum) against the JAX package's
    s8 x s8 -> s32 convolution: per-image activation scales, per-channel
    weight scales."""
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(2, 11, 9, 12)) * np.array([1.0, 30.0])[:, None, None, None]).astype(np.float32)
    w = (rng.normal(size=(3, 3, 12, 10)) * 0.1).astype(np.float32)
    b = rng.normal(size=(10,)).astype(np.float32)
    ref = np.asarray(JL.qconv2d_int8(
        {"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x), stride=(stride, stride),
        padding=((padding, padding), (padding, padding))))
    conv = torch.nn.Conv2d(12, 10, 3)
    with torch.no_grad():
        conv.weight.copy_(t(w).permute(3, 2, 0, 1))
        conv.bias.copy_(t(b))
        out = TL.conv2d(conv, t(x).permute(0, 3, 1, 2), stride=stride, padding=padding, int8=True)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), ref, atol=1e-4, rtol=1e-5)


def test_layout_probes_need_the_card():
    """The probe tool runs its kernels on the card only; its torch
    references are the JAX probes' array functions."""
    from omnivggt_tpu_torch.tools import probe_layouts as PL

    with pytest.raises(RuntimeError, match="CUDA"):
        PL.run()
    entries = PL.probes(torch.device("cpu"))
    assert len(entries) == 11  # the ten probes, the second in two alignments
    x = np.random.default_rng(0).normal(size=(PL.R, PL.W2, PL.C)).astype(np.float32)
    shapes = [tuple(ref().shape) for _, _, ref, _ in entries]
    R, W2, C = PL.R, PL.W2, PL.C
    assert shapes == [
        (R // 2, W2, C), (512, C), (432, C), (R // 2 - 1, W2, 2 * C), (R, W2 - 1, 2 * C),
        (R * (W2 - 1), 128), (R, W2, C), (R // 2, W2, C), (R, W2 // 2, C),
        (R, W2 // 2, 2 * C), (64, 128),
    ]
    # roll(x, 1, 1) is the function the TPU probe's pltpu.roll computes
    np.testing.assert_array_equal(torch.roll(t(x), 1, 1).numpy(), np.asarray(jnp.roll(x, 1, 1)))
