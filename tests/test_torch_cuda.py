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


def _kv(kv_valid, device):
    return torch.tensor(217, device=device) if kv_valid == "device" else kv_valid


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("bounded", [False, True])
@pytest.mark.parametrize(
    "shape,n_keys,kv_valid",
    [
        ((2, 333, 3, 64), 333, None),  # N not a multiple of 128
        ((1, 200, 2, 64), 77, None),  # Nk < 128
        ((2, 300, 2, 64), 300, 1),
        ((2, 300, 2, 64), 300, 256),  # a multiple of 128
        ((2, 300, 2, 64), 300, 290),  # inside the last tile
        ((2, 300, 2, 64), 300, "device"),
        ((1, 260, 2, 128), 260, None),
        ((2, 300, 2, 128), 384, "device"),
    ],
)
def test_tma_kernel_and_lse_match_plain(cuda, shape, n_keys, kv_valid, bounded, packed):
    """The bf16 kernel (TMA + wgmma, 128-row tiles) on both grids against
    attention_plain: o within 2^-7 max|v|, the LSE row by row within
    FK.lse_tolerance."""
    q, k, v = _qkv(shape, n_keys, 5, cuda)
    kv = _kv(kv_valid, cuda)
    o, lse = FK._launch(q, k, v, kv, bounded, packed, with_lse=True)
    torch.cuda.synchronize()
    _check(o, q, k, v, kv, bounded)
    _, lse_ref = FK.attention_plain(q.float(), k.float(), v.float(), kv, bounded, return_lse=True)
    tol = FK.lse_tolerance(q, k, lse_ref, kv)
    assert ((lse - lse_ref).abs() <= tol).all(), ((lse - lse_ref).abs() / tol).max().item()


@pytest.mark.parametrize("packed", [False, True])
def test_tma_kernel_with_no_valid_key(cuda, packed):
    """kv_valid = 0 (static or on the device): no key tile is visited, o is
    0 and the LSE +1e30, so the backward's p = exp(s - lse) is 0."""
    q, k, v = _qkv((1, 150, 2, 64), 150, 8, cuda)
    for kv in (0, torch.tensor(0, device=cuda)):
        for bounded in (False, True):
            o, lse = FK._launch(q, k, v, kv, bounded, packed, with_lse=True)
            torch.cuda.synchronize()
            assert (o == 0).all() and (lse == 1e30).all()


@pytest.mark.parametrize("D", [64, 128])
def test_tma_kernel_reads_strided_views(cuda, D):
    """q, k, v as views of one (B, N, 3, H, D) qkv tensor, and as
    (B, H, N, D) tensors seen as (B, N, H, D): the tensor maps take the
    strides as they are."""
    rng = np.random.default_rng(9)
    B, N, H = 2, 300, 3
    qkv = torch.tensor(rng.normal(size=(B, N, 3, H, D)), dtype=torch.bfloat16, device=cuda)
    views = [qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]]
    heads_first = [x.transpose(1, 2).contiguous().transpose(1, 2) for x in views]
    for q, k, v in (views, heads_first):
        for packed in (False, True):
            for bounded in (False, True):
                o = FK._launch(q, k, v, 250, bounded, packed)
                torch.cuda.synchronize()
                _check(o, q, k, v, 250, bounded)


@pytest.mark.parametrize("D", [64, 128])
def test_tma_kernel_is_deterministic(cuda, D):
    """20 launches on the same inputs give bitwise the same o and LSE (a
    race in the stage ring would not show as a wrong mean)."""
    q, k, v = _qkv((2, 700, 4, D), 700, 6, cuda)
    for packed, bounded, kv in ((False, True, None), (True, False, torch.tensor(650, device=cuda))):
        o0, lse0 = FK._launch(q, k, v, kv, bounded, packed, with_lse=True)
        for _ in range(20):
            o, lse = FK._launch(q, k, v, kv, bounded, packed, with_lse=True)
            assert torch.equal(o, o0) and torch.equal(lse, lse0)


def test_tma_kernel_wrong_head_fails_the_tolerance(cuda):
    """A planted fault (K and V loaded from the next head) must leave the
    2^-7 max|v| tolerance."""
    q, k, v = _qkv((1, 300, 4, 64), 300, 7, cuda)
    for mode in (FK.MODE_HEAD_MAJOR, FK.MODE_TOKEN_MAJOR):
        o = FK._launch_fwd(FK.flash_attention, q, k, v, None, True, mode, kv_head_shift=1)
        torch.cuda.synchronize()
        ref = FK.attention_plain(q.float(), k.float(), v.float(), None, True)
        err = (o.float() - ref).abs().max().item()
        assert err > 2.0**-7 * v.float().abs().max().item()


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
        ((1, 1374, 2, 64), 1374, None),  # a frame's tokens: 10.7 tiles of 128
        ((2, 129, 2, 64), 129, None),  # one row past a 128-row tile
        ((1, 150, 2, 64), 300, 200),  # Nk past a 128-key tile, kv_valid inside the second
        ((2, 129, 2, 128), 260, "tensor"),  # D 128 (64-query dk/dv tiles), dynamic kv_valid
    ],
)
def test_backward_kernels_match_plain(cuda, shape, n_keys, kv_valid, bounded):
    """The forward's LSE output and both backward kernels against their
    plain versions: ragged N and Nk, D 128, static and dynamic kv_valid
    (inside a key tile, so the last tile is masked)."""
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


def test_backward_kernels_are_deterministic(cuda):
    """21 launches of each backward kernel on the same inputs give the same
    dq, delta, dk and dv, bit for bit (every sum in one block in a fixed
    order, no atomics; a race in a stage ring would show here)."""
    for shape, kv_valid in (((2, 300, 2, 64), 290), ((1, 200, 2, 128), None)):
        q, k, v = _qkv(shape, shape[1], 8, cuda)
        o, lse = FK._launch(q, k, v, kv_valid, True, packed=False, with_lse=True)
        do = torch.randn(o.shape, device=cuda).to(torch.bfloat16)
        first = (*FK.flash_attention_bwd_dq(q, k, v, o, do, lse, kv_valid, True),)
        first += FK.flash_attention_bwd_dkv(q, k, v, do, lse, first[1], kv_valid, True)
        for _ in range(20):
            dq, delta = FK.flash_attention_bwd_dq(q, k, v, o, do, lse, kv_valid, True)
            dk, dv = FK.flash_attention_bwd_dkv(q, k, v, do, lse, delta, kv_valid, True)
            assert all(torch.equal(a, b) for a, b in zip((dq, delta, dk, dv), first))
        torch.cuda.synchronize()


def test_autograd_with_an_expanded_gradient(cuda, monkeypatch):
    """out.sum().backward() hands the backward an expanded do (zero
    strides), which no TMA map takes: flash_attention_backward copies it
    once, the kernels get the copy, and the gradients are the plain
    backward's for do = 1."""
    q, k, v = _qkv((1, 300, 2, 64), 300, 9, cuda)
    seen = {}
    backward, dq_kernel = FK.flash_attention_backward, FK.flash_attention_bwd_dq

    def spy_backward(*args):
        seen["handed"] = args[4].stride()
        return backward(*args)

    def spy_dq(*args):
        seen["launched"] = args[4].stride()
        return dq_kernel(*args)

    spy_dq.launches = 0  # the kernel's wrapper counts on the name it is called by
    monkeypatch.setattr(FK, "flash_attention_backward", spy_backward)
    monkeypatch.setattr(FK, "flash_attention_bwd_dq", spy_dq)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    FK.flash_attention(*leaves, kv_valid=250, bounded_logits=True).sum().backward()
    torch.cuda.synchronize()
    assert seen == {"handed": (0, 0, 0, 0), "launched": (300 * 2 * 64, 2 * 64, 64, 1)}
    o, lse = FK._launch(q, k, v, 250, True, packed=False, with_lse=True)
    _check_backward(q, k, v, o, lse, torch.ones_like(o), 250, True, [x.grad for x in leaves])


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
        "flash_attention_int8": 0, "flash_attention_packed_stream": 0,
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


# ---------------------------------------------------------------------------
# the serving slice's kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bounded", [False, True])
@pytest.mark.parametrize("kv_valid", [None, 187, "device"])
@pytest.mark.parametrize("shape", [(2, 300, 4, 64), (1, 150, 2, 128)])
def test_head_major_int8_matches_plain_on_the_same_grid(cuda, shape, kv_valid, bounded):
    """The int8 form against attention_plain_int8 (the same int8 values, so
    the bf16 kernels' tolerance holds), ragged lengths, both head dims."""
    q, k, v = _qkv(shape, shape[1], 3, cuda, scale=2.0)
    if kv_valid == "device":
        kv_valid = torch.tensor(187 if shape[1] > 187 else 100, dtype=torch.int32, device=cuda)
    elif kv_valid is not None:
        kv_valid = min(kv_valid, shape[1] - 10)
    before = FK.flash_attention_int8.launches
    out = FK.flash_attention(q, k, v, kv_valid, bounded, qk_int8=True)
    torch.cuda.synchronize()
    assert FK.flash_attention_int8.launches == before + 1
    ref = FK.attention_plain_int8(q.float(), k.float(), v.float(), kv_valid, bounded)
    assert (out.float() - ref).abs().max().item() <= 2.0**-7 * v.float().abs().max().item()
    k_quant = FK.quant_per_head(k)
    if kv_valid is None:
        again = FK.flash_attention(q, None, v, None, bounded, qk_int8=True, k_quant=k_quant)
        assert torch.equal(again, out)


@pytest.mark.parametrize("qk_int8", [False, True])
@pytest.mark.parametrize("kv_valid", [None, 211, "device"])
def test_stream_kernel_matches_plain(cuda, kv_valid, qk_int8):
    """The streaming kernel, bf16 and int8 forms; the q grid it makes
    inside equals quant_token_major's, value for value."""
    shape = (2, 300, 4, 64)
    q, k, v = _qkv(shape, 300, 4, cuda, scale=2.0)
    if kv_valid == "device":
        kv_valid = torch.tensor(211, dtype=torch.int32, device=cuda)
    before = FK.flash_attention_packed_stream.launches
    out = FK.flash_attention_packed_stream(q, k, v, kv_valid, qk_int8=qk_int8)
    torch.cuda.synchronize()
    assert FK.flash_attention_packed_stream.launches == before + 1
    ref = FK.attention_stream_plain(q.float(), k.float(), v.float(), kv_valid, qk_int8)
    assert (out.float() - ref).abs().max().item() <= 2.0**-7 * v.float().abs().max().item()
    if qk_int8:
        q8 = torch.empty(shape, dtype=torch.int8, device=cuda)
        assert torch.equal(FK._stream_int8(q, k, v, kv_valid, None, q8_out=q8), out)
        assert torch.equal(q8, FK.quant_token_major(q, kv_valid)[0])
        if kv_valid is None:
            again = FK.flash_attention_packed_stream(
                q, None, v, qk_int8=True, k_quant=FK.quant_k_token_major(k))
            assert torch.equal(again, out)


def _int8_launch(form, q, k, v, kv_valid, bounded, kv_head_shift=0):
    """One launch of an int8 form on the grid its wrapper makes: "head-major"
    from quant_per_head's q and k, "stream" (bounded) from the bf16 q, which
    the kernel quantises, and quant_token_major's k."""
    D = q.shape[-1]
    if form == "head-major":
        (q8, q_scale), (k8, k_scale) = FK.quant_per_head(q, kv_valid), FK.quant_per_head(k, kv_valid)
        return FK._launch_fwd(FK.flash_attention_int8, q8, k8, v, kv_valid, bounded,
                              FK.MODE_HEAD_MAJOR, qk=FK.SCORES_INT8, c=q_scale * k_scale * D**-0.5,
                              kv_head_shift=kv_head_shift)
    _, q_scale, q_inv = FK.quant_token_major(q, kv_valid)
    k8, k_scale, _ = FK.quant_token_major(k, kv_valid)
    return FK._launch_fwd(FK.flash_attention_packed_stream, q, k8, v, kv_valid, True,
                          FK.MODE_TOKEN_MAJOR, qk=FK.SCORES_INT8_Q_IN,
                          c=q_scale * k_scale * D**-0.5, qinv=q_inv, kv_head_shift=kv_head_shift)


def _int8_reference(form, q, k, v, kv_valid, bounded):
    f = [x.float() for x in (q, k, v)]
    if form == "head-major":
        return FK.attention_plain_int8(*f, kv_valid, bounded)
    return FK.attention_stream_plain(*f, kv_valid, True)


def _int8_err_tol(form, out, q, k, v, kv_valid, bounded):
    """(max error against the plain version on the same int8 grid, 2^-7
    max|v|): the integer scores are exact on both sides, so the bf16
    kernels' tolerance holds."""
    ref = _int8_reference(form, q, k, v, kv_valid, bounded)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    return (out.float() - ref).abs().max().item(), 2.0**-7 * v.float().abs().max().item()


# (form, bounded, shape): the stream form is bounded with head dim 64 only
INT8_FORMS = [("head-major", True, (2, 333, 3, 64)), ("head-major", False, (1, 1100, 2, 64)),
              ("head-major", True, (2, 300, 2, 128)), ("head-major", False, (1, 129, 2, 128)),
              ("stream", True, (2, 333, 4, 64)), ("stream", True, (1, 1100, 2, 64))]


@pytest.mark.parametrize("kv_valid", [None, 1, 128, "last tile", "device"])
@pytest.mark.parametrize("form,bounded,shape", INT8_FORMS)
def test_int8_tile_matches_plain(cuda, form, bounded, shape, kv_valid):
    """Both int8 forms on the TMA + wgmma tile (s8 scores): N and Nk not
    multiples of 128 (TMA's zero fill), more key tiles than stages, every
    kind of kv_valid (one key, a whole tile, inside the last tile, a device
    scalar)."""
    q, k, v = _qkv(shape, shape[1], 10, cuda, scale=2.0)
    n = shape[1]
    kv = {"last tile": n - 5, "device": torch.tensor(n - 70, dtype=torch.int32, device=cuda)}.get(
        kv_valid, kv_valid)
    out = _int8_launch(form, q, k, v, kv, bounded)
    torch.cuda.synchronize()
    err, tol = _int8_err_tol(form, out, q, k, v, kv, bounded)
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("form", ["head-major", "stream"])
def test_int8_tile_with_a_zero_scale(cuda, form):
    """All-zero q and k: the dequantising scalar underflows to 0, every valid
    key weighs the same and the masked keys stay out (the last tile masks
    after the scale)."""
    q, k, v = _qkv((1, 300, 2, 64), 300, 11, cuda)
    q, k = torch.zeros_like(q), torch.zeros_like(k)
    for bounded in ((True, False) if form == "head-major" else (True,)):
        out = _int8_launch(form, q, k, v, 200, bounded)
        torch.cuda.synchronize()
        err, tol = _int8_err_tol(form, out, q, k, v, 200, bounded)
        assert err <= tol, (err, tol)
        mean = v[:, :200].float().mean(dim=1, keepdim=True).expand_as(out)
        assert (out.float() - mean).abs().max().item() <= tol


@pytest.mark.parametrize("D", [64, 128])
def test_int8_tile_reads_strided_and_token_major_k_quant(cuda, D):
    """k_quant as a strided view and as a token-major (B, Nk, H*D) view, and
    the stream form's bf16 q as a view of a fused qkv tensor: the tensor
    maps take the strides as they are, bitwise the same answer."""
    rng = np.random.default_rng(12)
    B, N, H = 2, 300, 4
    qkv = torch.tensor(rng.normal(size=(B, N, 3, H, D)) * 2, dtype=torch.bfloat16, device=cuda)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    k8, k_scale = FK.quant_per_head(k)
    pair = torch.zeros((B, N, 2, H, D), dtype=torch.int8, device=cuda)
    pair[:, :, 1] = k8
    views = [pair[:, :, 1], k8.reshape(B, N, H * D).reshape(B, N, H, D),
             k8.transpose(1, 2).contiguous().transpose(1, 2)]
    base = FK.flash_attention(q, None, v, None, True, qk_int8=True, k_quant=(k8.contiguous(), k_scale))
    for view in views:
        got = FK.flash_attention(q, None, v, None, True, qk_int8=True, k_quant=(view, k_scale))
        torch.cuda.synchronize()
        assert torch.equal(got, base)
    err, tol = _int8_err_tol("head-major", base, q, k, v, None, True)
    assert err <= tol, (err, tol)
    if D != 64:
        return
    k8t, kt_scale = FK.quant_k_token_major(k)
    wide = torch.zeros((B, N, 2 * H * D), dtype=torch.int8, device=cuda)
    wide[..., H * D:] = k8t
    base = FK.flash_attention_packed_stream(q.contiguous(), None, v, qk_int8=True,
                                            k_quant=(k8t, kt_scale))
    for qq, view in ((q, k8t), (q.contiguous(), wide[..., H * D:]), (q, wide[..., H * D:])):
        got = FK.flash_attention_packed_stream(qq, None, v, qk_int8=True, k_quant=(view, kt_scale))
        torch.cuda.synchronize()
        assert torch.equal(got, base)
    err, tol = _int8_err_tol("stream", base, q, k, v, None, True)
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("form", ["head-major", "stream"])
def test_int8_tile_is_deterministic(cuda, form):
    """21 launches on the same inputs give bitwise the same o (a race in the
    stage ring or in the in-kernel quantisation would not show as a wrong
    mean); the stream form's q grid each time equal to quant_token_major's."""
    q, k, v = _qkv((2, 700, 4, 64), 700, 13, cuda, scale=2.0)
    kv = torch.tensor(650, dtype=torch.int32, device=cuda)
    o0 = _int8_launch(form, q, k, v, kv, True)
    for _ in range(20):
        assert torch.equal(_int8_launch(form, q, k, v, kv, True), o0)
    if form == "stream":
        q8 = torch.empty(q.shape, dtype=torch.int8, device=cuda)
        for _ in range(3):
            assert torch.equal(FK._stream_int8(q, k, v, kv, None, q8_out=q8), o0)
            assert torch.equal(q8, FK.quant_token_major(q, kv)[0])


@pytest.mark.parametrize("form", ["head-major", "stream"])
def test_int8_tile_planted_faults_fail_the_tolerance(cuda, form):
    """Two planted faults must leave the 2^-7 max|v| tolerance: K and V of
    the next head (the kernel's test hook), the last key tile left out."""
    q, k, v = _qkv((1, 300, 4, 64), 300, 14, cuda, scale=4.0)
    ref = _int8_reference(form, q, k, v, None, True)
    tol = 2.0**-7 * v.float().abs().max().item()
    wrong_head = _int8_launch(form, q, k, v, None, True, kv_head_shift=1)
    torch.cuda.synchronize()
    assert (wrong_head.float() - ref).abs().max().item() > tol
    # the same int8 grid, the keys past 256 left out
    q8, q_scale = FK.quant_per_head(q)
    k8, k_scale = FK.quant_per_head(k)
    if form == "head-major":
        cut = FK._launch_fwd(FK.flash_attention_int8, q8, k8, v, 256, True, FK.MODE_HEAD_MAJOR,
                             qk=FK.SCORES_INT8, c=q_scale * k_scale / 8)
    else:
        _, q_scale, q_inv = FK.quant_token_major(q)
        k8, k_scale, _ = FK.quant_token_major(k)
        cut = FK._launch_fwd(FK.flash_attention_packed_stream, q, k8, v, 256, True,
                             FK.MODE_TOKEN_MAJOR, qk=FK.SCORES_INT8_Q_IN,
                             c=q_scale * k_scale / 8, qinv=q_inv)
    torch.cuda.synchronize()
    assert (cut.float() - ref).abs().max().item() > tol


def test_stream_gradient_runs_the_backward_kernels(cuda):
    q, k, v = (x.requires_grad_(True) for x in _qkv((1, 200, 2, 64), 200, 5, cuda))
    before = FK.launches()
    FK.flash_attention_packed_stream(q, k, v).float().square().sum().backward()
    after = FK.launches()
    assert after["flash_attention"] == before["flash_attention"] + 1  # head-major, with its LSE
    assert after["flash_attention_bwd_dq"] == before["flash_attention_bwd_dq"] + 1
    assert after["flash_attention_packed_stream"] == before["flash_attention_packed_stream"]
    assert all(torch.isfinite(x.grad).all() for x in (q, k, v))
    with pytest.raises(ValueError, match="serving-only"):
        FK.flash_attention_packed_stream(q, k, v, qk_int8=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize(
    "case", [(2, 64, 32, 24, 22, False), (1, 128, 64, 16, 18, True), (1, 16, 8, 13, 10, True),
             (1, 20, 24, 37, 45, False), (2, 33, 48, 40, 70, True)])
def test_conv3x3_kernel_matches_plain(cuda, case, channels_last, dtype):
    """The 3x3 convolution kernel against F.conv2d in fp32 from the same
    inputs, entry by entry within the accumulation bound (both sides add
    9 cin products in fp32; the bf16 kernel rounds its output once)."""
    from omnivggt_tpu_torch.ops.kernels import conv3x3 as CK

    F = torch.nn.functional
    B, cin, cout, H, W, relu = case
    torch.manual_seed(0)
    conv = torch.nn.Conv2d(cin, cout, 3, padding=1).to(cuda)
    x = torch.randn(B, cin, H, W, device=cuda).to(dtype)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    w = conv.weight.detach().to(dtype).float()
    torch.backends.cudnn.allow_tf32 = False
    with torch.no_grad():
        before = CK.conv3x3_folded.launches
        out = CK.conv3x3_folded(conv, x, relu)
        assert CK.conv3x3_folded.launches == before + 1
        ref = F.conv2d(x.float(), w, conv.bias, padding=1)
        tol = F.conv2d(x.float().abs(), w.abs(), conv.bias.abs(), padding=1)
    tol = tol * (2 * (9 * cin + 1) * 2.0**-24)
    if dtype == torch.bfloat16:
        tol = tol + 2.0**-8 * ref.abs()
    ref = F.relu(ref) if relu else ref
    assert out.dtype == dtype and out.shape == ref.shape
    assert out.is_contiguous(memory_format=torch.channels_last if channels_last
                             else torch.contiguous_format)
    assert ((out.float() - ref).abs() <= tol).all()
    with pytest.raises(ValueError, match="forward-only"):
        CK.conv3x3_folded(conv, x.requires_grad_(True), relu)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv3x3_kernel_layouts_and_launches_agree(cuda, dtype):
    """The same x in NCHW (copied once by the wrapper, counted) and in
    channels_last (read in place) gives the same bits, in either output
    layout; 21 launches on the same inputs are bitwise equal."""
    from omnivggt_tpu_torch.ops.kernels import conv3x3 as CK

    torch.manual_seed(2)
    conv = torch.nn.Conv2d(40, 24, 3, padding=1).to(cuda)
    x = torch.randn(2, 40, 37, 70, device=cuda).to(dtype)
    x_cl = x.contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        ref = CK.conv3x3_folded(conv, x_cl, True)
        assert ref.is_contiguous(memory_format=torch.channels_last)
        nchw = CK.conv3x3_folded(conv, x, True)
        assert nchw.is_contiguous() and torch.equal(nchw, ref)
        to_nchw = CK.conv3x3_folded(conv, x_cl, True, memory_format=torch.contiguous_format)
        assert to_nchw.is_contiguous() and torch.equal(to_nchw, ref)
        for _ in range(20):
            assert torch.equal(CK.conv3x3_folded(conv, x_cl, True), ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv3x3_relayouts_only_what_tma_cannot_map(cuda, dtype):
    """channels_last at cin 128 goes in place (0 copies), NCHW at W 518 is
    copied once; the launch shape the library reports is conv_launch_shape's."""
    from omnivggt_tpu_torch.ops.kernels import conv3x3 as CK

    conv = torch.nn.Conv2d(128, 32, 3, padding=1).to(cuda)
    x = torch.randn(1, 128, 40, 518, device=cuda).to(dtype)
    before = CK.conv3x3_folded.relayouts
    with torch.no_grad():
        CK.conv3x3_folded(conv, x.contiguous(memory_format=torch.channels_last))
        assert CK.conv3x3_folded.relayouts == before
        CK.conv3x3_folded(conv, x)
        assert CK.conv3x3_folded.relayouts == before + 1
    for cin, cout in ((128, 32), (128, 64), (16, 8), (20, 24), (33, 48), (64, 32)):
        assert CK.built_launch_shape(cin, cout, dtype) == CK.conv_launch_shape(cin, cout, dtype)


def test_head_conv_flag_launches_the_kernel_whatever_the_grad_mode(cuda, monkeypatch):
    """With the head-conv flag on, an eligible convolution of a CUDA tensor
    launches the kernel with grad mode on as well as off; only a gradient
    really asked for (requires_grad) is refused."""
    from omnivggt_tpu_torch.models import dpt_head as TDH
    from omnivggt_tpu_torch.ops.kernels import conv3x3 as CK

    monkeypatch.setattr(TDH, "_PALLAS_HEAD_CONVS", True)
    conv = torch.nn.Conv2d(16, 8, 3, padding=1).to(cuda).requires_grad_(False)
    x = torch.randn(1, 16, 20, 20, device=cuda)
    before = CK.conv3x3_folded.launches
    assert torch.is_grad_enabled()
    out = TDH._conv3x3(conv, x, relu=True)
    with torch.no_grad():
        assert torch.equal(TDH._conv3x3(conv, x, relu=True), out)
    assert CK.conv3x3_folded.launches == before + 2
    assert TDH._conv3x3(conv, x, int8=True).shape == out.shape  # int8 keeps the library route
    assert CK.conv3x3_folded.launches == before + 2
    with pytest.raises(ValueError, match="forward-only"):
        TDH._conv3x3(conv.requires_grad_(True), x)


def test_layout_probes_pass(cuda):
    from omnivggt_tpu_torch.tools import probe_layouts as PL

    lines = []
    assert PL.run(out=lines.append)
    assert sum(line.strip().startswith("PASS") for line in lines) == 11


def test_int8_dense_and_conv_are_exact_on_the_card(cuda):
    """torch._int_mm behind qlinear_int8 and qconv2d_int8: the card's
    answers equal the CPU's exact ones (integer sums are order-free)."""
    from omnivggt_tpu_torch.ops import layers as TL

    torch.manual_seed(1)
    lin = torch.nn.Linear(4096, 40)
    x = torch.randn(3, 5, 4096)
    conv = torch.nn.Conv2d(12, 10, 3)
    img = torch.randn(2, 12, 11, 9)
    with torch.no_grad():
        for stride, padding in ((1, 1), (2, 1)):
            want = TL.qconv2d_int8(conv, img, stride, padding)
            got = TL.qconv2d_int8(conv.to(cuda), img.to(cuda), stride, padding)
            conv.cpu()
            torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=1e-5)
        want = TL.qlinear_int8(lin, x)
        got = TL.qlinear_int8(lin.to(cuda), x.to(cuda))
    torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=1e-5)


# ---- the ring kernels and the sharded strategies ---------------------------


def _ring_inputs(n, nl, H, D, seed, device, q_scale=3.0, B=1):
    # q scaled so that the softmax is peaked: the output is of v's size and a
    # shard read twice or left out shows
    rng = np.random.default_rng(seed)
    shape = (B, n * nl, H, D)
    q = rng.normal(size=shape) * q_scale
    k, v = rng.normal(size=shape), rng.normal(size=shape)
    return [torch.tensor(x, dtype=torch.bfloat16, device=device) for x in (q, k, v)]


@pytest.mark.parametrize("qk_int8", [False, True])
@pytest.mark.parametrize("bounded", [False, True])
@pytest.mark.parametrize(
    "n,nl,B,H,D,kw",
    [
        (4, 256, 1, 2, 64, dict(block_q=128, block_k=128)),              # kernel 5, one chunk
        (2, 512, 1, 1, 64, dict(block_q=128, block_k=256, chunk_q=256)),  # kernel 5, two chunks
        (4, 600, 1, 3, 64, {}),                     # kernel 6, ragged
        (4, 300, 1, 2, 64, {}),                     # ragged: 2 whole key tiles and 44 keys
        (2, 40, 1, 2, 64, {}),                      # nl < 128: one key tile, mostly zero fill
        (8, 75, 1, 2, 128, {}),                     # kernel 5, D = 128, 8 ranks, nl < 128
        (4, 100, 2, 2, 128, {}),                    # D = 128, B = 2, ragged nl < 128
        (3, 1100, 2, 2, 128, {}),                   # kernel 6, ragged, D = 128, B = 2
        (8, 300, 2, 2, 128, {}),                    # 8 ranks, D = 128, B = 2, ragged
        (1, 130, 1, 2, 64, {}),                     # one rank: no rotation
    ],
)
def test_ring_kernels_match_plain(cuda, n, nl, B, H, D, kw, bounded, qk_int8):
    from omnivggt_tpu_torch.ops.kernels import ring_attention as RK
    from omnivggt_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(seq=n, device=cuda)
    q, k, v = _ring_inputs(n, nl, H, D, 3, cuda, B=B)
    RK.reset_launches()
    out = RK.ring_flash_attention(q, k, v, mesh, "seq", bounded_logits=bounded,
                                  qk_int8=qk_int8, **kw)
    torch.cuda.synchronize()
    fits = nl < 512 or nl % 512 == 0  # ring_flash_attention's own contract
    assert RK.launches() == {"ring_flash_attention": int(fits),
                             "ring_flash_attention_hbm": int(not fits)}
    # against the plain version on the same (int8) grid: P and the output
    # rounded to bf16, 2^-7 max|v| as for the other forward kernels
    ref = RK.ring_attention_plain(q.float(), k.float(), v.float(), n, bounded,
                                  chunk_q=kw.get("chunk_q"), qk_int8=qk_int8)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    err = (out.float() - ref).abs().max().item()
    tol = 2.0**-7 * v.float().abs().max().item()
    assert err <= tol, (err, tol)
    if qk_int8:  # the card's grids equal the CPU's
        on_card = RK.quant_ring(q, k, v, n, D**-0.5)
        on_cpu = RK.quant_ring(q.cpu(), k.cpu(), v.cpu(), n, D**-0.5)
        assert all(torch.equal(a.cpu(), b) for a, b in zip(on_card, on_cpu))


def test_ring_rotates_its_slots_and_a_skipped_rotation_shows(cuda):
    """After the call each rank's last-read slot holds the shard of rank
    (r + 1) mod n, exactly; the bounded bf16 ring agrees with the head-major
    kernel within the sums' reordering; with the last rotation left out
    (a stale slot read twice) the output leaves the tolerance."""
    from omnivggt_tpu_torch.ops.kernels import ring_attention as RK

    n, nl, H, D = 4, 300, 2, 64
    q, k, v = _ring_inputs(n, nl, H, D, 4, cuda)
    out, slots = RK._ring_launch(RK.ring_flash_attention_hbm, q, k, v, n, True, False)
    bad, _ = RK._ring_launch(RK.ring_flash_attention_hbm, q, k, v, n, True, False,
                             skip_rotation_at=n - 2)
    torch.cuda.synchronize()
    last = (n - 1) % 2
    for r in range(n):
        src = (r + 1) % n
        for kv, x in enumerate((k, v)):
            want = x[0, src * nl:(src + 1) * nl].transpose(0, 1)  # (H, nl, D)
            assert torch.equal(slots[r][last, kv], want), (r, kv)
    ref = RK.ring_attention_plain(q.float(), k.float(), v.float(), n, True)
    tol = 2.0**-7 * v.float().abs().max().item()
    assert (out.float() - ref).abs().max().item() <= tol
    assert (bad.float() - ref).abs().max().item() > tol
    head_major = FK.flash_attention(q, k, v, bounded_logits=True).float()
    sharp = RK.reorder_tolerance(head_major, v, n * nl)
    assert ((out.float() - head_major).abs() <= sharp).all()


@pytest.mark.parametrize("qk_int8", [False, True])
@pytest.mark.parametrize("bounded", [False, True])
@pytest.mark.parametrize("n,nl,D", [(4, 300, 64), (2, 100, 128)])
def test_ring_planted_faults_fail_the_tolerance(cuda, n, nl, D, bounded, qk_int8):
    """The ring tile's two test hooks plant faults that must leave the
    2^-7 max|v| tolerance in both forms: the last key tile of every shard
    left out, and K and V read from the next head; in the int8 form also
    head 0's v scale used for every head (there v's heads at scales 1 and
    2, so their int8 scales differ)."""
    from omnivggt_tpu_torch.ops.kernels import ring_attention as RK

    q, k, v = _ring_inputs(n, nl, 2, D, 8, cuda)
    if qk_int8:
        v = v * torch.tensor([1.0, 2.0], dtype=v.dtype, device=cuda)[None, None, :, None]
    ref = RK.ring_attention_plain(q.float(), k.float(), v.float(), n, bounded, qk_int8=qk_int8)
    tol = 2.0**-7 * v.float().abs().max().item()
    wrapper = RK.ring_flash_attention_hbm
    sound, _ = RK._ring_launch(wrapper, q, k, v, n, bounded, qk_int8)
    faults = [RK._ring_launch(wrapper, q, k, v, n, bounded, qk_int8, **hook)[0]
              for hook in (dict(drop_last_key_tile=True), dict(kv_head_shift=1))]
    if qk_int8:
        q8, k8, v8, table = RK.quant_ring(q, k, v, n, D**-0.5)
        one_scale = table.clone()
        one_scale[:, :, 1] = table[:, :1, 1]  # B = 1: row h is head h
        faults.append(RK._ring_run(q8, k8, v8, one_scale, n, bounded)[0])
    torch.cuda.synchronize()
    errs = [(x.float() - ref).abs().max().item() for x in [sound] + faults]
    assert errs[0] <= tol < min(errs[1:]), (errs, tol)


@pytest.mark.parametrize("qk_int8", [False, True])
@pytest.mark.parametrize("D", [64, 128])
def test_ring_kernel_is_deterministic(cuda, D, qk_int8):
    """21 launches of the ring on the same inputs give bitwise the same
    output in both forms (a race in the stage ring, in the int8 form's V
    conversion or in the state between the steps would not show as a wrong
    mean)."""
    from omnivggt_tpu_torch.ops.kernels import ring_attention as RK

    q, k, v = _ring_inputs(4, 300, 2, D, 9, cuda, B=2)
    for bounded in (True, False):
        o0, _ = RK._ring_launch(RK.ring_flash_attention_hbm, q, k, v, 4, bounded, qk_int8)
        for _ in range(20):
            o, _ = RK._ring_launch(RK.ring_flash_attention_hbm, q, k, v, 4, bounded, qk_int8)
            assert torch.equal(o, o0)


def test_ring_launch_shape_is_the_sources(cuda):
    """The shared memory that ring_launch_shape works out is what the built
    kernel asks for, in both forms and at both head dims."""
    from omnivggt_tpu_torch.ops.kernels import ring_attention as RK

    for D in (64, 128):
        for int8 in (False, True):
            assert RK.ring_launch_shape(D, int8) == RK.built_launch_shape(D, int8)


def test_ring_wrappers_refuse_what_the_kernel_does_not_take(cuda):
    from omnivggt_tpu_torch.ops.kernels import ring_attention as RK
    from omnivggt_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(seq=2, device=cuda)
    q, k, v = _ring_inputs(2, 64, 2, 64, 5, cuda)
    with pytest.raises(TypeError, match="bf16"):
        RK.ring_flash_attention(q.float(), k.float(), v.float(), mesh)
    with pytest.raises(ValueError, match="forward only"):
        RK.ring_flash_attention(q.requires_grad_(True), k, v, mesh)
    with pytest.raises(ValueError, match="does not divide"):
        RK.ring_flash_attention(q[:, :127].detach(), k[:, :127], v[:, :127], mesh)


@pytest.mark.parametrize("stream", [False, True])
def test_allgather_pregathered_int8_k_is_the_whole_arrays_grid(cuda, stream, monkeypatch):
    """Under allgather + qk_int8 past the packed kernel's key contract, K is
    quantised per shard on the max over the ranks and gathered as int8: the
    gathered grid equals the quantiser's on the whole K, and the output is
    within the forward tolerance of exact attention plus the int8 noise."""
    from omnivggt_tpu_torch.ops import attention as TA
    from omnivggt_tpu_torch.parallel import attention as PA
    from omnivggt_tpu_torch.parallel.mesh import make_mesh

    monkeypatch.setattr(TA, "_STREAM_ATTN", stream)
    n, nl, H, D = 4, 640, 2, 64
    mesh = make_mesh(seq=n, device=cuda)
    q, k, v = _ring_inputs(n, nl, H, D, 6, cuda, q_scale=1.0)
    seen = []
    target = "quant_k_token_major" if stream else "quant_per_head"
    real = getattr(FK, target)

    def spy(x, *args, **kw):
        out = real(x, *args, **kw)
        if kw.get("amax_reduce") is not None:  # a K shard on its way to the gather
            seen.append(out)
        return out

    monkeypatch.setattr(FK, target, spy)
    FK.reset_launches()
    out = PA.allgather_attention(q, k, v, mesh, "seq", impl="flash", bounded_logits=True,
                                 qk_int8=True)
    torch.cuda.synchronize()
    counter = "flash_attention_packed_stream" if stream else "flash_attention_int8"
    assert FK.launches()[counter] == n and len(seen) == n
    whole = real(k)
    assert torch.equal(torch.cat([k8 for k8, _ in seen], dim=1), whole[0])
    assert all(torch.equal(scale, whole[1]) for _, scale in seen)
    ref = FK.attention_plain(q.float(), k.float(), v.float(), None, True)
    assert 0 < (out.float() - ref).abs().max().item() < 5e-2


def test_sharded_tiny_model_on_the_card(cuda):
    """The tiny model at 224 px (261 tokens a frame, so the attention
    dispatch reaches the kernels) under every strategy against the
    single-device forward, with the launch counts."""
    from omnivggt_tpu_torch.config import tiny_test_config
    from omnivggt_tpu_torch.models.omnivggt import OmniVGGT
    from omnivggt_tpu_torch.ops.kernels import ring_attention as RK
    from omnivggt_tpu_torch.parallel import attention as PA
    from omnivggt_tpu_torch.parallel.mesh import make_mesh
    from omnivggt_tpu_torch.parallel.sharding import ModelSharding

    import dataclasses

    from omnivggt_tpu_torch.models import omnivggt as TM

    # head dim 64 and a bf16 trunk: what the kernels take
    cfg = dataclasses.replace(tiny_test_config(embed_dim=128, num_heads=2),
                              compute_dtype="bfloat16")
    model = OmniVGGT(cfg, device=cuda, seed=0).eval()
    mesh = make_mesh(seq=4, device=cuda)
    images = torch.rand((1, 8, 224, 224, 3), device=cuda)
    depth = cfg.aggregator.depth
    with torch.inference_mode():
        ref = model(images, attn_impl="flash")
        for strategy in ("allgather", "ring", "ring_fused"):
            RK.reset_launches()
            out = model(images, attn_impl="flash", sharding=ModelSharding(mesh, strategy))
            torch.cuda.synchronize()
            assert RK.launches()["ring_flash_attention_hbm"] == (
                depth if strategy == "ring_fused" else 0)
            a, b = ({k: o[k].float().cpu().numpy() for k in TM.PROBE_KEYS} for o in (ref, out))
            assert not TM._probe_failures(a, b, 2e-2, 2e-2), strategy
    assert PA.fused_ring_attention.unfused_fallbacks == 0


# the seq axis over processes: two processes on the card, a gloo group and
# CUDA IPC (parallel/peer.py), one seq rank each

_PROCESS_RING_CASES = (  # (wrapper, nl, bounded, int8)
    ("ring_flash_attention_hbm", 300, True, False),
    ("ring_flash_attention_hbm", 300, False, True),
    ("ring_flash_attention", 256, True, False),
    ("ring_flash_attention", 256, True, True),
)


def _process_ring_inputs(nl, device):
    return _qkv((1, 2 * nl, 2, 64), 2 * nl, 21, device, scale=2.0)


_PEER_SIZES, _PEER_BUCKET = (777, 3000, 5, 1024), 1000


def _peer_part(rank, dtype, device):
    """Seq rank `rank`'s part of a gathered (1, 2 x 6, 2, 8) tensor."""
    return (torch.arange(96, device=device).reshape(1, 6, 2, 8) * 0.25 + 100 * rank).to(dtype)


def _peer_weight(rank, dtype, device):
    """The gathered tensor's weight in rank `rank`'s loss."""
    return torch.cos(torch.arange(192, device=device).reshape(1, 12, 2, 8) * (rank + 1.5)).to(dtype)


def _peer_grad(rank, n, device):
    return torch.sin(torch.arange(n, device=device) * 0.37 + rank * 3.1) * (rank + 1)


# a block's sharded tensors: (whole shape, sharded dim); a bucket of 80
# elements takes the chunks of the first three in one gather bucket and the
# last in a second, and each tensor's reduce-scatter in a bucket of its own
_BLOCK = (((6, 8), 0), ((4, 10), 1), ((2, 3, 12), 2), ((16,), 0))
_BLOCK_BUCKET = 80


def _block_whole(i, dtype, device):
    shape, _ = _BLOCK[i]
    n = int(np.prod(shape))
    return (torch.arange(n, device=device).reshape(shape) * 0.125 - i).to(dtype)


def _block_grad(i, rank, dtype, device):
    """Rank `rank`'s gradient of tensor i of the block (whole)."""
    shape, _ = _BLOCK[i]
    n = int(np.prod(shape))
    return torch.sin(torch.arange(n, device=device).reshape(shape) * (0.7 + i) + rank).to(dtype)


def _block_chunk(x, i, rank):
    dim = _BLOCK[i][1]
    n = x.shape[dim] // 2
    return x.narrow(dim, rank * n, n)


def _small_part(rank, device):
    return torch.arange(24, dtype=torch.float32, device=device).reshape(4, 6).sin() * (rank + 1) \
        - rank


def _process_worker(rank, rdzv, out):
    import os

    import torch.distributed as dist

    from omnivggt_tpu_torch.ops.kernels import ring_attention as RK
    from omnivggt_tpu_torch.parallel import collectives as C
    from omnivggt_tpu_torch.parallel.mesh import make_mesh, multihost_initialize

    dev = multihost_initialize(device="cuda", backend="gloo", local_rank=0, init_method=rdzv,
                               world_size=2, rank=rank, timeout=120)
    mesh = make_mesh(data=1, seq=2, device=dev)
    probe = mesh.peer.buffer("probe", (4096,), torch.int64)
    probe.own.copy_(torch.arange(4096, device=dev) * (rank + 3))
    mesh.peer.barrier()
    peer = (rank + 1) % 2
    res = {"seq_rank": mesh.seq_rank, "opens": mesh.peer.opens,
           "read": torch.equal(probe.view(peer), torch.arange(4096, device=dev) * (peer + 3))}
    mesh.peer.barrier()
    res["ring"] = []
    for name, nl, bounded, int8 in _PROCESS_RING_CASES:
        q, k, v = (x[:, rank * nl:(rank + 1) * nl] for x in _process_ring_inputs(nl, dev))
        o = getattr(RK, name)(q, k, v, mesh, bounded_logits=bounded, qk_int8=int8)
        res["ring"].append(C.seq_all_gather(o, mesh, 1).cpu())
    # the training collectives through the peer memory: the differentiable
    # gather's backward (fp32 and bf16) and the bucketed gradient sum
    res["gather"] = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = _peer_part(rank, dtype, dev).requires_grad_()
        gathered = C.seq_gather(x, mesh, 1)
        (gathered * _peer_weight(rank, dtype, dev)).sum().backward()
        res["gather"][str(dtype)] = (gathered.detach().cpu(), x.grad.cpu())
    # the seq axis's gathers and reductions with the tensor in one bucket,
    # and copied out in buckets of 5 elements
    res["small_buckets"], x, sound = {}, _small_part(rank, dev), C.SEQ_BUCKET_ELEMS
    for bucket in (24, 5):
        C.SEQ_BUCKET_ELEMS = bucket
        try:
            res["small_buckets"][bucket] = [t.cpu() for t in (
                C.seq_all_gather(x, mesh, 1), C.seq_sum(x, mesh), C.seq_max(x, mesh),
                C.seq_reduce_scatter(x, mesh, 1))]
        finally:
            C.SEQ_BUCKET_ELEMS = sound
    grads = [_peer_grad(rank, n, dev) for n in _PEER_SIZES]
    C.reset_calls()
    C.seq_all_reduce_sum(grads, mesh, bucket_elems=_PEER_BUCKET)
    res["sum"] = ([g.cpu() for g in grads], C.calls()["seq_all_reduce"])
    # the state's flat collectives: a block's chunks gathered as one
    # (differentiable: its backward a flat reduce-scatter), and both in
    # buckets of _BLOCK_BUCKET elements
    res["block"] = {}
    dims = [d for _, d in _BLOCK]
    for dtype in (torch.float32, torch.bfloat16):
        shards = [[_block_chunk(_block_whole(i, dtype, dev), i, rank).clone().requires_grad_()]
                  for i in range(len(_BLOCK))]
        C.reset_calls()
        fulls = C.gather_shards(shards, mesh, dims)
        sum((f * _block_grad(i, rank, dtype, dev)).sum() for i, f in enumerate(fulls)).backward()
        flat = C.calls()
        small = C.all_gather_many([[s[0].detach()] for s in shards], mesh, dims,
                                  bucket_elems=_BLOCK_BUCKET)
        scattered = C.reduce_scatter_many([_block_grad(i, rank, dtype, dev)
                                           for i in range(len(_BLOCK))], mesh, dims,
                                          bucket_elems=_BLOCK_BUCKET)
        res["block"][str(dtype)] = {
            "gathered": [f.detach().cpu() for f in fulls], "grads": [s[0].grad.cpu() for s in shards],
            "small": [f.cpu() for f in small], "scattered": [c.cpu() for (c,) in scattered],
            "flat": flat, "calls": C.calls()}
    mesh.close()
    torch.save(res, os.path.join(out, f"rank_{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def process_runs(tmp_path_factory):
    import multiprocessing
    import os

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from omnivggt_tpu_torch.ops.kernels import ring_attention as RK

    RK.load_kernels()  # built here, before the processes start
    from omnivggt_tpu_torch.parallel import peer

    peer.load_library()
    out = str(tmp_path_factory.mktemp("peer"))
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_process_worker, args=(r, f"file://{out}/rdzv", out))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=300)
    for p in procs:
        if p.is_alive():
            p.kill()
    assert [p.exitcode for p in procs] == [0, 0]
    return [torch.load(os.path.join(out, f"rank_{r}.pt")) for r in range(2)]


def test_peer_memory_maps_the_other_process(cuda, process_runs):
    """Each process reads the pattern the other wrote into its symmetric
    buffer, through the handle it opened."""
    for rank, res in enumerate(process_runs):
        assert res["seq_rank"] == rank and res["opens"] >= 1 and res["read"]


def test_seq_gather_and_bucketed_sum_over_peer_memory(cuda, process_runs):
    """The training collectives through the peer-mapped buffers: the
    differentiable gather joins the parts in rank order, and its backward
    hands each process its own part of every process's gradient summed in
    rank order (fp32 and bf16, bitwise); the bucketed gradient sum (4
    tensors over buckets of 1000 elements, one cut inside a tensor) leaves
    every process the same bits, the rank-order sum, in 5 buckets through
    one buffer."""
    for dtype in (torch.float32, torch.bfloat16):
        whole = torch.cat([_peer_part(r, dtype, cuda) for r in range(2)], dim=1).cpu()
        w = [_peer_weight(r, dtype, cuda) for r in range(2)]  # cos as the card rounds it
        for rank, res in enumerate(process_runs):
            out, grad = res["gather"][str(dtype)]
            assert torch.equal(out, whole), dtype
            want = (w[0] + w[1])[:, rank * 6:(rank + 1) * 6].cpu()
            assert torch.equal(grad, want), (dtype, rank)
    want = [_peer_grad(0, n, cuda) + _peer_grad(1, n, cuda) for n in _PEER_SIZES]
    for res in process_runs:
        got, buckets = res["sum"]
        assert buckets == -(-sum(_PEER_SIZES) // _PEER_BUCKET)
        for g, w in zip(got, want):
            assert torch.equal(g, w.cpu())


def test_seq_collectives_in_buckets_smaller_than_the_tensor(cuda, process_runs):
    """seq_all_gather, seq_sum, seq_max and seq_reduce_scatter through the
    peer memory give the same bits with the tensor in one staging bucket
    and copied out in buckets of 5 elements."""
    parts = [_small_part(r, cuda) for r in range(2)]
    total = parts[0] + parts[1]
    for rank, res in enumerate(process_runs):
        want = (torch.cat(parts, 1), total, torch.maximum(parts[0], parts[1]),
                total[:, rank * 3:(rank + 1) * 3])
        for bucket in (24, 5):
            for name, a, b in zip(("gather", "sum", "max", "scatter"),
                                  res["small_buckets"][bucket], want):
                assert torch.equal(a, b.cpu()), (bucket, name, rank)


def test_flat_state_collectives_over_peer_memory_are_the_logical_layout(cuda, process_runs):
    """The state's flat collectives over two processes through the peer
    memory, fp32 and bf16, bitwise against the same calls on 2 logical
    ranks in one process: a block's chunks gathered as one collective
    (one bucket each way), its backward reduce-scattering every rank's
    gradient in rank order onto the chunks; and the gather and the
    reduce-scatter in buckets of 80 elements (2 and 4 buckets)."""
    from omnivggt_tpu_torch.parallel import collectives as C
    from omnivggt_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(data=1, seq=2, device=cuda)
    dims = [d for _, d in _BLOCK]
    for dtype in (torch.float32, torch.bfloat16):
        wholes = [_block_whole(i, dtype, cuda) for i in range(len(_BLOCK))]
        shards = [[_block_chunk(w, i, r).clone().requires_grad_() for r in range(2)]
                  for i, w in enumerate(wholes)]
        fulls = C.gather_shards(shards, mesh, dims)
        sum((f * _block_grad(i, r, dtype, cuda)).sum() for i, f in enumerate(fulls)
            for r in range(2)).backward()
        summed = [_block_grad(i, 0, dtype, cuda) + _block_grad(i, 1, dtype, cuda)
                  for i in range(len(_BLOCK))]
        for rank, res in enumerate(process_runs):
            got = res["block"][str(dtype)]
            for i, w in enumerate(wholes):
                assert torch.equal(got["gathered"][i], fulls[i].detach().cpu()), (dtype, i)
                assert torch.equal(got["gathered"][i], w.cpu()) and torch.equal(
                    got["small"][i], w.cpu()), (dtype, i)
                want = shards[i][rank].grad.cpu()
                assert torch.equal(got["grads"][i], want), (dtype, rank, i)
                assert torch.equal(want, _block_chunk(summed[i], i, rank).cpu()), (dtype, i)
                assert torch.equal(got["scattered"][i], want), (dtype, rank, i)
            assert (got["flat"]["state_seq_gather"], got["flat"]["state_seq_scatter"]) == (1, 1)
            assert (got["calls"]["state_seq_gather"] - 1, got["calls"]["state_seq_scatter"] - 1) \
                == (2, 4)


def test_ring_process_form_is_the_logical_form_bitwise(cuda, process_runs):
    """Both ring kernels over two processes (the rotation into the peer's
    mapped slot, a barrier between the steps) give the logical form's
    output bit for bit, and every process gathers the same."""
    from omnivggt_tpu_torch.ops.kernels import ring_attention as RK
    from omnivggt_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(data=1, seq=2, device=cuda)
    for i, (name, nl, bounded, int8) in enumerate(_PROCESS_RING_CASES):
        q, k, v = _process_ring_inputs(nl, cuda)
        want = getattr(RK, name)(q, k, v, mesh, bounded_logits=bounded, qk_int8=int8).cpu()
        for res in process_runs:
            assert torch.equal(res["ring"][i], want), (name, nl, bounded, int8)
