"""What the backward wrappers hand the Hopper kernels, checked on the CPU.

The two backward kernels (csrc/flash_attention_bwd.cu) stage q, k, v and dO
by TMA, whose tensor maps take only positive strides that are multiples of
16 bytes from 16-byte aligned bases, and read the (B, H, N) lse and delta
through 1-D maps over the flat buffers. Here the C entry points are
recorded, not run (the kernels run only on the card: tests/test_torch_cuda.py,
chip_smoke.py): the wrappers must pass strided views of a fused qkv tensor
as they are, copy a gradient that TMA refuses, hand the dk/dv kernel the
delta buffer that the dq kernel wrote, and count one launch each.
"""

import contextlib
import types

import numpy as np
import pytest
import torch

from omnivggt_tpu_torch.ops.kernels import flash_attention as FK

B, N, H, D = 2, 150, 3, 64


def _record(monkeypatch):
    """Replaces the kernels' C entry points by recorders (each returns 0,
    a launch without error) and the CUDA stream by a stand-in."""
    calls = {"dq": [], "dkv": []}
    monkeypatch.setattr(FK, "_libraries", lambda: (
        None, lambda *a: calls["dq"].append(a) or 0, lambda *a: calls["dkv"].append(a) or 0, ""))
    monkeypatch.setattr(FK, "_on_cpu", lambda *tensors: False)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    for fn in (FK.flash_attention_bwd_dq, FK.flash_attention_bwd_dkv):
        monkeypatch.setattr(fn, "launches", 0)
    return calls


def _grad(kind):
    """dO of shape (B, N, H, D) in bf16: as autograd hands it over, or laid
    out so that no TMA map takes it."""
    rng = np.random.default_rng(3)
    values = torch.tensor(rng.normal(size=(B, N, H, D)), dtype=torch.bfloat16)
    if kind == "contiguous":
        return values
    if kind == "expanded":  # out.sum().backward(): zero strides
        return torch.ones((), dtype=torch.bfloat16).expand(B, N, H, D)
    if kind == "row stride 68":  # 136 bytes between heads: not a multiple of 16
        padded = torch.zeros((B, N, H, D + 4), dtype=torch.bfloat16)
        padded[..., :D] = values
        return padded[..., :D]
    flat = torch.zeros(values.numel() + 1, dtype=torch.bfloat16)  # "base off by 2 bytes"
    flat[1:] = values.reshape(-1)
    return flat[1:].view(B, N, H, D)


def _tma_takes(ptr, strides):
    return ptr % 16 == 0 and all(s > 0 and s % 8 == 0 for s in strides)


@pytest.mark.parametrize("kind", ["contiguous", "expanded", "row stride 68", "base off by 2 bytes"])
def test_backward_wrappers_hand_tma_strides_to_the_kernels(monkeypatch, kind):
    """flash_attention_backward's two launches, as the C entry points see
    them: q, k, v are strided views of a fused (B, N, 3, H, D) qkv tensor
    and reach the kernels uncopied (token stride 3 H D); a dO that TMA
    refuses arrives as a contiguous copy with the same values; every
    operand that TMA stages has a base and strides it takes; both kernels
    get the same dO (copied once), and the dk/dv kernel reads the lse and
    the delta buffer that the dq kernel got; one launch of each is
    counted."""
    calls = _record(monkeypatch)
    rng = np.random.default_rng(1)
    qkv = torch.tensor(rng.normal(size=(B, N, 3, H, D)), dtype=torch.bfloat16)
    q, k, v = qkv.unbind(2)
    o = torch.tensor(rng.normal(size=(B, N, H, D)), dtype=torch.bfloat16)
    lse = torch.tensor(rng.normal(size=(B, H, N)), dtype=torch.float32)
    do = _grad(kind)

    dq, dk, dv = FK.flash_attention_backward(q, k, v, o, do, lse, 120, True)
    assert FK.flash_attention_bwd_dq.launches == FK.flash_attention_bwd_dkv.launches == 1
    (dq_call,), (dkv_call,) = calls["dq"], calls["dkv"]
    assert dq_call[:2] == dkv_call[:2] == (1, D)  # bounded, head dim
    # pointers: dq (q, k, v, o, dO, lse, delta, dq), dk/dv (q, k, v, dO, lse, delta, dk, dv)
    q_p, k_p, v_p, o_p, do_p, lse_p, delta_p, dq_p = dq_call[2:10]
    assert dkv_call[2:5] == (q_p, k_p, v_p) == (q.data_ptr(), k.data_ptr(), v.data_ptr())
    assert (dkv_call[5], dkv_call[6], dkv_call[7]) == (do_p, lse_p, delta_p)
    assert (lse_p, dq_p) == (lse.data_ptr(), dq.data_ptr())
    assert (dkv_call[8], dkv_call[9]) == (dk.data_ptr(), dv.data_ptr())
    token = [N * 3 * H * D, 3 * H * D, D]
    dense = [N * H * D, H * D, D]
    dq_st, dkv_st = list(dq_call[10]), list(dkv_call[10])
    assert dq_st[:9] == dkv_st[:9] == token * 3  # q, k, v in place
    assert dq_st[9:12] == dkv_st[9:12]  # the same dO to both kernels
    if kind == "contiguous":
        assert do_p == do.data_ptr()
    else:
        assert do_p != do.data_ptr() and dq_st[9:12] == dense
    assert dq_st[12:] == dense * 2 and dkv_st[12:] == dense * 2  # o, dq; dk, dv
    for ptr, strides in ((q_p, dq_st[0:3]), (k_p, dq_st[3:6]), (v_p, dq_st[6:9]),
                         (do_p, dq_st[9:12])):
        assert _tma_takes(ptr, strides)
    assert lse_p % 16 == 0 and delta_p % 16 == 0
    assert dq_call[11:17] == dkv_call[11:17] == (B, H, N, N, 120, None)  # kv_valid static


def test_operand_copies_have_fresh_strides_and_aligned_rows():
    """The helpers behind the wrappers: a view TMA takes is passed as it is;
    a zero stride, an odd stride on a size-1 axis (which `.contiguous()`
    keeps) or an odd base is copied with fresh strides; a (B, H, N) row
    vector keeps its buffer when it is contiguous fp32 from an aligned
    base, and is re-laid otherwise."""
    fused = torch.zeros((1, 40, 3, 2, 64), dtype=torch.bfloat16)
    view = fused[:, :, 1]
    assert FK._vector_aligned(view) is view
    odd_batch = torch.zeros((40, 2, 64), dtype=torch.bfloat16).as_strided((1, 40, 2, 64),
                                                                          (3, 128, 64, 1))
    assert odd_batch.is_contiguous() and odd_batch.contiguous().stride()[0] == 3
    for x in (torch.zeros((), dtype=torch.bfloat16).expand(1, 40, 2, 64), odd_batch):
        y = FK._vector_aligned(x)
        assert y.stride() == (40 * 2 * 64, 2 * 64, 64, 1) and torch.equal(y, x)
    rows = torch.rand(2, 3, 150)
    assert FK._rows_aligned(rows) is rows
    shifted = torch.rand(2 * 3 * 150 + 1)[1:].view(2, 3, 150)
    assert shifted.data_ptr() % 16 != 0
    fixed = FK._rows_aligned(shifted)
    assert fixed.data_ptr() % 16 == 0 and torch.equal(fixed, shifted)
    assert FK._rows_aligned(rows.double()).dtype == torch.float32
