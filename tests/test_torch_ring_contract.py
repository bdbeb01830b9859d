"""What the ring wrappers hand the Hopper ring kernel, checked on the CPU.

The ring kernel (csrc/ring_attention.cu) runs only on the card
(tests/test_torch_cuda.py, chip_smoke.py). Here its C entry point is
recorded, not run: the int8 form must reach the kernel as the int8 grids
and the per-rank scalar table of `quant_ring`, with the planted-fault hooks
passed through as in the bf16 form, one launch counted per wrapper call and
none by `_ring_run`; and the shared memory that a step's block asks for
must fit the H100's 227 KB in every form.
"""

import contextlib
import ctypes
import types

import numpy as np
import pytest
import torch

from omnivggt_tpu_torch.ops.kernels import ring_attention as RK

B, H, D = 1, 3, 64
# the C entry point's arguments by position (see omnivggt_ring_attention)
INT8, Q, K, V, C, STRIDES, NL, Q0, Q_ROWS, N_RANKS, SKIP, SHIFT, DROP = (
    2, 3, 4, 5, 10, 11, 14, 15, 16, 17, 18, 21, 22)
BLOCK_SMEM = 232448  # bytes of shared memory a block of the H100 can have


def _record(monkeypatch):
    """Replaces the C entry point by a recorder that copies, at call time,
    what the pointers it is given hold (each call returns 0, a launch
    without error), and the CUDA stream by a stand-in."""
    calls = []

    def fake(*args):
        n, nl = args[N_RANKS], args[NL]
        int8 = args[INT8]
        esize = 1 if int8 else 2
        held = {}
        for name, pos in (("q", Q), ("k", K), ("v", V)):
            ptrs = [args[pos][r] for r in range(n)]
            # rank r's shard starts nl token rows after rank r - 1's
            held[name + "_offsets"] = [p - ptrs[0] for p in ptrs]
            held[name] = ctypes.string_at(ptrs[0], B * n * nl * H * D * esize)
        held["c"] = ([ctypes.string_at(args[C][r], B * H * 2 * 4) for r in range(n)]
                     if int8 else None)
        calls.append((args, held))
        return 0

    monkeypatch.setattr(RK, "_library", lambda: (fake, ""))
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    for fn in RK.KERNELS:
        monkeypatch.setattr(fn, "launches", 0)
    return calls


def _qkv(n, nl, seed=0):
    rng = np.random.default_rng(seed)
    shape = (B, n * nl, H, D)
    q = rng.normal(size=shape) * 3.0
    k, v = rng.normal(size=shape), rng.normal(size=shape)
    return [torch.tensor(x, dtype=torch.bfloat16) for x in (q, k, v)]


@pytest.mark.parametrize("n,nl,chunk_q", [(4, 150, None), (2, 150, 64)])
def test_int8_launch_hands_the_kernel_quant_rings_grids_and_table(monkeypatch, n, nl, chunk_q):
    """_ring_launch(qk_int8=True): every pass of the kernel gets the int8
    form's flag, q, k and v as the int8 grids of quant_ring (contiguous
    (B, N, H, D), rank r's shard nl rows after rank r - 1's, strides in
    int8 elements) and rank r's (B*H, 2) row of the table; one pass per
    query chunk; one launch counted."""
    calls = _record(monkeypatch)
    q, k, v = _qkv(n, nl)
    counter = RK.ring_flash_attention_hbm
    o, slots = RK._ring_launch(counter, q, k, v, n, True, True, chunk_q=chunk_q)
    assert counter.launches == 1 and RK.ring_flash_attention.launches == 0
    assert o.shape == q.shape and o.dtype == torch.bfloat16
    assert len(slots) == n and all(s.dtype == torch.int8 and s.shape == (2, 2, B * H, nl, D)
                                   for s in slots)
    q8, k8, v8, table = RK.quant_ring(q, k, v, n, D**-0.5)
    chunk = nl if chunk_q is None else chunk_q
    assert [(a[Q0], a[Q_ROWS]) for a, _ in calls] == [
        (q0, min(chunk, nl - q0)) for q0 in range(0, nl, chunk)]
    token = [n * nl * H * D, H * D, D]
    for args, held in calls:
        assert args[INT8] == 1 and args[N_RANKS] == n and args[NL] == nl
        assert list(args[STRIDES])[:9] == token * 3  # q, k, v: int8 elements
        for name, x in (("q", q8), ("k", k8), ("v", v8)):
            assert held[name + "_offsets"] == [r * nl * H * D for r in range(n)]
            assert held[name] == x.contiguous().numpy().tobytes(), name
        for r in range(n):
            got = np.frombuffer(held["c"][r], dtype=np.float32).reshape(B * H, 2)
            np.testing.assert_array_equal(got, table[r].numpy())
        assert (args[SKIP], args[SHIFT], args[DROP]) == (-1, 0, 0)


def test_bf16_launch_hands_the_kernel_its_inputs_and_no_table(monkeypatch):
    """The bf16 form: the flag off, q, k and v as given (bf16, uncopied),
    no table."""
    calls = _record(monkeypatch)
    n, nl = 4, 100
    q, k, v = _qkv(n, nl, seed=1)
    RK._ring_launch(RK.ring_flash_attention, q, k, v, n, False, False)
    ((args, held),) = calls
    assert args[INT8] == 0 and args[C] is None and held["c"] is None
    for name, x in (("q", q), ("k", k), ("v", v)):
        assert held[name] == x.view(torch.int16).numpy().tobytes()
        assert args[Q + "qkv".index(name)][0] == x.data_ptr()


@pytest.mark.parametrize("qk_int8", [False, True])
@pytest.mark.parametrize("hook", [dict(kv_head_shift=1), dict(drop_last_key_tile=True),
                                  dict(skip_rotation_at=2)])
def test_fault_hooks_reach_the_kernel_in_both_forms(monkeypatch, hook, qk_int8):
    """Each planted-fault hook reaches the C entry point as given, in the
    int8 form as in the bf16 form, and the others stay at their real
    values."""
    calls = _record(monkeypatch)
    n, nl = 4, 150
    q, k, v = _qkv(n, nl, seed=2)
    RK._ring_launch(RK.ring_flash_attention_hbm, q, k, v, n, False, qk_int8, **hook)
    ((args, _),) = calls
    want = {"skip_rotation_at": -1, "kv_head_shift": 0, "drop_last_key_tile": 0}
    want.update({key: int(val) for key, val in hook.items()})
    assert args[INT8] == int(qk_int8)
    assert (args[SKIP], args[SHIFT], args[DROP]) == (
        want["skip_rotation_at"], want["kv_head_shift"], want["drop_last_key_tile"])


def test_ring_run_launches_on_grids_made_once_and_counts_nothing(monkeypatch):
    """_ring_run takes quant_ring's grids and table as they are (what a
    bench times as the kernel alone), counts no launch, and refuses a form
    whose types and table disagree."""
    calls = _record(monkeypatch)
    n, nl = 2, 150
    q, k, v = _qkv(n, nl, seed=3)
    q8, k8, v8, table = RK.quant_ring(q, k, v, n, D**-0.5)
    for _ in range(2):
        RK._ring_run(q8, k8, v8, table, n, True)
    assert len(calls) == 2 and all(RK.launches()[name] == 0 for name in RK.launches())
    assert all(a[Q][0] == q8.data_ptr() and a[INT8] == 1 for a, _ in calls)
    with pytest.raises(TypeError, match="int8"):
        RK._ring_run(q, k, v, table, n, True)  # bf16 inputs with a table
    with pytest.raises(TypeError, match="bfloat16"):
        RK._ring_run(q8, k8, v8, None, n, True)  # int8 inputs without one
    with pytest.raises(ValueError, match="table"):
        RK._ring_run(q8, k8, v8, table[:, :1], n, True)
    assert len(calls) == 2


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("head_dim", [64, 128])
def test_ring_launch_shape_fits_a_block(head_dim, int8):
    """A step's block (384 threads) asks for no more shared memory than an
    H100 block can have; the int8 form's staged int8 V tiles add to the
    bf16 form's layout, so it asks for more."""
    threads, smem = RK.ring_launch_shape(head_dim, int8)
    assert threads == 384 and 0 < smem <= BLOCK_SMEM
    if int8:
        assert smem > RK.ring_launch_shape(head_dim, False)[1]
