"""Flash-attention kernels for Hopper and their plain versions.

Counterparts of the TPU kernels of omnivggt_tpu/ops/pallas/flash_attention.py:

  - `flash_attention` replaces `_flash_kernel` (head-major streaming
    softmax, reached through `_flash_forward` and `flash_attention`). It
    serves the global attention, whose key axis (S * 1374) is long.
  - `flash_attention_packed` replaces `_flash_packed_kernel` (token-major,
    whole key axis per block, reached through `_flash_packed_forward` and
    `flash_attention_packed`). It serves frame and DINOv2 attention, whose
    key axis is at most `PACKED_MAX_KEYS`.
  - `flash_attention(..., qk_int8=True)` (counted apart, as
    `flash_attention_int8`) replaces `_flash_kernel`'s `qk_int8` form: q
    and k are quantised per head by `quant_per_head` (`_quant_per_head`:
    `round(x / scale)`, rows at or past `kv_valid` left out of the max-abs
    and clipped), the scores are an exact s8 x s8 -> s32 product times the
    per-head scalar c = q_scale * k_scale * D^-0.5. The quantisation pass
    is plain torch ops on the tensors' device (a max-abs reduce and an
    elementwise round), outside the kernel as on the TPU. Forward only.
  - `flash_attention_packed_stream` replaces `_flash_packed_stream_kernel`
    (token-major, key axis streamed, bounded softmax only, D == 64 and an
    even head count as in `stream_eligible`). Its int8 form quantises q
    inside the kernel as `round(q * qinv)` and takes a k quantised outside
    by `quant_token_major` (`round(k * kinv)`): another rounding than
    `quant_per_head`'s division, so the two int8 grids differ. Its bf16
    form is differentiable through the head-major forward and the backward
    kernels, as the JAX package routes it.
  - `flash_attention_bwd_dq` and `flash_attention_bwd_dkv` replace
    `_flash_bwd_dq_kernel` and `_flash_bwd_dkv_kernel` (reached through
    `_flash_backward` from every custom_vjp wrapper); the gradient of both
    forward wrappers runs them, in that order, from the forward's saved
    row log-sum-exp (`_flash_kernel`'s `return_lse` output). Both run the
    forward's TMA + wgmma tile; the dq kernel writes delta = rowsum(do * o)
    as (B, H, N) fp32, and the dk/dv kernel reads that buffer.

The forward wrappers take (B, N, H, D) tensors and compute non-causal
softmax attention with fp32 accumulation:

  - `bounded_logits=True`: softmax at a fixed max of 0 with the insurance
    clamp exp(min(s, 80)) (qk-normed inputs keep |s| far below it);
    otherwise a running max. The backward clamps the same way and passes
    the gradient straight through the clamp, as the TPU kernels do.
  - `kv_valid` (a Python int or an integer tensor, on the device): keys at
    positions >= kv_valid, like keys past Nk, get a score of -1e30.

Both are differentiable: when grad is enabled and q, k or v requires it,
they run as a `torch.autograd.Function` whose forward also writes the LSE
and whose backward is the two backward kernels; otherwise the forward
writes no LSE and saves nothing.

On CPU tensors every wrapper computes its plain version: `attention_plain`
(materialised fp32 scores, the same clamp and the same -1e30 mask),
`attention_plain_int8` and `attention_stream_plain` (the same with the
int8 grids of the two quantisers) and `attention_backward_plain`
(`_bwd_recompute`'s math in fp32). On CUDA
tensors it launches the kernels of csrc/flash_attention.cu and
csrc/flash_attention_bwd.cu, built by nvcc at first use, or raises; it
never falls back. The kernels take bf16 with head dim 64 or 128 only, and
return bf16. Each kernel's wrapper counts its launches in a plain integer
attribute, `launches`.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading

import numpy as np
import torch

from omnivggt_tpu_torch.ops.kernels import build

# the packed kernel's key-length contract, kept from the TPU kernel
# (flash_attention.py:761): frame and DINOv2 attention fit, global does not
PACKED_MAX_KEYS = 2048
HEAD_DIMS = (64, 128)
NEG_INF = -1e30
BOUNDED_CLAMP = 80.0
# fp32(1 / 127), the constant XLA multiplies by where the JAX package
# divides an int8 scale by 127.0 under jit (exact in a Python float)
INV_127 = float(np.float32(1.0) / np.float32(127.0))
SOURCES = ("flash_attention.cu", "flash_attention_bwd.cu")
QUERY_TILE = 128  # query rows a block of the forward kernel
_MAX_GRID_YZ = 65535


def _scores(q, k, kv_valid, bounded_logits):
    """fp32 scaled scores (B, H, N, Nk), clamped when bounded, masked."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * q.shape[-1] ** -0.5
    if bounded_logits:
        s = s.clamp_max(BOUNDED_CLAMP)
    if kv_valid is not None:
        key = torch.arange(k.shape[1], device=q.device)
        s = s.masked_fill(key >= kv_valid, NEG_INF)
    return s


def _softmax_pv(s, v, kv_valid, bounded_logits, dtype, return_lse=False):
    """The softmax of fp32 scaled scores (B, H, N, Nk), modified in place,
    times v: masked past kv_valid, at a fixed max of 0 with the clamp when
    bounded, else at the row max; P rounded to v's dtype before P @ V (as
    `_attention_xla` and the TPU kernels round it; a no-op for fp32 v), the
    row sums from the unrounded P; output (B, N, H, D) in `dtype`."""
    if kv_valid is not None:
        key = torch.arange(v.shape[1], device=v.device)
        s.masked_fill_(key >= kv_valid, NEG_INF)
    if bounded_logits:
        m = None
        p = s.clamp_max_(BOUNDED_CLAMP).exp_()
    else:
        m = s.detach().amax(dim=-1, keepdim=True)
        p = s.sub_(m).exp_()
    denom = p.sum(dim=-1)  # (B, H, N)
    pv = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    o = pv / denom.transpose(1, 2).unsqueeze(-1)
    o = o.to(dtype)
    if not return_lse:
        return o
    lse = denom.log()
    if m is not None:
        lse = lse + m[..., 0]
    return o, lse


def attention_plain(q, k, v, kv_valid=None, bounded_logits=False, return_lse=False):
    """Plain PyTorch version of both forward kernels: (B, N, H, D) ->
    (B, N, H, D) in q's dtype, from materialised fp32 scores, P rounded to
    v's dtype before P @ V as the kernels round it. With
    return_lse, also the (B, H, N) fp32 row log-sum-exp of the scores.

    Differentiable by autograd (the row max is taken without a gradient,
    which the softmax does not need)."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()).mul_(scale)
    return _softmax_pv(s, v, kv_valid, bounded_logits, q.dtype, return_lse)


def _abs_max_per_head(x, valid):
    """(B, H) fp32 max |x| over the token and channel axes of (B, N, H, D),
    rows at or past `valid` (an int or a device scalar) left out."""
    xa = x.float().abs()
    if valid is not None:
        row = torch.arange(x.shape[1], device=x.device)[None, :, None, None]
        xa = torch.where(row < valid, xa, 0.0)
    return xa.amax(dim=(1, 3))


def _scale_of(amax, floor):
    """max-abs -> the int8 step, max(amax, floor) / 127, computed as the
    jitted JAX package computes it: XLA rewrites the division by the
    constant into a multiplication by fp32(1 / 127) (`INV_127`), which
    lands one ulp off a true division for ~4% of inputs. One IEEE fp32
    multiplication rounds alike on the CPU and the card, so the card's grid
    equals the CPU's and the JAX package's."""
    floored = amax.clamp_min(floor)
    return floored * torch.full_like(floored, INV_127)


def quant_per_head(x, valid=None, amax_reduce=None):
    """Counterpart of `_quant_per_head`: (B, N, H, D) float -> (int8 values
    of the same shape, (B, H) fp32 scales), symmetric max-abs per head,
    x8 = round(x / scale) (half to even). Rows at or past `valid` are left
    out of the max-abs and clipped to +-127, so padded frames cannot move
    the real frames' grid.

    amax_reduce: a callable applied to the (B, H) max-abs before the scale
    is formed. The sharded strategies pass the max over the ranks
    (parallel/attention.py), so a local shard is quantised on the grid of
    the gathered array, bit for bit (a max over more rows only grows the
    scale, so nothing needs clipping)."""
    amax = _abs_max_per_head(x, valid)
    if amax_reduce is not None:
        amax = amax_reduce(amax)
    scale = _scale_of(amax, 1e-30)
    x8 = torch.round(x.float() / scale[:, None, :, None])
    if valid is not None:
        x8 = x8.clamp_(-127.0, 127.0)
    return x8.to(torch.int8), scale


def quant_token_major(x, valid=None, amax_reduce=None):
    """The stream kernel's quantiser (`_flash_packed_stream_forward`):
    (B, N, H, D) float -> (int8 values, (B, H) fp32 scales, (B, H) fp32
    inverse scales), x8 = round(x * (1 / scale)): a multiplication by the
    reciprocal where `quant_per_head` divides. Rows at or past `valid` are
    left out of the max-abs and clipped. amax_reduce: as in
    `quant_per_head`."""
    amax = _abs_max_per_head(x, valid)
    if amax_reduce is not None:
        amax = amax_reduce(amax)
    scale = _scale_of(amax, 1e-30)
    inv = 1.0 / scale
    x8 = torch.round(x.float() * inv[:, None, :, None])
    if valid is not None:
        x8 = x8.clamp_(-127.0, 127.0)
    return x8.to(torch.int8), scale, inv


def quant_k_token_major(k, amax_reduce=None):
    """Counterpart of `quant_k_token_major`: (B, Nk, H, D) float ->
    ((B, Nk, H*D) int8 token-major, (B, H) fp32 scales), the `k_quant`
    argument of `flash_attention_packed_stream`. amax_reduce: as in
    `quant_per_head` (a local K shard on the gathered array's grid)."""
    k8, scale, _ = quant_token_major(k, amax_reduce=amax_reduce)
    return k8.reshape(k.shape[0], k.shape[1], -1), scale


def _attention_from_int8(q8, k8, c, v, kv_valid, bounded_logits, dtype):
    """Attention from int8 q and k and the (B, H) dequantising scalar c:
    the integer scores are exact in fp32 (|s| <= 127^2 D < 2^24)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q8.float(), k8.float()).mul_(c[:, :, None, None])
    return _softmax_pv(s, v, kv_valid, bounded_logits, dtype)


def attention_plain_int8(q, k, v, kv_valid=None, bounded_logits=False, k_quant=None):
    """Plain PyTorch version of the head-major kernel's int8 form: q and k
    through `quant_per_head` (k_quant: an already quantised (k8 (B, Nk, H,
    D) int8, (B, H) scales) pair, without kv_valid), scores
    (q8 . k8) * q_scale * k_scale * D^-0.5, then `attention_plain`'s
    softmax and P @ V."""
    q8, q_scale = quant_per_head(q, kv_valid)
    k8, k_scale = quant_per_head(k, kv_valid) if k_quant is None else k_quant
    c = q_scale * k_scale * q.shape[-1] ** -0.5
    return _attention_from_int8(q8, k8, c, v, kv_valid, bounded_logits, q.dtype)


def attention_stream_plain(q, k, v, kv_valid=None, qk_int8=False, k_quant=None):
    """Plain PyTorch version of the stream kernel (bounded softmax): its
    bf16 form is `attention_plain` at a fixed max; its int8 form takes q
    and k through `quant_token_major` (k_quant: the pair that
    `quant_k_token_major` returns)."""
    if not qk_int8:
        return attention_plain(q, k, v, kv_valid, bounded_logits=True)
    B, _, H, D = q.shape
    q8, q_scale, _ = quant_token_major(q, kv_valid)
    if k_quant is None:
        k8, k_scale, _ = quant_token_major(k, kv_valid)
    else:
        k8, k_scale = k_quant[0].reshape(B, -1, H, D), k_quant[1]
    c = q_scale * k_scale * D**-0.5
    return _attention_from_int8(q8, k8, c, v, kv_valid, True, q.dtype)


def _backward_terms(q, k, v, o, do, lse, kv_valid, bounded_logits):
    """fp32 (p, ds, do) of _bwd_recompute: p = exp(s - lse) (s clamped when
    bounded, masked keys at -1e30), ds = p * (do v^T - rowsum(do * o))."""
    p = (_scores(q, k, kv_valid, bounded_logits) - lse.float()[..., None]).exp_()
    dof = do.float()
    delta = (dof * o.float()).sum(-1).transpose(1, 2)  # (B, H, N)
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", dof, v.float()) - delta[..., None])
    return p, ds, dof


def attention_backward_plain(q, k, v, o, do, lse, kv_valid=None, bounded_logits=False):
    """Plain PyTorch version of both backward kernels: (dq, dk, dv) in the
    inputs' dtypes from the forward's output o, its gradient do and its
    (B, H, N) LSE, in fp32 (the math of _bwd_recompute and the two TPU
    backward kernels): dq = scale ds k, dk = scale ds^T q, dv = p^T do. The
    bounded clamp passes gradients straight through; masked keys get p = 0."""
    scale = q.shape[-1] ** -0.5
    p, ds, dof = _backward_terms(q, k, v, o, do, lse, kv_valid, bounded_logits)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def lse_tolerance(q, k, lse, kv_valid=None):
    """(B, H, N) bound on the difference between two fp32 computations of
    the forward's row LSE from the same inputs (the kernel's and
    attention_plain's), each with unit roundoff u = 2^-24: the row sum of
    nk positive terms moves by at most (nk - 1) u of itself (the kernel
    sums fewer in sequence: in every 64 x 128 wgmma tile a thread holds
    2 rows x 32 columns and adds its nk / 4 terms of a row, then one quad
    shuffle adds the four partial sums), and the rescaling by the running
    max by at most 3 u per key tile, 3/128 nk u over 128-key tiles (the
    bound keeps the 3/64 nk u of the earlier 64-key tiles, which covers
    it); each term's exponent moves by at most 2 (D + 1) u A, A = scale
    |q_i| max_j |k_j| >= scale sum_d |q_d k_d| (the dot product's fp32
    accumulation, truncating on the tensor cores in D / 16 steps of 16, and
    the scale); exp, log and (m + log2 l) ln 2 add a few u of |lse|. Both
    sides: 2 u (17/16 nk + 2 (D + 1) A + 4 |lse| + 8)."""
    D = q.shape[-1]
    nk = k.shape[1] if kv_valid is None else max(min(int(kv_valid), k.shape[1]), 1)
    k_max = k[:, :nk].float().norm(dim=-1).amax(dim=1)  # (B, H)
    a = q.float().norm(dim=-1).transpose(1, 2) * k_max[..., None] * D**-0.5
    return 2.0**-23 * (17 / 16 * nk + 2 * (D + 1) * a + 4 * lse.float().abs() + 8)


# c in the backward bound: 2 exp(-c^2 / 2) = 4.6e-11 per entry at c = 7
BWD_SIGMAS = 7.0


def backward_tolerance(q, k, v, o, do, lse, kv_valid=None, bounded_logits=False, lse_err=0.0):
    """Per-entry bounds (tol_dq, tol_dk, tol_dv), shaped like the gradients,
    on the backward kernels' error against attention_backward_plain on the
    same bf16 inputs and this LSE, when the kernels were given an LSE
    within lse_err of it.

    Each gradient entry is a sum of terms t = w x: w = ds for dq (x = scale
    k) and dk (x = scale q), w = p for dv (x = dO). Two kinds of error:

      - bf16 rounding. The kernels round each w to bf16 before the
        product, which moves each term by eps t, |eps| <= 2^-8, with zero
        mean and independently from term to term; by Hoeffding's inequality
        the sum moves by more than c 2^-8 sqrt(sum t^2) with probability at
        most 2 exp(-c^2 / 2): at c = BWD_SIGMAS = 7, 4.6e-11 per entry,
        below 1e-3 over the 2e7 entries of the largest check. Rounding the
        output to bf16 adds at most 2^-8 of its value.
      - fp32 rounding, both sides, summed worst-case over the terms as
        sum |dw| |x|, u = 2^-24. Each p moves by eta p, eta = 4 (D + 1) u
        scale sum_d |q_d k_d| + 4 u |lse| + expm1(lse_err) (the score's dot
        product, accumulated with truncation on the tensor cores, and the
        LSE); ds = p (dP - delta) moves by eta |ds| + 4 D u p (sum_d |dO_d
        v_d| + sum_d |dO_d o_d|), the dot products of dP and delta, which
        cancel where one key takes the whole row."""
    D = q.shape[-1]
    scale, u = D**-0.5, 2.0**-24
    p, ds, dof = _backward_terms(q, k, v, o, do, lse, kv_valid, bounded_logits)
    eta = torch.einsum("bqhd,bkhd->bhqk", q.float().abs(), k.float().abs())
    eta.mul_(4 * (D + 1) * u * scale).add_(4 * u * lse.float().abs()[..., None] + math.expm1(lse_err))
    dots = torch.einsum("bqhd,bkhd->bhqk", dof.abs(), v.float().abs())
    dots.add_((dof * o.float()).abs().sum(-1).transpose(1, 2)[..., None]).mul_(p).mul_(4 * D * u)
    err_ds = dots.addcmul_(eta, ds.abs())
    del dots
    err_p = eta.mul_(p)
    tols = []
    for w, dw, x, mul, eq in (
        (ds, err_ds, k.float(), scale, "bhqk,bkhd->bqhd"),
        (ds, err_ds, q.float(), scale, "bhqk,bqhd->bkhd"),
        (p, err_p, dof, 1.0, "bhqk,bqhd->bkhd"),
    ):
        value = torch.einsum(eq, w, x).abs_()
        rms = torch.einsum(eq, w.square(), x.square()).sqrt_()
        tol = value.add_(rms, alpha=BWD_SIGMAS).mul_(2.0**-8)
        tol.add_(torch.einsum(eq, dw, x.abs()))
        tols.append(tol.mul_(mul))
    return tuple(tols)


_BUILD_LOCK = threading.Lock()


def _libraries():
    """The three kernel entry points and the build log; built once, under a
    lock (sessions call the wrappers from several threads)."""
    with _BUILD_LOCK:
        return _libraries_locked()


@functools.lru_cache(maxsize=None)
def _libraries_locked():
    logs = build.build_all(SOURCES)
    fwd_lib, _ = build.load(SOURCES[0])
    bwd_lib, _ = build.load(SOURCES[1])
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    strides = ctypes.POINTER(ctypes.c_longlong)
    fwd = fwd_lib.omnivggt_flash_attention_fwd
    fwd.argtypes = [
        i32, i32, i32, i32,     # mode, bounded, D, qk
        ptr, ptr, ptr, ptr, ptr,  # q, k, v, o, lse
        ptr, ptr, ptr,          # c, qinv, q8_out
        strides,                # 12 strides
        i32, i32, i32, i32,     # B, H, N, Nk
        i32, ptr,               # kv_static, kv_dynamic
        f32, ptr,               # scale, stream
        i32,                    # kv_head_shift (a test hook, 0)
    ]
    bwd_args = [
        i32, i32,                            # bounded, D
        ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,  # 8 tensors (see the source)
        strides,                             # 18 strides
        i32, i32, i32, i32, i32, ptr,        # B, H, N, Nk, kv_static, kv_dynamic
        f32, ptr,                            # scale, stream
    ]
    dq, dkv = bwd_lib.omnivggt_flash_attention_bwd_dq, bwd_lib.omnivggt_flash_attention_bwd_dkv
    dq.argtypes = dkv.argtypes = bwd_args
    for fn in (fwd, dq, dkv):
        fn.restype = ctypes.c_int
    return fwd, dq, dkv, "\n".join(logs[s] for s in SOURCES)


def load_kernels() -> str:
    """Build (both sources at once) and load the kernels now (they
    otherwise build at first launch); returns the compiler logs, empty
    where a library was cached."""
    return _libraries()[3]


def bwd_launch_shape(head_dim: int) -> tuple:
    """(threads a block, dynamic shared-memory bytes of the dq kernel, of
    the dk/dv kernel) at this head dim, as the backward source computes
    them."""
    lib, _ = build.load(SOURCES[1])
    threads, smem = lib.omnivggt_flash_attention_bwd_threads, lib.omnivggt_flash_attention_bwd_smem_bytes
    threads.argtypes, smem.argtypes = [], [ctypes.c_int, ctypes.c_int]
    threads.restype = smem.restype = ctypes.c_int
    return threads(), smem(0, int(head_dim)), smem(1, int(head_dim))


def tma_launch_shape(head_dim: int, qk: int = 0) -> tuple:
    """(threads a block, dynamic shared-memory bytes a block) of the
    forward kernel at this head dim and score form (`SCORES_*`), as its
    source computes them; 0 bytes where the pair has no kernel."""
    lib, _ = build.load(SOURCES[0])
    threads, smem = lib.omnivggt_flash_attention_tma_threads, lib.omnivggt_flash_attention_tma_smem_bytes
    threads.argtypes, smem.argtypes = [], [ctypes.c_int, ctypes.c_int]
    threads.restype = smem.restype = ctypes.c_int
    return threads(), smem(int(head_dim), int(qk))


def _on_cpu(*tensors) -> bool:
    devices = {t.device.type for t in tensors}
    if devices == {"cpu"}:
        return True
    if devices == {"cuda"}:
        return False
    raise ValueError(f"attention tensors must all lie on the CPU or all on CUDA, got {devices}")


def _vector_aligned(x):
    """x itself when a TMA map takes its (B, N, H) strides as they are and
    every row starts on a 16-byte boundary (the kernels' vector loads): the
    last axis contiguous, the base and each stride a positive multiple of
    16 bytes. Else a contiguous copy: cuTensorMapEncodeTiled refuses a zero
    stride (autograd's expanded gradients) or a misaligned one, and a size-1
    axis keeps an odd stride through `.contiguous()`, so the copy is made
    with fresh strides."""
    per_vector = 16 // x.element_size()
    if (
        x.stride(-1) == 1
        and all(s > 0 and s % per_vector == 0 for s in x.stride()[:3])
        and x.data_ptr() % 16 == 0
    ):
        return x
    return x.clone(memory_format=torch.contiguous_format)


def _rows_aligned(x):
    """A (B, H, N) row vector as the backward kernels read it: contiguous
    fp32 from a 16-byte aligned base (a 1-D TMA map over the flat buffer);
    x itself when it is one already."""
    x = x.float().contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


MODE_HEAD_MAJOR, MODE_TOKEN_MAJOR = 0, 1  # the grid order
SCORES_BF16, SCORES_INT8, SCORES_INT8_Q_IN = 0, 1, 2


def _check(q, k, v, packed=False, qk=SCORES_BF16):
    """Validate what the kernels take; returns (B, N, H, D, Nk)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, N, H, D)")
    B, N, H, D = q.shape
    Nk = k.shape[1]
    if k.shape != (B, Nk, H, D) or v.shape != k.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    want = (
        torch.int8 if qk == SCORES_INT8 else torch.bfloat16,
        torch.bfloat16 if qk == SCORES_BF16 else torch.int8,
        torch.bfloat16,
    )
    if (q.dtype, k.dtype, v.dtype) != want:
        raise TypeError(
            f"the Hopper kernels take {want} for q, k, v here, got {q.dtype}/{k.dtype}/{v.dtype}"
        )
    if D not in HEAD_DIMS:
        raise ValueError(f"the Hopper kernels take head dim in {HEAD_DIMS}, got {D}")
    # query tiles of 128 rows in every form; the token-major grid puts them on y
    if (max(B, math.ceil(N / QUERY_TILE)) if packed else B * H) > _MAX_GRID_YZ:
        raise ValueError(f"grid too large for (B, N, H) = {(B, N, H)}")
    return B, N, H, D, Nk


def _check_grad_inputs(q, do, rows, o=None):
    """do (and o) bf16 shaped like q; each of `rows` a (B, H, N) tensor."""
    B, N, H, _ = q.shape
    for name, x in (("do", do), ("o", o)):
        if x is not None and (x.shape != q.shape or x.dtype != torch.bfloat16):
            raise ValueError(f"{name} must be bf16 {tuple(q.shape)}, got {x.dtype} {tuple(x.shape)}")
    for x in rows:
        if x.shape != (B, H, N):
            raise ValueError(f"lse/delta must be (B, H, N) = {(B, H, N)}, got {tuple(x.shape)}")


def _kv_args(kv_valid, Nk, device):
    """(kv_static, device pointer or None, tensor to keep alive)."""
    if isinstance(kv_valid, torch.Tensor):
        keep = kv_valid.to(device=device, dtype=torch.int32).reshape(())
        return Nk, keep.data_ptr(), keep
    if kv_valid is not None:
        return max(min(int(kv_valid), Nk), 0), None, None
    return Nk, None, None


def _strides(*tensors):
    return (ctypes.c_longlong * (3 * len(tensors)))(*[s for x in tensors for s in x.stride()[:3]])


def _raise_on(err, what):
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {err}")


def _launch_fwd(counter, q, k, v, kv_valid, bounded_logits, mode, with_lse=False,
                qk=SCORES_BF16, c=None, qinv=None, q8_out=None, kv_head_shift=0):
    """One forward kernel launch, counted on `counter`: o, or (o, lse)
    with_lse. qk, c, qinv, q8_out: the int8 forms (see the source).
    kv_head_shift: 0; a test hook that plants a fault (every form reads K
    and V of head (h + shift) % H)."""
    B, N, H, D, Nk = _check(q, k, v, mode != MODE_HEAD_MAJOR, qk)
    q, k, v = (_vector_aligned(x) for x in (q, k, v))
    o = torch.empty((B, N, H, D), dtype=torch.bfloat16, device=q.device)
    lse = torch.empty((B, H, N), dtype=torch.float32, device=q.device) if with_lse else None
    kv_static, kv_ptr, _keep = _kv_args(kv_valid, Nk, q.device)
    scales = []
    for x in (c, qinv):
        if x is not None:
            if x.shape != (B, H) or x.device != q.device:
                raise ValueError(f"per-head scales must be (B, H) = {(B, H)} on {q.device}")
            x = x.float().contiguous()
        scales.append(x)
    if q8_out is not None and (
        q8_out.shape != q.shape or q8_out.dtype != torch.int8 or not q8_out.is_contiguous()
        or q8_out.device != q.device
    ):
        raise ValueError("q8_out must be a contiguous int8 tensor shaped like q")
    fwd = _libraries()[0]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fwd(
            mode, int(bool(bounded_logits)), D, qk,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if lse is None else lse.data_ptr(),
            *(None if x is None else x.data_ptr() for x in scales),
            None if q8_out is None else q8_out.data_ptr(),
            _strides(q, k, v, o),
            B, H, N, Nk, kv_static, kv_ptr, D ** -0.5, stream, kv_head_shift,
        )
    _raise_on(err, "flash-attention forward")
    counter.launches += 1
    return (o, lse) if with_lse else o


def _launch(q, k, v, kv_valid, bounded_logits, packed, with_lse=False):
    """One bf16 forward launch of the head-major or the packed kernel."""
    counter, mode = (
        (flash_attention_packed, MODE_TOKEN_MAJOR) if packed
        else (flash_attention, MODE_HEAD_MAJOR)
    )
    return _launch_fwd(counter, q, k, v, kv_valid, bounded_logits, mode, with_lse)


def flash_attention_bwd_dq(q, k, v, o, do, lse, kv_valid=None, bounded_logits=False):
    """The dq kernel (counterpart of _flash_bwd_dq_kernel) on CUDA tensors:
    returns (dq, delta), delta = rowsum(do * o) as (B, H, N) fp32 for the
    dk/dv kernel."""
    B, N, H, D, Nk = _check(q, k, v)
    _check_grad_inputs(q, do, (lse,), o)
    q, k, v, o, do = (_vector_aligned(x) for x in (q, k, v, o, do))
    lse = _rows_aligned(lse)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    delta = torch.empty((B, H, N), dtype=torch.float32, device=q.device)
    kv_static, kv_ptr, _keep = _kv_args(kv_valid, Nk, q.device)
    dq_fn = _libraries()[1]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = dq_fn(
            int(bool(bounded_logits)), D,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), _strides(q, k, v, do, o, dq),
            B, H, N, Nk, kv_static, kv_ptr, D ** -0.5, stream,
        )
    _raise_on(err, "flash-attention dq")
    flash_attention_bwd_dq.launches += 1
    return dq, delta


flash_attention_bwd_dq.launches = 0


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, kv_valid=None, bounded_logits=False):
    """The dk/dv kernel (counterpart of _flash_bwd_dkv_kernel) on CUDA
    tensors, from the delta that flash_attention_bwd_dq returned:
    returns (dk, dv)."""
    B, N, H, D, Nk = _check(q, k, v)
    _check_grad_inputs(q, do, (lse, delta))
    q, k, v, do = (_vector_aligned(x) for x in (q, k, v, do))
    lse, delta = _rows_aligned(lse), _rows_aligned(delta)
    dk = torch.empty((B, Nk, H, D), dtype=k.dtype, device=k.device)
    dv = torch.empty((B, Nk, H, D), dtype=v.dtype, device=v.device)
    kv_static, kv_ptr, _keep = _kv_args(kv_valid, Nk, q.device)
    dkv_fn = _libraries()[2]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = dkv_fn(
            int(bool(bounded_logits)), D,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), _strides(q, k, v, do, dk, dv),
            B, H, N, Nk, kv_static, kv_ptr, D ** -0.5, stream,
        )
    _raise_on(err, "flash-attention dk/dv")
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_bwd_dkv.launches = 0


def flash_attention_backward(q, k, v, o, do, lse, kv_valid=None, bounded_logits=False):
    """(dq, dk, dv) of either forward wrapper: the plain version on CPU
    tensors; on CUDA the dq kernel, then the dk/dv kernel (do laid out for
    TMA once, for both: autograd may hand over an expanded gradient)."""
    if _on_cpu(q, k, v, o, do):
        return attention_backward_plain(q, k, v, o, do, lse, kv_valid, bounded_logits)
    do = _vector_aligned(do)
    dq, delta = flash_attention_bwd_dq(q, k, v, o, do, lse, kv_valid, bounded_logits)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, kv_valid, bounded_logits)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Counterpart of the custom_vjp wrappers (_flash_unmasked,
    _flash_masked, _packed_*): the forward kernel with its LSE, the two
    backward kernels as the gradient (plain versions on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, kv_valid, bounded, packed):
        if _on_cpu(q, k, v):
            o, lse = attention_plain(q, k, v, kv_valid, bounded, return_lse=True)
        else:
            o, lse = _launch(q, k, v, kv_valid, bounded, packed, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kv_valid, ctx.bounded = kv_valid, bounded
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, o, do, lse, ctx.kv_valid, ctx.bounded)
        return dq, dk, dv, None, None, None


def _attend(q, k, v, kv_valid, bounded_logits, packed):
    cpu = _on_cpu(q, k, v)
    if _wants_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, kv_valid, bool(bounded_logits), packed)
    if cpu:
        return attention_plain(q, k, v, kv_valid, bounded_logits)
    return _launch(q, k, v, kv_valid, bounded_logits, packed)


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(x is not None and x.requires_grad for x in tensors)


def flash_attention(q, k, v, kv_valid=None, bounded_logits=False, qk_int8=False, k_quant=None):
    """Head-major flash attention over (B, N, H, D); any key length.
    Counterpart of flash_attention.py::_flash_kernel.

    qk_int8: the kernel's int8 form (`flash_attention_int8`), forward only.
    k_quant: with qk_int8 and no kv_valid, an already quantised k as
    (k8 (B, Nk, H, D) int8, (B, H) fp32 scales), e.g. `quant_per_head(k)`."""
    if qk_int8:
        return flash_attention_int8(q, k, v, kv_valid, bounded_logits, k_quant)
    if k_quant is not None:
        raise ValueError("k_quant requires qk_int8")
    return _attend(q, k, v, kv_valid, bounded_logits, packed=False)


flash_attention.launches = 0


def flash_attention_int8(q, k, v, kv_valid=None, bounded_logits=False, k_quant=None):
    """The head-major kernel's int8 form (`_flash_kernel` with qk_int8):
    q and k quantised per head by `quant_per_head` (plain torch ops on the
    tensors' device), exact s8 scores times the per-head c in the kernel.
    Serving only: no LSE and no gradient."""
    if k_quant is not None and kv_valid is not None:
        raise ValueError("k_quant requires qk_int8 and no kv_valid")
    if _wants_grad(q, k, v):
        raise ValueError("qk_int8 is a serving-only forward mode (no gradient)")
    if _on_cpu(q, v) if k is None else _on_cpu(q, k, v):
        return attention_plain_int8(q, k, v, kv_valid, bounded_logits, k_quant)
    q8, q_scale = quant_per_head(q, kv_valid)
    k8, k_scale = quant_per_head(k, kv_valid) if k_quant is None else k_quant
    c = q_scale * k_scale * q.shape[-1] ** -0.5
    return _launch_fwd(
        flash_attention_int8, q8, k8, v, kv_valid, bounded_logits, MODE_HEAD_MAJOR,
        qk=SCORES_INT8, c=c,
    )


flash_attention_int8.launches = 0


def flash_attention_packed(q, k, v, kv_valid=None, bounded_logits=False):
    """Token-major flash attention over (B, N, H, D) for key lengths up to
    PACKED_MAX_KEYS. Counterpart of flash_attention.py::_flash_packed_kernel;
    under grad its gradient runs the same backward kernels as the
    head-major wrapper's."""
    if k.shape[1] > PACKED_MAX_KEYS:
        raise ValueError(
            f"packed kernel requires Nk <= {PACKED_MAX_KEYS}, got {k.shape[1]}"
        )
    return _attend(q, k, v, kv_valid, bounded_logits, packed=True)


flash_attention_packed.launches = 0


def flash_attention_packed_stream(q, k, v, kv_valid=None, qk_int8=False, k_quant=None):
    """Token-major streaming flash attention over (B, N, H, D) for long key
    axes, bounded softmax only. Counterpart of
    flash_attention.py::_flash_packed_stream_kernel.

    qk_int8: int8 scores; q is quantised inside the kernel as
    round(q * qinv) from per-head scales taken here, k outside by
    `quant_token_major`. Forward only. k_quant: with qk_int8 and no
    kv_valid, the pair `quant_k_token_major` returns. The bf16 form is
    differentiable: under grad it runs the head-major forward with its LSE
    and the backward kernels.

    On the card it launches the token-major kernel that the packed wrapper
    launches (its key loop has no length limit); the TPU's two kernels are
    two contracts and two launch counters here."""
    B, N, H, D = q.shape
    if D != 64 or H % 2:
        raise ValueError(
            f"the streaming kernel takes head dim 64 and an even head count, got D={D}, H={H}"
        )
    if k_quant is not None and (not qk_int8 or kv_valid is not None):
        raise ValueError("k_quant requires qk_int8 and no kv_valid")
    if not qk_int8:
        if _wants_grad(q, k, v):
            return _FlashAttention.apply(q, k, v, kv_valid, True, False)
        if _on_cpu(q, k, v):
            return attention_stream_plain(q, k, v, kv_valid)
        return _launch_fwd(
            flash_attention_packed_stream, q, k, v, kv_valid, True, MODE_TOKEN_MAJOR
        )
    if _wants_grad(q, k, v):
        raise ValueError("qk_int8 is a serving-only forward mode (no gradient)")
    if _on_cpu(q, v) if k is None else _on_cpu(q, k, v):
        return attention_stream_plain(q, k, v, kv_valid, True, k_quant)
    return _stream_int8(q, k, v, kv_valid, k_quant)


def _stream_int8(q, k, v, kv_valid, k_quant, q8_out=None):
    """The stream wrapper's int8 launch on CUDA tensors. q8_out: an int8
    tensor shaped like q that receives the q quantised inside the kernel,
    for the checks of its grid."""
    B, _, H, D = q.shape
    q_scale = _scale_of(_abs_max_per_head(q, kv_valid), 1e-30)
    if k_quant is None:
        k8, k_scale, _ = quant_token_major(k, kv_valid)
    else:
        k8, k_scale = k_quant[0].reshape(B, -1, H, D), k_quant[1]
    c = q_scale * k_scale * D**-0.5
    return _launch_fwd(
        flash_attention_packed_stream, q, k8, v, kv_valid, True, MODE_TOKEN_MAJOR,
        qk=SCORES_INT8_Q_IN, c=c, qinv=1.0 / q_scale, q8_out=q8_out,
    )


flash_attention_packed_stream.launches = 0


def reset_launches() -> None:
    """Set every kernel's launch counter to 0."""
    for fn in KERNELS:
        fn.launches = 0


def launches() -> dict:
    """{kernel wrapper name: launches since the last reset}."""
    return {fn.__name__: fn.launches for fn in KERNELS}


KERNELS = (
    flash_attention, flash_attention_packed, flash_attention_bwd_dq, flash_attention_bwd_dkv,
    flash_attention_int8, flash_attention_packed_stream,
)
