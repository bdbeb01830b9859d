"""Flash-attention forward kernels for Hopper and their plain versions.

Counterparts of the two TPU kernels on the inference path
(omnivggt_tpu/ops/pallas/flash_attention.py):

  - `flash_attention` replaces `_flash_kernel` (head-major streaming
    softmax, reached through `_flash_forward` and `flash_attention`). It
    serves the global attention, whose key axis (S * 1374) is long.
  - `flash_attention_packed` replaces `_flash_packed_kernel` (token-major,
    whole key axis per block, reached through `_flash_packed_forward` and
    `flash_attention_packed`). It serves frame and DINOv2 attention, whose
    key axis is at most `PACKED_MAX_KEYS`.

Both take (B, N, H, D) tensors and compute non-causal softmax attention
with fp32 accumulation:

  - `bounded_logits=True`: softmax at a fixed max of 0 with the insurance
    clamp exp(min(s, 80)) (qk-normed inputs keep |s| far below it);
    otherwise a running max.
  - `kv_valid` (a Python int or an integer tensor, on the device): keys at
    positions >= kv_valid, like keys past Nk, get a score of -1e30.

On a CPU tensor each wrapper computes its plain version, `attention_plain`
(materialised fp32 scores, the same clamp and the same -1e30 mask). On a
CUDA tensor it launches the kernel of csrc/flash_attention.cu, built by
nvcc at first use, or raises; it never falls back. The kernels take bf16
with head dim 64 or 128 only, and return bf16. Each wrapper counts its
launches in a plain integer attribute, `launches`.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from omnivggt_tpu_torch.ops.kernels import build

# the packed kernel's key-length contract, kept from the TPU kernel
# (flash_attention.py:761): frame and DINOv2 attention fit, global does not
PACKED_MAX_KEYS = 2048
HEAD_DIMS = (64, 128)
NEG_INF = -1e30
BOUNDED_CLAMP = 80.0
_SOURCE = "flash_attention.cu"
_MAX_GRID_YZ = 65535


def attention_plain(q, k, v, kv_valid=None, bounded_logits=False):
    """Plain PyTorch version of both kernels: (B, N, H, D) -> (B, N, H, D)
    in q's dtype, from materialised fp32 scores."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()).mul_(scale)
    if kv_valid is not None:
        key = torch.arange(k.shape[1], device=q.device)
        s.masked_fill_(key >= kv_valid, NEG_INF)
    if bounded_logits:
        p = s.clamp_max_(BOUNDED_CLAMP).exp_()
    else:
        p = s.sub_(s.amax(dim=-1, keepdim=True)).exp_()
    denom = p.sum(dim=-1).transpose(1, 2).unsqueeze(-1)  # (B, N, H, 1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float()) / denom
    return o.to(q.dtype)


@functools.lru_cache(maxsize=None)
def _library():
    lib, log = build.load(_SOURCE)
    fn = lib.omnivggt_flash_attention_fwd
    fn.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int,           # packed, bounded, D
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # q, k, v
        ctypes.c_void_p,                                    # o
        ctypes.POINTER(ctypes.c_longlong),                  # 12 strides
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, H, N, Nk
        ctypes.c_int, ctypes.c_void_p,                      # kv_static, kv_dynamic
        ctypes.c_float, ctypes.c_void_p,                    # scale, stream
    ]
    fn.restype = ctypes.c_int
    return fn, log


def load_kernels() -> str:
    """Build and load the kernels now (they otherwise build at first
    launch); returns the compiler log, empty if the library was cached."""
    return _library()[1]


def _on_cpu(*tensors) -> bool:
    devices = {t.device.type for t in tensors}
    if devices == {"cpu"}:
        return True
    if devices == {"cuda"}:
        return False
    raise ValueError(f"q, k and v must all lie on the CPU or all on CUDA, got {devices}")


def _vector_aligned(x):
    """x itself when every row starts on a 16-byte boundary (the kernel's
    vector loads), else a contiguous copy."""
    if (
        x.stride(-1) == 1
        and all(s % 8 == 0 for s in x.stride()[:3])
        and x.data_ptr() % 16 == 0
    ):
        return x
    return x.contiguous()


def _launch(q, k, v, kv_valid, bounded_logits, packed):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, N, H, D)")
    B, N, H, D = q.shape
    Nk = k.shape[1]
    if k.shape != (B, Nk, H, D) or v.shape != k.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError(f"the Hopper kernels take bfloat16, got {q.dtype}/{k.dtype}/{v.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"the Hopper kernels take head dim in {HEAD_DIMS}, got {D}")
    q_tiles = math.ceil(N / 64)
    if (B * H if not packed else max(B, q_tiles)) > _MAX_GRID_YZ:
        raise ValueError(f"grid too large for (B, N, H) = {(B, N, H)}")

    q, k, v = (_vector_aligned(x) for x in (q, k, v))
    o = torch.empty((B, N, H, D), dtype=q.dtype, device=q.device)
    kv_static, kv_ptr, kv_keep = Nk, None, None
    if isinstance(kv_valid, torch.Tensor):
        kv_keep = kv_valid.to(device=q.device, dtype=torch.int32).reshape(())
        kv_ptr = kv_keep.data_ptr()
    elif kv_valid is not None:
        kv_static = max(min(int(kv_valid), Nk), 0)
    strides = (ctypes.c_longlong * 12)(
        *[s for x in (q, k, v, o) for s in x.stride()[:3]]
    )
    fn, _ = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            int(packed), int(bool(bounded_logits)), D,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), strides,
            B, H, N, Nk, kv_static, kv_ptr, D ** -0.5, stream,
        )
    if err != 0:
        raise RuntimeError(f"flash-attention kernel launch failed: cudaError {err}")
    return o


def flash_attention(q, k, v, kv_valid=None, bounded_logits=False):
    """Head-major flash attention over (B, N, H, D); any key length.
    Counterpart of flash_attention.py::_flash_kernel."""
    if _on_cpu(q, k, v):
        return attention_plain(q, k, v, kv_valid, bounded_logits)
    o = _launch(q, k, v, kv_valid, bounded_logits, packed=False)
    flash_attention.launches += 1
    return o


flash_attention.launches = 0


def flash_attention_packed(q, k, v, kv_valid=None, bounded_logits=False):
    """Token-major flash attention over (B, N, H, D) for key lengths up to
    PACKED_MAX_KEYS. Counterpart of flash_attention.py::_flash_packed_kernel."""
    if k.shape[1] > PACKED_MAX_KEYS:
        raise ValueError(
            f"packed kernel requires Nk <= {PACKED_MAX_KEYS}, got {k.shape[1]}"
        )
    if _on_cpu(q, k, v):
        return attention_plain(q, k, v, kv_valid, bounded_logits)
    o = _launch(q, k, v, kv_valid, bounded_logits, packed=True)
    flash_attention_packed.launches += 1
    return o


flash_attention_packed.launches = 0
