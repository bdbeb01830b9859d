"""3x3 stride-1 pad-1 convolution kernel for Hopper and its plain version.

Counterpart of omnivggt_tpu/ops/pallas/conv3x3.py: `conv3x3_folded`
replaces `_conv_kernel` (reached through the JAX `conv3x3_folded`), the
3x3 convolution + bias + optional fused ReLU for narrow outputs
(cout <= 64). On the flagship it serves the DPT heads' `output_conv2[0]`,
128 -> 32 channels at 518 x 518, when the head-conv flag is on
(models/dpt_head.py). Forward only, like the TPU kernel.

The TPU kernel's W-fold, its tap expansion outside the kernel and its
16-aligned pads answer the MXU's lanes and Mosaic's layout rules and are
not carried over (see csrc/conv3x3.cu); `conv3x3_eligible` keeps what
decides which convolutions the kernel serves, so both packages route the
same ones: a 3x3 kernel and a fold factor 128 // cout of at least 2.

Tensors are (B, C, H, W), the heads' layout here, in fp32 (products in
full fp32, no TF32) or bf16 (tensor cores), contiguous or channels_last:
the kernel reads x by its strides and writes the output in x's memory
format, so no relayout pass runs outside it. On CPU tensors the wrapper
computes `conv3x3_plain`; on CUDA tensors it launches the kernel, built by
nvcc at first use, or raises; it never falls back. `conv3x3_folded.launches`
counts the launches.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch
import torch.nn.functional as F

from omnivggt_tpu_torch.ops.kernels import build

SOURCE = "conv3x3.cu"
MAX_COUT = 64
_BUILD_LOCK = threading.Lock()


def _fold_factor(cout: int) -> int:
    return max(1, min(4, 128 // cout))


def conv3x3_eligible(x_shape, w_shape) -> bool:
    """Whether `conv3x3_folded` serves this convolution: x (..., C, H, W),
    w (cout, cin, kh, kw). The JAX package's rule without its VMEM slab
    budget: a 3x3 kernel whose output is narrow enough to fold
    (128 // cout >= 2, i.e. cout <= 64)."""
    cout, _, kh, kw = w_shape
    return kh == 3 and kw == 3 and _fold_factor(cout) >= 2


def conv3x3_plain(p, x: torch.Tensor, relu: bool = False) -> torch.Tensor:
    """Plain PyTorch version: F.conv2d with the module's weight and bias in
    x's dtype, padding 1, then the ReLU."""
    bias = None if p.bias is None else p.bias.to(x.dtype)
    y = F.conv2d(x, p.weight.to(x.dtype), bias, padding=1)
    return F.relu(y) if relu else y


@functools.lru_cache(maxsize=None)
def _library_locked():
    lib, log = build.load(SOURCE)
    fn = lib.omnivggt_conv3x3
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [
        i32, ptr, ptr, ptr, ptr,        # is_bf16, x, w, bias, out
        i32, i32, i32, i32, i32,        # B, cin, cout, H, W
        ctypes.POINTER(ctypes.c_longlong),  # 8 strides
        i32, i32, ptr,                  # relu, drop_halo_column, stream
    ]
    fn.restype = ctypes.c_int
    return fn, log


def _library():
    with _BUILD_LOCK:
        return _library_locked()


def load_kernels() -> str:
    """Build and load the kernel now; returns the compiler log."""
    return _library()[1]


def conv3x3_folded(p, x: torch.Tensor, relu: bool = False):
    """3x3 stride-1 pad-1 convolution of (B, cin, H, W) x with the
    nn.Conv2d-like module p (weight (cout, cin, 3, 3), optional bias),
    + bias, + ReLU when `relu`; fp32 accumulation, output in x's dtype and
    memory format. Requires `conv3x3_eligible`."""
    if x.dim() != 4 or not conv3x3_eligible(x.shape, p.weight.shape):
        raise ValueError(
            f"conv3x3_folded ineligible: x {tuple(x.shape)}, w {tuple(p.weight.shape)}"
        )
    if p.weight.shape[1] != x.shape[1]:
        raise ValueError(f"x has {x.shape[1]} channels, the weight takes {p.weight.shape[1]}")
    if x.device.type == "cpu":
        return conv3x3_plain(p, x, relu)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_folded takes CPU or CUDA tensors, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the Hopper conv kernel takes float32 or bfloat16, got {x.dtype}")
    if torch.is_grad_enabled() and (x.requires_grad or p.weight.requires_grad):
        raise ValueError("conv3x3_folded is a forward-only kernel (no gradient)")
    return _launch(p, x, relu)


def _launch(p, x, relu, drop_halo_column=False):
    """One kernel launch on a validated CUDA x, counted on
    `conv3x3_folded`. `drop_halo_column` plants a fault (the left halo
    column read as zeros) for the kernel's own checks."""
    B, cin, H, W = x.shape
    cout = p.weight.shape[0]
    channels_last = x.stride(1) == 1 and cin > 1
    if not (channels_last or x.is_contiguous()):
        x = x.contiguous()
    w = p.weight.detach().to(device=x.device, dtype=x.dtype).contiguous()
    if p.bias is None:
        bias = torch.zeros(cout, dtype=torch.float32, device=x.device)
    else:
        bias = p.bias.detach().to(device=x.device, dtype=torch.float32).contiguous()
    out = torch.empty(
        (B, cout, H, W), dtype=x.dtype, device=x.device,
        memory_format=torch.channels_last if channels_last else torch.contiguous_format,
    )
    strides = (ctypes.c_longlong * 8)(*x.stride(), *out.stride())
    fn = _library()[0]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(
            int(x.dtype == torch.bfloat16), x.data_ptr(), w.data_ptr(), bias.data_ptr(),
            out.data_ptr(), B, cin, cout, H, W, strides, int(bool(relu)),
            int(bool(drop_halo_column)), stream,
        )
    if err != 0:
        raise RuntimeError(f"conv3x3 kernel launch failed: cudaError {err}")
    conv3x3_folded.launches += 1
    return out


conv3x3_folded.launches = 0
