"""fp32 stride-1 convolutions (3x3 pad 1, and 1x1) on Hopper's tensor cores
at fp32 accuracy, and their plain version.

Replaces no TPU kernel: the JAX package leaves the DPT heads' fp32
convolutions to XLA. On the card `conv2d_tf32x3` takes them from cuDNN's
fp32 FFMA convolutions (models/dpt_head.py routes each convolution that
`eligible` accepts), by csrc/conv_tf32x3.cu: an implicit GEMM over
channels-last x, 128 output pixels x N output channels a tile, K = taps x
cin in 32-channel slices, staged by TMA (im2col for x) and multiplied by
`wgmma` in TF32 three times a multiply.

Precision (3xTF32). Each operand is split into a high and a low TF32 part
(10 stored mantissa bits each) and the product taken as hi*hi + hi*lo +
lo*hi: the weights here, hi = rna(w) and lo = rna(w - hi), once per call
into a transient packed copy (`split_weights_plain` is the kernel's packing
in torch ops); the activations in the kernel's registers, hi = x with its
low 13 bits cleared and lo = rna(x - hi). What is lost is lo*lo and lo's
own rounding, ~2^-21 of each product, unbiased; the tensor core's
accumulation is added to an fp32 sum by ordinary additions after every 32
channels of a tap. One-pass TF32 (hi*hi alone, what cuDNN runs with TF32
on, and what `utils/platform.exact_fp32` keeps off) keeps ~2^-11 of each
product. The card tests (tests/test_torch_conv_tf32x3_cuda.py) hold the
kernel at every head shape to the repo's fp32 convolution tolerance
2 (taps cin + 1) 2^-24 conv(|x|, |w|) and to at most twice cuDNN fp32's
median relative error on the same inputs; one-pass TF32 and a dropped
correction product fail the second, a lost halo column and a wrong bias or
ReLU the first. Readings on the H100 (PERF.md §6): err/tol at most 7.2e-3;
median relative error 2.9e-7 to 3.7e-7, 0.31 to 1.44 times cuDNN's; one-pass
TF32 4.2e-4 and the lo*hi product dropped 3.7e-4 (~700 times cuDNN's).

x is (B, cin, H, W) fp32 and must be TMA-mappable (channels innermost,
every other stride a multiple of 16 bytes, a 16-byte aligned base; the
heads' tensors are); any other x is copied once into such a buffer,
counted on `conv2d_tf32x3.relayouts`. The output is channels_last when x's
channels are innermost, else NCHW, as F.conv2d's. On CPU tensors the
wrapper computes `conv2d_tf32x3_plain`; on CUDA tensors it launches the
kernel, built by nvcc at first use, or raises; it never falls back.
`conv2d_tf32x3.launches` counts the launches.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch
import torch.nn.functional as F
from torch.nn.modules.utils import _pair

from omnivggt_tpu_torch.ops.kernels import build
from omnivggt_tpu_torch.ops.kernels.conv3x3 import _mappable_copy, tma_mappable

SOURCE = "conv_tf32x3.cu"
SMEM_LIMIT = 232448  # dynamic shared memory a block of the H100 can have
MAX_STAGES = 8
TILE_M = 128  # output pixels a tile
THREADS = 384  # two consumer warpgroups and a producer warpgroup
# test hooks of the kernel that plant faults (`_launch(fault=...)`), built
# into forms of their own at the N tiles FAULT_N alone; the forms real calls
# launch carry none of them
FAULTS = {"one_pass_tf32": 1, "lo_hi_dropped": 2, "halo_column": 3, "bias_dropped": 4,
          "relu_dropped": 5}
FAULT_N = (32, 128)
_BUILD_LOCK = threading.Lock()


def takes(w_shape, stride=1, padding=0, groups=1) -> bool:
    """The shape rule: a 3x3 pad-1 or 1x1 pad-0 stride-1 convolution,
    groups 1, cout a multiple of 16."""
    cout, _, kh, kw = w_shape
    if groups != 1 or _pair(stride) != (1, 1) or kh != kw:
        return False
    return (kh, _pair(padding)) in ((3, (1, 1)), (1, (0, 0))) and cout % 16 == 0


def eligible(p, x: torch.Tensor, stride=1, padding=0) -> bool:
    """Whether `conv2d_tf32x3` takes this convolution of x by the
    nn.Conv2d-like p (weight (cout, cin, k, k), optional bias): x a CUDA
    fp32 tensor that autograd does not record, and `takes`."""
    if x.device.type != "cuda" or x.dtype != torch.float32 or x.dim() != 4:
        return False
    params = [x, p.weight] + ([] if p.bias is None else [p.bias])
    if torch.is_grad_enabled() and any(t.requires_grad for t in params):
        return False
    groups = getattr(p, "groups", 1)
    return x.shape[1] == p.weight.shape[1] and takes(p.weight.shape, stride, padding, groups)


def conv2d_tf32x3_plain(p, x: torch.Tensor, padding=0, relu: bool = False) -> torch.Tensor:
    """Plain PyTorch version: F.conv2d with the module's weight and bias,
    then the ReLU."""
    y = F.conv2d(x, p.weight.to(x.dtype), None if p.bias is None else p.bias.to(x.dtype),
                 padding=padding)
    return F.relu(y) if relu else y


def _rna_tf32(t: torch.Tensor) -> torch.Tensor:
    """fp32 to the nearest TF32 value, ties away from zero (cvt.rna.tf32):
    on the bits, add half of the 13 dropped bits' unit to the magnitude and
    clear them."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


# K position 8 kk + j of a 32-channel slice holds channel 8 (j % 4) + 4 (j // 4) + kk
SLICE_ORDER = [8 * (j % 4) + 4 * (j // 4) + kk for kk in range(4) for j in range(8)]


def split_weights_plain(w: torch.Tensor) -> torch.Tensor:
    """The kernel's split and packing of w (cout, cin, k, k) in torch ops:
    (2, cout, k k, cin rounded up to 32) fp32, [0] = rna(w), [1] = rna(w -
    [0]), zero past cin, each 32-channel slice in the kernel's K order
    (SLICE_ORDER). Bitwise the card's split (tested there)."""
    cout, cin, kh, kw = w.shape
    cin32 = -(-cin // 32) * 32
    wp = F.pad(w.float().permute(0, 2, 3, 1), (0, cin32 - cin))  # (cout, kh, kw, cin32)
    order = torch.tensor(SLICE_ORDER, device=w.device)
    wp = wp.reshape(cout, kh * kw, cin32 // 32, 32)[..., order].reshape(cout, kh * kw, cin32)
    hi = _rna_tf32(wp)
    return torch.stack([hi, _rna_tf32(wp - hi)])


@functools.lru_cache(maxsize=None)
def _library_locked():
    lib, log = build.load(SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    strides = ctypes.POINTER(ctypes.c_longlong)
    conv = lib.omnivggt_conv_tf32x3
    conv.argtypes = [
        ptr, strides, ptr, ptr,       # x, x strides, split weights, bias (or null)
        ptr, strides,                 # out, out strides
        i32, i32, i32, i32, i32,      # B, cin, cout, H, W
        i32, i32, i32, ptr,           # k, relu, fault, stream
    ]
    conv.restype = ctypes.c_int
    split = lib.omnivggt_conv_tf32x3_split
    split.argtypes = [ptr, ptr, i32, i32, i32, ptr]  # w, out, cout, cin, taps, stream
    split.restype = ctypes.c_int
    return conv, split, log


def _library():
    with _BUILD_LOCK:
        return _library_locked()


def load_kernels() -> str:
    """Build and load the kernel now; returns the compiler log."""
    return _library()[2]


def _geometry(cout: int) -> dict:
    """csrc/conv_tf32x3.cu's `geometry`: the N tile (128, or cout rounded up
    to 16, 32 or 64), the stages of the ring (a stage: the 128 x 32 fp32
    pixel tile and the hi and lo N x 32 weight tiles; as many as fit, at
    most 8) and the dynamic shared memory (1,024 bytes of alignment and 16
    of barriers a stage)."""
    n = 16
    while n < cout and n < 128:
        n *= 2
    stage = TILE_M * 128 + 2 * n * 128
    stages = min(MAX_STAGES, (SMEM_LIMIT - 1024 - 16 * MAX_STAGES) // stage)
    return {"threads": THREADS, "n": n, "stages": stages, "smem": 1024 + stages * (stage + 16)}


def launch_shape(cout: int) -> tuple:
    """(threads a block, dynamic shared-memory bytes a block) of the kernel
    for cout output channels (cin does not change them)."""
    geo = _geometry(cout)
    return geo["threads"], geo["smem"]


def built_launch_shape(cout: int) -> tuple:
    """`launch_shape` as the built library reports it (needs the card's
    toolkit): (threads, shared-memory bytes)."""
    lib, _ = build.load(SOURCE)
    fn = lib.omnivggt_conv_tf32x3_launch_shape
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = None
    got = (ctypes.c_int * 4)()
    fn(cout, got)
    return got[0], got[1]


def split_weights(w: torch.Tensor) -> torch.Tensor:
    """`split_weights_plain` by one launch on the card (w a CUDA tensor)."""
    cout, cin, kh, kw = w.shape
    w = w.detach().to(torch.float32).contiguous()
    out = torch.empty((2, cout, kh * kw, -(-cin // 32) * 32), dtype=torch.float32, device=w.device)
    with torch.cuda.device(w.device):
        err = _library()[1](w.data_ptr(), out.data_ptr(), cout, cin, kh * kw,
                            torch.cuda.current_stream(w.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv_tf32x3 weight split launch failed: cudaError {err}")
    return out


def conv2d_tf32x3(p, x: torch.Tensor, padding=0, relu: bool = False) -> torch.Tensor:
    """Stride-1 convolution of (B, cin, H, W) fp32 x by the nn.Conv2d-like
    p (weight (cout, cin, 3, 3) with padding 1, or (cout, cin, 1, 1) with
    padding 0; optional bias), + bias, + ReLU when `relu`. Requires
    `takes`; on the card, a forward only."""
    if x.dim() != 4 or not takes(p.weight.shape, 1, padding, getattr(p, "groups", 1)):
        raise ValueError(f"conv2d_tf32x3 does not take x {tuple(x.shape)}, w "
                         f"{tuple(p.weight.shape)}, padding {padding}")
    if p.weight.shape[1] != x.shape[1]:
        raise ValueError(f"x has {x.shape[1]} channels, the weight takes {p.weight.shape[1]}")
    if x.device.type == "cpu":
        return conv2d_tf32x3_plain(p, x, padding, relu)
    if not eligible(p, x, 1, padding):
        raise ValueError("conv2d_tf32x3 takes CPU tensors, or CUDA fp32 tensors that autograd "
                         f"does not record (a forward-only kernel); got {x.device} {x.dtype}")
    return _launch(p, x, relu)


def _launch(p, x, relu, fault=0):
    """One kernel launch (and the weight split's) on a validated CUDA x,
    counted on `conv2d_tf32x3`; an x that TMA cannot map is copied first,
    counted on `conv2d_tf32x3.relayouts`. `fault` (FAULTS) plants a fault
    for the kernel's own checks, where the N tile is one of FAULT_N."""
    B, cin, H, W = x.shape
    cout, _, k, _ = p.weight.shape
    if fault and _geometry(cout)["n"] not in FAULT_N:
        raise ValueError(f"the planted faults are built at N tiles {FAULT_N}, not for cout {cout}")
    channels_last = x.stride(1) == 1 and cin > 1
    if not tma_mappable(x):
        x = _mappable_copy(x)
        conv2d_tf32x3.relayouts += 1
    split = split_weights(p.weight)
    if fault == FAULTS["one_pass_tf32"]:
        split[1].zero_()  # the kernel drops the activations' low parts
    bias = None if p.bias is None else p.bias.detach().to(torch.float32).contiguous()
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    out = torch.empty((B, cout, H, W), dtype=torch.float32, device=x.device, memory_format=fmt)
    x_strides = (ctypes.c_longlong * 4)(*x.stride())
    o_strides = (ctypes.c_longlong * 4)(*out.stride())
    with torch.cuda.device(x.device):
        err = _library()[0](
            x.data_ptr(), x_strides, split.data_ptr(), None if bias is None else bias.data_ptr(),
            out.data_ptr(), o_strides, B, cin, cout, H, W, k, int(bool(relu)), int(fault),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"conv_tf32x3 kernel launch failed: cudaError {err}")
    conv2d_tf32x3.launches += 1
    return out


conv2d_tf32x3.launches = 0
conv2d_tf32x3.relayouts = 0
