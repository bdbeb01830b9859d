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

Tensors are (B, C, H, W) in fp32 (products in full fp32, no TF32) or bf16
(tensor cores). The kernel stages x by TMA (csrc/conv3x3.cu), which needs
x channels_last with every stride but the channels' a multiple of 16 bytes
and a 16-byte aligned base (`tma_mappable`): the DPT heads hand it such a
tensor (models/dpt_head.py converts before the upsample that feeds it). Any
other x (NCHW, a channel count whose pixel stride is not a multiple of 16
bytes, an unaligned view) is copied once into a mappable channels_last
buffer, counted on `conv3x3_folded.relayouts`. The output is in x's memory
format. On CPU tensors the wrapper computes `conv3x3_plain`; on CUDA
tensors it launches the kernel, built by nvcc at first use, or raises; it
never falls back. `conv3x3_folded.launches` counts the launches.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch
import torch.nn.functional as F

from omnivggt_tpu_torch.ops.kernels import build

SOURCE = "conv3x3.cu"
SMEM_LIMIT = 232448  # dynamic shared memory a block of the H100 can have
MAX_STAGES = 4
TILE_W = 64  # output columns a unit of work
SLICE_BYTES = 9216  # bf16: one staged 66-pixel row of 64 channels, 1024-byte aligned
UNIT_ROWS_BF16 = 16  # bf16: output rows a unit of work
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
    strides = ctypes.POINTER(ctypes.c_longlong)
    fn.argtypes = [
        i32, ptr, strides, ptr, ptr,    # is_bf16, x, x strides, w, bias
        ptr, strides,                   # out, out strides
        i32, i32, i32, i32, i32,        # B, cin, cout, H, W
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


def conv_launch_shape(cin: int, cout: int, dtype) -> tuple:
    """(threads a block, dynamic shared-memory bytes a block) of the kernel
    for this convolution: csrc/conv3x3.cu's `geometry` worked out here, so
    the CPU checks it against the block's 227 KB and chip_smoke.py holds it
    against the built source's own count. N is cout rounded up to 16, 32
    or 64. bf16: 320 threads; the weights resident (9 x slices tiles of
    N x 128 bytes, slices of 64 channels), then two rings (one a consumer
    warpgroup) of up to 4 stages, a stage one 66-pixel input row of every
    slice (9,216 bytes a slice). fp32: 288 threads; one ring of up to 4
    stages, a stage one 16-channel slice: a (rows + 2) x 66-pixel box of 64
    bytes a pixel and the slice's 9 x 16 x N weights, rows 8 (4 at N 64).
    Raises where two stages do not fit."""
    geo = _geometry(cin, cout, dtype)
    return geo["threads"], geo["smem"]


def _geometry(cin, cout, dtype):
    """N, output rows a unit, stages, threads and shared memory (see
    conv_launch_shape); raises where two stages do not fit."""
    n = 16 if cout <= 16 else 32 if cout <= 32 else 64
    if dtype == torch.bfloat16:
        slices = -(-cin // 64)
        threads, rows, rings = 320, UNIT_ROWS_BF16, 2
        stage, weights = slices * SLICE_BYTES, 9 * slices * n * 128
        resident = weights
    else:  # 16-channel slices, each stage its box and its 9 x 16 x N weights
        threads, rows, rings = 288, 4 if n == 64 else 8, 1
        weights, resident = 9 * 16 * n * 4, 0
        stage = -(-(rows + 2) * (TILE_W + 2) * 64 // 1024) * 1024 + weights
    room = SMEM_LIMIT - 1024 - 16 * 2 * MAX_STAGES - resident
    stages = min(MAX_STAGES, max(room, 0) // (rings * stage))
    if stages < 2:
        raise ValueError(f"the conv kernel cannot hold a {cin} -> {cout} convolution in "
                         f"{dtype}: its weights leave no room for two stages")
    return {"threads": threads, "n": n, "rows": rows, "stages": stages,
            "smem": 1024 + resident + rings * stages * (stage + 16)}


def built_launch_shape(cin: int, cout: int, dtype) -> tuple:
    """`conv_launch_shape` as the built library reports it (needs the
    card's toolkit): (threads, shared-memory bytes)."""
    lib, _ = build.load(SOURCE)
    fn = lib.omnivggt_conv3x3_launch_shape
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = None
    got = (ctypes.c_int * 4)()
    fn(int(dtype == torch.bfloat16), cin, cout, got)
    return got[0], got[1]


def tma_mappable(x: torch.Tensor) -> bool:
    """Whether the kernel's TMA map can describe x (B, C, H, W) in place:
    channels innermost (stride 1), the column, row and batch strides
    multiples of 16 bytes, the base 16-byte aligned."""
    size = x.element_size()
    return (x.dim() == 4 and x.stride(1) == 1 and x.data_ptr() % 16 == 0
            and all(x.stride(d) * size % 16 == 0 for d in (0, 2, 3)))


def _mappable_copy(x: torch.Tensor) -> torch.Tensor:
    """x copied once into a channels_last buffer whose pixel stride is the
    channel count rounded up to 16 bytes (the pad is never read: TMA reads
    channels past cin as zeros)."""
    B, cin, H, W = x.shape
    align = 16 // x.element_size()
    buf = torch.empty((B, H, W, -(-cin // align) * align), dtype=x.dtype, device=x.device)
    view = buf[..., :cin]
    view.copy_(x.permute(0, 2, 3, 1))
    return view.permute(0, 3, 1, 2)


def _packed_weights(p, dtype, device, n, cin, cout):
    """The weights in the kernel's layout, zero padded: bf16 (3 dx, 3 dy,
    n, cin rounded up to 64), for each dx the three tap rows' K-major tiles
    stacked along N; fp32 (cin / 16 rounded up, 3 dy, 3 dx, 16, n), one
    block a 16-channel slice; and the bias (n) in fp32."""
    w = p.weight.detach().to(device=device, dtype=dtype)
    if dtype == torch.bfloat16:
        packed = torch.zeros((9, n, -(-cin // 64) * 64), dtype=dtype, device=device)
        packed[:, :cout, :cin] = w.permute(3, 2, 0, 1).reshape(9, cout, cin)
    else:
        slices = -(-cin // 16)
        packed = torch.zeros((9, slices * 16, n), dtype=dtype, device=device)
        packed[:, :cin, :cout] = w.permute(2, 3, 1, 0).reshape(9, cin, cout)
        packed = packed.reshape(9, slices, 16, n).transpose(0, 1).contiguous()
    bias = torch.zeros(n, dtype=torch.float32, device=device)
    if p.bias is not None:
        bias[:cout] = p.bias.detach().to(device=device, dtype=torch.float32)
    return packed, bias


def conv3x3_folded(p, x: torch.Tensor, relu: bool = False, memory_format=None):
    """3x3 stride-1 pad-1 convolution of (B, cin, H, W) x with the
    nn.Conv2d-like module p (weight (cout, cin, 3, 3), optional bias),
    + bias, + ReLU when `relu`; fp32 accumulation, output in x's dtype and
    in x's memory format, or in `memory_format` where one is named (the
    kernel stores either directly). Requires `conv3x3_eligible`."""
    if x.dim() != 4 or not conv3x3_eligible(x.shape, p.weight.shape):
        raise ValueError(
            f"conv3x3_folded ineligible: x {tuple(x.shape)}, w {tuple(p.weight.shape)}"
        )
    if p.weight.shape[1] != x.shape[1]:
        raise ValueError(f"x has {x.shape[1]} channels, the weight takes {p.weight.shape[1]}")
    if x.device.type == "cpu":
        out = conv3x3_plain(p, x, relu)
        return out if memory_format is None else out.contiguous(memory_format=memory_format)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_folded takes CPU or CUDA tensors, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the Hopper conv kernel takes float32 or bfloat16, got {x.dtype}")
    if torch.is_grad_enabled() and (x.requires_grad or p.weight.requires_grad):
        raise ValueError("conv3x3_folded is a forward-only kernel (no gradient)")
    return _launch(p, x, relu, memory_format=memory_format)


def _launch(p, x, relu, drop_halo_column=False, memory_format=None):
    """One kernel launch on a validated CUDA x, counted on
    `conv3x3_folded`; an x that TMA cannot map is copied first, counted on
    `conv3x3_folded.relayouts`. `drop_halo_column` plants a fault (the left
    halo column read as zeros) for the kernel's own checks."""
    B, cin, H, W = x.shape
    cout = p.weight.shape[0]
    geo = _geometry(cin, cout, x.dtype)
    if memory_format is None:
        channels_last = x.stride(1) == 1 and cin > 1
        memory_format = torch.channels_last if channels_last else torch.contiguous_format
    if not tma_mappable(x):
        x = _mappable_copy(x)
        conv3x3_folded.relayouts += 1
    w, bias = _packed_weights(p, x.dtype, x.device, geo["n"], cin, cout)
    out = torch.empty((B, cout, H, W), dtype=x.dtype, device=x.device, memory_format=memory_format)
    x_strides = (ctypes.c_longlong * 4)(*x.stride())
    o_strides = (ctypes.c_longlong * 4)(*out.stride())
    with torch.cuda.device(x.device):
        err = _library()[0](
            int(x.dtype == torch.bfloat16), x.data_ptr(), x_strides, w.data_ptr(),
            bias.data_ptr(), out.data_ptr(), o_strides, B, cin, cout, H, W, int(bool(relu)),
            int(bool(drop_halo_column)), torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"conv3x3 kernel launch failed: cudaError {err}")
    conv3x3_folded.launches += 1
    return out


conv3x3_folded.launches = 0
conv3x3_folded.relayouts = 0
