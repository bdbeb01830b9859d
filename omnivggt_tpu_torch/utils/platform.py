"""The numeric mode every entry point of the port runs in (counterpart of
omnivggt_tpu/utils/platform.py).

PyTorch's defaults let cuDNN run fp32 convolutions in TF32
(`torch.backends.cudnn.allow_tf32 = True`), which keeps 10 of fp32's 23
mantissa bits. The port's fp32 heads are the JAX package's
reference-parity heads and keep full fp32, so:

  - `ensure_platform(device)` resolves the device (CUDA unless the CPU is
    asked for; it raises without CUDA) and turns both TF32 switches off,
    for the process. Every command-line entry point and `serving.serve`
    calls it first;
  - `exact_fp32()` turns them off for a block and restores the caller's
    values after it. `models.omnivggt.apply` runs the whole forward under
    it, so a library caller's global switches do not change the answer.
    The switches are process-wide: two threads that enter the block with
    TF32 on globally may restore each other's values early.

The JAX package's `enable_compilation_cache` (XLA's persistent compile
cache) has no counterpart: the port has no JIT, and its kernels are built
once into the ignored `_build/` directory (ops/kernels/build.py).
"""

from __future__ import annotations

import contextlib

import torch

from omnivggt_tpu_torch.utils.device import resolve_device


def set_tf32(enabled: bool) -> None:
    """Both TF32 switches: cuBLAS fp32 matmuls and cuDNN fp32 convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled


def tf32_switches() -> tuple:
    """(matmul, cudnn) TF32 switches as they stand."""
    return torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32


def ensure_platform(device=None) -> torch.device:
    """The resolved device (utils.device.resolve_device: raises when CUDA
    is asked for and missing), with TF32 off for the process."""
    dev = resolve_device(device)
    set_tf32(False)
    return dev


@contextlib.contextmanager
def exact_fp32():
    """fp32 matmuls and convolutions in full fp32 inside the block, whatever
    the global switches; the caller's switches are restored after it."""
    matmul, cudnn = tf32_switches()
    set_tf32(False)
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn
