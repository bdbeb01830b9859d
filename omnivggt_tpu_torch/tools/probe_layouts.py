"""Layout probes for the 3x3 convolution kernel, on the card only.

    python -m omnivggt_tpu_torch.tools.probe_layouts

Counterpart of tools/probe_mosaic_layouts.py. Each of the ten probes is one
data-movement or matrix-product primitive on a small (rows, columns, 64)
bf16 tile, run as a tiny CUDA kernel (csrc/layout_probes.cu) that goes
through shared memory, held against the torch expression of the same array
function, and printed as PASS or FAIL with its time.

On the TPU the question each probe answered was "does Mosaic lower it":
interpret mode accepted everything, and on the chip most shifted, rolled
and strided forms were refused, which decided the TPU kernel's shape. On
Hopper all ten are address arithmetic and compile, so the question is "is
it right, and does the vector load stay legal": the kernels' shared rows
carry a pad, a slice shifted by one column then starts on an 8-byte
boundary, and a 16-byte load there would fault. A FAIL here means the
convolution kernel's tile addressing cannot be trusted. Exit code 1 on any
FAIL or without a CUDA device.
"""

from __future__ import annotations

import ctypes
import functools
import statistics
import sys

import torch

from omnivggt_tpu_torch.ops.kernels import build

SOURCE = "layout_probes.cu"
R, W2, C = 18, 24, 64  # tile rows, columns, channels (as the TPU probes)


@functools.lru_cache(maxsize=None)
def _library():
    lib, log = build.load(SOURCE)
    fn = lib.omnivggt_layout_probe
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [i32, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, ptr]
    fn.restype = ctypes.c_int
    return fn, log


def _launch(probe, x, out_shape, w=None, off=0):
    """One probe kernel on x (rows, cols, 64) -> out_shape (A, B, CO)."""
    x = x.contiguous()
    out = torch.empty(out_shape, dtype=torch.bfloat16, device=x.device)
    A, B, CO = out_shape
    fn = _library()[0]
    with torch.cuda.device(x.device):
        err = fn(
            probe, x.data_ptr(), None if w is None else w.contiguous().data_ptr(),
            out.data_ptr(), x.shape[0], x.shape[1], A, B, CO, off,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"layout probe {probe} launch failed: cudaError {err}")
    _launch.launches += 1
    return out


_launch.launches = 0


def _matmul_ref(a, w):
    return (a.float() @ w.float()).to(torch.bfloat16)


def probes(device, seed: int = 0):
    """[(name, kernel thunk, torch reference thunk, exact)] for the ten
    probes; the matrix products compare within bf16 rounding of the output,
    the movements exactly."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)

    x, x_al, x_un = rand(R, W2, C), rand(16, 32, C), rand(16, 27, C)
    x2, w = rand(64, C), rand(C, 128)
    xr = x.reshape(R // 2, 2, W2, C)
    return [
        ("reshape major split (2rb+2,w2,c)->(rb+1,2,w2,c), halves added",
         lambda: _launch(0, x, (R // 2, W2, C)), lambda: xr[:, 0] + xr[:, 1], True),
        ("reshape major merge (rb,32,c)->(rb*32,c) [16-aligned columns]",
         lambda: _launch(1, x_al, (16 * 32, 1, C)).reshape(16 * 32, C),
         lambda: x_al.reshape(16 * 32, C), True),
        ("reshape major merge (rb,27,c)->(rb*27,c) [unaligned columns]",
         lambda: _launch(2, x_un, (16 * 27, 1, C)).reshape(16 * 27, C),
         lambda: x_un.reshape(16 * 27, C), True),
        ("channel concat of major-shifted slices (a shift along H)",
         lambda: _launch(3, x, (R // 2 - 1, W2, 2 * C)),
         lambda: torch.cat([xr[0 : R // 2 - 1, 0], xr[1 : R // 2, 0]], dim=-1), True),
        ("channel concat of column-offset slices (a shift along W, 8-byte aligned loads)",
         lambda: _launch(4, x, (R, W2 - 1, 2 * C)),
         lambda: torch.cat([x[:, 0 : W2 - 1], x[:, 1:W2]], dim=-1), True),
        ("matmul with a column-offset left operand",
         lambda: _launch(9, x, (R * (W2 - 1), 1, 128), w, off=1).reshape(-1, 128),
         lambda: _matmul_ref(x[:, 1:W2].reshape(-1, C), w), False),
        ("roll by one along the column axis",
         lambda: _launch(5, x, (R, W2, C)), lambda: torch.roll(x, 1, 1), True),
        ("strided major slice x[0::2]",
         lambda: _launch(6, x, (R // 2, W2, C)), lambda: x[0::2], True),
        ("strided column slice x[:,0::2]",
         lambda: _launch(7, x, (R, W2 // 2, C)), lambda: x[:, 0::2], True),
        ("channel concat of column-interleaved slices",
         lambda: _launch(8, x, (R, W2 // 2, 2 * C)),
         lambda: torch.cat([x[:, 0::2], x[:, 1::2]], dim=-1), True),
        ("sanity 2D matmul (64,64)@(64,128)",
         lambda: _launch(9, x2.reshape(64, 1, C), (64, 1, 128), w).reshape(64, 128),
         lambda: _matmul_ref(x2, w), False),
    ]


def _time_ms(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def run(device="cuda", out=print, stats=None) -> bool:
    """Run every probe; prints one line each; True when all pass. stats: an
    optional dict that receives max_abs_err, ms and plain_ms (the probes'
    and their torch expressions' median times, summed) and bytes (moved,
    inputs read and outputs written once)."""
    if not torch.cuda.is_available():
        raise RuntimeError("the layout probes run on a CUDA device only")
    device = torch.device(device)
    _library()
    ok, worst, ms, plain_ms, nbytes = True, 0.0, 0.0, 0.0, 0
    out(f"layout probes (bf16, tile ({R}, {W2}, {C}), shared rows padded by 8 bytes):")
    for name, kernel, ref, exact in probes(device):
        got, want = kernel(), ref()
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        # the product rounds its fp32 sum to bf16 once on either side
        tol = 0.0 if exact else 2.0**-7 * want.float().abs().max().item()
        passed = got.shape == want.shape and err <= tol
        ok &= passed
        t_kernel, t_plain = _time_ms(kernel), _time_ms(ref)
        worst, ms, plain_ms = max(worst, err), ms + t_kernel, plain_ms + t_plain
        nbytes += 2 * (R * W2 * C + want.numel())  # about: the tile in, the result out
        out(f"  {'PASS' if passed else 'FAIL'} {name}: max_abs_err {err:.3e} "
            f"(tol {tol:.3e}), {t_kernel:.4f} ms (torch expression {t_plain:.4f} ms)")
    if stats is not None:
        stats.update(max_abs_err=worst, ms=ms, plain_ms=plain_ms, bytes=nbytes)
    return ok


if __name__ == "__main__":
    sys.exit(0 if run() else 1)
