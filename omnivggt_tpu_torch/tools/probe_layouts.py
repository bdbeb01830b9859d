"""Layout probes for the 3x3 convolution kernel, on the card only.

    python -m omnivggt_tpu_torch.tools.probe_layouts

Counterpart of tools/probe_mosaic_layouts.py. Each of the ten probes is one
data-movement or matrix-product primitive on a small (rows, columns, 64)
bf16 tile, run as a tiny CUDA kernel (csrc/layout_probes.cu) on the
primitives the convolution kernel (csrc/conv3x3.cu) uses, held against the
torch expression of the same array function, and printed as PASS or FAIL
with its time.

On the TPU the question each probe answered was "does Mosaic lower it":
interpret mode accepted everything, and on the chip most shifted, rolled
and strided forms were refused, which decided the TPU kernel's shape. On
Hopper the tile enters shared memory as one TMA box under the 128-byte
swizzle, the movements read it back through the swizzled addresses, and
the matrix products run wgmma on shared-memory descriptors, so the question
is "does this addressing read the tile right". The column-offset product
starts its left operand one 128-byte pixel row into each image row, off
the swizzle's 1024-byte repeat, as the convolution's dx taps do; it runs
in the descriptor form the convolution uses (`CONV_BASE_OFFSET`), and
`descriptor_forms` reports, for starts 0..7 rows past the repeat, which
forms of the descriptor's base-offset field read right. A FAIL here means
the convolution kernel's tile addressing cannot be trusted. Exit code 1 on
any FAIL or without a CUDA device.
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
# the descriptor form of csrc/conv3x3.cu's shifted A operands: 0 leaves
# the matrix base-offset field at 0, 1 sets it to (start >> 7) & 7
CONV_BASE_OFFSET = 0
_MAPS: dict = {}


@functools.lru_cache(maxsize=None)
def _library():
    lib, log = build.load(SOURCE)
    fn = lib.omnivggt_layout_probe
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [i32, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32, ptr]
    fn.restype = ctypes.c_int
    lib.omnivggt_probe_encode.argtypes = [ptr, i32, i32, ptr]
    lib.omnivggt_probe_encode.restype = ctypes.c_int
    return fn, lib.omnivggt_probe_encode, log


def _map(t, rows, cols):
    """The TMA map of the contiguous (rows, cols, 64) bf16 tensor t, encoded
    once per tensor and shape."""
    key = (t.data_ptr(), rows, cols)
    if key not in _MAPS:
        buf = ctypes.create_string_buffer(128)
        if not _library()[1](t.data_ptr(), rows, cols, buf):
            raise RuntimeError(f"no TMA map for a ({rows}, {cols}, {C}) tile")
        _MAPS[key] = buf
    return _MAPS[key]


def _launch(probe, x, out_shape, wt=None, off=0, base_offset=CONV_BASE_OFFSET):
    """One probe kernel on the contiguous x (rows, cols, 64) -> out_shape
    (A, B, CO); the matmul probe (9) takes wt = w^T, (128, 64) contiguous."""
    out = torch.empty(out_shape, dtype=torch.bfloat16, device=x.device)
    A, B, CO = out_shape
    rows, cols = x.shape[0], x.shape[1]
    w_map = None if wt is None else _map(wt, 128, 1)
    err = _library()[0](
        probe, _map(x, rows, cols), w_map, out.data_ptr(), rows, cols, A, B, CO, off,
        base_offset, torch.cuda.current_stream(x.device).cuda_stream,
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
    wt = w.t().contiguous()  # the K-major right operand the kernel stages
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
        ("channel concat of column-offset slices (a shift along W, swizzled 16-byte loads)",
         lambda: _launch(4, x, (R, W2 - 1, 2 * C)),
         lambda: torch.cat([x[:, 0 : W2 - 1], x[:, 1:W2]], dim=-1), True),
        ("matmul with a column-offset left operand",
         lambda: _launch(9, x, (R * (W2 - 1), 1, 128), wt, off=1).reshape(-1, 128),
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
         lambda: _launch(9, x2.reshape(1, 64, C), (64, 1, 128), wt).reshape(64, 128),
         lambda: _matmul_ref(x2, w), False),
    ]


def descriptor_forms(device, seed: int = 1) -> dict:
    """{base_offset: [starts that read right]}: the column-offset product on
    a (2, 72, 64) tile with its left operand starting k = 0..7 pixel rows
    into each image row (k 128-byte rows past the swizzle's 1024-byte
    repeat), with the descriptor's base-offset field left at 0 and set to
    (start >> 7) & 7, each held against the torch product."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    x = torch.randn((2, 72, C), generator=gen, device=device).to(torch.bfloat16)
    w = torch.randn((C, 128), generator=gen, device=device).to(torch.bfloat16)
    wt = w.t().contiguous()
    forms = {}
    for base_offset in (0, 1):
        forms[base_offset] = []
        for k in range(8):
            got = _launch(9, x, (2 * (72 - k), 1, 128), wt, off=k, base_offset=base_offset)
            want = _matmul_ref(x[:, k:].reshape(-1, C), w)
            tol = 2.0**-7 * want.float().abs().max().item()
            if (got.reshape(-1, 128).float() - want.float()).abs().max().item() <= tol:
                forms[base_offset].append(k)
    return forms


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
    out(f"layout probes (bf16, tile ({R}, {W2}, {C}) as one TMA box under the 128-byte swizzle, "
        f"matrix products by wgmma; shifted descriptors with base-offset field "
        f"{'(start >> 7) & 7' if CONV_BASE_OFFSET else '0'}, as csrc/conv3x3.cu):")
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
    forms = descriptor_forms(device)
    out(f"  descriptor starts k = 0..7 pixel rows past the swizzle's 1024-byte repeat that read "
        f"right: base-offset field 0 at k = {forms[0]}, field (start >> 7) & 7 at k = {forms[1]}")
    ok &= forms[CONV_BASE_OFFSET] == list(range(8))
    if stats is not None:
        stats.update(max_abs_err=worst, ms=ms, plain_ms=plain_ms, bytes=nbytes, forms=forms)
    return ok


if __name__ == "__main__":
    sys.exit(0 if run() else 1)
