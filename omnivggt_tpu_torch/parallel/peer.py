"""Symmetric device buffers over the processes of a mesh's seq axis, mapped
into each other through CUDA IPC (csrc/peer.cu).

A `PeerMemory` belongs to one process of a seq group on a CUDA device. Its
`buffer(tag, shape, dtype)` is one allocation of the same size in every
process of the group, made with the library's own cudaMalloc (a pointer
of PyTorch's caching allocator lies inside a larger block, and an IPC
handle names a whole allocation). The handles are exchanged once with
`all_gather_object` over the seq group and opened with
cudaIpcMemLazyEnablePeerAccess, so the buffer of a process on the same
card or on another one reads and writes alike; a process does not open
its own. A refused open raises with CUDA's message: nothing is staged
through host memory instead.

Buffers are cached per (tag, shape, dtype) for the life of the
PeerMemory, since one open costs milliseconds; every process of the group
must ask for the same buffers in the same order (the exchange is a
collective). `close()` tears them down: every peer closes its mappings, a
barrier, then each owner frees its own.

`barrier()` is the step boundary between processes: this process's
current stream synchronised, then a gloo barrier over the seq group. What
one process wrote into its buffer before the barrier is there for every
peer after it.

Nothing here builds or loads the library at import time.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import Dict, List, Sequence

import torch

from omnivggt_tpu_torch.ops.kernels import build

SOURCE = "peer.cu"
_BUILD_LOCK = threading.Lock()


def _library():
    with _BUILD_LOCK:
        return _library_locked()


@functools.lru_cache(maxsize=None)
def _library_locked():
    lib, _ = build.load(SOURCE)
    i32, ptr = ctypes.c_int, ctypes.c_void_p
    lib.omnivggt_peer_handle_bytes.argtypes, lib.omnivggt_peer_handle_bytes.restype = [], i32
    lib.omnivggt_peer_error.argtypes, lib.omnivggt_peer_error.restype = [i32], ctypes.c_char_p
    signatures = {
        "omnivggt_peer_malloc": [i32, ctypes.c_ulonglong, ctypes.POINTER(ptr)],
        "omnivggt_peer_free": [i32, ptr],
        "omnivggt_peer_handle": [i32, ptr, ptr],
        "omnivggt_peer_open": [i32, ptr, ctypes.POINTER(ptr)],
        "omnivggt_peer_close": [i32, ptr],
    }
    for name, args in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, i32
    return lib


def load_library():
    """Build and load csrc/peer.cu now (it otherwise builds at first use)."""
    return _library()


def _check(err: int, what: str) -> None:
    if err:
        msg = _library().omnivggt_peer_error(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")


class _Bytes:
    """A device allocation as a flat byte array for torch.as_tensor."""

    def __init__(self, ptr: int, nbytes: int):
        self.__cuda_array_interface__ = {
            "shape": (nbytes,), "typestr": "|u1", "data": (ptr, False), "version": 2,
            "strides": None,
        }


def view(ptr: int, shape: Sequence[int], dtype: torch.dtype, device) -> torch.Tensor:
    """A tensor over `ptr` (owned elsewhere: this process's allocation or a
    peer's mapped one), contiguous, of `shape` and `dtype`."""
    nbytes = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
    flat = torch.as_tensor(_Bytes(ptr, nbytes), device=device)
    return flat.view(dtype).view(tuple(shape))


class SymmetricBuffer:
    """One allocation a process of the group: `ptrs[r]` is rank r's, mapped
    into this process (this process's own at its rank)."""

    def __init__(self, ptrs: List[int], shape, dtype, device, rank: int):
        self.ptrs, self.shape, self.dtype, self.device = ptrs, tuple(shape), dtype, device
        self.rank = rank

    def view(self, r: int) -> torch.Tensor:
        """Rank r's buffer as a tensor in this process."""
        return view(self.ptrs[r], self.shape, self.dtype, self.device)

    @property
    def own(self) -> torch.Tensor:
        return self.view(self.rank)


class PeerMemory:
    """The symmetric buffers of one process of a seq group on `device`
    (rank `rank` of `size`); `group` is the seq group (gloo)."""

    def __init__(self, group, rank: int, size: int, device):
        self.group, self.rank, self.size = group, rank, size
        self.device = torch.device(device)
        self._buffers: Dict[tuple, SymmetricBuffer] = {}
        self.opens = 0  # handles opened so far (a cache miss opens size - 1)

    def barrier(self) -> None:
        """This process's stream drained, then every process of the group
        here: what each wrote before is visible to all after."""
        import torch.distributed as dist

        torch.cuda.current_stream(self.device).synchronize()
        dist.barrier(group=self.group)

    def buffer(self, tag: str, shape, dtype: torch.dtype) -> SymmetricBuffer:
        """The cached symmetric buffer of (tag, shape, dtype); made on first
        use, a collective over the group."""
        key = (tag, tuple(shape), dtype)
        if key not in self._buffers:
            self._buffers[key] = self._allocate(shape, dtype)
        return self._buffers[key]

    def _allocate(self, shape, dtype) -> SymmetricBuffer:
        import torch.distributed as dist

        lib = _library()
        dev = self.device.index if self.device.index is not None else torch.cuda.current_device()
        nbytes = max(math.prod(shape) * torch.empty((), dtype=dtype).element_size(), 1)
        own = ctypes.c_void_p()
        _check(lib.omnivggt_peer_malloc(dev, nbytes, ctypes.byref(own)), "cudaMalloc")
        handle = ctypes.create_string_buffer(lib.omnivggt_peer_handle_bytes())
        _check(lib.omnivggt_peer_handle(dev, own, handle), "cudaIpcGetMemHandle")
        handles: List[bytes] = [b""] * self.size
        dist.all_gather_object(handles, handle.raw, group=self.group)
        ptrs = []
        for r, h in enumerate(handles):
            if r == self.rank:
                ptrs.append(own.value)
                continue
            mapped = ctypes.c_void_p()
            _check(lib.omnivggt_peer_open(dev, h, ctypes.byref(mapped)),
                   f"cudaIpcOpenMemHandle of seq rank {r}'s buffer in seq rank {self.rank}")
            ptrs.append(mapped.value)
            self.opens += 1
        return SymmetricBuffer(ptrs, shape, dtype, self.device, self.rank)

    def close(self) -> None:
        """Every mapping closed, a barrier, then every owner frees its own."""
        if not self._buffers:
            return
        lib = _library()
        dev = self.device.index if self.device.index is not None else torch.cuda.current_device()
        torch.cuda.synchronize(self.device)
        for buf in self._buffers.values():
            for r, p in enumerate(buf.ptrs):
                if r != self.rank:
                    _check(lib.omnivggt_peer_close(dev, ctypes.c_void_p(p)), "cudaIpcCloseMemHandle")
        self.barrier()
        for buf in self._buffers.values():
            _check(lib.omnivggt_peer_free(dev, ctypes.c_void_p(buf.ptrs[self.rank])), "cudaFree")
        self._buffers.clear()
