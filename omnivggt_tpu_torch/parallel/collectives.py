"""The collectives of multi-device training over a mesh's ranks
(parallel/mesh.py): the sums, scatters and gathers that the JAX package's
partitioner inserts for its sharding annotations.

State is sharded over all `data x seq` ranks of the mesh, rank-major: a
sharded dim splits into `mesh.size` equal chunks, and the process of data
rank r holds chunks [r * seq, (r + 1) * seq), one for each of its logical
ranks. So a process holds a contiguous slab of 1 / data of the dim.

  - logical ranks (no process group): one process computes the whole
    batch, so its gradients are already the sums over the data ranks.
    `all_reduce_sum` leaves a tensor as it is, `reduce_scatter` is a split
    into the ranks' chunks and `all_gather` a `torch.cat` of them;
  - the data axis over processes: `dist.all_reduce`, then
    `dist.reduce_scatter_tensor` of the whole tensor into this process's
    slab (split into its logical ranks' chunks), and
    `dist.all_gather_into_tensor` of the slabs (the sharded dim moved to
    the front for both, since they concatenate along dim 0).

The seq axis's collectives (`seq_all_gather`, `seq_max`, `seq_sum`) join
or reduce what each seq rank holds of a scene's frames or tokens:

  - logical seq ranks: one process holds every rank's part already, so
    each returns its input (the caller passes the whole tensor);
  - seq processes on the CPU (gloo): `dist.all_gather` over the seq group;
  - seq processes on CUDA: through the seq group's peer-mapped buffers
    (parallel/peer.py): each process writes its part into its own
    symmetric buffer, a barrier, each copies every rank's part in rank
    order, a barrier (so no part is overwritten before every peer has
    read it).
The max and the sum reduce the gathered parts in rank order, so every
process gets the same bits.

Training over the seq processes adds the collectives that carry
gradients:

  - `seq_gather`, the gather that autograd differentiates: its backward
    is `seq_reduce_scatter`, every seq rank's gradient of the whole
    summed in rank order and cut to this process's part, as the JAX
    package's `all_gather(tiled=True)` transposes to a `psum_scatter`.
    Without a gradient to carry it is `seq_all_gather`, which serving and
    the int8 pre-gathered K keep calling;
  - `seq_all_reduce_sum`, the parameter gradients summed in place over
    the seq processes in buckets of one fixed shape (so the peer memory
    holds one staging buffer, not a second copy of the gradients).

Every call counts one in `calls()` and its whole tensor's elements in
`elements()` (the input of a reduce-scatter, the output of a gather, the
reduced tensor of seq_max / seq_sum; seq_all_reduce_sum counts one a
bucket), in
the style of the kernels' `launches()`, so tests and chip_smoke.py can
assert which collective ran. `gather_shards` is the gather that FSDP
differentiates through: its backward is a reduce-scatter.
"""

from __future__ import annotations

from collections import Counter
from typing import List, Sequence

import torch

from omnivggt_tpu_torch.parallel.mesh import Mesh

NAMES = ("all_reduce", "reduce_scatter", "all_gather", "seq_all_gather", "seq_max", "seq_sum",
         "seq_gather", "seq_reduce_scatter", "seq_all_reduce")
# elements of one bucket of seq_all_reduce_sum: 256 MiB of fp32 a process,
# staged in its symmetric buffer, and as much again for the sum. A bucket
# costs two barriers (~2.5 ms each with processes time-sliced on one card)
# and three passes over its bytes (~0.25 ms at 3.35 TB/s), so the barriers
# set its time: the flagship's 1.217B gradients take 19 buckets, 38
# barriers, for 0.5 GB a process beside its ~27 GB
SEQ_BUCKET_ELEMS = 1 << 26
_calls: Counter = Counter()
_elements: Counter = Counter()


def calls() -> dict:
    """{collective: calls since the last reset}."""
    return {n: _calls[n] for n in NAMES}


def elements() -> dict:
    """{collective: elements of the whole tensors since the last reset}."""
    return {n: _elements[n] for n in NAMES}


def reset_calls() -> None:
    _calls.clear()
    _elements.clear()


def _count(name: str, numel: int) -> None:
    _calls[name] += 1
    _elements[name] += numel


def all_reduce_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """x summed over the data ranks, in place; returns x."""
    _count("all_reduce", x.numel())
    if mesh.group is not None:
        import torch.distributed as dist

        dist.all_reduce(x, group=mesh.group)
    return x


def reduce_scatter(x: torch.Tensor, mesh: Mesh, dim: int) -> List[torch.Tensor]:
    """x summed over the data ranks and split along `dim` into the mesh's
    `size` chunks; returns this process's chunks (views of one tensor)."""
    _count("reduce_scatter", x.numel())
    if mesh.group is not None:
        import torch.distributed as dist

        front = x.movedim(dim, 0).contiguous()
        slab = front.new_empty((front.shape[0] // mesh.data,) + front.shape[1:])
        dist.reduce_scatter_tensor(slab, front, group=mesh.group)
        x = slab.movedim(0, dim)
    return list(x.chunk(mesh.local_size, dim))


def all_gather(shards: Sequence[torch.Tensor], mesh: Mesh, dim: int) -> torch.Tensor:
    """The whole tensor from every rank's chunk along `dim`: this process's
    chunks joined, then (processes) the slabs of every data rank."""
    slab = torch.cat(list(shards), dim)
    if mesh.group is not None:
        import torch.distributed as dist

        front = slab.movedim(dim, 0).contiguous()
        full = front.new_empty((front.shape[0] * mesh.data,) + front.shape[1:])
        dist.all_gather_into_tensor(full, front, group=mesh.group)
        slab = full.movedim(0, dim).contiguous()
    _count("all_gather", slab.numel())
    return slab


class _GatherShards(torch.autograd.Function):
    """all_gather forward, reduce_scatter backward: the shards' gradient is
    their chunk of the whole gradient summed over the data ranks."""

    @staticmethod
    def forward(ctx, mesh, dim, *shards):
        ctx.mesh, ctx.dim = mesh, dim
        return all_gather(shards, mesh, dim)

    @staticmethod
    def backward(ctx, grad):
        return (None, None, *reduce_scatter(grad, ctx.mesh, ctx.dim))


def gather_shards(shards: Sequence[torch.Tensor], mesh: Mesh, dim: int) -> torch.Tensor:
    """all_gather that autograd differentiates: the backward reduce-scatters
    the gradient onto the shards."""
    return _GatherShards.apply(mesh, dim, *shards)


def _seq_combine(x: torch.Tensor, mesh: Mesh, combine) -> torch.Tensor:
    """combine(every seq rank's x, in rank order) on seq processes. The
    result must be a tensor of its own (a cat, a sum): on CUDA the peers'
    parts are views of buffers that the next call overwrites."""
    x = x.contiguous()
    if mesh.peer is None:
        import torch.distributed as dist

        parts = [torch.empty_like(x) for _ in range(mesh.seq)]
        dist.all_gather(parts, x, group=mesh.seq_group)
        return combine(parts)
    buf = mesh.peer.buffer("seq_gather", x.shape, x.dtype)
    buf.own.copy_(x)
    mesh.peer.barrier()
    out = combine([x if r == mesh.seq_rank else buf.view(r) for r in range(mesh.seq)])
    mesh.peer.barrier()
    return out


def sum_in_rank_order(parts):
    """The sum of a list of tensors, added left to right."""
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    return total


def seq_all_gather(x: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    """Every seq rank's x joined along `dim` in rank order: this process's
    part of a scene's frames or tokens -> the whole. Logical seq ranks: x
    is the whole already and is returned."""
    if mesh.seq_processes:
        x = _seq_combine(x, mesh, lambda parts: torch.cat(parts, dim))
    _count("seq_all_gather", x.numel())
    return x


def seq_max(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The elementwise max of x over the seq ranks."""
    if mesh.seq_processes:
        x = _seq_combine(x, mesh, lambda parts: torch.stack(parts).amax(dim=0))
    _count("seq_max", x.numel())
    return x


def seq_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The elementwise sum of x over the seq ranks, added in rank order."""
    if mesh.seq_processes:
        x = _seq_combine(x, mesh, sum_in_rank_order)
    _count("seq_sum", x.numel())
    return x


def seq_reduce_scatter(x: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    """Every seq rank's x (the whole along `dim`) summed in rank order, and
    this process's part of the sum: the seq ranks' equal parts along
    `dim`, in rank order. Logical seq ranks: x is every rank's already and
    is returned."""
    _count("seq_reduce_scatter", x.numel())
    if not mesh.seq_processes:
        return x
    if x.shape[dim] % mesh.seq:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide over {mesh.seq} seq ranks")
    part = x.shape[dim] // mesh.seq
    lo = mesh.seq_rank * part
    return _seq_combine(x, mesh, lambda parts: sum_in_rank_order(
        [p.narrow(dim, lo, part) for p in parts]))


class _SeqGather(torch.autograd.Function):
    """seq_all_gather forward, seq_reduce_scatter backward."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        out = _seq_combine(x, mesh, lambda parts: torch.cat(parts, dim))
        _count("seq_gather", out.numel())
        return out

    @staticmethod
    def backward(ctx, grad):
        return seq_reduce_scatter(grad, ctx.mesh, ctx.dim), None, None


def seq_gather(x: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    """seq_all_gather that autograd differentiates: with the seq axis over
    processes and a gradient to carry (grad enabled, x requiring one), the
    backward sums every process's gradient of the whole and hands each its
    own part (seq_reduce_scatter), so the gradient of a shard is what every
    seq rank's use of it contributed. Otherwise seq_all_gather."""
    if mesh.seq_processes and torch.is_grad_enabled() and x.requires_grad:
        return _SeqGather.apply(x, mesh, dim)
    return seq_all_gather(x, mesh, dim)


def seq_all_reduce_sum(tensors: Sequence[torch.Tensor], mesh: Mesh,
                       bucket_elems: int = SEQ_BUCKET_ELEMS) -> None:
    """Contiguous tensors of one dtype, each summed in place over the seq
    ranks, added in rank order, so every process ends with the same bits.

    The tensors are laid end to end and cut into buckets of
    min(bucket_elems, their total) elements, one fixed shape for the call:
    on CUDA each bucket is staged in this process's symmetric buffer
    (parallel/peer.py), a barrier, every rank's staged bucket summed in
    rank order, a barrier, the sum copied back; on the CPU each bucket is
    gathered over gloo and summed alike. Every process must pass tensors
    of the same shapes in the same order. Logical seq ranks: unchanged."""
    tensors = list(tensors)
    if not tensors:
        return
    if len({t.dtype for t in tensors}) > 1:
        dtypes = sorted({str(t.dtype) for t in tensors})
        raise ValueError(f"seq_all_reduce_sum takes one dtype, got {dtypes}")
    flats = [t.view(-1) for t in tensors]
    total = sum(f.numel() for f in flats)
    size = min(bucket_elems, total)
    pending, filled = [], 0
    for flat in flats:
        start = 0
        while start < flat.numel():
            take = min(flat.numel() - start, size - filled)
            pending.append((flat, start, take, filled))
            start, filled = start + take, filled + take
            if filled == size:
                _reduce_bucket(pending, filled, size, mesh)
                pending, filled = [], 0
    if pending:
        _reduce_bucket(pending, filled, size, mesh)


def _reduce_bucket(segments, filled: int, size: int, mesh: Mesh) -> None:
    """One bucket of seq_all_reduce_sum: segments (flat, start, length,
    offset in the bucket) summed over the seq ranks in place."""
    _count("seq_all_reduce", filled)
    if not mesh.seq_processes:
        return
    flat0 = segments[0][0]
    if mesh.peer is None:
        bucket = flat0.new_empty(filled)
    else:
        buf = mesh.peer.buffer("seq_all_reduce", (size,), flat0.dtype)
        bucket = buf.own[:filled]
    for flat, start, take, off in segments:
        bucket[off:off + take].copy_(flat[start:start + take])
    if mesh.peer is None:
        import torch.distributed as dist

        parts = [torch.empty_like(bucket) for _ in range(mesh.seq)]
        dist.all_gather(parts, bucket, group=mesh.seq_group)
        summed = sum_in_rank_order(parts)
    else:
        mesh.peer.barrier()
        summed = sum_in_rank_order([buf.view(r)[:filled] for r in range(mesh.seq)])
        mesh.peer.barrier()
    for flat, start, take, off in segments:
        flat[start:start + take].copy_(summed[off:off + take])
