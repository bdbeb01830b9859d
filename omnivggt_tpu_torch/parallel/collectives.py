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

Every call counts one in `calls()` and its whole tensor's elements in
`elements()` (the input of a reduce-scatter, the output of a gather), in
the style of the kernels' `launches()`, so tests and chip_smoke.py can
assert which collective ran. `gather_shards` is the gather that FSDP
differentiates through: its backward is a reduce-scatter.
"""

from __future__ import annotations

from collections import Counter
from typing import List, Sequence

import torch

from omnivggt_tpu_torch.parallel.mesh import Mesh

NAMES = ("all_reduce", "reduce_scatter", "all_gather")
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
