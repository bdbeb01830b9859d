"""The collectives of multi-device training over a mesh's ranks
(parallel/mesh.py): the sums, scatters and gathers that the JAX package's
partitioner inserts for its sharding annotations.

State is sharded over all `data x seq` ranks of the mesh, rank-major: a
sharded dim splits into `mesh.size` equal chunks, and rank (d, s) holds
chunk d * seq + s, as the JAX package's NamedSharding over ("data",
"seq") places it. A process holds the chunks of the ranks it runs
(`mesh.own_ranks`):

  - logical ranks (no process group): one process computes the whole
    batch, so its gradients are already the sums over the ranks.
    `all_reduce_sum` leaves a tensor as it is, `reduce_scatter_many`
    splits each tensor into the ranks' chunks and `all_gather_many` is a
    `torch.cat` of them (`all_gather` for one tensor);
  - the data axis over processes: the process of data rank r holds chunks
    [r * seq, (r + 1) * seq), a contiguous slab of 1 / data of the dim.
    `dist.all_reduce`, then `dist.reduce_scatter_tensor` of the whole
    tensor into this process's slab (split into its logical ranks'
    chunks), and `dist.all_gather_into_tensor` of the slabs (the sharded
    dim moved to the front for both, since they concatenate along dim 0);
  - both axes over processes: one chunk a process. `reduce_scatter_many`
    sums every seq rank's whole tensor in rank order (so the chunks are
    the bits of state "none"'s seq sum, `seq_all_reduce_sum`) and keeps
    this seq rank's chunk of every data rank's slab, then reduce-scatters
    those over the data group; `all_gather_many` joins the seq ranks'
    chunks into the slab, then the data group gathers the slabs. The seq
    part of either takes many tensors as one flat collective (laid end to
    end in buckets of `SEQ_BUCKET_ELEMS`, a tensor never cut), so fsdp
    pays two barriers a block and not two a tensor.

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
    the seq processes in buckets.
Every seq collective over CUDA processes is staged through `_exchange`,
in one peer buffer of `SEQ_BUCKET_ELEMS` elements a dtype (the peer
memory caches each buffer for the life of the mesh, so it holds one fixed
shape, not one a tensor shape, nor a second copy of the gradients).

Every call counts one in `calls()` and its whole tensor's elements in
`elements()` (the input of a reduce-scatter, the output of a gather, the
reduced tensor of seq_max / seq_sum; seq_all_reduce_sum and the state's
flat seq collectives, "state_seq_gather" and "state_seq_scatter", count
one a bucket), in the style of the kernels' `launches()`, so tests and
chip_smoke.py can assert which collective ran. `gather_shards` is the
gather that FSDP differentiates through: its backward is a reduce-scatter.
"""

from __future__ import annotations

from collections import Counter
from typing import Callable, List, Sequence, Tuple

import torch

from omnivggt_tpu_torch.parallel.mesh import Mesh

NAMES = ("all_reduce", "reduce_scatter", "all_gather", "seq_all_gather", "seq_max", "seq_sum",
         "seq_gather", "seq_reduce_scatter", "seq_all_reduce", "state_seq_gather",
         "state_seq_scatter")
# elements of one bucket of the seq processes' gradient sum and of the
# state's flat collectives: 256 MiB of fp32 a process, staged in its
# symmetric buffer, and as much again for the sum. A bucket costs two
# barriers (~2.5 ms each with processes time-sliced on one card) and three
# passes over its bytes (~0.25 ms at 3.35 TB/s), so the barriers set its
# time: the flagship's 1.217B gradients take 19 buckets, 38 barriers, for
# 0.5 GB a process beside its ~27 GB
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


def all_gather(shards: Sequence[torch.Tensor], mesh: Mesh, dim: int) -> torch.Tensor:
    """The whole tensor from every rank's chunk along `dim` (all_gather_many)."""
    return all_gather_many([shards], mesh, [dim])[0]


def reduce_scatter_many(xs: Sequence[torch.Tensor], mesh: Mesh, dims: Sequence[int],
                        bucket_elems: int = SEQ_BUCKET_ELEMS) -> List[List[torch.Tensor]]:
    """Each x summed over every rank and split along its dim into the
    mesh's `size` chunks; returns this process's chunks of each (views of
    one tensor). Seq processes: every seq rank's x summed in rank order,
    one flat collective for all of xs (_seq_scatter_state), then the data
    group's reduce-scatter of what is left. Every process must pass the
    same shapes in the same order."""
    for x in xs:
        _count("reduce_scatter", x.numel())
    xs = list(xs)
    if mesh.seq_processes and xs:
        xs = _seq_scatter_state(xs, mesh, list(dims), bucket_elems)
    out = []
    for x, dim in zip(xs, dims):
        if mesh.group is not None:
            import torch.distributed as dist

            front = x.movedim(dim, 0).contiguous()
            slab = front.new_empty((front.shape[0] // mesh.data,) + front.shape[1:])
            dist.reduce_scatter_tensor(slab, front, group=mesh.group)
            x = slab.movedim(0, dim)
        out.append(list(x.chunk(mesh.local_size, dim)))
    return out


def all_gather_many(pieces: Sequence[Sequence[torch.Tensor]], mesh: Mesh, dims: Sequence[int],
                    bucket_elems: int = SEQ_BUCKET_ELEMS) -> List[torch.Tensor]:
    """Each tensor whole from every rank's chunks along its dim: this
    process's chunks joined, then (seq processes) every seq rank's chunk in
    rank order, one flat collective for all of them (_seq_gather_state),
    then (processes) the slabs of every data rank. Each result is a tensor
    of its own."""
    slabs = [torch.cat(list(p), d) for p, d in zip(pieces, dims)]
    if mesh.seq_processes and slabs:
        slabs = _seq_gather_state(slabs, mesh, list(dims), bucket_elems)
    out = []
    for slab, dim in zip(slabs, dims):
        if mesh.group is not None:
            import torch.distributed as dist

            front = slab.movedim(dim, 0).contiguous()
            full = front.new_empty((front.shape[0] * mesh.data,) + front.shape[1:])
            dist.all_gather_into_tensor(full, front, group=mesh.group)
            slab = full.movedim(0, dim).contiguous()
        _count("all_gather", slab.numel())
        out.append(slab)
    return out


class _GatherShards(torch.autograd.Function):
    """all_gather_many forward, reduce_scatter_many backward: each shard's
    gradient is its chunk of the whole gradient summed over the ranks."""

    @staticmethod
    def forward(ctx, mesh, dims, counts, *shards):
        ctx.mesh, ctx.dims = mesh, dims
        pieces, i = [], 0
        for n in counts:
            pieces.append(shards[i:i + n])
            i += n
        return tuple(all_gather_many(pieces, mesh, dims))

    @staticmethod
    def backward(ctx, *grads):
        chunks = reduce_scatter_many(grads, ctx.mesh, ctx.dims)
        return (None, None, None, *(c for cs in chunks for c in cs))


def gather_shards(pieces: Sequence[Sequence[torch.Tensor]], mesh: Mesh,
                  dims: Sequence[int]) -> List[torch.Tensor]:
    """all_gather_many that autograd differentiates: the backward
    reduce-scatters the gradients onto the shards, again as one flat
    collective over the seq processes."""
    return list(_GatherShards.apply(mesh, tuple(dims), tuple(len(p) for p in pieces),
                                    *(s for p in pieces for s in p)))


def state_buckets(sizes: Sequence[int], cap: int) -> List[Tuple[List[Tuple[int, int]], int]]:
    """Tensors of `sizes` elements laid end to end in buckets of at most
    `cap` elements, a tensor never cut: [([(index, offset), ...], filled)]
    a bucket, in order."""
    buckets, members, filled = [], [], 0
    for i, n in enumerate(sizes):
        if n > cap:
            raise ValueError(f"a tensor of {n} elements exceeds a bucket of {cap}")
        if filled + n > cap:
            buckets.append((members, filled))
            members, filled = [], 0
        members.append((i, filled))
        filled += n
    if members:
        buckets.append((members, filled))
    return buckets


def _one_dtype(tensors) -> torch.dtype:
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) > 1:
        raise ValueError(f"a flat seq collective takes one dtype, got {sorted(map(str, dtypes))}")
    return dtypes.pop()


def _shaped(flat: torch.Tensor, shape, dim: int) -> torch.Tensor:
    """`flat` as a tensor of `shape` whose `dim` is its outermost (the
    layout a chunk takes in a staging buffer)."""
    front = (shape[dim],) + tuple(shape[:dim]) + tuple(shape[dim + 1:])
    return flat.view(front).movedim(0, dim)


def _exchange(mesh: Mesh, dtype: torch.dtype, numel: int, bucket_elems: int,
              stage: Callable[[torch.Tensor], None],
              read: Callable[[List[torch.Tensor]], None]) -> None:
    """One bucket over the seq processes: stage(own) fills this process's
    `numel` elements, then read(parts) is given every seq rank's, in rank
    order. On CUDA they are this process's and its peers' staging buffers
    (one of `bucket_elems` elements a dtype for the life of the mesh),
    valid only inside `read`: a barrier before it, one after; on the CPU
    they are gathered over gloo."""
    if mesh.peer is None:
        import torch.distributed as dist

        own = torch.empty(numel, dtype=dtype, device=mesh.device)
        stage(own)
        parts = [torch.empty_like(own) for _ in range(mesh.seq)]
        dist.all_gather(parts, own, group=mesh.seq_group)
        read(parts)
        return
    buf = mesh.peer.buffer("seq_stage", (bucket_elems,), dtype)
    stage(buf.own[:numel])
    mesh.peer.barrier()
    read([buf.view(r)[:numel] for r in range(mesh.seq)])
    mesh.peer.barrier()


def _seq_gather_state(chunks: List[torch.Tensor], mesh: Mesh, dims: List[int],
                      bucket_elems: int) -> List[torch.Tensor]:
    """Each process's chunk of each tensor, joined along its dim with every
    seq rank's in rank order; the chunks laid end to end in buckets."""
    dtype = _one_dtype(chunks)
    outs = [c.new_empty(c.shape[:d] + (c.shape[d] * mesh.seq,) + c.shape[d + 1:])
            for c, d in zip(chunks, dims)]
    for members, filled in state_buckets([c.numel() for c in chunks], bucket_elems):
        _count("state_seq_gather", filled * mesh.seq)

        def stage(own, members=members):
            for i, off in members:
                c, d = chunks[i], dims[i]
                _shaped(own[off:off + c.numel()], c.shape, d).copy_(c)

        def read(parts, members=members):
            for i, off in members:
                c, d = chunks[i], dims[i]
                rows = c.shape[d]
                for r, part in enumerate(parts):
                    outs[i].narrow(d, r * rows, rows).copy_(
                        _shaped(part[off:off + c.numel()], c.shape, d))

        _exchange(mesh, dtype, filled, bucket_elems, stage, read)
    return outs


def _seq_scatter_state(xs: List[torch.Tensor], mesh: Mesh, dims: List[int],
                       bucket_elems: int) -> List[torch.Tensor]:
    """Each whole x summed over the seq ranks in rank order, keeping the
    chunks of this seq rank: chunk d * seq + seq_rank of every data rank d,
    joined along its dim in data-rank order. A bucket holds seq equal
    regions, one a destination rank, each of at most bucket_elems // seq."""
    dtype, seq, data = _one_dtype(xs), mesh.seq, mesh.data
    for x, d in zip(xs, dims):
        if x.shape[d] % mesh.size:
            raise ValueError(f"dim {d} of {tuple(x.shape)} does not divide over {mesh.size} ranks")
    rows = [x.shape[d] // mesh.size for x, d in zip(xs, dims)]
    shapes = [x.shape[:d] + (r,) + x.shape[d + 1:] for x, d, r in zip(xs, dims, rows)]
    outs = [x.new_empty(x.shape[:d] + (r * data,) + x.shape[d + 1:])
            for x, d, r in zip(xs, dims, rows)]
    for members, filled in state_buckets([x.numel() // seq for x in xs], bucket_elems // seq):
        _count("state_seq_scatter", filled * seq)

        def stage(own, members=members, filled=filled):
            for i, off in members:
                x, d, n = xs[i], dims[i], xs[i].numel() // mesh.size
                for r in range(seq):
                    for dd in range(data):
                        at = r * filled + off + dd * n
                        _shaped(own[at:at + n], shapes[i], d).copy_(
                            x.narrow(d, (dd * seq + r) * rows[i], rows[i]))

        def read(parts, members=members, filled=filled):
            at0 = mesh.seq_rank * filled
            for i, off in members:
                d, n = dims[i], xs[i].numel() // mesh.size
                summed = sum_in_rank_order(
                    [p[at0 + off:at0 + off + n * data] for p in parts])
                for dd in range(data):
                    outs[i].narrow(d, dd * rows[i], rows[i]).copy_(
                        _shaped(summed[dd * n:(dd + 1) * n], shapes[i], d))

        _exchange(mesh, dtype, filled * seq, bucket_elems, stage, read)
    return outs


def _seq_combine(x: torch.Tensor, mesh: Mesh, combine) -> torch.Tensor:
    """combine(every seq rank's x, in rank order) on seq processes, staged
    through _exchange. The result must be a tensor of its own (a cat, a
    sum): on CUDA the parts are views of buffers that the next call
    overwrites. An x larger than a bucket is copied out bucket by bucket
    first."""
    flat = x.contiguous().view(-1)
    n, out = flat.numel(), []
    if n <= SEQ_BUCKET_ELEMS:
        _exchange(mesh, x.dtype, n, SEQ_BUCKET_ELEMS, lambda own: own.copy_(flat),
                  lambda parts: out.append(combine([p.view(x.shape) for p in parts])))
        return out[0]
    wholes = [torch.empty_like(flat) for _ in range(mesh.seq)]
    for lo in range(0, n, SEQ_BUCKET_ELEMS):
        hi = min(n, lo + SEQ_BUCKET_ELEMS)
        _exchange(mesh, x.dtype, hi - lo, SEQ_BUCKET_ELEMS, lambda own: own.copy_(flat[lo:hi]),
                  lambda parts: [w[lo:hi].copy_(p) for w, p in zip(wholes, parts)])
    return combine([w.view(x.shape) for w in wholes])


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
    min(bucket_elems, their total) elements: each bucket is staged
    (_exchange: on CUDA in this process's staging buffer of bucket_elems
    elements, on the CPU gathered over gloo), every rank's staged bucket
    summed in rank order, the sum copied back. Every process must pass
    tensors of the same shapes in the same order. Logical seq ranks:
    unchanged."""
    tensors = list(tensors)
    if not tensors:
        return
    _one_dtype(tensors)
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
                _reduce_bucket(pending, filled, mesh, bucket_elems)
                pending, filled = [], 0
    if pending:
        _reduce_bucket(pending, filled, mesh, bucket_elems)


def _reduce_bucket(segments, filled: int, mesh: Mesh, bucket_elems: int) -> None:
    """One bucket of seq_all_reduce_sum: segments (flat, start, length,
    offset in the bucket) summed over the seq ranks in place."""
    _count("seq_all_reduce", filled)
    if not mesh.seq_processes:
        return

    def stage(own):
        for flat, start, take, off in segments:
            own[off:off + take].copy_(flat[start:start + take])

    def read(parts):
        summed = sum_in_rank_order(parts)
        for flat, start, take, off in segments:
            flat[start:start + take].copy_(summed[off:off + take])

    _exchange(mesh, segments[0][0].dtype, filled, bucket_elems, stage, read)
