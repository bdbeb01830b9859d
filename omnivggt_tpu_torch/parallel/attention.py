"""Sequence-sharded attention over a mesh of logical ranks (counterpart of
omnivggt_tpu/parallel/attention.py).

All functions take (B, N, H, D) tensors on the mesh's device and return the
same layout. Under the sequence strategies rank r of the `seq_axis` owns
rows [r * nl, (r + 1) * nl) of the token axis; under the rows strategy the
ranks split the leading axis. What the JAX package does with collectives
inside `shard_map` is done here on slices, rank by rank:

  - "allgather": queries stay sharded; the ranks' K and V shards are
    gathered (one copy of the whole key axis, which all logical ranks read)
    and each rank attends its own rows to it, one kernel launch per rank;
  - "ring": K/V shards rotate (a real copy per step) while every rank keeps
    a streaming-softmax (max, denom, acc) carry in fp32 torch ops;
  - "ring_fused": the ring kernels of ops/kernels/ring_attention.py;
  - "rows": the leading axis split over ranks, no communication.

A mesh's data axis replicates the sequence strategies' work in the JAX
package; logical ranks compute it once. Rows split over the ranks this
process runs (`mesh.local_shape`): with the data axis over processes each
process holds its own scenes and runs only its seq ranks.

With the seq axis over processes (`mesh.seq_processes`) the tensors are
this process's rows only, the shard of seq rank `mesh.seq_rank`. Each
strategy is written once, for the seq ranks this process runs (all of
them on logical ranks, one over processes); only the gather of K and V
and the max over the ranks differ (`_all_gather`, `_max_over_ranks`: a
join here, or collectives.seq_gather / seq_max across the processes; the
gather is differentiable, so "allgather" and "ring" train over processes).
"ring_fused" runs the ring kernels' process form, and "rows" has nothing
to cross.
"""

from __future__ import annotations

import functools
import logging

import torch

from omnivggt_tpu_torch.ops.attention import (
    packed_eligible,
    resolve_impl,
    scaled_dot_product_attention,
    stream_eligible,
)
from omnivggt_tpu_torch.ops.kernels import flash_attention as FK
from omnivggt_tpu_torch.ops.kernels import ring_attention as RK
from omnivggt_tpu_torch.parallel import collectives as C
from omnivggt_tpu_torch.parallel.mesh import SEQ_AXIS


def _shards(x, n_ranks: int):
    """The ranks' views of x along the token axis."""
    N = x.shape[1]
    if N % n_ranks:
        raise ValueError(f"sequence length {N} does not divide over {n_ranks} ranks")
    return list(x.split(N // n_ranks, dim=1))


def _own_shards(x, mesh, seq_axis: str):
    """The shards of the seq ranks this process runs: every rank's on
    logical ranks, x itself with the seq axis over processes."""
    return _shards(x, mesh.local_shape[seq_axis])


def _all_gather(shards, mesh):
    """Every seq rank's shard joined in rank order along the token axis,
    from this process's shards: joined here on logical ranks, gathered
    over the seq processes (collectives.seq_gather) otherwise. Under
    autograd the gather's backward sums every process's gradient of the
    gathered K/V and hands each its own shard's part."""
    if mesh.seq_processes:
        (own,) = shards
        return C.seq_gather(own, mesh, 1)
    return torch.cat(shards, dim=1)


def _max_over_ranks(k_shards, mesh):
    """An `amax_reduce` for the quantisers: the elementwise max of a rank's
    (B, H) max-abs with every seq rank's, which is what a max-reduction
    over the ring axis hands each rank."""
    if mesh.seq_processes:
        return lambda amax: C.seq_max(amax, mesh)
    peers = torch.stack([FK._abs_max_per_head(k, None) for k in k_shards]).amax(dim=0)
    return lambda amax: torch.maximum(amax, peers)


def _join(outs):
    """This process's ranks' output shards, one tensor."""
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def allgather_attention(q, k, v, mesh, seq_axis: str = SEQ_AXIS, impl: str = "auto",
                        kv_valid=None, bounded_logits: bool = False, qk_int8: bool = False):
    """Sequence-sharded attention with gathered K and V. kv_valid masks keys
    at or past it in the gathered sequence: the gather restores the global
    token order, so the valid prefix stays a prefix.

    qk_int8: each rank quantises its own q rows with its own per-head
    scales. Without kv_valid, and only when the gathered call would run an
    int8 kernel (not the packed bf16 kernel, which wins where it is
    eligible), K is quantised before the gather: each rank's shard on the
    max over all ranks' max-abs, so the gathered int8 grid equals that of
    the gathered array bit for bit and the gather moves int8. With kv_valid
    (bucketed serving) K is gathered, then quantised, since the scale's
    masking needs the global row index; the padded frames' q rows are
    zeroed by global row index so that they cannot move a rank's q scales.

    With the seq axis over processes q, k, v are this process's rows and
    the output is too: the same steps for its one rank."""
    q_shards, k_shards, v_shards = (_own_shards(x, mesh, seq_axis) for x in (q, k, v))
    nl = q_shards[0].shape[1]
    N = nl * mesh.shape[seq_axis]

    if kv_valid is None:
        local = q_shards[0]
        flash = resolve_impl(local, impl) == "flash"
        if qk_int8 and flash and stream_eligible(local.shape, N, bounded_logits):
            # token-major pre-gather for the streaming kernel
            quant, attend = FK.quant_k_token_major, FK.flash_attention_packed_stream
        elif qk_int8 and flash and not packed_eligible(local.shape, N):
            # head-major pre-gather
            quant = FK.quant_per_head
            attend = functools.partial(FK.flash_attention, bounded_logits=bounded_logits)
        else:
            k_full, v_full = _all_gather(k_shards, mesh), _all_gather(v_shards, mesh)
            return _join([
                scaled_dot_product_attention(qs, k_full, v_full, impl=impl,
                                             bounded_logits=bounded_logits, qk_int8=qk_int8)
                for qs in q_shards
            ])
        reduce = _max_over_ranks(k_shards, mesh)
        quants = [quant(ks, amax_reduce=reduce) for ks in k_shards]
        k_quant = (_all_gather([k8 for k8, _ in quants], mesh), quants[0][1])
        v_full = _all_gather(v_shards, mesh)
        return _join([attend(qs, None, v_full, qk_int8=True, k_quant=k_quant)
                      for qs in q_shards])

    k_full, v_full = _all_gather(k_shards, mesh), _all_gather(v_shards, mesh)
    outs = []
    for r, qs in enumerate(q_shards, start=mesh.seq_rank):
        if qk_int8:
            row = r * nl + torch.arange(nl, device=q.device)
            qs = torch.where((row < kv_valid)[None, :, None, None], qs, 0.0)
        outs.append(scaled_dot_product_attention(
            qs, k_full, v_full, impl=impl, kv_valid=kv_valid,
            bounded_logits=bounded_logits, qk_int8=qk_int8,
        ))
    return _join(outs)


def ring_attention(q, k, v, mesh, seq_axis: str = SEQ_AXIS, bounded_logits: bool = False):
    """Sequence-sharded ring attention in torch ops (the unfused ring): the
    K/V shards rotate one rank to the right per step, a copy of every
    shard, and each rank keeps a streaming-softmax (max, denom, acc) carry
    in fp32. Exact, any shard length. bounded_logits: the softmax runs at a
    fixed max of 0, without the running-max carry.

    This process's ranks run as one leading axis of each tensor, so a step
    is one batched product over them. Every shard is gathered once, and at
    step t rank r holds the shard of rank (r - t) % n. With the seq axis
    over processes q, k, v and the output are this process's rows."""
    B, N, H, D = q.shape
    n, local = mesh.shape[seq_axis], mesh.local_shape[seq_axis]
    nl = _own_shards(q, mesh, seq_axis)[0].shape[1]
    k_all, v_all = (_all_gather(_own_shards(x, mesh, seq_axis), mesh).reshape(B, n, nl, H, D)
                    for x in (k, v))
    own = range(mesh.seq_rank, mesh.seq_rank + local)
    qf = q.reshape(B, local, nl, H, D).float() * D**-0.5
    m = None if bounded_logits else torch.full((B, local, H, nl), -torch.inf, device=q.device)
    d = torch.zeros((B, local, H, nl), device=q.device)
    acc = torch.zeros((B, local, H, nl, D), device=q.device)
    for step in range(n):
        held = [(r - step) % n for r in own]
        s = torch.einsum("brqhd,brkhd->brhqk", qf, k_all[:, held].float())
        vf = v_all[:, held].float().transpose(2, 3)  # (B, local, H, nl, D)
        if bounded_logits:
            p = s.clamp_max_(80.0).exp_()
            d = d + p.sum(-1)
            acc = acc + p @ vf
        else:
            m_new = torch.maximum(m, s.amax(-1))
            p = s.sub_(m_new[..., None]).exp_()
            corr = (m - m_new).exp()
            d = d * corr + p.sum(-1)
            acc = acc * corr[..., None] + p @ vf
            m = m_new
    out = acc / d[..., None]
    return out.transpose(2, 3).reshape(B, N, H, D).to(q.dtype)


def fused_ring_attention(q, k, v, mesh, seq_axis: str = SEQ_AXIS,
                         bounded_logits: bool = False, qk_int8: bool = False):
    """The ring kernels (ops/kernels/ring_attention.py). Shards past the
    second kernel's cap (`fits_hbm_ring`) go to the unfused ring, logged
    and counted in `fused_ring_attention.unfused_fallbacks`, as in the JAX
    package; the unfused ring ignores qk_int8."""
    nl = q.shape[1] if mesh.seq_processes else q.shape[1] // mesh.shape[seq_axis]
    if not RK.fits_hbm_ring(nl):
        logging.getLogger(__name__).warning(
            "per-device sequence %d exceeds the HBM-staged ring kernel cap "
            "%d; falling back to the unfused ring (exact, but the inner loop "
            "runs as torch ops instead of the fused kernel)",
            nl, RK.MAX_LOCAL_SEQ_HBM,
        )
        fused_ring_attention.unfused_fallbacks += 1
        return ring_attention(q, k, v, mesh, seq_axis, bounded_logits=bounded_logits)
    return RK.ring_flash_attention(
        q, k, v, mesh, seq_axis, bounded_logits=bounded_logits, qk_int8=qk_int8
    )


fused_ring_attention.unfused_fallbacks = 0


def rows_sharded_attention(q, k, v, mesh, rows_spec, impl: str = "auto", kv_valid=None,
                           bounded_logits: bool = False, qk_int8: bool = False):
    """Attention with the leading (batch / rows) axis split over the ranks
    of `rows_spec` (a mesh axis name or a tuple of them): frame attention,
    where each frame attends within itself, so nothing crosses ranks. Each
    rank runs the attention dispatch on its own rows.

    kv_valid: a token-level valid prefix within each row's sequence (the
    DINOv2 alignment padding); the token axis is whole on every rank, so
    the same prefix applies everywhere."""
    axes = (rows_spec,) if isinstance(rows_spec, str) else tuple(rows_spec or ())
    n = 1
    for axis in axes:
        n *= mesh.local_shape[axis]
    rows = q.shape[0]
    if rows % n:
        raise ValueError(f"{rows} rows do not divide over {n} ranks")
    return torch.cat([
        scaled_dot_product_attention(qs, ks, vs, impl=impl, kv_valid=kv_valid,
                                     bounded_logits=bounded_logits, qk_int8=qk_int8)
        for qs, ks, vs in zip(*(x.split(rows // n, dim=0) for x in (q, k, v)))
    ], dim=0)
