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
"""

from __future__ import annotations

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
from omnivggt_tpu_torch.parallel.mesh import SEQ_AXIS


def _shards(x, n_ranks: int):
    """The ranks' views of x along the token axis."""
    N = x.shape[1]
    if N % n_ranks:
        raise ValueError(f"sequence length {N} does not divide over {n_ranks} ranks")
    return list(x.split(N // n_ranks, dim=1))


def _all_gather(shards):
    """The ranks' shards joined in rank order: a copy of the whole axis."""
    return torch.cat(shards, dim=1)


def _max_over_ranks(k_shards):
    """An `amax_reduce` for the quantisers: the elementwise max of a rank's
    (B, H) max-abs with every rank's, which is what a max-reduction over
    the ring axis hands each rank."""
    peers = torch.stack([FK._abs_max_per_head(k, None) for k in k_shards]).amax(dim=0)
    return lambda amax: torch.maximum(amax, peers)


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
    zeroed by global row index so that they cannot move a rank's q scales."""
    n = mesh.shape[seq_axis]
    q_shards, k_shards, v_shards = (_shards(x, n) for x in (q, k, v))
    N = q.shape[1]
    nl = N // n

    if kv_valid is None:
        local = q_shards[0]
        flash = resolve_impl(local, impl) == "flash"
        if qk_int8 and flash and stream_eligible(local.shape, N, bounded_logits):
            # token-major pre-gather for the streaming kernel
            reduce = _max_over_ranks(k_shards)
            quant = [FK.quant_k_token_major(ks, amax_reduce=reduce) for ks in k_shards]
            k_quant = (_all_gather([k8 for k8, _ in quant]), quant[0][1])
            v_full = _all_gather(v_shards)
            return torch.cat([
                FK.flash_attention_packed_stream(qs, None, v_full, qk_int8=True, k_quant=k_quant)
                for qs in q_shards
            ], dim=1)
        if qk_int8 and flash and not packed_eligible(local.shape, N):
            # head-major pre-gather
            reduce = _max_over_ranks(k_shards)
            quant = [FK.quant_per_head(ks, amax_reduce=reduce) for ks in k_shards]
            k_quant = (_all_gather([k8 for k8, _ in quant]), quant[0][1])
            v_full = _all_gather(v_shards)
            return torch.cat([
                FK.flash_attention(qs, None, v_full, bounded_logits=bounded_logits,
                                   qk_int8=True, k_quant=k_quant)
                for qs in q_shards
            ], dim=1)
        k_full, v_full = _all_gather(k_shards), _all_gather(v_shards)
        return torch.cat([
            scaled_dot_product_attention(qs, k_full, v_full, impl=impl,
                                         bounded_logits=bounded_logits, qk_int8=qk_int8)
            for qs in q_shards
        ], dim=1)

    k_full, v_full = _all_gather(k_shards), _all_gather(v_shards)
    outs = []
    for r, qs in enumerate(q_shards):
        if qk_int8:
            row = r * nl + torch.arange(nl, device=q.device)
            qs = torch.where((row < kv_valid)[None, :, None, None], qs, 0.0)
        outs.append(scaled_dot_product_attention(
            qs, k_full, v_full, impl=impl, kv_valid=kv_valid,
            bounded_logits=bounded_logits, qk_int8=qk_int8,
        ))
    return torch.cat(outs, dim=1)


def ring_attention(q, k, v, mesh, seq_axis: str = SEQ_AXIS, bounded_logits: bool = False):
    """Sequence-sharded ring attention in torch ops (the unfused ring): the
    K/V shards rotate one rank to the right per step, a copy of every
    shard, and each rank keeps a streaming-softmax (max, denom, acc) carry
    in fp32. Exact, any shard length. bounded_logits: the softmax runs at a
    fixed max of 0, without the running-max carry.

    The ranks run as one leading axis of each tensor, so a step is one
    batched product over all ranks."""
    n = mesh.shape[seq_axis]
    B, N, H, D = q.shape
    if N % n:
        raise ValueError(f"sequence length {N} does not divide over {n} ranks")
    nl = N // n

    def ranks(x):
        return x.reshape(B, n, nl, H, D)

    qf = ranks(q).float() * D**-0.5
    k_cur, v_cur = ranks(k), ranks(v)
    m = None if bounded_logits else torch.full((B, n, H, nl), -torch.inf, device=q.device)
    d = torch.zeros((B, n, H, nl), device=q.device)
    acc = torch.zeros((B, n, H, nl, D), device=q.device)
    for step in range(n):
        s = torch.einsum("brqhd,brkhd->brhqk", qf, k_cur.float())
        vf = v_cur.float().transpose(2, 3)  # (B, n, H, nl, D)
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
        if step + 1 < n:  # the last shard's rotation would be discarded
            k_cur, v_cur = torch.roll(k_cur, 1, dims=1), torch.roll(v_cur, 1, dims=1)
    out = acc / d[..., None]
    return out.transpose(2, 3).reshape(B, N, H, D).to(q.dtype)


def fused_ring_attention(q, k, v, mesh, seq_axis: str = SEQ_AXIS,
                         bounded_logits: bool = False, qk_int8: bool = False):
    """The ring kernels (ops/kernels/ring_attention.py). Shards past the
    second kernel's cap (`fits_hbm_ring`) go to the unfused ring, logged
    and counted in `fused_ring_attention.unfused_fallbacks`, as in the JAX
    package; the unfused ring ignores qk_int8."""
    nl = q.shape[1] // mesh.shape[seq_axis]
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
