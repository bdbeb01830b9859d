"""Sharding strategy objects threaded through the model (counterpart of
omnivggt_tpu/parallel/sharding.py).

`AttnShard` selects a mesh-parallel attention strategy per call site:
  - rows:        batch/frames axis split, no communication (frame
                 attention, DINOv2 per-image attention)
  - allgather:   sequence axis split, K/V gathered (global attention)
  - ring:        sequence axis split, K/V rotated in torch ops
  - ring_fused:  the same through the ring kernels

`ModelSharding` bundles the mesh and the global-attention strategy. The JAX
class's `constrain_*` methods steer XLA's partitioner; logical ranks on one
device have nothing to place, so they are left out.
"""

from __future__ import annotations

from dataclasses import dataclass

from omnivggt_tpu_torch.ops import attention as AT
from omnivggt_tpu_torch.parallel import attention as pattn
from omnivggt_tpu_torch.parallel.mesh import DATA_AXIS, SEQ_AXIS, Mesh


@dataclass(frozen=True)
class AttnShard:
    mesh: Mesh
    kind: str  # "rows" | "allgather" | "ring" | "ring_fused"
    axis: object = (DATA_AXIS, SEQ_AXIS)  # rows axes or the seq axis name

    def _ranks(self) -> int:
        axes = (self.axis,) if isinstance(self.axis, str) else tuple(self.axis or ())
        n = 1
        for a in axes:
            n *= self.mesh.local_shape.get(a, 1)
        return n

    def resolve_impl(self, q, impl: str = "auto") -> str:
        """The attention impl each rank's compute will use for the query
        tensor q (B, N, H, D): the ring strategies always run the streaming
        recurrence ("flash"); rows and allgather run the attention dispatch
        on the rank's own slice, which can resolve to "plain" or
        "blockwise"."""
        if self.kind in ("ring", "ring_fused"):
            return "flash"
        n = self._ranks()
        if self.kind == "rows":
            return AT.resolve_impl(q[: max(q.shape[0] // n, 1)], impl)
        return AT.resolve_impl(q[:, : max(q.shape[1] // n, 1)], impl)

    def attend(self, q, k, v, impl, kv_valid=None, bounded_logits=False, qk_int8=False):
        # qk_int8 reaches rows / allgather (their per-rank compute is the
        # attention dispatch) and the fused ring (int8 K/V shards on one
        # grid over all ranks); the unfused ring ignores it
        if self.kind == "rows":
            # kv_valid here is a token-level prefix within each row's whole
            # sequence; frame-level padding never reaches rows attention
            return pattn.rows_sharded_attention(
                q, k, v, self.mesh, self.axis, impl=impl, kv_valid=kv_valid,
                bounded_logits=bounded_logits, qk_int8=qk_int8,
            )
        if self.kind == "allgather":
            return pattn.allgather_attention(
                q, k, v, self.mesh, self.axis, impl=impl, kv_valid=kv_valid,
                bounded_logits=bounded_logits, qk_int8=qk_int8,
            )
        if self.kind in ("ring", "ring_fused"):
            if kv_valid is not None:
                raise NotImplementedError(
                    "valid-prefix masking is not wired into the ring strategy;"
                    " use global_attn='allgather' for bucketed serving"
                )
            if self.kind == "ring_fused":
                return pattn.fused_ring_attention(
                    q, k, v, self.mesh, self.axis,
                    bounded_logits=bounded_logits, qk_int8=qk_int8,
                )
            return pattn.ring_attention(
                q, k, v, self.mesh, self.axis, bounded_logits=bounded_logits
            )
        raise ValueError(self.kind)


@dataclass(frozen=True)
class ModelSharding:
    """How the OmniVGGT forward is laid out on the mesh."""

    mesh: Mesh
    global_attn: str = "allgather"  # or "ring", "ring_fused"

    @property
    def frame_attn_shard(self) -> AttnShard:
        return AttnShard(self.mesh, "rows", (DATA_AXIS, SEQ_AXIS))

    @property
    def global_attn_shard(self) -> AttnShard:
        return AttnShard(self.mesh, self.global_attn, SEQ_AXIS)
