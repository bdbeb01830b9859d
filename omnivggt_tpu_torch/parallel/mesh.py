"""A mesh of logical ranks on one device (counterpart of
omnivggt_tpu/parallel/mesh.py).

The JAX package lays its (data, seq) mesh over devices. Here a mesh is
`data x seq` logical ranks that all live on one explicit device, in one
process: the counterpart of the virtual CPU devices the JAX package's
tests run on. A rank is a slice of a tensor's batch or token axis (its q
shard, its output shard, its own K/V ring buffer), and what crosses ranks
(the gather, the rotation, the max over ranks) really moves or reduces
data. Ranks as processes over `torch.distributed`, one per card, are not
ported yet.

  - "data": scene/batch parallelism;
  - "seq":  sequence parallelism over frames / tokens, the axis the
            global-attention stage communicates over.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from omnivggt_tpu_torch.utils.device import resolve_device

DATA_AXIS = "data"
SEQ_AXIS = "seq"


@dataclass(frozen=True)
class Mesh:
    """`data x seq` logical ranks on `device`."""

    data: int
    seq: int
    device: torch.device

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.data, SEQ_AXIS: self.seq}


def make_mesh(data: int = 1, seq: Optional[int] = None, device=None) -> Mesh:
    """A (data, seq) mesh of logical ranks on `device` (default "cuda",
    raising without one; "cpu" when asked). With seq=None the sequence axis
    gets the device count over `data`, as the JAX function gives it all
    remaining devices: 1 on one card or on the CPU. An explicit seq asks
    for that many logical ranks; they need no devices of their own, so the
    JAX function's "needs more devices" error has no counterpart."""
    device = resolve_device(device)
    if not isinstance(data, int) or data < 1:
        raise ValueError(f"data must be a positive int, got {data!r}")
    if seq is None:
        n = torch.cuda.device_count() if device.type == "cuda" else 1
        if n % data != 0:
            raise ValueError(f"{n} devices not divisible by data={data}")
        seq = n // data
    if not isinstance(seq, int) or seq < 1:
        raise ValueError(f"seq must be a positive int, got {seq!r}")
    return Mesh(data, seq, device)


def multihost_initialize(**kwargs) -> None:
    """The JAX package brings up jax.distributed here. Ranks as processes
    (torch.distributed: gloo on the CPU, NCCL and peer-mapped ring slots
    across cards) are not ported: ROADMAP.md, Queue 1 item 14."""
    raise NotImplementedError(
        "multi-process meshes are not ported yet (ROADMAP.md Queue 1 item 14: ranks as "
        "processes over torch.distributed); make_mesh builds logical ranks on one device"
    )


def frames_sharding(mesh: Mesh):
    """How (B, S, ...) arrays lie on the mesh: batch over data, frames over
    seq. For logical ranks this is a description, not a placement: the
    (axis, ranks) pairs of the two leading axes."""
    return ((DATA_AXIS, mesh.data), (SEQ_AXIS, mesh.seq))


def replicated(mesh: Mesh):
    """Every rank sees the whole array: no axis is split."""
    return ()


def shard_batch(mesh: Mesh, tree):
    """Place a tree (dict / list / tuple) of (B, S, ...) arrays for the
    mesh: every tensor or array leaf moves to the mesh's device. The ranks'
    shards are slices of it, taken where a strategy needs them, so nothing
    else is done; leaves that are no arrays pass through."""
    if isinstance(tree, dict):
        return {k: shard_batch(mesh, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_batch(mesh, v) for v in tree)
    if hasattr(tree, "ndim") and tree.ndim >= 2:
        return torch.as_tensor(tree, device=mesh.device)
    return tree
