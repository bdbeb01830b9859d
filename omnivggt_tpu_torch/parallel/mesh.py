"""The (data, seq) mesh: logical ranks on one device, or axes over
processes (counterpart of omnivggt_tpu/parallel/mesh.py).

The JAX package lays its (data, seq) mesh over devices. Here a mesh is
`data x seq` ranks in one of three layouts:

  - logical ranks (no process group): all `data x seq` ranks live on one
    explicit device in one process, the counterpart of the virtual CPU
    devices the JAX package's tests run on. A rank is a slice of a
    tensor's batch or token axis (its q shard, its output shard, its own
    K/V ring buffer), and what crosses ranks (the gather, the rotation,
    the max over ranks) really moves or reduces data;
  - the data axis over processes (a `torch.distributed` group of `data`
    processes is up, `multihost_initialize`): one process per data rank,
    each with a full model on its own device (NCCL across cards, gloo on
    the CPU), each holding `B / data` scenes of the batch. The seq axis
    stays logical ranks inside each process. Every cross-frame operation
    stays inside one scene and so inside one process; what crosses
    processes are the training state's collectives
    (parallel/collectives.py) and the loss's denominators;
  - both axes over processes (a group of `data x seq` processes, seq > 1):
    every process is one (data, seq) rank, rank-major as the JAX mesh
    reshapes its devices to (data, seq): process p is data rank
    p // seq and seq rank p % seq. A process holds the frames of its seq
    rank, [s S / seq, (s + 1) S / seq), and `local_shape` is 1 on both
    axes. What crosses frames crosses processes: the global attention's
    K/V (gathered, or rotated by the ring kernels into the right
    neighbour's peer-mapped slot), the camera rebase, the depth mean, the
    camera head's attention over frames and the outputs
    (parallel/collectives.py's seq_* collectives). Each seq group is a
    gloo group of its own, which carries the host side of those
    (barriers, the exchange of IPC handles; on the CPU the data itself);
    on CUDA the data moves through peer-mapped device memory
    (parallel/peer.py, `mesh.peer`), so the processes may share one card
    and the default group may be gloo when data is 1. The data axis's
    gradient collectives still need NCCL on CUDA, and training over seq
    processes is not ported (train/step.make_train_step raises).

  - "data": scene/batch parallelism;
  - "seq":  sequence parallelism over frames / tokens, the axis the
            global-attention stage communicates over.
"""

from __future__ import annotations

import contextlib
import datetime
import os
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

from omnivggt_tpu_torch.utils.device import resolve_device

DATA_AXIS = "data"
SEQ_AXIS = "seq"


@dataclass(frozen=True)
class Mesh:
    """`data x seq` ranks on `device`. With a data `group` the data axis lies
    over its processes (this one is data rank `rank`); with a `seq_group`
    the seq axis does too (this one is seq rank `seq_rank`, and on CUDA
    `peer` holds the seq group's symmetric buffers); an axis without a
    group is logical ranks of this process."""

    data: int
    seq: int
    device: torch.device
    group: Optional[object] = None  # torch.distributed.ProcessGroup of the data axis
    rank: int = 0
    seq_group: Optional[object] = None  # gloo ProcessGroup of this process's seq axis
    seq_rank: int = 0
    peer: Optional[object] = field(default=None, compare=False, repr=False)

    @property
    def shape(self) -> Dict[str, int]:
        """The mesh's axes, over every process."""
        return {DATA_AXIS: self.data, SEQ_AXIS: self.seq}

    @property
    def local_shape(self) -> Dict[str, int]:
        """The logical ranks of each axis that this process runs: one rank
        a process on an axis that lies over processes."""
        return {DATA_AXIS: 1 if self.group is not None or self.seq_group is not None else self.data,
                SEQ_AXIS: 1 if self.seq_group is not None else self.seq}

    @property
    def size(self) -> int:
        return self.data * self.seq

    @property
    def local_size(self) -> int:
        return self.local_shape[DATA_AXIS] * self.local_shape[SEQ_AXIS]

    @property
    def seq_processes(self) -> bool:
        """Whether the seq axis lies over processes (one seq rank each)."""
        return self.seq_group is not None

    def close(self) -> None:
        """Tear down the seq group's peer-mapped buffers (a collective over
        the seq group: every process of it calls this)."""
        if self.peer is not None:
            self.peer.close()


def _process_group():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def make_mesh(data: int = 1, seq: Optional[int] = None, device=None) -> Mesh:
    """A (data, seq) mesh on `device` (default "cuda", raising without one;
    "cpu" when asked).

    Without a process group every rank is logical. With seq=None the
    sequence axis gets the device count over `data`, as the JAX function
    gives it all remaining devices: 1 on one card or on the CPU. An
    explicit seq asks for that many logical ranks; they need no devices
    of their own, so the JAX function's "needs more devices" error has no
    counterpart.

    With a process group up (multihost_initialize) of W processes:
      - data == W: the data axis lies over the processes, one data rank a
        process, and seq (default 1) stays logical ranks in each;
      - seq > 1 and data x seq == W: both axes lie over the processes,
        rank-major (process p is data rank p // seq, seq rank p % seq).
        Every process makes every subgroup, in the same order: the data
        groups (default backend) when data > 1, then the seq groups
        (gloo). On CUDA the seq axis's data moves through peer-mapped
        device memory (`mesh.peer`), so with data == 1 a gloo default
        group is accepted there and the processes may share one card.
    The two overlap only at seq 1, where they are the same layout. The
    device must otherwise suit the group's backend: CUDA under NCCL, the
    CPU under gloo."""
    if not isinstance(data, int) or data < 1:
        raise ValueError(f"data must be a positive int, got {data!r}")
    if seq is not None and (not isinstance(seq, int) or seq < 1):
        raise ValueError(f"seq must be a positive int, got {seq!r}")
    dist = _process_group()
    if dist is not None:
        world = dist.get_world_size()
        seq = 1 if seq is None else seq
        over_seq = seq > 1 and data * seq == world
        if data != world and not over_seq:
            raise ValueError(
                f"a process group of {world} processes is up: either the data axis lies over "
                f"the processes (data must be {world}; seq stays logical ranks in each) or both "
                f"axes do (data x seq must be {world}), got data={data}, seq={seq} (without a "
                "group every rank is logical)"
            )
        device = resolve_device(device)
        backend = dist.get_backend()
        gloo_on_card = over_seq and data == 1 and backend == "gloo" and device.type == "cuda"
        if (backend == "nccl") != (device.type == "cuda") and not gloo_on_card:
            raise ValueError(f"a {backend} process group cannot run a mesh on {device}: "
                             "NCCL needs CUDA tensors, gloo CPU tensors (a gloo group runs "
                             "CUDA meshes only with data 1 and the seq axis over the processes)")
        if not over_seq:
            return Mesh(data, seq, device, dist.group.WORLD, dist.get_rank())
        return _seq_process_mesh(dist, data, seq, device)
    device = resolve_device(device)
    if seq is None:
        n = torch.cuda.device_count() if device.type == "cuda" else 1
        if n % data != 0:
            raise ValueError(f"{n} devices not divisible by data={data}")
        seq = n // data
    return Mesh(data, seq, device)


def _seq_process_mesh(dist, data: int, seq: int, device) -> Mesh:
    """Both axes over the processes: this process's data and seq groups,
    made by every process in the same order."""
    me = dist.get_rank()
    d, s = divmod(me, seq)
    data_group = None
    if data > 1:
        for col in range(seq):
            g = dist.new_group([row * seq + col for row in range(data)])
            data_group = g if col == s else data_group
    seq_group = None
    for row in range(data):
        g = dist.new_group([row * seq + col for col in range(seq)], backend="gloo")
        seq_group = g if row == d else seq_group
    peer = None
    if device.type == "cuda":
        from omnivggt_tpu_torch.parallel.peer import PeerMemory

        peer = PeerMemory(seq_group, s, seq, device)
    return Mesh(data, seq, device, data_group, d, seq_group, s, peer)


def multihost_initialize(*, device=None, backend: Optional[str] = None,
                         init_method: Optional[str] = None, world_size: Optional[int] = None,
                         rank: Optional[int] = None, local_rank: Optional[int] = None,
                         timeout: float = 1800.0) -> torch.device:
    """Bring up the default torch.distributed process group, one process
    per data rank, and return this process's device.

    device: "cuda" (the default: NCCL, the process's card is
    cuda:LOCAL_RANK) or "cpu" (gloo). backend overrides the choice. The
    rendezvous comes from the arguments, else from the environment that
    torchrun sets (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE, LOCAL_RANK:
    init_method "env://"). timeout (seconds) bounds the rendezvous and
    every collective, so a wrong address fails in that time.

    Only "already initialised" is tolerated (the group is kept); any other
    failure raises. Swallowing it would silently degrade a job of N
    processes to N independent ones, each training on its own batch."""
    import torch.distributed as dist

    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if local_rank is None:
            local_rank = int(os.environ.get("LOCAL_RANK", "0"))
        device = resolve_device(torch.device("cuda", local_rank))
    if dist.is_initialized():
        return device
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    kwargs = {}
    if world_size is not None:
        kwargs["world_size"] = world_size
    if rank is not None:
        kwargs["rank"] = rank
    if backend == "nccl":
        kwargs["device_id"] = device
    dist.init_process_group(backend, init_method=init_method or "env://",
                            timeout=datetime.timedelta(seconds=timeout), **kwargs)
    return device


@contextlib.contextmanager
def process_group(device):
    """An entry point's device. Started by torchrun (RANK and WORLD_SIZE in
    the environment), the process group comes up from its environment
    (multihost_initialize on `device`) and this process's device is
    yielded; it is destroyed on the way out. Otherwise `device` itself is
    yielded. Either way resolved, with TF32 off (utils/platform)."""
    import torch.distributed as dist

    from omnivggt_tpu_torch.utils.platform import ensure_platform

    launched = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    dev = ensure_platform(multihost_initialize(device=device) if launched else device)
    try:
        yield dev
    finally:
        if launched:
            dist.destroy_process_group()


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
    mesh: every tensor or array leaf of two or more dimensions moves to
    the mesh's device. With the data axis over processes this process
    keeps its B / data scenes of each such leaf (B is the global batch);
    logical ranks keep the whole batch, whose ranks' shards are slices
    taken where a strategy needs them. The frames stay whole when the seq
    axis lies over processes too: the forward takes this process's own
    (models/omnivggt.apply). Other leaves pass through."""
    if isinstance(tree, dict):
        return {k: shard_batch(mesh, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_batch(mesh, v) for v in tree)
    if hasattr(tree, "ndim") and tree.ndim >= 2:
        x = torch.as_tensor(tree)
        if mesh.group is not None:
            if x.shape[0] % mesh.data:
                raise ValueError(f"batch {x.shape[0]} does not divide over {mesh.data} data ranks")
            b = x.shape[0] // mesh.data
            x = x[mesh.rank * b:(mesh.rank + 1) * b]
        return x.to(mesh.device)
    return tree
