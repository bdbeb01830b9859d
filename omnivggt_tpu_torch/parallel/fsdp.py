"""ZeRO-2 / FSDP training-state sharding (counterpart of
omnivggt_tpu/parallel/fsdp.py).

The JAX package annotates each large state leaf as sharded over the whole
(data, seq) mesh and lets GSPMD insert the collectives. Here the same
layouts are held by hand, with the collectives of parallel/collectives.py:

    mode   params                 grads                          AdamW moments
    none   replicated             all-reduced over processes     replicated
    zero2  replicated             reduce-scattered onto shards   per shard
    fsdp   per shard, gathered    reduce-scattered (the gather's  per shard
           at use, then freed     backward)

A sharded tensor splits along one dim into `mesh.size` equal chunks,
rank-major: rank (d, s) holds chunk d * seq + s (parallel/collectives.py),
and a process the chunks of the ranks it runs (`mesh.own_ranks`: all of
them on logical ranks, its data rank's slab over data processes, one chunk
over seq processes); each chunk is a tensor of its own.
Under fsdp a transformer block's sharded parameters are gathered by a
forward pre-hook on its module (ops/layers.block runs it) and released by
its forward hook: per DINOv2 block, per aggregator frame and global block
(finer than the JAX package's layer pair), and once a call for the camera
head, which runs its trunk once an iteration (`REPEATED_STACKS`).
remat's recomputation gathers again. Everything else (embeddings, tokens,
the adapters, the heads) is one group, gathered for the whole step. A
group is gathered, and its gradients reduce-scattered in the backward, as
one flat collective (collectives.gather_shards), so over seq processes a
block costs two barriers a gather and not two a tensor; a gather returns
tensors of their own, never views of the peer buffer that the next one
overwrites. Every process runs the same graph, so under remat they issue
the same gathers and reduce-scatters in the same order.

Which dim a tensor shards on is decided from the JAX leaf it belongs to.
The JAX package stacks the aggregator's 24 frame and global blocks, the
DINOv2 blocks, the camera-head trunk and the pose embeddings / camera
adapters along a leading layer axis and keeps linear weights (in, out) and
convolutions HWIO; the port holds one tensor per layer in torch's layouts
(checkpoint.params_from_jax). So `tree_specs` rebuilds each tensor's JAX
leaf shape (the stack in front, the axes permuted back), applies
`spec_for_leaf` to it (also its `_MIN_SHARD_ELEMS` threshold, judged on the
stacked leaf) and maps the chosen axis to the port tensor's dim. Where the
JAX package would shard the layer axis itself, the port tensor stays
replicated; no leaf of the flagship or the tiny config does so at 1 to 8
ranks, so the bytes per device equal the JAX package's in every mode.

The JAX optimizer state also holds two int32 step counts on the device;
the port's counts live on the host, so `state_bytes_per_device` counts the
parameters and the two AdamW moments of each.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from omnivggt_tpu_torch.ops import layers as L
from omnivggt_tpu_torch.parallel import collectives as C
from omnivggt_tpu_torch.parallel.mesh import Mesh

# leaves below this element count stay replicated: a (1024,) bias sharded 8
# ways saves 3.5 KB a rank but costs a collective per use
_MIN_SHARD_ELEMS = 1 << 16

STATE_SHARDING_MODES = ("none", "zero2", "fsdp")
# the components under which the JAX package stacks per-layer parameters
STACKED_KEYS = ("blocks", "frame_blocks", "global_blocks", "trunk", "pose_embeddings",
                "camera_adapters")
# the stacked blocks that their owner runs more than once a call (the
# camera head's trunk, once an iteration): fsdp gathers the owner's
# sharded parameters as one group a call, not a group a block call
REPEATED_STACKS = ("trunk",)


def check_mode(mode: str) -> None:
    if mode not in STATE_SHARDING_MODES:
        raise ValueError(f"state_sharding={mode!r}; expected one of {STATE_SHARDING_MODES}")


def spec_for_leaf(shape, n_dev: int, min_elems: Optional[int] = None) -> Optional[int]:
    """The dim of `shape` to shard over n_dev ranks: the largest one that
    n_dev divides, ties going to the last; None (replicated) if none does
    or the leaf has fewer than min_elems elements."""
    if min_elems is None:
        min_elems = _MIN_SHARD_ELEMS
    if math.prod(shape) < min_elems:
        return None
    best, best_size = None, 0
    for i, s in enumerate(shape):
        if s % n_dev == 0 and s >= best_size:
            best, best_size = i, s
    return best


def jax_leaf_layouts(model: nn.Module) -> Dict[str, Tuple[tuple, tuple]]:
    """{parameter name: (shape of the JAX leaf it belongs to, the port dim
    of each JAX axis)}; the layer axis of a stacked leaf maps to None."""
    names = [n for n, _ in model.named_parameters()]
    depths: Dict[tuple, int] = {}
    for name in names:
        stack = _stack_of(name)
        if stack is not None:
            prefix, i = stack
            depths[prefix] = max(depths.get(prefix, 0), i + 1)
    out = {}
    for mname, module in model.named_modules():
        for pname, p in module.named_parameters(recurse=False):
            name = f"{mname}.{pname}" if mname else pname
            if pname == "weight" and isinstance(module, nn.Linear):
                axes = (1, 0)  # (in, out)
            elif pname == "weight" and isinstance(module, nn.Conv2d):
                axes = (2, 3, 1, 0)  # HWIO
            else:
                axes = tuple(range(p.ndim))
            shape = tuple(p.shape[a] for a in axes)
            stack = _stack_of(name)
            if stack is not None:
                shape, axes = (depths[stack[0]],) + shape, (None,) + axes
            out[name] = (shape, axes)
    return out


def _stack_of(name: str):
    """(prefix, layer index) of a parameter in a stacked component."""
    parts = name.split(".")
    for i, part in enumerate(parts[:-1]):
        if part in STACKED_KEYS and parts[i + 1].isdigit():
            return tuple(parts[: i + 1]), int(parts[i + 1])
    return None


def tree_specs(model: nn.Module, n_dev: int, min_elems: Optional[int] = None
               ) -> Dict[str, Optional[int]]:
    """{parameter name: the dim it shards on over n_dev ranks, or None}."""
    specs = {}
    for name, (shape, axes) in jax_leaf_layouts(model).items():
        axis = spec_for_leaf(shape, n_dev, min_elems)
        specs[name] = None if axis is None else axes[axis]
    return specs


def _ranks(mesh) -> int:
    return mesh.size if isinstance(mesh, Mesh) else int(mesh)


def state_shardings(model: nn.Module, mesh, mode: str, min_elems: Optional[int] = None
                    ) -> Dict[str, Tuple[Optional[int], Optional[int]]]:
    """{parameter name: (the parameter's sharded dim, its moments')} under
    `mode` over `mesh` (a Mesh or a rank count): parameters shard under
    fsdp only, moments under zero2 and fsdp."""
    check_mode(mode)
    return {name: (spec if mode == "fsdp" else None, spec if mode != "none" else None)
            for name, spec in tree_specs(model, _ranks(mesh), min_elems).items()}


def state_bytes_per_device(model: nn.Module, mesh, mode: str,
                           min_elems: Optional[int] = None) -> int:
    """Steady-state training-state bytes a rank holds under `mode` (the
    parameters and their two AdamW moments; not activations, not the
    gradients of the backward). `model` may be on the meta device."""
    n = _ranks(mesh)
    shapes = dict(model.named_parameters())
    total = 0
    for name, (param_dim, moment_dim) in state_shardings(model, n, mode, min_elems).items():
        nbytes = shapes[name].numel() * shapes[name].element_size()
        total += nbytes // n if param_dim is not None else nbytes
        total += 2 * (nbytes // n if moment_dim is not None else nbytes)
    return total


class StateLayout:
    """A model's parameters laid out over `mesh` under `mode` ("zero2" or
    "fsdp"); made by shard_state. `shards[name]` holds this process's
    chunks of each sharded parameter: views of the parameter under zero2,
    parameters of their own (the autograd leaves) under fsdp, where the
    model's own entry is an empty placeholder between gathers."""

    def __init__(self, model: nn.Module, mesh: Mesh, mode: str, min_elems: Optional[int] = None):
        if mode not in ("zero2", "fsdp"):
            raise ValueError(f"a StateLayout is for zero2 or fsdp, not {mode!r}")
        self.model, self.mesh, self.mode = model, mesh, mode
        self.specs = {n: d for n, d in tree_specs(model, mesh.size, min_elems).items()
                      if d is not None}
        self.params = dict(model.named_parameters())
        self.shards: Dict[str, List[torch.Tensor]] = {}
        self._owners = {}
        self._placeholders = {}
        for name, dim in self.specs.items():
            p = self.params[name]
            pieces = self.local_pieces(name, p.detach())
            if mode == "zero2":
                self.shards[name] = pieces
                continue
            self.shards[name] = [nn.Parameter(c.clone()) for c in pieces]
            prefix, _, pname = name.rpartition(".")
            owner = model.get_submodule(prefix)
            self._owners[name] = (owner, pname)
            self._placeholders[name] = nn.Parameter(p.new_empty(0), requires_grad=False)
            owner._parameters[pname] = self._placeholders[name]
            del self.params[name]
        # {module name: the sharded parameters its call gathers}: each
        # L.Block, except those of a module that owns one of
        # REPEATED_STACKS, which is one group for the call, so that a
        # block's gradient sums its uses before the reduce-scatter, in the
        # order state "none" accumulates them
        self.block_groups: Dict[str, List[str]] = {}
        if mode == "fsdp":
            grouped = set()
            for mname, module in model.named_modules():
                repeats = any(c in REPEATED_STACKS for c, _ in module.named_children())
                if not (isinstance(module, L.Block) or repeats):
                    continue
                names = [n for n in self.specs if n.startswith(mname + ".") and n not in grouped]
                if names:
                    self.block_groups[mname] = names
                    grouped.update(names)
                    module.register_forward_pre_hook(
                        lambda m, args, names=names: self.gather(names))
                    module.register_forward_hook(
                        lambda m, args, out, names=names: self.release(names))
            self.rest = [n for n in self.specs if n not in grouped]

    def local_pieces(self, name: str, full: torch.Tensor) -> List[torch.Tensor]:
        """This process's chunks of `full` (views): chunk i of the mesh's
        `size` for each rank i it runs."""
        dim = self.specs[name]
        n = full.shape[dim] // self.mesh.size
        return [full.narrow(dim, i * n, n) for i in self.mesh.own_ranks]

    def full_tensor(self, name: str, pieces) -> torch.Tensor:
        """The whole tensor from this process's `pieces` and every other
        process's (a gather over processes)."""
        return C.all_gather(pieces, self.mesh, self.specs[name])

    # fsdp: gathers at use
    def gather(self, names) -> None:
        """The group's sharded parameters whole, one flat collective."""
        if not names:
            return
        fulls = C.gather_shards([self.shards[n] for n in names], self.mesh,
                                [self.specs[n] for n in names])
        for name, full in zip(names, fulls):
            owner, pname = self._owners[name]
            owner._parameters[pname] = full

    def release(self, names) -> None:
        for name in names:
            owner, pname = self._owners[name]
            owner._parameters[pname] = self._placeholders[name]

    @contextlib.contextmanager
    def gathered_rest(self):
        """The parameters outside the blocks gathered for a step's forward
        and backward; every sharded parameter released after it."""
        if self.mode != "fsdp":
            yield
            return
        self.gather(self.rest)
        try:
            yield
        finally:
            self.release(self.specs)

    # the gradient sync and the update (train/step.py)
    def sync_grads(self) -> None:
        """Gradients summed over the ranks: zero2 reduce-scatters the
        sharded parameters' onto their shards (one flat collective over the
        seq processes; fsdp did so in the backward), and the replicated
        parameters' are summed over the seq processes (seq_all_reduce_sum,
        in rank order), then all-reduced over the data ranks, as state
        "none" sums them. One the forward did not reach gets zeros, so every
        process passes the same tensors."""
        for p in self.params.values():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        sharded = [n for n in self.params if n in self.specs]  # zero2
        if sharded:
            chunks = C.reduce_scatter_many([self.params[n].grad for n in sharded], self.mesh,
                                           [self.specs[n] for n in sharded])
            for name, cs in zip(sharded, chunks):
                for shard, g in zip(self.shards[name], cs):
                    shard.grad = g
                self.params[name].grad = None
        grads = [p.grad for n, p in self.params.items() if n not in self.specs]
        if self.mesh.seq_processes:
            C.seq_all_reduce_sum(grads, self.mesh)
        for g in grads:
            C.all_reduce_sum(g, self.mesh)

    @torch.no_grad()
    def gather_params(self) -> None:
        """zero2: every rank's updated shards gathered back into the
        replicated parameters, in groups of at most collectives'
        SEQ_BUCKET_ELEMS elements (one flat collective each over the seq
        processes; a group's whole tensors are the only copy it adds)."""
        names = list(self.specs)
        sizes = [self.params[n].numel() for n in names]
        for members, _ in C.state_buckets(sizes, max(sizes + [C.SEQ_BUCKET_ELEMS])):
            group = [names[i] for i, _ in members]
            fulls = C.all_gather_many([self.shards[n] for n in group], self.mesh,
                                      [self.specs[n] for n in group])
            for name, full in zip(group, fulls):
                self.params[name].copy_(full)

    def zero_grad(self) -> None:
        for shards in self.shards.values():
            for s in shards:
                s.grad = None

    # checkpoints
    @torch.no_grad()
    def full_state_dict(self, place: Optional[Callable] = None) -> Dict[str, torch.Tensor]:
        """The model's state dict with every sharded parameter whole.
        place: applied to each gathered tensor as soon as it is whole, its
        result kept instead (a copy on the host, or None to drop it), so
        that one gathered tensor at a time lies on the device."""
        place = place or (lambda t: t)
        sd = self.model.state_dict()
        if self.mode == "fsdp":
            for name in self.specs:
                sd[name] = place(self.full_tensor(name, [s.detach() for s in self.shards[name]]))
        return sd

    @torch.no_grad()
    def load_full_state_dict(self, sd: Dict[str, torch.Tensor]) -> None:
        """Load whole tensors (a state dict in the unsharded layout)."""
        own = set(self.params) | set(self.specs)
        if set(sd) != own:
            raise KeyError(f"state dict keys differ: missing {sorted(own - set(sd))[:5]}, "
                           f"unexpected {sorted(set(sd) - own)[:5]}")
        for name, value in sd.items():
            if name in self.params:
                self.params[name].copy_(value)
            else:
                for shard, piece in zip(self.shards[name], self.local_pieces(name, value)):
                    shard.copy_(piece)


def shard_state(state, mesh: Mesh, mode: str, min_elems: Optional[int] = None):
    """Lay a TrainState (train/step.py) out over `mesh` under `mode`, in
    place: its model's parameters (fsdp) and its optimizer's moments
    (zero2, fsdp, re-sharded if the optimizer has stepped) held as this
    process's shards. "none" leaves the state as it is. Returns the state."""
    check_mode(mode)
    if state.layout is not None:
        raise ValueError(f"the state is already laid out ({state.layout.mode})")
    if mode == "none":
        return state
    layout = StateLayout(state.model, mesh, mode, min_elems)
    state.optimizer.use_layout(layout)
    state.layout = layout
    return state


def sharded_init(build_model: Callable[[], nn.Module], build_optimizer: Callable, mesh: Mesh,
                 mode: str, min_elems: Optional[int] = None):
    """A TrainState built from the seed and laid out under `mode`:
    build_model() -> the model, build_optimizer(model) -> its Optimizer.
    The model is built whole (the flagship's replicated fp32 state, 19.5
    GB with moments, fits one 80 GB card) and then keeps only its shards;
    the values are bitwise those of the unsharded init."""
    from omnivggt_tpu_torch.train.step import init_state

    check_mode(mode)
    model = build_model()
    return shard_state(init_state(model, build_optimizer(model)), mesh, mode, min_elems)
