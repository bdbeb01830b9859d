"""Training checkpoints: save and resume (counterpart of
omnivggt_tpu/train/checkpointing.py).

The whole TrainState (model parameters, optimizer state including the
schedule's count, and the step) goes into one `torch.save` file,
`{ckpt_dir}/step_{N:08d}.pt`, written under a temporary name and renamed
into place; the newest `keep_last` files are kept. The JAX package's orbax
directories are a different format and are not read here.

A state laid out over a mesh (zero2 / fsdp, parallel/fsdp.py; its chunks
over data processes, seq processes or both) is gathered into the unsharded
layout one tensor at a time, on every process (the gathers are
collectives): the process of global rank 0 copies each whole tensor to
the host as soon as it is gathered and alone writes the file, the others
drop it, so a save holds one gathered tensor at a time on the device. A
replicated state over processes is written by global rank 0 too. Restore
reads the file on the host and copies it into the layout of the state it
loads into (each process its own chunks), so a checkpoint written sharded
restores unsharded, and the other way round, and a state is laid out
before it is restored: no process holds the whole state on the way.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from omnivggt_tpu_torch.train.step import TrainState

_PREFIX, _SUFFIX = "step_", ".pt"


def _checkpoints(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(d for d in os.listdir(ckpt_dir) if d.startswith(_PREFIX) and d.endswith(_SUFFIX))


def _writes() -> bool:
    """Whether this process writes: the only one, or global rank 0."""
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def save_train_state(ckpt_dir: str, state: TrainState, step: Optional[int] = None,
                     keep_last: int = 3) -> str:
    """Write {ckpt_dir}/step_{N}.pt and prune all but the newest keep_last.
    Under processes every process calls it (the gathers are collectives)
    and global rank 0 writes; every process returns the path."""
    step = state.step if step is None else step
    path = os.path.join(os.path.abspath(ckpt_dir), f"{_PREFIX}{step:08d}{_SUFFIX}")
    writes = _writes()
    place = (lambda t: t.cpu()) if writes else (lambda t: None)
    model = (state.layout.full_state_dict(place) if state.layout is not None
             else state.model.state_dict())
    optimizer = state.optimizer.state_dict(place)
    if not writes:
        return path
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = path + ".tmp"
    torch.save({"model": model, "optimizer": optimizer, "step": step}, tmp)
    os.replace(tmp, path)
    for stale in _checkpoints(ckpt_dir)[:-keep_last]:
        os.remove(os.path.join(ckpt_dir, stale))
    return path


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    found = _checkpoints(ckpt_dir)
    return os.path.join(os.path.abspath(ckpt_dir), found[-1]) if found else None


def restore_train_state(path: str, like: TrainState) -> TrainState:
    """Load the checkpoint at `path` into `like`'s model and optimizer (on
    the model's device, in `like`'s layout); returns `like` at the saved
    step. The file is mapped on the host and copied in tensor by tensor."""
    saved = torch.load(path, map_location="cpu", mmap=True, weights_only=True)
    if like.layout is not None:
        like.layout.load_full_state_dict(saved["model"])
    else:
        like.model.load_state_dict(saved["model"], strict=True)
    like.optimizer.load_state_dict(saved["optimizer"])
    like.step = int(saved["step"])
    return like


def resume_or_init(ckpt_dir: str, init_state: TrainState) -> TrainState:
    """Resume from the newest checkpoint in ckpt_dir, else init_state."""
    path = latest_checkpoint(ckpt_dir)
    return init_state if path is None else restore_train_state(path, init_state)
