"""Sharded streaming input pipeline (counterpart of
omnivggt_tpu/data/streaming.py), standard library and numpy.

SceneDataset (data/dataset.py) loads and preprocesses whole scenes in the
training process: right for a handful of scenes, wrong for corpora that are
preprocessed once and then streamed. This module is the webdataset-style
answer:

  - `write_shards`: serialise an iterator of sample dicts (str -> ndarray,
    e.g. SceneDataset.sample's) into numbered tar shards of .npz members
    (the JAX package's members, names and payloads: each package reads the
    other's shards).
  - `ShardedSampleStream`: each process streams the shards assigned to it
    (round-robin by rank over the shard list after a per-epoch shuffle),
    decodes the .npz members and mixes them through a bounded shuffle
    buffer; endless epochs or one pass; deterministic under a seed.
  - `batch_stream`: stacks same-shaped samples into batches along a new
    leading axis, on a background thread (dataset.prefetch).

Tools: `python -m omnivggt_tpu_torch.tools.make_shards` writes shards from
a scene root; `python -m omnivggt_tpu_torch.tools.train --shards` streams
them.
"""

from __future__ import annotations

import glob
import io
import os
import tarfile
from typing import Dict, Iterable, Iterator, List, Optional

import numpy as np


def write_shards(
    samples: Iterable[Dict[str, np.ndarray]],
    out_dir: str,
    samples_per_shard: int = 256,
    prefix: str = "shard",
) -> List[str]:
    """Write samples into `{out_dir}/{prefix}-{i:06d}.tar` files of .npz
    members `sample-{n:09d}.npz`. Returns the shard paths.

    Samples meant for `batch_stream` use the SceneDataset layout: multi-axis
    arrays carry a leading batch dim of 1 ((1, S, H, W, 3) images, (1, S, 3,
    4) extrinsics; S=1 scenes are (1, 1, ...)), per-frame masks are 1-D
    (S,). batch_stream strips exactly that leading 1; an array in another
    layout whose first dim happens to be 1 would lose a real axis."""
    os.makedirs(out_dir, exist_ok=True)
    paths: List[str] = []
    tar = None
    count = 0

    def open_next() -> tarfile.TarFile:
        path = os.path.join(out_dir, f"{prefix}-{len(paths):06d}.tar")
        paths.append(path)
        return tarfile.open(path, "w")

    try:
        for i, sample in enumerate(samples):
            if tar is None or count >= samples_per_shard:
                if tar is not None:
                    tar.close()
                tar = open_next()
                count = 0
            buf = io.BytesIO()
            np.savez(buf, **sample)
            data = buf.getvalue()
            info = tarfile.TarInfo(name=f"sample-{i:09d}.npz")
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))
            count += 1
    finally:
        if tar is not None:
            tar.close()
    return paths


class ShardedSampleStream:
    """Iterate samples from tar shards, partitioned across processes.

    Args:
        pattern: glob of the shard files (e.g. "shards/shard-*.tar").
        shard_rank / num_shards: this process's partition (default: the
            rank and world size of an initialised torch.distributed process
            group, else 0 / 1). Shards are assigned round-robin after the
            per-epoch shuffle, so each rank sees a different, changing
            subset while the union covers every shard; with fewer shards
            than ranks, a rank wraps onto shard rank % n.
        shuffle_buffer: size of the in-memory mixing buffer (0 or 1: in
            order).
        shuffle_shards: reshuffle the shard order every epoch (apart from
            the sample buffer; turn off for in-order evaluation sweeps).
        seed: base seed; the epoch is folded in: the shard order draws from
            numpy's default_rng((seed, epoch)), the buffer from
            default_rng((seed, rank, epoch)), as in the JAX package.
        repeat: loop forever (training) or stop after one pass.
    """

    def __init__(
        self,
        pattern: str,
        shard_rank: Optional[int] = None,
        num_shards: Optional[int] = None,
        shuffle_buffer: int = 0,
        shuffle_shards: bool = True,
        seed: int = 0,
        repeat: bool = True,
    ):
        self.paths = sorted(glob.glob(pattern))
        if not self.paths:
            raise ValueError(f"no shards match {pattern!r}")
        if shard_rank is None or num_shards is None:
            shard_rank, num_shards = _default_partition()
        if not 0 <= shard_rank < num_shards:
            raise ValueError(f"shard_rank {shard_rank} not in [0,{num_shards})")
        self.rank = shard_rank
        self.world = num_shards
        self.shuffle_buffer = shuffle_buffer
        self.shuffle_shards = shuffle_shards
        self.seed = seed
        self.repeat = repeat

    def _epoch_paths(self, epoch: int) -> List[str]:
        order = np.arange(len(self.paths))
        if self.shuffle_shards:
            np.random.default_rng((self.seed, epoch)).shuffle(order)
        mine = order[self.rank :: self.world]
        if len(mine) == 0:
            # fewer shards than ranks: wrap so every rank has input
            mine = order[[self.rank % len(order)]]
        return [self.paths[i] for i in mine]

    def _read_shard(self, path: str) -> Iterator[Dict[str, np.ndarray]]:
        with tarfile.open(path, "r") as tar:
            for member in tar:
                if not member.isfile() or not member.name.endswith(".npz"):
                    continue
                f = tar.extractfile(member)
                if f is None:
                    continue
                with np.load(io.BytesIO(f.read()), allow_pickle=False) as z:
                    yield {k: z[k] for k in z.files}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        epoch = 0
        while True:
            rng = np.random.default_rng((self.seed, self.rank, epoch))
            buf: List[Dict[str, np.ndarray]] = []
            for path in self._epoch_paths(epoch):
                for sample in self._read_shard(path):
                    if self.shuffle_buffer <= 1:
                        yield sample
                        continue
                    buf.append(sample)
                    if len(buf) >= self.shuffle_buffer:
                        j = int(rng.integers(len(buf)))
                        buf[j], buf[-1] = buf[-1], buf[j]
                        yield buf.pop()
            while buf:
                j = int(rng.integers(len(buf)))
                buf[j], buf[-1] = buf[-1], buf[j]
                yield buf.pop()
            if not self.repeat:
                return
            epoch += 1


def batch_stream(
    stream: Iterable[Dict[str, np.ndarray]],
    batch_size: int,
    prefetch_depth: int = 2,
) -> Iterator[Dict[str, np.ndarray]]:
    """Stack `batch_size` same-shaped samples along a new leading axis and
    prefetch the batches on a background thread. Samples use the
    SceneDataset layout (see write_shards): the leading 1 of multi-axis
    arrays is squeezed before stacking, 1-D masks are stacked as they are.
    Samples of other resolutions or view counts go to their own bucket
    (keyed by every array's name, shape and dtype); when the stream ends,
    each unfilled bucket is flushed as a smaller batch.

    Ranks streaming different shards can meet different shapes at the same
    step; synchronised multi-process training needs shards of one shape."""
    from omnivggt_tpu_torch.data.dataset import prefetch

    def squeeze(g, k):
        x = g[k]
        # only multi-axis arrays carry a (1, S, ...) batch dim; a (1,) mask
        # of a one-view sample must stack to (B, 1), not (B,)
        return x[0] if (x.ndim >= 2 and x.shape[0] == 1) else x

    def stack(group):
        return {k: np.stack([squeeze(g, k) for g in group]) for k in group[0]}

    def batches():
        buckets: Dict[tuple, list] = {}
        for sample in stream:
            key = tuple(sorted((k, v.shape, str(v.dtype)) for k, v in sample.items()))
            group = buckets.setdefault(key, [])
            group.append(sample)
            if len(group) >= batch_size:
                yield stack(group)
                buckets[key] = []
        for group in buckets.values():
            if group:
                yield stack(group)

    return prefetch(batches(), depth=prefetch_depth)


def _default_partition():
    """(rank, world size) of an already initialised torch.distributed
    process group, else (0, 1). Never initialises one: a data reader must
    not join a group as a side effect."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1
