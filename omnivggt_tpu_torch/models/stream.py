"""The key/value cache of a frame-causal stream (StreamVGGT, arXiv
2507.11539; `OmniVGGTConfig.global_attention="frame_causal"`).

A stream answers one frame at a time. Frame t's tokens attend, in every
global block, to the tokens of frames 0..t; the keys and values of the
earlier frames are kept here, per global layer, as the model's memory of
the clip. The camera head's trunk, which attends over frames, keeps its own
per (iteration, trunk layer). Every buffer is allocated once, for
`capacity` frames, and a frame's keys and values are written into its slot
in place: a step allocates nothing that grows with the clip, and the
attention reads a prefix view of the buffer (no concatenation).

  - `StreamState`: the buffers and the count of frames filled; `reset()`
    starts a new clip in the same buffers;
  - `LayerCache`: one layer's view for the frame being run: `append(k, v)`
    writes the frame's keys and values into its slot and returns the
    prefix of frames 0..t that its attention reads.

A step runs one frame, so its kernels are small and eager PyTorch would
spend more time launching them than the card spends running them. On CUDA
the parts of a step whose shapes do not change from frame to frame (DINOv2,
each layer's frame block with the global block's projections before its
attention, each global block after it, each DPT head) are captured into
CUDA graphs at the stream's first frame and replayed after it
(`StreamState.replay`); the cache writes and the attention over the cache,
whose key count grows each frame, and the camera head's trunk run eagerly
between them.
"""

from __future__ import annotations

import torch

from omnivggt_tpu_torch.config import OmniVGGTConfig
from omnivggt_tpu_torch.utils.profiling import span


class LayerCache:
    """One layer's keys and values, (1, capacity * tokens, heads, head_dim)
    each, with the slot [start, stop) of the frame being run."""

    __slots__ = ("k", "v", "start", "stop")

    def __init__(self, k: torch.Tensor, v: torch.Tensor, start: int, stop: int):
        self.k, self.v, self.start, self.stop = k, v, start, stop

    def append(self, k: torch.Tensor, v: torch.Tensor):
        """Write the frame's (1, tokens, heads, head_dim) keys and values
        into its slot; returns the prefix (keys, values) of every frame up
        to and including this one: strided views of the buffers."""
        with span("stream.cache_append", bytes=2 * k.numel() * k.element_size()):
            self.k[:, self.start:self.stop].copy_(k)
            self.v[:, self.start:self.stop].copy_(v)
        return self.k[:, :self.stop], self.v[:, :self.stop]


class StreamState:
    """The caches of one stream of frames of `image_hw` on `device`:

      - `k`, `v`: (depth, capacity * P, heads, head_dim) in the trunk dtype,
        P = the tokens of a frame (camera, registers, patches);
      - `camera_k`, `camera_v`: (iterations, trunk depth, capacity, heads,
        head_dim) in the head dtype, one pose token a frame;
      - `filled`: the frames written so far, a host int.

    graphs: on CUDA, replay the step's fixed-shape parts as CUDA graphs
    (`replay`); False launches them op by op, as on the CPU (a state used
    for one clip only, whose captures would not be replayed enough to pay).
    """

    def __init__(self, cfg: OmniVGGTConfig, capacity: int, image_hw, device,
                 graphs: bool = True):
        if capacity < 1:
            raise ValueError(f"a stream holds at least one frame, got capacity {capacity}")
        a, c = cfg.aggregator, cfg.camera_head
        H, W = image_hw
        self.image_hw = (int(H), int(W))
        self.tokens_per_frame = a.patch_start_idx + (H // a.patch_size) * (W // a.patch_size)
        self.capacity = int(capacity)
        self.filled = 0
        head_dim = a.embed_dim // a.num_heads
        self.k = torch.empty((a.depth, capacity * self.tokens_per_frame, a.num_heads, head_dim),
                             dtype=cfg.trunk_dtype, device=device)
        self.v = torch.empty_like(self.k)
        self.camera_k = torch.empty(
            (c.num_iterations, c.trunk_depth, capacity, c.num_heads, c.dim_in // c.num_heads),
            dtype=cfg.heads_dtype, device=device)
        self.camera_v = torch.empty_like(self.camera_k)
        self.constants = {}
        self._graphs = {}
        self._pool = torch.cuda.graph_pool_handle() if graphs and self.k.is_cuda else None

    def reset(self) -> None:
        """Start a new clip: the buffers stay, their contents are written
        anew frame by frame."""
        with span("stream.reset", frames=self.filled):
            self.filled = 0

    def check_frame(self, image_hw) -> None:
        """Raise unless one more frame of `image_hw` fits."""
        if tuple(int(x) for x in image_hw) != self.image_hw:
            raise ValueError(f"this stream holds frames of {self.image_hw}, got {tuple(image_hw)}")
        if self.filled >= self.capacity:
            raise ValueError(f"the stream is full: {self.capacity} frames; reset() it "
                             "or make one with a larger capacity")

    def constant(self, key, make):
        """make()'s value, made at the first call with `key` and the same
        tensors after it (what the captured graphs read stays in place)."""
        if key not in self.constants:
            self.constants[key] = make()
        return self.constants[key]

    def replay(self, key, fn, *inputs):
        """fn(*inputs), a tuple of tensors from tensors. On CUDA the first
        call with `key` runs fn once on a side stream (its lazy set-up),
        then captures it into a CUDA graph over these inputs, on the
        stream's memory pool; every call copies its inputs into the
        captured ones (those it is not already) and replays the graph. The
        outputs are the graph's own buffers, rewritten by its next replay.
        The graphs are captured and replayed in the same order, frame after
        frame, which is what lets them share the pool. Elsewhere fn(*inputs)."""
        if self._pool is None:
            return fn(*inputs)
        entry = self._graphs.get(key)
        if entry is None:
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                fn(*inputs)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=self._pool):
                out = fn(*inputs)
            entry = self._graphs[key] = (graph, inputs, out)
        graph, captured, out = entry
        for held, x in zip(captured, inputs):
            if held is not x:
                held.copy_(x)
        graph.replay()
        return out

    def global_layer(self, i: int) -> LayerCache:
        """Global block i's cache for the frame being run."""
        P = self.tokens_per_frame
        return LayerCache(self.k[i:i + 1], self.v[i:i + 1], self.filled * P,
                          (self.filled + 1) * P)

    def camera_layer(self, iteration: int, j: int) -> LayerCache:
        """The camera head's trunk layer j, at `iteration`, for the frame
        being run (one token a frame)."""
        return LayerCache(self.camera_k[iteration, j][None], self.camera_v[iteration, j][None],
                          self.filled, self.filled + 1)
