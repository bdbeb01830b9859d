"""The frozen analytic counts of a frame-causal stream (the cell
stream-s256): the operations of one frame's step and the least time of its
attention, by the rules of `flops.py` (a multiply-add is 2; attention
counts its two products; bf16 Q, K, V, O read or written once; the card's
peaks are `flops.py`'s).

A step runs one frame with `cached` frames before it in the clip:

  - the frame's own work, the whole model at S = 1 (`flops.forward_flops`)
    less the attention of its global blocks and of the camera head's trunk
    over that one frame;
  - its global blocks' attention: P query rows against the (cached + 1) P
    keys of frames 0..t, 4 P (cached + 1) P C operations a layer;
  - the camera head's trunk: one pose token against cached + 1 keys a
    layer and iteration.

The forward spans' `bound_s` and `flops` (set by `run.py` for a whole scene
of the span's frames) do not describe a step; the stream's readers take
theirs from here.
"""

from __future__ import annotations

from typing import List, Tuple

from portbench import flops


def tokens_per_frame(arch: dict, H: int, W: int) -> int:
    ps = arch["patch_size"]
    return 1 + arch["num_register_tokens"] + (H // ps) * (W // ps)


def _camera_attn(arch: dict, keys: int) -> float:
    c = arch["camera_head"]
    return c["num_iterations"] * c["trunk_depth"] * flops._attn(1, keys, 2 * arch["embed_dim"])


def step_flops(arch: dict, cached: int, H: int, W: int) -> float:
    """Operations of one frame's step with `cached` frames before it."""
    P, C, L = tokens_per_frame(arch, H, W), arch["embed_dim"], arch["depth"]
    own = flops.forward_flops(arch, 1, H, W) - L * flops._attn(P, P, C) - _camera_attn(arch, 1)
    return own + L * flops._attn(P, (cached + 1) * P, C) + _camera_attn(arch, cached + 1)


def attention_calls(arch: dict, cached: int, H: int, W: int) -> List[Tuple[int, int, int, int, int]]:
    """(calls, query rows, keys, width, heads) of a step's attention over
    image tokens (frame, global over the cache, DINOv2), as
    `flops.attention_calls` lists a scene's; the camera head's is left
    out."""
    frame, glob, *dino = flops.attention_calls(arch, 1, H, W)
    calls, P, _, C, heads = glob
    return [frame, (calls, P, (cached + 1) * P, C, heads), *dino]


def attention_bound_s(arch: dict, cached: int, H: int, W: int) -> float:
    """Least time of a step's attention calls on the card: for each call
    max(operations / bf16 peak, bytes / HBM bandwidth), Q and O of the
    frame and K and V of the keys it reads once each."""
    total = 0.0
    for calls, nq, nk, C, _ in attention_calls(arch, cached, H, W):
        ops = flops._attn(nq, nk, C)
        nbytes = 2.0 * C * (2 * nq + 2 * nk)
        total += calls * max(ops / flops.PEAK_BF16_FLOPS, nbytes / flops.PEAK_HBM_BYTES)
    return total


def clip_flops(arch: dict, frames: int, H: int, W: int) -> float:
    """Operations of a clip of `frames` frames, step by step."""
    return sum(step_flops(arch, t, H, W) for t in range(frames))
