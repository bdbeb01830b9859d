"""Seeded weights under the published state-dict names, made on the device.

One state dict feeds both sides: the program under test loads it strictly
and the reference loads the same values, drawn again from the same seed.
The values come from one `torch.Generator` on the device, in a few large
draws (groups of at most GROUP_ELEMS elements, in the state dict's order),
so a seed gives the same tensors on every run on one kind of device.

The trunk's distribution is variance preserving, unlike the published
initialisation (zero adapters, LayerScale 0.01), so every layer of the
embedder and the aggregator, the GT cameras and depth included, moves the
answer. The heads' input LayerNorms (camera_head.token_norm and the DPT
heads' norm) have a small gain, HEAD_INPUT_GAIN, and unit biases: a head
sees a learned constant plus a few percent of the trunk's signal, and the
rest of the head is variance preserving. That is what lets the check see
the heads' precision: the bf16 trunk's rounding (about 1% of its output)
reaches the answer attenuated with the rest of the trunk's part, while
rounding inside a head does not; and a fault in the trunk still reads far
above the trunk's rounding, which it is attenuated with. Here:
  - matrices and kernels: normal, std 1 / sqrt(fan in);
  - biases: normal, std 0.02;
  - LayerNorm: weight 1 + 0.05 normal, bias 0.02 normal; the qk-norm
    weights are scaled by QK_GAIN, so attention is peaked, and stay inside
    the bound under which the program may use its fixed-max softmax; the
    heads' input norms: weight HEAD_INPUT_GAIN (1 + 0.05 normal), bias
    normal, std 1;
  - LayerScale: DINOv2 1.0, the aggregator and the camera head 0.1, each
    times 1 + 0.05 normal;
  - learned tokens normal, std 1; the DINOv2 position embedding std 0.1;
  - the camera adapters and pose embeddings random like any matrix, so GT
    cameras change the answer.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import torch

from portbench.reference.model import state_shapes

GROUP_ELEMS = 1 << 28
QK_GAIN = 1.8
HEAD_INPUT_GAIN = 0.05
HEAD_INPUTS = ("camera_head.token_norm", "depth_head.norm", "point_head.norm")
TOKENS = ("camera_token", "register_token", "register_tokens", "cls_token",
          "depth_placeholder", "empty_pose_tokens")
TRANSPOSED = ("resize_layers.0.weight", "resize_layers.1.weight")


def _rule(name: str, shape: tuple) -> Tuple[float, float]:
    """(offset, scale): the tensor is offset + scale * standard normal."""
    leaf = name.rsplit(".", 1)[-1]
    parts = name.split(".")
    if leaf in TOKENS:
        return 0.0, 1.0
    if leaf == "pos_embed":
        return 0.0, 0.1
    if leaf == "gamma":
        base = 1.0 if parts[:2] == ["aggregator", "patch_embed"] else 0.1
        return base, 0.05 * base
    head_input = name.rsplit(".", 1)[0] in HEAD_INPUTS
    if head_input:
        return (HEAD_INPUT_GAIN, 0.05 * HEAD_INPUT_GAIN) if leaf == "weight" else (0.0, 1.0)
    norm = any(p.endswith("norm") or p.startswith("norm") for p in parts[:-1])
    if norm and leaf == "weight" and len(shape) == 1:
        gain = QK_GAIN if parts[-2] in ("q_norm", "k_norm") else 1.0
        return gain, 0.05 * gain
    if leaf == "bias":
        return 0.0, 0.02
    fan_in = shape[0] if name.endswith(TRANSPOSED) else 1
    if not name.endswith(TRANSPOSED):
        for d in shape[1:]:
            fan_in *= d
    return 0.0, fan_in ** -0.5


def _groups(shapes: Dict[str, tuple]) -> Iterator[list]:
    group, n = [], 0
    for name, shape in shapes.items():
        numel = 1
        for d in shape:
            numel *= d
        if group and n + numel > GROUP_ELEMS:
            yield group
            group, n = [], 0
        group.append((name, shape, numel))
        n += numel
    if group:
        yield group


def make_state_dict(arch: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """{published name: float32 tensor on `device`} drawn from `seed`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = {}
    with torch.no_grad():
        for group in _groups(state_shapes(arch)):
            flat = torch.randn(sum(n for *_, n in group), generator=gen, device=device)
            i = 0
            for name, shape, numel in group:
                offset, scale = _rule(name, shape)
                out[name] = flat[i:i + numel].view(shape).mul_(scale).add_(offset)
                i += numel
    return out
