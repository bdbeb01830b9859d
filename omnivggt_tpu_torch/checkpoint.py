"""Checkpoints: the safetensors format, the JAX parameter bridge, strict
loading, and the bf16 trunk cast (counterpart of omnivggt_tpu/checkpoint.py).

The port's modules use the reference's state-dict names, so a reference
safetensors file loads with `load_state_dict(strict=True)`. A VGGT-layout
state dict (VGGT's, StreamVGGT's) loads with `load_vggt_layout`: OmniVGGT's
own leaves (the GT-camera adapters and pose embeddings, the depth patch
embedding and placeholder) are set to zero, which makes the model compute
VGGT's forward on images alone, and the track head's leaves are skipped.
`read_safetensors` / `write_safetensors` implement the file format with
torch and numpy alone (the `safetensors` package is not needed): an 8-byte
little-endian header length, a JSON header of {name: {dtype, shape,
data_offsets}} and an optional "__metadata__" of strings, padded with
spaces to 8 bytes, then the tensors' raw little-endian bytes. The writer
lays a file out as the `safetensors` package does (largest dtype first,
then by name), so both write the same bytes for the same tensors.
`params_from_jax` is the inverse of omnivggt_tpu.checkpoint.convert_state_dict:
it turns the JAX package's parameter pytree (numpy leaves) into this
package's state dict, unstacking the per-layer stacks and transposing
(in, out) linears and HWIO convs back to torch's layouts.
"""

from __future__ import annotations

import json
import math
import os
import logging
import sys
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from omnivggt_tpu_torch.config import OmniVGGTConfig

# reference buffers that are constants here (the JAX converter drops them too)
_IGNORED_SUFFIXES = ("_resnet_mean", "_resnet_std")


class StateDictEmitter:
    """Collects state-dict entries from JAX parameter subtrees; the inverse
    of omnivggt_tpu.checkpoint._Consumer, one method per parameter kind."""

    def __init__(self):
        self.sd: Dict[str, np.ndarray] = {}

    def raw(self, name, x):
        self.sd[name] = np.asarray(x)

    def linear(self, prefix, p):
        self.raw(f"{prefix}.weight", np.asarray(p["w"]).T)
        if "b" in p:
            self.raw(f"{prefix}.bias", p["b"])

    def conv(self, prefix, p):
        self.raw(f"{prefix}.weight", np.transpose(np.asarray(p["w"]), (3, 2, 0, 1)))  # HWIO -> OIHW
        if "b" in p:
            self.raw(f"{prefix}.bias", p["b"])

    def norm(self, prefix, p):
        self.raw(f"{prefix}.weight", p["scale"])
        self.raw(f"{prefix}.bias", p["bias"])

    def block(self, prefix, p):
        self.norm(f"{prefix}.norm1", p["norm1"])
        self.norm(f"{prefix}.norm2", p["norm2"])
        self.linear(f"{prefix}.attn.qkv", p["attn"]["qkv"])
        self.linear(f"{prefix}.attn.proj", p["attn"]["proj"])
        if "q_norm" in p["attn"]:
            self.norm(f"{prefix}.attn.q_norm", p["attn"]["q_norm"])
            self.norm(f"{prefix}.attn.k_norm", p["attn"]["k_norm"])
        for name in ("w12", "w3") if "w12" in p["mlp"] else ("fc1", "fc2"):
            self.linear(f"{prefix}.mlp.{name}", p["mlp"][name])
        if "ls1" in p:
            self.raw(f"{prefix}.ls1.gamma", p["ls1"]["gamma"])
            self.raw(f"{prefix}.ls2.gamma", p["ls2"]["gamma"])

    def blocks(self, prefix, stacked, n):
        """`n` blocks from the JAX package's leading-axis stack."""
        for i in range(n):
            self.block(f"{prefix}.{i}", _index(stacked, i))

    def dinov2(self, prefix, p, depth):
        self.conv(f"{prefix}.patch_embed.proj", p["patch_embed"]["proj"])
        self.raw(f"{prefix}.cls_token", p["cls_token"])
        self.raw(f"{prefix}.pos_embed", p["pos_embed"])
        self.norm(f"{prefix}.norm", p["norm"])
        if "register_tokens" in p:
            self.raw(f"{prefix}.register_tokens", p["register_tokens"])
        self.blocks(f"{prefix}.blocks", p["blocks"], depth)

    def dpt_head(self, prefix, p):
        self.norm(f"{prefix}.norm", p["norm"])
        for i in range(4):
            self.conv(f"{prefix}.projects.{i}", p["projects"][i])
        for i in (0, 1):  # ConvTranspose2d weights are kept (in, out, kh, kw)
            self.raw(f"{prefix}.resize_layers.{i}.weight", p["resize"][i]["w"])
            self.raw(f"{prefix}.resize_layers.{i}.bias", p["resize"][i]["b"])
        self.conv(f"{prefix}.resize_layers.3", p["resize"][3])
        for i in range(4):
            self.conv(f"{prefix}.scratch.layer{i + 1}_rn", p["layer_rn"][i])
        for r in (1, 2, 3, 4):
            f = p[f"refinenet{r}"]
            rp = f"{prefix}.scratch.refinenet{r}"
            self.conv(f"{rp}.out_conv", f["out_conv"])
            for unit, key in (("resConfUnit1", "rcu1"), ("resConfUnit2", "rcu2")):
                if key in f:
                    self.conv(f"{rp}.{unit}.conv1", f[key]["conv1"])
                    self.conv(f"{rp}.{unit}.conv2", f[key]["conv2"])
        self.conv(f"{prefix}.scratch.output_conv1", p["output_conv1"])
        if "output_conv2" in p:
            self.conv(f"{prefix}.scratch.output_conv2.0", p["output_conv2"]["conv1"])
            self.conv(f"{prefix}.scratch.output_conv2.2", p["output_conv2"]["conv2"])

    def state_dict(self, strip_prefix: str = "") -> Dict[str, torch.Tensor]:
        """fp32 tensors, with `strip_prefix` removed from every name."""
        n = len(strip_prefix)
        return {k[n:]: torch.tensor(v, dtype=torch.float32) for k, v in self.sd.items()}


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def params_from_jax(params, cfg: OmniVGGTConfig) -> Dict[str, torch.Tensor]:
    """JAX parameter pytree (numpy or array leaves) -> this package's state
    dict (fp32 tensors under the reference's names)."""
    e = StateDictEmitter()
    acfg = cfg.aggregator
    a = params["aggregator"]
    if acfg.patch_embed == "conv":
        e.conv("aggregator.patch_embed.proj", a["patch_embed"]["proj"])
    else:
        e.dinov2("aggregator.patch_embed", a["patch_embed"], acfg.backbone.depth)
    e.raw("aggregator.camera_token", a["camera_token"])
    e.raw("aggregator.register_token", a["register_token"])
    e.blocks("aggregator.frame_blocks", a["frame_blocks"], acfg.depth)
    e.blocks("aggregator.global_blocks", a["global_blocks"], acfg.depth)
    for g in range(acfg.num_groups):
        e.linear(f"aggregator.pose_embeddings.{g}", _index(a["pose_embeddings"], g))
        e.linear(f"aggregator.camera_adapters.{g}", _index(a["camera_adapters"], g))
    e.raw("aggregator.depth_placeholder", a["depth_placeholder"])
    e.conv("aggregator.depth_patch_embed.proj", a["depth_patch_embed"]["proj"])

    c = params["camera_head"]
    e.blocks("camera_head.trunk", c["trunk"], cfg.camera_head.trunk_depth)
    e.norm("camera_head.token_norm", c["token_norm"])
    e.norm("camera_head.trunk_norm", c["trunk_norm"])
    e.raw("camera_head.empty_pose_tokens", c["empty_pose_tokens"])
    e.linear("camera_head.embed_pose", c["embed_pose"])
    e.linear("camera_head.poseLN_modulation.1", c["poseLN_modulation"])
    e.linear("camera_head.pose_branch.fc1", c["pose_branch"]["fc1"])
    e.linear("camera_head.pose_branch.fc2", c["pose_branch"]["fc2"])

    e.dpt_head("depth_head", params["depth_head"])
    e.dpt_head("point_head", params["point_head"])
    return e.state_dict()


# the file format's dtypes, in the order the `safetensors` package lays a
# file out (largest first): its Dtype enum's, of which these are the ones
# torch holds
SAFETENSORS_DTYPES = {
    "I64": torch.int64, "F64": torch.float64, "F32": torch.float32, "I32": torch.int32,
    "BF16": torch.bfloat16, "F16": torch.float16, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}
_DTYPE_NAMES = {v: k for k, v in SAFETENSORS_DTYPES.items()}
_DTYPE_RANK = {k: i for i, k in enumerate(SAFETENSORS_DTYPES)}


def _parse_header(path: str):
    """(header dict without "__metadata__", data start, file size) of a
    safetensors file, every entry (and the metadata) checked against the
    file: a malformed file raises ValueError before any tensor is read."""
    size = os.path.getsize(path)
    if size < 8:
        raise ValueError(f"{path}: {size} bytes, shorter than the 8-byte header length")
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        if 8 + n > size:
            raise ValueError(f"{path}: header length {n} runs past the end of the file ({size} bytes)")
        raw = f.read(n)
    try:
        header = json.loads(raw.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f"{path}: the header is not JSON ({e})") from None
    if not isinstance(header, dict):
        raise ValueError(f"{path}: the header is not a JSON object")
    meta = header.pop("__metadata__", None)
    if meta is not None and not (
        isinstance(meta, dict) and all(isinstance(v, str) for v in meta.values())
    ):
        raise ValueError(f"{path}: __metadata__ must map strings to strings")
    data_len = size - 8 - n
    spans = []
    for name, info in header.items():
        if not isinstance(info, dict) or set(info) != {"dtype", "shape", "data_offsets"}:
            raise ValueError(f"{path}: entry {name!r} is not {{dtype, shape, data_offsets}}")
        if info["dtype"] not in SAFETENSORS_DTYPES:
            raise ValueError(f"{path}: {name!r} has an unknown dtype {info['dtype']!r}")
        shape, offs = info["shape"], info["data_offsets"]
        if not (isinstance(shape, list) and all(type(d) is int and d >= 0 for d in shape)):
            raise ValueError(f"{path}: {name!r} has a malformed shape {shape!r}")
        if not (isinstance(offs, list) and len(offs) == 2
                and all(type(o) is int for o in offs) and 0 <= offs[0] <= offs[1] <= data_len):
            raise ValueError(
                f"{path}: {name!r} has offsets {offs!r} outside the data area of {data_len} bytes"
            )
        nbytes = math.prod(shape) * SAFETENSORS_DTYPES[info["dtype"]].itemsize
        if offs[1] - offs[0] != nbytes:
            raise ValueError(
                f"{path}: {name!r} of shape {shape} in {info['dtype']} needs {nbytes} bytes, "
                f"its offsets span {offs[1] - offs[0]}"
            )
        spans.append((offs[0], offs[1], name))
    end = 0
    for begin, stop, name in sorted(spans):
        if begin != end:
            raise ValueError(
                f"{path}: {name!r} starts at byte {begin} of the data area, the tensors before "
                f"it end at {end} (offsets overlap or leave a gap)"
            )
        end = stop
    if end != data_len:
        raise ValueError(
            f"{path}: the tensors cover {end} bytes of a data area of {data_len} "
            "(offsets do not cover it exactly)"
        )
    return header, 8 + n, size


def read_safetensors(path: str, device=None) -> Dict[str, torch.Tensor]:
    """Every tensor of a safetensors file, each copied once from a map of
    the file onto `device` (default the CPU). The whole header is checked
    first (`_parse_header`), so a malformed file loads nothing."""
    if sys.byteorder != "little":
        raise RuntimeError("safetensors files are little-endian; this host is not")
    header, start, size = _parse_header(path)
    device = torch.device("cpu" if device is None else device)
    out = {}
    if size == start:
        return {name: torch.empty(info["shape"], dtype=SAFETENSORS_DTYPES[info["dtype"]],
                                  device=device) for name, info in header.items()}
    # a private (copy-on-write) map: torch needs a writable buffer, and the
    # file is never written
    data = torch.from_numpy(np.memmap(path, dtype=np.uint8, mode="c", offset=start))
    for name, info in header.items():
        begin, stop = info["data_offsets"]
        raw = torch.empty(stop - begin, dtype=torch.uint8, device=device)
        raw.copy_(data[begin:stop])
        out[name] = raw.view(SAFETENSORS_DTYPES[info["dtype"]]).reshape(info["shape"])
    return out


def write_safetensors(path: str, tensors: Dict[str, torch.Tensor],
                      metadata: Optional[Dict[str, str]] = None) -> None:
    """Write `tensors` (any devices, any strides) as a safetensors file, in
    the layout of the `safetensors` package: tensors ordered by dtype,
    largest first, then by name; a compact JSON header padded with spaces to
    a multiple of 8 bytes."""
    for name, t in tensors.items():
        if t.dtype not in _DTYPE_NAMES:
            raise ValueError(f"{name!r}: dtype {t.dtype} has no safetensors name")
    names = sorted(tensors, key=lambda k: (_DTYPE_RANK[_DTYPE_NAMES[tensors[k].dtype]], k))
    header = {} if metadata is None else {"__metadata__": dict(metadata)}
    offset = 0
    for name in names:
        t = tensors[name]
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _DTYPE_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    raw = json.dumps(header, separators=(",", ":"), ensure_ascii=False).encode("utf-8")
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        for name in names:
            t = tensors[name].detach().to("cpu").contiguous().reshape(-1)
            f.write(memoryview(t.view(torch.uint8).numpy()))


# leaves of OmniVGGT that a VGGT-layout checkpoint lacks, and of VGGT that
# this model has no place for
OMNIVGGT_ONLY = ("aggregator.pose_embeddings.", "aggregator.camera_adapters.",
                 "aggregator.depth_placeholder", "aggregator.depth_patch_embed.")
VGGT_ONLY = ("track_head.",)


def load_vggt_layout(model: nn.Module, sd: Dict[str, torch.Tensor]) -> List[str]:
    """Strictly load a VGGT-layout state dict (VGGT, StreamVGGT) into
    `model`: OmniVGGT's own leaves (OMNIVGGT_ONLY) are set to zero, and with
    them the GT-camera injections and the depth placeholder add nothing; the
    track head's leaves (VGGT_ONLY) are skipped. Every other leaf must be
    present and nothing else may be left over. Returns the skipped names."""
    sd = {k: v for k, v in sd.items() if not k.endswith(_IGNORED_SUFFIXES) and ".rope." not in k}
    own = [k for k in sd if k.startswith(OMNIVGGT_ONLY)]
    if own:
        raise ValueError(f"not a VGGT-layout state dict: it holds OmniVGGT's {own[:3]}")
    skipped = sorted(k for k in sd if k.startswith(VGGT_ONLY))
    kept = {k: v for k, v in sd.items() if not k.startswith(VGGT_ONLY)}
    for name, t in model.state_dict().items():
        if name.startswith(OMNIVGGT_ONLY):
            kept[name] = torch.zeros_like(t)
    model.load_state_dict(kept, strict=True)
    if skipped:
        logging.getLogger(__name__).info("skipped %d leaves of the VGGT layout: %s",
                                         len(skipped), ", ".join(skipped))
    return skipped


def load_safetensors(model: nn.Module, path: str) -> None:
    """Strictly load a reference safetensors checkpoint into `model`: every
    parameter must be present and nothing may be left over."""
    sd = read_safetensors(path, device=next(model.parameters()).device)
    sd = {
        k: v for k, v in sd.items()
        if not k.endswith(_IGNORED_SUFFIXES) and ".rope." not in k
    }
    model.load_state_dict(sd, strict=True)


@torch.no_grad()
def cast_trunk_params(model: nn.Module, dtype=torch.bfloat16) -> nn.Module:
    """Store the aggregator's (and DINOv2's) weights in `dtype`, in place.

    The trunk casts every weight to its bf16 activation dtype at the point
    of use, so bf16 storage halves the trunk's memory and weight traffic
    without changing what it computes. LayerNorm weights stay fp32 (they
    are consumed inside the fp32 normalisation), as does the DINOv2
    pos_embed (interpolated in fp32 before the activation cast); the heads
    are not touched. For inference only."""
    for mod in model.aggregator.modules():
        if isinstance(mod, nn.LayerNorm):
            continue
        for name, prm in mod.named_parameters(recurse=False):
            if name != "pos_embed" and prm.is_floating_point():
                prm.data = prm.data.to(dtype)
    return model
