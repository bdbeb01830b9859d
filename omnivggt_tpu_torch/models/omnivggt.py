"""OmniVGGT: aggregator + camera head + depth head + point head
(counterpart of omnivggt_tpu/models/omnivggt.py).

`apply` returns the reference's prediction dict with channels-last layouts:
pose_enc (B,S,9), pose_enc_list (iters,B,S,9), depth (B,S,H,W,1),
depth_conf (B,S,H,W), world_points (B,S,H,W,3), world_points_conf
(B,S,H,W), images (B,S,H,W,3). The aggregator trunk runs in
`config.compute_dtype` (bf16 by default) and the heads in
`config.head_dtype` (fp32); only the layers the heads read are kept. The
forward runs fp32 work in full fp32 whatever torch's TF32 switches say
(utils/platform.exact_fp32), as the JAX package's reference-parity heads do.

Frame-causal streaming (`config.global_attention="frame_causal"`,
StreamVGGT): `OmniVGGT.stream(capacity)` allocates the key/value cache of a
clip (models/stream.StreamState) and `OmniVGGT.stream_step(state, image)`
answers the clip's next frame through `apply(..., cache=state)`; `apply`
of a whole clip under that config runs it through the same steps.

Checkpoints: `from_safetensors` reads a reference file; `save_pretrained`
writes the port's own directory (config.json as the JAX package writes it,
model.safetensors under the reference's names) and `from_pretrained` reads
it back, or a JAX-written config.json beside such weights.

The fast serving modes (`trunk_quant`, `attn_quant`, `head_quant`,
`approx_gelu`, bf16 heads) are certified per checkpoint by
`certify_fast_modes`, which walks the same ladder with the same gates
(`_probe_failures`) as the JAX package; `from_safetensors(head_dtype="auto")`
runs it and keeps the verdict next to the checkpoint
(omnivggt_tpu_torch/certification.py).
"""

from __future__ import annotations

import dataclasses
import glob
import json
import logging
import math
import os
import re
from typing import List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from omnivggt_tpu_torch import config as C
from omnivggt_tpu_torch.config import OmniVGGTConfig
from omnivggt_tpu_torch.models import aggregator as agg
from omnivggt_tpu_torch.models import camera_head as chead
from omnivggt_tpu_torch.models import dpt_head as dhead
from omnivggt_tpu_torch.models.aggregator import AuxInputs
from omnivggt_tpu_torch.models.stream import StreamState
from omnivggt_tpu_torch.ops import layers as L
from omnivggt_tpu_torch.parallel import collectives as PC
from omnivggt_tpu_torch.utils.device import resolve_device
from omnivggt_tpu_torch.utils.platform import exact_fp32
from omnivggt_tpu_torch.utils.profiling import span


CONFIG_NAME, WEIGHTS_NAME = "config.json", "model.safetensors"
# only a plausible 'org/name' id goes to the hub: a mistyped local path must
# say that no such directory exists, not try a download
_HUB_ID = re.compile(r"[A-Za-z0-9][\w.\-]*/[\w.\-]+")


def config_from_dict(raw: dict) -> OmniVGGTConfig:
    """An OmniVGGTConfig from a save_pretrained `config.json` of either
    package, read as the JAX package's from_pretrained reads it (lists to
    tuples, the same defaults for the fields older files lack), and the
    port's head_quant, bounded_attn_logits and global_attention when
    present."""

    def tup(d, keys):
        return {k: tuple(v) if k in keys and isinstance(v, list) else v for k, v in d.items()}

    return OmniVGGTConfig(
        img_size=raw["img_size"],
        patch_size=raw["patch_size"],
        embed_dim=raw["embed_dim"],
        aggregator=C.AggregatorConfig(**tup(raw["aggregator"], ["aa_order"])),
        camera_head=C.CameraHeadConfig(**raw["camera_head"]),
        depth_head=C.DPTHeadConfig(
            **tup(raw["depth_head"], ["out_channels", "intermediate_layer_idx"])
        ),
        point_head=C.DPTHeadConfig(
            **tup(raw["point_head"], ["out_channels", "intermediate_layer_idx"])
        ),
        compute_dtype=raw["compute_dtype"],
        head_dtype=raw.get("head_dtype", "float32"),
        approx_gelu=raw.get("approx_gelu", False),
        trunk_quant=raw.get("trunk_quant", "none"),
        attn_quant=raw.get("attn_quant", "none"),
        head_quant=raw.get("head_quant", "none"),
        bounded_attn_logits=raw.get("bounded_attn_logits", True),
        global_attention=raw.get("global_attention", "full"),
    )


def config_to_dict(cfg: OmniVGGTConfig) -> dict:
    """The dict `save_pretrained` writes as config.json: the JAX package's
    fields as its save_pretrained writes them, and the port's own
    global_attention only where it is not the default "full" (so a "full"
    configuration's file is the JAX package's, byte for byte)."""
    raw = dataclasses.asdict(cfg)
    if raw["global_attention"] == "full":
        del raw["global_attention"]
    return raw


def needed_layers(cfg: OmniVGGTConfig):
    """Sorted union of the aggregator layers the heads read: the last layer
    (camera head) and the DPT heads' intermediate_layer_idx."""
    layers = {cfg.aggregator.depth - 1}
    layers.update(cfg.depth_head.intermediate_layer_idx)
    layers.update(cfg.point_head.intermediate_layer_idx)
    return tuple(sorted(layers))


def _uniform_(t: torch.Tensor, bound: float, gen: torch.Generator):
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=gen)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Random weights with the JAX package's init distributions (torch's
    own defaults for linear and conv layers), drawn from `generator`."""
    gen = generator
    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            fan_in = m.weight[0].numel()
            _uniform_(m.weight, 1.0 / math.sqrt(fan_in), gen)
            if m.bias is not None:
                _uniform_(m.bias, 1.0 / math.sqrt(fan_in), gen)
        elif isinstance(m, nn.ConvTranspose2d):
            _uniform_(m.weight, 1.0 / math.sqrt(m.weight[0].numel()), gen)
            m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, L.LayerScale):
            m.gamma.fill_(m.init_values)
    for name, prm in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("camera_token", "register_token"):
            prm.normal_(generator=gen).mul_(1e-6)
        elif leaf == "pos_embed":
            prm.normal_(generator=gen).mul_(0.02)
        elif leaf in ("cls_token", "register_tokens", "depth_placeholder", "empty_pose_tokens"):
            prm.zero_()
        elif ".camera_adapters." in f".{name}":
            prm.zero_()  # zero-initialised adapters


class OmniVGGT(nn.Module):
    """The model's parameters under the reference's state-dict names, with a
    reference-style call: model(images, extrinsics=..., intrinsics=...,
    depth=..., mask=..., depth_gt_index=[...], camera_gt_index=[...])."""

    def __init__(
        self,
        config: Optional[OmniVGGTConfig] = None,
        *,
        device=None,
        seed: Optional[int] = 0,
    ):
        """Builds the model on `device` (default "cuda"; raises without a
        CUDA device, so the CPU runs only with device="cpu") with random
        weights from `seed` (seed=None leaves them uninitialised, for
        loading a checkpoint)."""
        super().__init__()
        self.config = cfg = config or OmniVGGTConfig()
        with torch.device("meta"):
            self.aggregator = agg.Aggregator(cfg.aggregator)
            self.camera_head = chead.CameraHead(cfg.camera_head)
            self.depth_head = dhead.DPTHead(cfg.depth_head)
            self.point_head = dhead.DPTHead(cfg.point_head)
        device = resolve_device(device)
        self.to_empty(device=device)
        if seed is not None:
            gen = torch.Generator(device=device)
            gen.manual_seed(seed)
            init_weights(self, gen)

    @classmethod
    def from_safetensors(cls, path: str, config: Optional[OmniVGGTConfig] = None, device=None,
                         head_dtype: str = "auto", quantising_rungs: bool = False,
                         layout: str = "omnivggt"):
        """Load a reference safetensors checkpoint strictly; the fixed-max
        softmax is turned off when the weights break its logit bound.
        layout "vggt": a VGGT-layout file (VGGT, StreamVGGT; pair it with
        global_attention="frame_causal" for StreamVGGT), loaded by
        checkpoint.load_vggt_layout.

        head_dtype: "auto" (default) walks the `certify_fast_modes` ladder
        on load and keeps the most aggressive serving mode whose probe
        outputs stay within the gates of the reference-parity forward; the
        verdict is kept next to the checkpoint (<path>.certified.json, keyed
        by a content fingerprint), so a later load of the same file reads it
        instead of probing again. "float32" / "bfloat16" force that head
        dtype and skip the ladder.

        quantising_rungs: whether the ladder may return the modes that
        quantise (W8A8 trunk, int8 scores, W8A8 head convolutions). Off by
        default, unlike the JAX package's load: their quantise and
        dequantise passes are separate torch ops here, and on the H100
        every such rung measured slower than the default config (PERF.md),
        so a load certifies bf16 heads and the tanh GELU only. True walks
        the JAX package's whole ladder."""
        from omnivggt_tpu_torch.checkpoint import (
            load_safetensors, load_vggt_layout, read_safetensors,
        )
        from omnivggt_tpu_torch.utils.validation import check_bounded_logits_safe

        config = config or OmniVGGTConfig()
        if head_dtype != "auto":
            config = dataclasses.replace(config, head_dtype=head_dtype)
        model = cls(config, device=device, seed=None)
        if layout == "vggt":
            load_vggt_layout(model, read_safetensors(path, device=next(model.parameters()).device))
        elif layout == "omnivggt":
            load_safetensors(model, path)
        else:
            raise ValueError(f"layout must be 'omnivggt' or 'vggt', got {layout!r}")
        head_dim = config.embed_dim // config.aggregator.num_heads
        if config.bounded_attn_logits and not check_bounded_logits_safe(model, head_dim):
            config = dataclasses.replace(config, bounded_attn_logits=False)
        if head_dtype == "auto":
            config = _certify_cached(model.eval(), config, path,
                                     quantising_rungs=quantising_rungs)
        model.config = config
        return model

    def save_pretrained(self, directory: str) -> str:
        """The port's own checkpoint: `config.json` (written as the JAX
        package's save_pretrained writes it) and the state dict under the
        reference's names in `model.safetensors` (the JAX package writes
        Orbax `params/` there, which needs JAX and tensorstore)."""
        from omnivggt_tpu_torch.checkpoint import write_safetensors

        os.makedirs(directory, exist_ok=True)
        with open(os.path.join(directory, CONFIG_NAME), "w") as f:
            json.dump(config_to_dict(self.config), f, indent=2)
        write_safetensors(os.path.join(directory, WEIGHTS_NAME), self.state_dict())
        return directory

    @classmethod
    def from_pretrained(cls, directory: str, head_dtype: str = "keep", device=None):
        """Load a directory written by save_pretrained onto `device` (default
        "cuda"), or, given a hub repo id ('org/name') that is not a local
        directory, the reference checkpoint from the hub (needs
        huggingface_hub and the network; without them a RuntimeError says
        so). A mistyped local path raises FileNotFoundError.

        head_dtype: "keep" (default) serves the saved config's modes;
        "auto" resets them to reference parity and certifies them anew, as
        from_safetensors does (without the quantising rungs; the verdict is
        kept beside model.safetensors, keyed on its content);
        "float32" / "bfloat16" force that head dtype. The fixed-max softmax
        is turned off when the weights break its logit bound."""
        from omnivggt_tpu_torch.checkpoint import load_safetensors
        from omnivggt_tpu_torch.utils.validation import check_bounded_logits_safe

        if not os.path.isdir(directory) and _HUB_ID.fullmatch(directory):
            return cls._from_hub(directory, head_dtype="auto" if head_dtype == "keep" else head_dtype,
                                 device=device)
        cfg_path = os.path.join(directory, CONFIG_NAME)
        if not os.path.isfile(cfg_path):
            raise FileNotFoundError(f"no checkpoint directory with a {CONFIG_NAME} at {directory!r}")
        with open(cfg_path) as f:
            cfg = config_from_dict(json.load(f))
        if head_dtype not in ("keep", "auto"):
            cfg = dataclasses.replace(cfg, head_dtype=head_dtype)
        model = cls(cfg, device=device, seed=None)
        weights = os.path.join(directory, WEIGHTS_NAME)
        load_safetensors(model, weights)
        head_dim = cfg.embed_dim // cfg.aggregator.num_heads
        if cfg.bounded_attn_logits and not check_bounded_logits_safe(model, head_dim):
            cfg = dataclasses.replace(cfg, bounded_attn_logits=False)
        if head_dtype == "auto":
            cfg = dataclasses.replace(cfg, head_dtype="float32", approx_gelu=False,
                                      trunk_quant="none", attn_quant="none", head_quant="none")
            cfg = _certify_cached(model.eval(), cfg, weights, quantising_rungs=False)
        model.config = cfg
        return model

    @classmethod
    def _from_hub(cls, repo_id: str, head_dtype: str = "auto", device=None):
        """Fetch a reference-layout safetensors checkpoint from the hub and
        load it with from_safetensors."""
        try:
            from huggingface_hub import snapshot_download
        except ImportError as e:
            raise RuntimeError(
                f"{repo_id!r} is not a local checkpoint directory and "
                "huggingface_hub is not installed, so it cannot be fetched "
                "from the hub. Download the safetensors file manually and "
                "use OmniVGGT.from_safetensors(path)."
            ) from e
        try:
            snap = snapshot_download(repo_id, allow_patterns=["*.safetensors"])
        except Exception as e:
            raise RuntimeError(
                f"could not download {repo_id!r} from the hub (offline "
                "environment?). Download the safetensors file manually and "
                "use OmniVGGT.from_safetensors(path)."
            ) from e
        files = sorted(glob.glob(os.path.join(snap, "**", "*.safetensors"), recursive=True))
        if len(files) != 1:
            raise RuntimeError(
                f"hub snapshot {snap!r} holds {len(files)} .safetensors files "
                f"({[os.path.basename(f) for f in files]}); load one with "
                "OmniVGGT.from_safetensors(path)."
            )
        return cls.from_safetensors(files[0], device=device, head_dtype=head_dtype)

    def forward(
        self,
        images,
        extrinsics=None,
        intrinsics=None,
        depth=None,
        mask=None,
        depth_gt_index: Optional[List[int]] = None,
        camera_gt_index: Optional[List[int]] = None,
        attn_impl: str = "auto",
        num_valid_frames=None,
        sharding=None,
    ):
        device = next(self.parameters()).device
        images = torch.as_tensor(images, device=device)
        if images.ndim == 4:
            images = images[None]
        aux = make_aux(
            images.shape[1], extrinsics, intrinsics, depth, mask,
            depth_gt_index, camera_gt_index, device=device,
        )
        return apply(self, images, self.config, aux, attn_impl=attn_impl,
                     num_valid_frames=num_valid_frames, sharding=sharding)

    def stream(self, capacity: int, image_hw=None) -> StreamState:
        """The cache of a frame-causal stream of up to `capacity` frames of
        `image_hw` (default the config's square img_size), allocated once
        on the model's device: the global layers' keys and values in the
        trunk dtype and the camera head's in the head dtype. Needs
        config.global_attention == "frame_causal"."""
        if self.config.global_attention != "frame_causal":
            raise ValueError("streaming needs global_attention='frame_causal', this model is "
                             f"{self.config.global_attention!r}")
        hw = image_hw or (self.config.img_size, self.config.img_size)
        device = next(self.parameters()).device
        with torch.inference_mode(False):  # buffers written in place in any mode
            return StreamState(self.config, capacity, hw, device)

    @torch.no_grad()
    def stream_step(self, state: StreamState, image, attn_impl: str = "auto") -> dict:
        """The clip's next frame, (H, W, 3) channels-last in [0, 1] (or with
        leading axes of 1), through `apply(..., cache=state)`: its keys and
        values join the cache and it attends to the frames before it.
        Returns the frame's predictions, each with B = S = 1 (pose_enc,
        pose_enc_list, depth, depth_conf, world_points, world_points_conf).
        Raises once the state holds its capacity (reset() it)."""
        images = torch.as_tensor(image, device=next(self.parameters()).device)
        return _stream_step(self, state, images.reshape(1, 1, *images.shape[-3:]),
                            self.config, attn_impl)


def apply(
    model: OmniVGGT,
    images: torch.Tensor,
    cfg: OmniVGGTConfig,
    aux: Optional[AuxInputs] = None,
    *,
    attn_impl: str = "auto",
    sharding=None,
    pad_tokens: bool = True,
    remat=False,
    train_generator: Optional[torch.Generator] = None,
    num_valid_frames=None,
    gather_outputs: bool = True,
    cache: Optional[StreamState] = None,
):
    """Full forward pass on (B, S, H, W, 3) (or (S, H, W, 3)) channels-last
    images in [0, 1]. Returns the prediction dict (fp32 but `images`).

    cache: a StreamState (OmniVGGT.stream): the images are one frame, the
    clip's next; the global blocks and the camera head's trunk attend over
    the frames cached before it and the frame's keys and values join the
    cache. Without one, a frame_causal config runs the scene through such
    steps frame by frame (`_apply_clip`), into a cache sized to the scene.

    sharding: a parallel.sharding.ModelSharding: the aggregator's attention
    runs under its strategies over the mesh's ranks (the "ring_fused"
    kernels have no backward: train under "allgather" or "ring"). With
    the mesh's seq axis over processes every process is given the whole
    request, as the JAX package's shard_batch places a host array, and
    runs the frames of its seq rank s, [s S / seq, (s + 1) S / seq) (S must
    divide): the aggregator and the DPT heads on those, the camera head on
    every frame's camera token (gathered: its trunk attends over frames),
    and the dense outputs are gathered at the end, so every process
    returns the whole prediction dict, as the single-device forward does.
    gather_outputs=False keeps this process's frames of the dense outputs
    (the train step: each process's losses are its share over its own
    frames); pose_enc and pose_enc_list cover every frame either way.
    Under autograd the gathers are differentiable
    (collectives.seq_gather): each process's gradient of a gathered
    tensor is summed over the processes onto the frames that made it.

    num_valid_frames: an int or an integer scalar tensor on the images'
    device; frames at or past it are shape padding (bucketed serving) and
    are masked out of all cross-frame attention, so the real frames'
    outputs equal the unpadded forward's. The fast modes come from cfg:
    trunk_quant, attn_quant, head_quant, approx_gelu, head_dtype.

    remat: recompute each aggregator layer pair in the backward (True or
    "full"; "dots" keeps the linear layers' outputs).
    train_generator: a generator on the images' device that enables the
    aggregator's stochastic depth at cfg.aggregator.drop_path_rate (None:
    deterministic eval)."""
    if images.ndim == 4:
        images = images[None]
    B, S, H, W, _ = images.shape
    whole_images = images
    if cfg.global_attention == "frame_causal":
        if aux is not None and any(x is not None for x in aux):
            raise ValueError("a frame_causal model takes images only (GT cameras and depth "
                             "are normalised over the whole scene)")
        if (sharding is not None or remat or train_generator is not None
                or num_valid_frames is not None):
            raise ValueError("a frame_causal model runs inference on one device: no "
                             "sharding, remat, stochastic depth or padded frames")
        if cache is None:
            return _apply_clip(model, images, cfg, attn_impl)
        cache.check_frame((H, W))
    elif cache is not None:
        raise ValueError("a stream cache needs global_attention='frame_causal'")
    mesh = sharding.mesh if sharding is not None else None
    if mesh is not None and not mesh.seq_processes:
        mesh = None  # logical seq ranks: every frame is here
    if mesh is not None:
        images, aux = _own_frames(images, aux, mesh)
    # full fp32 wherever the forward runs fp32, whatever the caller's TF32
    # switches (utils/platform.exact_fp32); bf16 work is unaffected
    with exact_fp32():
        with span("model.trunk", frames=images.shape[0] * images.shape[1]):
            layers, patch_start_idx = agg.apply(
                model.aggregator, images, aux,
                output_layers=needed_layers(cfg),
                dtype=cfg.trunk_dtype,
                attn_impl=attn_impl,
                sharding=sharding,
                allow_bounded=cfg.bounded_attn_logits,
                approx_gelu=cfg.approx_gelu,
                pad_tokens=pad_tokens,
                remat=remat,
                train_generator=train_generator,
                drop_path_rate=cfg.aggregator.drop_path_rate,
                num_valid_frames=num_valid_frames,
                int8_dense=cfg.trunk_quant,
                int8_qk=cfg.attn_quant == "int8",
                stream=cache,
            )
        last = layers[cfg.aggregator.depth - 1]
        if mesh is not None:
            # the head reads only the camera tokens, of every frame
            last = PC.seq_gather(last[:, :, :1].contiguous(), mesh, 1)
        with span("model.camera_head"):
            pose_enc_list = chead.apply(
                model.camera_head, last.to(cfg.heads_dtype), num_valid_frames=num_valid_frames,
                stream=cache,
            )
        predictions = {"pose_enc": pose_enc_list[-1], "pose_enc_list": pose_enc_list}
        for name, head, key in (
            ("depth_head", model.depth_head, "depth"),
            ("point_head", model.point_head, "world_points"),
        ):
            hcfg = getattr(cfg, name)
            with span("model.dpt_head") as sp:
                convs = dhead.conv_counts()

                def run_head(*levels, head=head):
                    return dhead.apply(head, list(levels), (H, W), patch_start_idx,
                                       dtype=cfg.heads_dtype, quant=cfg.head_quant)

                levels = [layers[i] for i in hcfg.intermediate_layer_idx]
                if cache is None:
                    preds, conf = run_head(*levels)
                else:  # a CUDA graph on the card: the frame's own copy of its buffers
                    preds, conf = (x.clone() for x in cache.replay(name, run_head, *levels))
                sp.count(**dhead.conv_counts(since=convs))
            if mesh is not None and gather_outputs:
                preds, conf = (PC.seq_gather(x, mesh, 1) for x in (preds, conf))
            predictions[key] = preds
            predictions[f"{key}_conf"] = conf
        predictions["images"] = whole_images
        if cache is not None:
            cache.filled += 1
        return predictions


def _stream_step(model: OmniVGGT, state: StreamState, images: torch.Tensor,
                 cfg: OmniVGGTConfig, attn_impl: str) -> dict:
    """One (1, 1, H, W, 3) frame through `apply(..., cache=state)`, in the
    span `model.stream_step` (counts: the frame's index, the frames cached
    before it, the keys its global layers attend to)."""
    t = state.filled
    with span("model.stream_step", frame=t, cached_frames=t,
              keys=cfg.aggregator.depth * (t + 1) * state.tokens_per_frame):
        out = apply(model, images, cfg, attn_impl=attn_impl, cache=state)
    del out["images"]
    return out


@torch.no_grad()
def _apply_clip(model: OmniVGGT, images: torch.Tensor, cfg: OmniVGGTConfig, attn_impl: str):
    """A frame_causal forward of whole (B, S, ...) clips: each clip's frames
    through the stream's steps (`_stream_step`), in order, into a cache of S
    frames made for the call; the frames' predictions joined along the frame
    axis. The steps launch op by op: a cache that lives for one clip would
    capture its CUDA graphs anew at every call."""
    B, S, H, W, _ = images.shape
    clips = []
    for b in range(B):
        with torch.inference_mode(False):
            state = StreamState(cfg, S, (H, W), images.device, graphs=False)
        steps = [_stream_step(model, state, images[b:b + 1, t:t + 1], cfg, attn_impl)
                 for t in range(S)]
        clips.append({k: torch.cat([o[k] for o in steps], dim=2 if k == "pose_enc_list" else 1)
                      for k in steps[0]})
    out = {k: torch.cat([c[k] for c in clips], dim=1 if k == "pose_enc_list" else 0)
           for k in clips[0]}
    out["images"] = images
    return out


def own_frames(S: int, mesh) -> slice:
    """Seq rank s's frames of a scene's S, [s S / seq, (s + 1) S / seq)."""
    n = mesh.seq
    if S % n:
        raise ValueError(f"{S} frames do not divide over the {n} seq processes of the mesh")
    return slice(mesh.seq_rank * (S // n), (mesh.seq_rank + 1) * (S // n))


def frames_of(x, frames: slice):
    """`frames` of a (B, S, ...) array, or of an (S,) frame mask."""
    return x[frames] if x.ndim == 1 else x[:, frames]


def _own_frames(images, aux: Optional[AuxInputs], mesh):
    """This seq process's frames of a (B, S, ...) request and its GT (the
    frame masks are (S,) or (B, S))."""
    frames = own_frames(images.shape[1], mesh)
    if aux is not None:
        aux = AuxInputs(*(None if x is None else frames_of(x, frames) for x in aux))
    return images[:, frames], aux


def make_aux(
    S: int,
    extrinsics=None,
    intrinsics=None,
    depth=None,
    mask=None,
    depth_gt_index: Optional[Sequence[int]] = None,
    camera_gt_index: Optional[Sequence[int]] = None,
    device=None,
) -> Optional[AuxInputs]:
    """AuxInputs from reference-style index lists (None without any GT)."""
    cam_mask = None
    if camera_gt_index is not None and len(camera_gt_index) > 0:
        if extrinsics is None or intrinsics is None:
            raise ValueError(
                "camera_gt_index requires extrinsics and intrinsics (frames "
                "marked as having camera GT but no camera arrays were given)"
            )
        cam_mask = np.zeros((S,), bool)
        cam_mask[np.asarray(camera_gt_index)] = True
    d_mask = None
    if depth_gt_index is not None and len(depth_gt_index) > 0:
        if depth is None:
            raise ValueError(
                "depth_gt_index requires a depth array (frames marked as "
                "having depth GT but no depth was given)"
            )
        if mask is None:
            raise ValueError(
                "depth_gt_index requires a validity mask alongside depth "
                "(pass mask=np.ones(...) if every depth pixel is valid)"
            )
        d_mask = np.zeros((S,), bool)
        d_mask[np.asarray(depth_gt_index)] = True
    if cam_mask is None and d_mask is None:
        return None

    def t(x):
        return None if x is None else torch.as_tensor(x, device=device)

    return AuxInputs(
        extrinsics=t(extrinsics),
        intrinsics=t(intrinsics),
        depth=t(depth),
        depth_valid=t(mask),
        camera_mask=t(cam_mask),
        depth_mask=t(d_mask),
    )


# ---------------------------------------------------------------------------
# fast-mode certification
# ---------------------------------------------------------------------------

PROBE_KEYS = ("pose_enc", "depth", "world_points", "depth_conf")


def _probe_batch(probe_s: int, probe_hw: int) -> np.ndarray:
    """The deterministic probe batch, (1, probe_s, hw, hw, 3) uniform in
    [0, 1) from a seeded CPU generator. (The JAX package draws its own with
    its random module, whose bits PyTorch cannot reproduce; both ladders
    compare each candidate with the same package's reference forward on
    the same batch, so the batches need not agree.)"""
    gen = torch.Generator()
    gen.manual_seed(0)
    return torch.rand((1, probe_s, probe_hw, probe_hw, 3), generator=gen).numpy()


@torch.no_grad()
def _probe_outputs(model, cfg: OmniVGGTConfig, probe_hw, probe_s):
    """Forward on the small deterministic probe batch; numpy outputs."""
    if probe_hw is None:
        probe_hw = min(140, cfg.img_size)
    probe_hw -= probe_hw % cfg.patch_size
    device = next(model.parameters()).device
    images = torch.as_tensor(_probe_batch(probe_s, probe_hw), device=device)
    out = apply(model, images, cfg)
    return {k: out[k].float().cpu().numpy() for k in PROBE_KEYS}


def _probe_readings(ref, fast) -> dict:
    """The four gate readings between two probe-output dicts: max-abs on
    pose_enc, median relative error on the dense outputs."""

    def med_rel(a, b, floor=1e-3):
        a = a.astype(np.float64)
        b = b.astype(np.float64)
        return float(np.median(np.abs(a - b) / (np.abs(a) + floor)))

    return {
        "pose_enc_maxabs": float(np.max(np.abs(ref["pose_enc"] - fast["pose_enc"]))),
        "depth_medrel": med_rel(ref["depth"], fast["depth"]),
        "points_medrel": med_rel(ref["world_points"], fast["world_points"]),
        "depth_conf_medrel": med_rel(ref["depth_conf"], fast["depth_conf"]),
    }


def _probe_failures(ref, fast, pose_tol, rel_tol):
    """Dict of gate violations between two probe-output dicts (empty =
    pass). A non-finite reading fails: the breakage the ladder exists to
    catch can surface as NaN, and NaN > tol is False."""
    return {
        k: v
        for k, v in _probe_readings(ref, fast).items()
        if not np.isfinite(v) or v > (pose_tol if k == "pose_enc_maxabs" else rel_tol)
    }


def certify_head_dtype(
    model,
    cfg: OmniVGGTConfig,
    *,
    probe_hw: Optional[int] = None,
    probe_s: int = 2,
    pose_tol: float = 2e-2,
    rel_tol: float = 2e-2,
) -> OmniVGGTConfig:
    """The bf16-heads rung alone: cfg with head_dtype="bfloat16" when the
    probe deltas against the fp32-head forward stay within the gates, else
    cfg unchanged. Shares `_probe_outputs` and `_probe_failures` with the
    full ladder."""
    if cfg.head_dtype != "float32":
        return cfg  # caller already chose; nothing to certify
    ref = _probe_outputs(model, cfg, probe_hw, probe_s)
    bf16_cfg = dataclasses.replace(cfg, head_dtype="bfloat16")
    failed = _probe_failures(
        ref, _probe_outputs(model, bf16_cfg, probe_hw, probe_s), pose_tol, rel_tol
    )
    if failed:
        logging.getLogger(__name__).warning(
            "bf16-head certification failed (%s); keeping fp32 heads",
            ", ".join(f"{k}={v:.4g}" for k, v in failed.items()),
        )
        return cfg
    return bf16_cfg


def certify_fast_modes(
    model,
    cfg: OmniVGGTConfig,
    *,
    probe_hw: Optional[int] = None,
    probe_s: int = 2,
    pose_tol: float = 2e-2,
    rel_tol: float = 2e-2,
    final_hw: int = 448,
    report: Optional[list] = None,
    quantising_rungs: bool = True,
) -> OmniVGGTConfig:
    """Certify-then-default the fast serving modes, most aggressive first:

      1. int8 trunk + bf16 heads + tanh GELU (W8A8 dense)
      2. int8_ln trunk + bf16 heads + tanh GELU (qkv and fc1 only)
      3. bf16 heads + tanh-GELU trunk
      4. bf16 heads
      5. fp32 heads + exact erf GELU (reference parity, the fallback)

    The ladder, the gates and their order are the JAX package's
    (`certify_fast_modes` there). Ladder stage at `probe_hw` (default 140
    px): the first candidate that passes is the provisional winner. Final
    stage at `final_hw` (default 448 px, where every attention family
    crosses the flash dispatch length): the winner is gated again, stepping
    down the ladder until a rung passes, else the fallback; skipped when
    both sizes coincide. Then the winner is probed once more with
    attn_quant="int8", and, when the int8 trunk rung won, with
    head_quant="int8"; each upgrade is kept when the gates still pass
    against the reference-parity forward. Runs only when the caller has
    chosen no fast mode.

    report: an optional list that receives one dict per gate evaluated
    (stage, size, the candidate's modes, the four readings, passed).
    quantising_rungs: False leaves out rungs 1 and 2 and both upgrades, so
    only bf16 heads and the tanh GELU can be returned (what
    `from_safetensors` certifies by default)."""
    log = logging.getLogger(__name__)
    if (cfg.head_dtype != "float32" or cfg.approx_gelu
            or cfg.trunk_quant != "none" or cfg.attn_quant != "none"
            or cfg.head_quant != "none"):
        return cfg  # caller already chose; nothing to certify

    def snap(hw):
        hw = min(hw, cfg.img_size)
        return hw - hw % cfg.patch_size

    ladder_hw = snap(probe_hw if probe_hw is not None else 140)
    fin_hw = snap(final_hw)
    candidates = [
        dataclasses.replace(cfg, head_dtype="bfloat16", approx_gelu=True, trunk_quant="int8"),
        dataclasses.replace(cfg, head_dtype="bfloat16", approx_gelu=True, trunk_quant="int8_ln"),
        dataclasses.replace(cfg, head_dtype="bfloat16", approx_gelu=True),
        dataclasses.replace(cfg, head_dtype="bfloat16"),
    ]
    if not quantising_rungs:
        candidates = [c for c in candidates if c.trunk_quant == "none"]

    def gate(ref, cand, hw, stage):
        fast = _probe_outputs(model, cand, hw, probe_s)
        failed = _probe_failures(ref, fast, pose_tol, rel_tol)
        if report is not None:
            report.append({
                "stage": stage, "hw": hw, "head_dtype": cand.head_dtype,
                "approx_gelu": cand.approx_gelu, "trunk_quant": cand.trunk_quant,
                "attn_quant": cand.attn_quant, "head_quant": cand.head_quant,
                **_probe_readings(ref, fast), "passed": not failed,
            })
        if failed:
            log.warning(
                "fast-mode certification failed at %dpx (%s) for head_dtype=%s "
                "approx_gelu=%s trunk_quant=%s attn_quant=%s head_quant=%s (%s)",
                hw, stage, cand.head_dtype, cand.approx_gelu, cand.trunk_quant,
                cand.attn_quant, cand.head_quant,
                ", ".join(f"{k}={v:.4g}" for k, v in failed.items()),
            )
        return not failed

    ref = _probe_outputs(model, cfg, ladder_hw, probe_s)
    best, best_idx = cfg, len(candidates)
    for i, cand in enumerate(candidates):
        if gate(ref, cand, ladder_hw, "ladder"):
            best, best_idx = cand, i
            break

    if fin_hw == ladder_hw:
        ref_f = ref  # same resolution: the ladder gate is the final gate
    else:
        ref_f = _probe_outputs(model, cfg, fin_hw, probe_s)
        if best is not cfg:
            final_best = cfg
            for cand in candidates[best_idx:]:
                if gate(ref_f, cand, fin_hw, "final"):
                    final_best = cand
                    break
            best = final_best

    if not quantising_rungs:
        return best
    upgraded = dataclasses.replace(best, attn_quant="int8")
    if gate(ref_f, upgraded, fin_hw, "attn_quant upgrade"):
        best = upgraded
    if best.trunk_quant == "int8" and best.head_quant == "none":
        upgraded = dataclasses.replace(best, head_quant="int8")
        if gate(ref_f, upgraded, fin_hw, "head_quant upgrade"):
            best = upgraded
    return best


def certification_gates(
    probe_hw: Optional[int] = None,
    probe_s: int = 2,
    pose_tol: float = 2e-2,
    rel_tol: float = 2e-2,
    final_hw: int = 448,
) -> dict:
    """The gate parameters certify_fast_modes runs with, as the dict kept
    in (and matched against) a checkpoint certificate."""
    return {
        "probe_hw": probe_hw, "probe_s": probe_s, "pose_tol": pose_tol,
        "rel_tol": rel_tol, "final_hw": final_hw,
    }


def _certify_cached(model, cfg: OmniVGGTConfig, ckpt_path: str, *,
                    quantising_rungs: bool = True, **gate_kwargs) -> OmniVGGTConfig:
    """certify_fast_modes with the verdict kept next to the checkpoint: a
    valid certificate (matching content fingerprint, gates and base modes)
    skips every probe forward. A ladder cut to the rungs that do not
    quantise says so in the certificate's gates, so its verdict and the
    whole ladder's (the JAX package's) are never taken for each other."""
    from omnivggt_tpu_torch.certification import (
        checkpoint_fingerprint, load_certificate, save_certificate,
    )

    gates = certification_gates(**gate_kwargs)
    if not quantising_rungs:
        gates["quantising_rungs"] = False
    fp = checkpoint_fingerprint(ckpt_path)
    cached = load_certificate(ckpt_path, cfg, gates, fingerprint=fp)
    if cached is not None:
        return cached
    certified = certify_fast_modes(model, cfg, quantising_rungs=quantising_rungs, **gate_kwargs)
    save_certificate(ckpt_path, cfg, certified, gates, fingerprint=fp)
    return certified
