"""Alternating frame/global attention aggregator with auxiliary-modality
injection (counterpart of omnivggt_tpu/models/aggregator.py).

  - the 24 (frame, global) layer pairs run as a Python loop; only the layers
    that a head reads are kept, as (frame ‖ global) concatenations;
  - special tokens: slot 0 of camera_token / register_token is for frame 0,
    slot 1 for every other frame;
  - GT cameras are normalised over the selected frames, encoded to the 9-dim
    pose encoding, embedded per injection group, and injected through the
    zero-initialised adapters at the input and after every frame block; the
    adapter bias reaches every frame (adapter(0) = bias);
  - GT depth is mean-normalised over the selected frames' valid pixels and
    patchified with its mask; frames without it get the learned placeholder;
  - training: `remat` recomputes each (frame, global) pair in the backward
    (torch.utils.checkpoint, as jax.checkpoint wraps the JAX scan step;
    DINOv2 is not recomputed; remat="dots" keeps the linear layers'
    outputs, as the JAX package's dots_with_no_batch_dims_saveable
    policy does), and `train_generator` enables stochastic
    depth at the model config's drop_path_rate. Its keep masks for every block are drawn
    before the loop (as the JAX package splits its keys outside the scan),
    so the recomputed pair drops the same samples as the first pass;
  - with the seq axis over processes (parallel/mesh.py) the images and GT
    are this process's frames, [s S_l, (s + 1) S_l) of the scene's S =
    seq S_l; slot 0 of the special tokens goes to the scene's frame 0
    (seq rank 0's first), the camera rebase runs on the whole frame axis
    (the per-frame extrinsics and masks gathered) and the depth mean over
    every process's sums (collectives.seq_sum);
  - a frame-causal stream (`stream`, models/stream.StreamState): one frame
    a call; each global block writes the frame's keys and values into the
    stream's cache and attends to the cached frames 0..t; the frame takes
    slot 0 of the special tokens only as the clip's first (an empty cache).
    RoPE's positions are the frame's own 2D ones (there is no temporal
    position). Frame attention and DINOv2 are unchanged.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
)

from omnivggt_tpu_torch.config import AggregatorConfig
from omnivggt_tpu_torch.models import dinov2
from omnivggt_tpu_torch.ops import layers as L
from omnivggt_tpu_torch.ops import rope as R
from omnivggt_tpu_torch.parallel import collectives as PC
from omnivggt_tpu_torch.utils import geometry as G

_RESNET_MEAN = (0.485, 0.456, 0.406)
_RESNET_STD = (0.229, 0.224, 0.225)


class AuxInputs(NamedTuple):
    """Optional per-frame auxiliary modalities; masks are booleans over the
    S frames (True = ground truth given for that frame)."""

    extrinsics: Optional[torch.Tensor] = None  # (B, S, 3, 4) world-to-camera
    intrinsics: Optional[torch.Tensor] = None  # (B, S, 3, 3)
    depth: Optional[torch.Tensor] = None  # (B, S, H, W, 1)
    depth_valid: Optional[torch.Tensor] = None  # (B, S, H, W)
    camera_mask: Optional[torch.Tensor] = None  # (S,) or (B, S) bool
    depth_mask: Optional[torch.Tensor] = None  # (S,) or (B, S) bool


class Aggregator(nn.Module):
    """Parameters under the reference's names (aggregator.*)."""

    def __init__(self, cfg: AggregatorConfig):
        super().__init__()
        self.cfg = cfg
        C, G_ = cfg.embed_dim, cfg.num_groups
        if cfg.patch_embed == "conv":
            self.patch_embed = L.PatchEmbed(cfg.patch_size, 3, C)
        else:
            self.patch_embed = dinov2.DinoVisionTransformer(cfg.backbone)

        def blocks():
            return nn.ModuleList(
                L.Block(
                    C, cfg.num_heads, mlp_ratio=cfg.mlp_ratio, qkv_bias=cfg.qkv_bias,
                    proj_bias=cfg.proj_bias, ffn_bias=cfg.ffn_bias,
                    init_values=cfg.init_values, qk_norm=cfg.qk_norm,
                )
                for _ in range(cfg.depth)
            )

        self.camera_token = nn.Parameter(torch.zeros(1, 2, 1, C))
        self.register_token = nn.Parameter(torch.zeros(1, 2, cfg.num_register_tokens, C))
        self.frame_blocks = blocks()
        self.global_blocks = blocks()
        self.pose_embeddings = nn.ModuleList(
            nn.Linear(cfg.pose_hidden_dim, C) for _ in range(G_)
        )
        self.camera_adapters = nn.ModuleList(nn.Linear(C, C) for _ in range(G_))
        self.depth_placeholder = nn.Parameter(torch.zeros(1, 1, C))
        self.depth_patch_embed = L.PatchEmbed(cfg.patch_size, 2, C)


def _expand_special_token(tok: torch.Tensor, B: int, S: int, dtype,
                          has_first: bool = True) -> torch.Tensor:
    """(1, 2, X, C) -> (B, S, X, C): slot 0 for the first frame, slot 1 for
    the rest. has_first False: these S frames do not hold the scene's first
    (a seq process other than rank 0's), so slot 1 for all."""
    X, C = tok.shape[2], tok.shape[3]
    tok = tok.to(dtype)
    if not has_first:
        return tok[:, 1:2].expand(B, S, X, C)
    first = tok[:, 0:1].expand(B, 1, X, C)
    others = tok[:, 1:2].expand(B, S - 1, X, C)
    return torch.cat([first, others], dim=1)


def masked_normalize_extrinsics(extrinsics: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Rebase (B, S, 3, 4) extrinsics to the first selected camera and divide
    translations by the mean distance of the other selected cameras to it;
    mask: (B, S) bool. Unselected frames are transformed too (their values
    are ignored downstream)."""
    B, S = extrinsics.shape[:2]
    idx0 = mask.int().argmax(dim=1)  # first selected frame
    homog = G.expand_extrinsic_to_homog(extrinsics)
    batch = torch.arange(B, device=extrinsics.device)
    first_inv = G.closed_form_inverse_se3(homog[batch, idx0])
    new = homog @ first_inv[:, None]

    cam_centers = new[:, :, :3, 3]
    ref = cam_centers[batch, idx0][:, None]
    dist = torch.linalg.norm(cam_centers - ref, dim=-1)  # (B, S)
    excl = mask & (torch.arange(S, device=mask.device)[None, :] != idx0[:, None])
    cnt = excl.sum(dim=1)
    mean_dist = (dist * excl).sum(dim=1) / cnt.clamp_min(1)
    scale = torch.where(cnt > 0, mean_dist.clamp_min(1e-6), 1.0)
    new = new.clone()
    new[:, :, :3, 3] = new[:, :, :3, 3] / scale[:, None, None]
    return new[:, :, :3]


def masked_normalize_depth(
    depth: torch.Tensor, valid: torch.Tensor, frame_mask: torch.Tensor, eps: float = 1e-8,
    mesh=None,
) -> torch.Tensor:
    """depth / (mean over the selected frames' valid pixels + eps) * valid.
    depth: (B, S, H, W, 1); valid: (B, S, H, W); frame_mask: (B, S) bool.
    mesh: a sum and a count are taken per seq rank's frames and added in
    rank order (collectives.sum_in_rank_order), across the processes
    (collectives.seq_sum) when the seq axis lies over them and these are
    this process's frames, so both layouts give the same bits."""
    d = depth[..., 0]
    sel = valid * frame_mask[:, :, None, None]
    n = 1 if mesh is None else mesh.local_shape["seq"]
    sums = PC.sum_in_rank_order([torch.stack([a.sum(dim=(1, 2, 3)), b.sum(dim=(1, 2, 3))])
                                 for a, b in zip((d * sel).chunk(n, 1), sel.chunk(n, 1))])
    if mesh is not None and mesh.seq_processes:
        sums = PC.seq_sum(sums, mesh)
    total, cnt = sums[0], sums[1]
    mean = total / cnt.clamp_min(1.0)
    norm = torch.where(
        cnt[:, None, None, None] > 0, d / (mean[:, None, None, None] + eps), 0.0
    )
    return (norm * valid)[..., None]


def _frame_mask(mask, B: int, S: int, device):
    """A camera/depth mask as (B, S) bool, or None."""
    if mask is None:
        return None
    mask = torch.as_tensor(mask, device=device)
    if mask.ndim == 1:
        mask = mask[None, :].expand(B, S)
    return mask.bool()


def compute_pose_encoding(
    aux: AuxInputs, image_size_hw: Tuple[int, int], camera_mask: torch.Tensor, mesh=None
) -> torch.Tensor:
    """(B, S, 9) pose encoding of the mask-normalised GT extrinsics; frames
    without GT are encoded from identity cameras (masked out later).
    mesh: with the seq axis over processes these are this process's
    frames, rebased on the whole scene (rebased_extrinsics)."""
    B, S = camera_mask.shape
    dev = camera_mask.device
    eye34 = torch.eye(3, 4, device=dev).expand(B, S, 3, 4)
    eyeK = torch.eye(3, device=dev).expand(B, S, 3, 3)
    m4 = camera_mask[:, :, None, None]
    ex = torch.where(m4, aux.extrinsics.float(), eye34)
    K = torch.where(m4, aux.intrinsics.float(), eyeK)
    return G.extri_intri_to_pose_encoding(rebased_extrinsics(ex, camera_mask, mesh), K,
                                          image_size_hw)


def rebased_extrinsics(ex: torch.Tensor, mask: Optional[torch.Tensor], mesh=None) -> torch.Tensor:
    """(B, S, 3, 4) extrinsics rebased to the scene's first camera, or to
    its first selected one under a (B, S) mask (masked_normalize_extrinsics).
    mesh: with the seq axis over processes these are this process's
    frames: every frame's extrinsics and mask are gathered (12 + 1 values
    a frame), the rebase runs on the whole scene and this process's frames
    are kept."""
    def rebase(ex, mask):
        return G.normalize_extrinsics(ex) if mask is None else \
            masked_normalize_extrinsics(ex, mask)

    if mesh is None or not mesh.seq_processes:
        return rebase(ex, mask)
    B, S = ex.shape[:2]
    packed = ex.reshape(B, S, 12)
    if mask is not None:
        packed = torch.cat([packed, mask[:, :, None].float()], dim=-1)
    whole = PC.seq_all_gather(packed, mesh, 1)
    ex_all = whole[..., :12].reshape(B, -1, 3, 4)
    first = mesh.seq_rank * S
    return rebase(ex_all, None if mask is None else whole[..., 12] > 0.5)[:, first:first + S]


def _dots_saveable(ctx, op, *args, **kwargs):
    """The selective-checkpoint policy of remat="dots" (the JAX package's
    jax.checkpoint_policies.dots_with_no_batch_dims_saveable): keep the
    outputs of the products without batch dimensions, which are the linear
    layers' (F.linear dispatches aten.addmm, or aten.mm without a bias), and
    recompute everything else. Attention is not such a product: its batched
    matmuls (aten.bmm) and the flash kernels' autograd Functions (not aten
    ops, so never cached) run again in the recomputation, as the Pallas
    call does under jax.checkpoint.

    For parity with the JAX package's remat options: it is no faster than
    remat=True on any shape measured. The dispatch mode that applies the
    policy runs Python on every op of the region, and that host time costs
    more than the recompute of the products it saves (one H100, the flagship
    at S=4: step medians -1 to +246 ms at B=1 and +186 to +213 ms at B=2,
    every profiled step 227 to 476 ms slower, with 4.9 and 9.7 GB more
    memory; chip_smoke.py's fine-tuning phase)."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


_DOTS_CONTEXT = functools.partial(create_selective_checkpoint_contexts, _dots_saveable)


def apply(
    p: Aggregator,
    images: torch.Tensor,
    aux: Optional[AuxInputs] = None,
    *,
    output_layers: Tuple[int, ...],
    dtype=torch.float32,
    attn_impl: str = "auto",
    sharding=None,
    allow_bounded: bool = True,
    approx_gelu: bool = False,
    pad_tokens: bool = True,
    remat: Union[bool, str] = False,
    train_generator: Optional[torch.Generator] = None,
    drop_path_rate: float = 0.0,
    num_valid_frames=None,
    int8_dense=False,
    int8_qk: bool = False,
    stream=None,
):
    """Run the aggregator on (B, S, H, W, 3) channels-last images in [0, 1].

    num_valid_frames: an int or an integer scalar tensor on the images'
    device; frames at or past it are shape padding (bucketed serving) and
    are masked out of the global-attention keys, a valid prefix of
    num_valid_frames * P tokens since the token order is frame-major. Frame
    attention and the patch embedder are per frame and need no mask.
    int8_dense (a trunk_quant mode) and int8_qk: the blocks' fast modes.
    sharding: a ModelSharding (parallel/sharding.py): the frame blocks and
    DINOv2 attend under its frame shard, the global blocks under its global
    shard (which takes the padded frames' mask only under "allgather").

    stream: a models/stream.StreamState and one frame (B = S = 1), the
    clip's next: the global blocks attend over the stream's cache, which
    this call fills at the frame's slot (the caller advances the count);
    on the card the layers between the cache's writes run as CUDA graphs.

    remat: recompute each layer pair in the backward instead of keeping its
    activations (only while grad is enabled): True or "full" keeps nothing,
    "dots" keeps the outputs of the matrix products without batch
    dimensions (`_dots_saveable`). train_generator: a generator
    on the images' device that enables stochastic depth at drop_path_rate
    (None: eval, deterministic).

    Returns ({layer: (B, S, P, 2C) tensor in `dtype`} for each of
    `output_layers`, patch_start_idx)."""
    cfg = p.cfg
    B, S, H, W, _ = images.shape
    C = cfg.embed_dim
    psi = cfg.patch_start_idx
    gh, gw = H // cfg.patch_size, W // cfg.patch_size
    n_patch = gh * gw
    P = psi + n_patch
    dev = images.device
    aux = aux or AuxInputs()
    frame_shard = sharding.frame_attn_shard if sharding is not None else None
    global_shard = sharding.global_attn_shard if sharding is not None else None
    mesh = sharding.mesh if sharding is not None else None
    has_first = mesh is None or not mesh.seq_processes or mesh.seq_rank == 0
    if stream is not None:
        if B != 1 or S != 1 or sharding is not None or tuple(cfg.aa_order) != ("frame", "global"):
            raise ValueError("a stream runs one frame a call on one device, frame blocks "
                             f"first; got B={B}, S={S}, aa_order {cfg.aa_order}"
                             + (" under a sharding" if sharding else ""))
        has_first = stream.filled == 0

    mean = torch.tensor(_RESNET_MEAN, dtype=dtype, device=dev)
    std = torch.tensor(_RESNET_STD, dtype=dtype, device=dev)
    imgs = (images.reshape(B * S, H, W, 3).to(dtype) - mean) / std

    if cfg.patch_embed == "conv":
        patch_tokens = L.patch_embed(p.patch_embed, imgs)
    else:
        def embed(imgs):
            return dinov2.apply(
                p.patch_embed, imgs, attn_impl=attn_impl, shard=frame_shard,
                approx_gelu=approx_gelu, int8_dense=int8_dense, int8_qk=int8_qk,
                pad_tokens=pad_tokens,
            )

        patch_tokens = embed(imgs) if stream is None else stream.replay("dinov2", embed, imgs)

    camera_token = _expand_special_token(p.camera_token, B, S, dtype, has_first)
    register_token = _expand_special_token(p.register_token, B, S, dtype, has_first)

    # GT cameras: the input injection group (index 0)
    camera_mask = _frame_mask(aux.camera_mask, B, S, dev)
    if camera_mask is not None:
        pose_enc = compute_pose_encoding(aux, (H, W), camera_mask, mesh).to(dtype)
        pe_tok = L.linear(p.pose_embeddings[0], pose_enc)
        gt_camera = torch.where(camera_mask[:, :, None], pe_tok, 0.0)
        cam_mask_f = camera_mask[:, :, None].to(dtype)
    else:
        pose_enc = torch.zeros(B, S, cfg.pose_hidden_dim, dtype=dtype, device=dev)
        gt_camera = torch.zeros(B, S, C, dtype=dtype, device=dev)
        cam_mask_f = torch.zeros(B, S, 1, dtype=dtype, device=dev)
    camera_token = camera_token + L.linear(p.camera_adapters[0], gt_camera)[:, :, None, :]

    # GT depth
    placeholder = p.depth_placeholder.to(dtype)[None]  # (1, 1, 1, C)
    depth_mask = _frame_mask(aux.depth_mask, B, S, dev)
    if depth_mask is not None:
        valid = aux.depth_valid.float()
        dn = masked_normalize_depth(aux.depth.float(), valid, depth_mask, mesh=mesh)
        dm = torch.cat([dn, valid[..., None]], dim=-1).reshape(B * S, H, W, 2)
        d_tok = L.patch_embed(p.depth_patch_embed, dm.to(dtype)).reshape(B, S, n_patch, C)
        gt_depth = torch.where(depth_mask[:, :, None, None], d_tok, placeholder)
    else:
        gt_depth = placeholder.expand(B, S, n_patch, C)

    patch_tokens = patch_tokens.reshape(B, S, n_patch, C) + gt_depth
    tokens = torch.cat([camera_token, register_token, patch_tokens], dim=2)

    if cfg.rope_freq > 0:
        def tables():
            cos, sin = R.rope_tables(gh, gw, psi, C // cfg.num_heads, cfg.rope_freq, dev)
            return cos.to(dtype), sin.to(dtype)

        cos_f, sin_f = tables() if stream is None else stream.constant("rope", tables)
        cos_g, sin_g = R.tile_tables(cos_f, sin_f, S)
    else:
        cos_f = sin_f = cos_g = sin_g = None

    if tuple(cfg.aa_order) not in (("frame", "global"), ("global", "frame")):
        raise NotImplementedError(f"aa_order {cfg.aa_order}")
    kw = dict(ln_eps=cfg.ln_eps, attn_impl=attn_impl, allow_bounded=allow_bounded,
              approx_gelu=approx_gelu, int8_dense=int8_dense, int8_qk=int8_qk)
    # a device scalar stays on the device: no host sync per layer
    kv_valid_tokens = None if num_valid_frames is None else num_valid_frames * P

    dp_rate = drop_path_rate if train_generator is not None else 0.0
    if dp_rate > 0.0:
        # (first block's, second block's) keep masks per layer pair, two
        # residual branches each, drawn up front in a fixed order. Each
        # process draws the whole batch's, B x S_global scene-major rows for
        # a frame block and B_global for a global block, and keeps its own:
        # its data rank's scenes and, with the seq axis over processes, its
        # seq rank's frames of each; so the masks are the logical ranks' ones
        over_data = mesh is not None and mesh.group is not None
        data, rank = (mesh.data, mesh.rank) if over_data else (1, 0)
        over_seq = mesh is not None and mesh.seq_processes
        seq, seq_rank = (mesh.seq, mesh.seq_rank) if over_seq else (1, 0)

        def frame_masks():
            drawn = L.drop_path_masks(B * data * S * seq, 2, dp_rate, train_generator, dev)
            drawn = drawn.reshape(2, B * data, S * seq)
            return drawn[:, rank * B:(rank + 1) * B,
                         seq_rank * S:(seq_rank + 1) * S].reshape(2, B * S)

        def scene_masks():
            drawn = L.drop_path_masks(B * data, 2, dp_rate, train_generator, dev)
            return drawn[:, rank * B:(rank + 1) * B]

        if cfg.aa_order[0] == "frame":
            keeps = [(frame_masks(), scene_masks()) for _ in range(cfg.depth)]
        else:
            keeps = [(scene_masks(), frame_masks()) for _ in range(cfg.depth)]
    else:
        keeps = [(None, None)] * cfg.depth

    def frame_step(tokens, i, keep):
        x = L.block(p.frame_blocks[i], tokens.reshape(B * S, P, C), cos_f, sin_f, **kw,
                    shard=frame_shard, drop_path_rate=dp_rate, drop_path_keep=keep)
        x = x.reshape(B, S, P, C)
        # camera re-injection into the camera token, injection group i + 1
        pe_tok = L.linear(p.pose_embeddings[i + 1], pose_enc) * cam_mask_f
        inj = L.linear(p.camera_adapters[i + 1], pe_tok)
        return torch.cat([x[:, :, :1] + inj[:, :, None], x[:, :, 1:]], dim=2)

    def global_step(tokens, i, keep):
        g = L.block(p.global_blocks[i], tokens.reshape(B, S * P, C), cos_g, sin_g, **kw,
                    shard=global_shard, drop_path_rate=dp_rate, drop_path_keep=keep,
                    kv_valid=kv_valid_tokens)
        return g.reshape(B, S, P, C)

    def pair(tokens, i, keep_first, keep_second):
        """One (frame, global) layer pair: (frame_inter, global_inter)."""
        if cfg.aa_order[0] == "frame":
            frame_inter = frame_step(tokens, i, keep_first)
            return frame_inter, global_step(frame_inter, i, keep_second)
        global_inter = global_step(tokens, i, keep_first)
        return frame_step(global_inter, i, keep_second), global_inter

    wanted = set(output_layers)
    outputs = {}
    tokens = tokens.to(dtype)
    if stream is not None:
        # one frame against the stream's cache: each layer's frame block with
        # the global block's projections, then the cache write and the
        # attention over frames 0..t, then the rest of the global block; the
        # parts whose shapes stay from frame to frame are CUDA graphs on the
        # card (StreamState.replay), which read these tensors in place
        pose_enc, cam_mask_f = stream.constant("no_camera", lambda: (pose_enc, cam_mask_f))
        for i in range(cfg.depth):
            blk = p.global_blocks[i]

            def before(x, i=i, blk=blk):
                f = frame_step(x, i, None)
                h = L.layer_norm(blk.norm1, f.reshape(B, P, C), cfg.ln_eps)
                return (f, *L.attention_qkv(blk.attn, h, cos_f, sin_f, ln_eps=cfg.ln_eps,
                                            int8_dense=int8_dense))

            def after(f, o, i=i, blk=blk):
                x = f.reshape(B, P, C)
                h = L.attention_proj(blk.attn, x, o, int8_dense)
                g = L.block_rest(blk, x, h, ln_eps=cfg.ln_eps, approx_gelu=approx_gelu,
                                 int8_dense=int8_dense).reshape(B, S, P, C)
                return (g, torch.cat([f, g], dim=-1)) if i in wanted else (g,)

            f, q, k, v = stream.replay(("before", i), before, tokens)
            keys, values = stream.global_layer(i).append(k, v)
            o = L.scaled_dot_product_attention(
                q, keys, values, impl=attn_impl, bounded_logits=allow_bounded and cfg.qk_norm,
                qk_int8=int8_qk)
            tokens, *kept = stream.replay(("after", i), after, f, o)
            if kept:
                outputs[i] = kept[0]
        return L.run_forward_hooks(p, (images,), (outputs, psi))
    ckpt_kw = {"context_fn": _DOTS_CONTEXT} if remat == "dots" else {}
    for i in range(cfg.depth):
        if remat and torch.is_grad_enabled():
            frame_inter, global_inter = checkpoint(pair, tokens, i, *keeps[i], use_reentrant=False,
                                                   **ckpt_kw)
        else:
            frame_inter, global_inter = pair(tokens, i, *keeps[i])
        tokens = global_inter if cfg.aa_order[0] == "frame" else frame_inter
        if i in wanted:
            # (frame ‖ global) in this fixed order for either aa_order
            outputs[i] = torch.cat([frame_inter, global_inter], dim=-1)
    return L.run_forward_hooks(p, (images,), (outputs, psi))
