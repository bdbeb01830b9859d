"""StreamVGGT in plain float32 PyTorch: the reference of the frame-causal
configuration (`configs/streamvggt-1b.json`).

Written from the published model (Zhuo, Zheng et al., "Streaming 4D Visual
Geometry Transformer", arXiv 2507.11539; github.com/wzzheng/StreamVGGT):
VGGT-1B's layers (the ones of `model.py`, whose parameters and names it
shares) with temporal causal global attention: the tokens of frame t attend
only to the tokens of frames 0..t. This is the whole-clip forward, with no
cache: each global block computes every frame's queries, keys and values
and attends in blocks of query rows, each block reading only the keys of
the frames up to its own. Everything runs in float32 with TF32 off
(`model.exact_float32()`).

Departures, each a choice of this benchmark:
  - the camera head's trunk, which attends over the frames' pose tokens,
    is causal too: in each of its iterations frame t's token attends to
    frames 0..t of that iteration. That follows from the streaming
    principle (a frame is answered before the next one exists); it is not
    checked against the official code;
  - the track head is left out (the program has none);
  - OmniVGGT's camera adapters, pose embeddings and depth placeholder are
    present, as in `model.py`; this configuration's weights set the
    adapters' biases and the placeholder to zero, so with no GT input they
    add nothing (images only: no GT cameras or depth).

This module imports torch and the plain reference's layers only.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference import model as R

# query rows a block of the causal attention; scores of one block are
# (B, heads, rows, keys of frames 0..t) float32
QUERY_BLOCK = 512


def attend_causal(q, k, v, tokens_per_frame: int):
    """Frame-causal softmax(q k^T / sqrt(d)) v over (B, S * P, H, D): the
    queries of frame f attend to the keys of frames 0..f. Scores and
    softmax in float32, P V accumulated in float32, in blocks of at most
    QUERY_BLOCK query rows inside a frame."""
    P = tokens_per_frame
    scale = q.shape[-1] ** -0.5
    out = []
    for f in range(q.shape[1] // P):
        stop = (f + 1) * P
        kt = k[:, :stop].float().permute(0, 2, 3, 1)  # (B, H, D, keys)
        vh = v[:, :stop].float().transpose(1, 2)  # (B, H, keys, D)
        for i in range(f * P, stop, QUERY_BLOCK):
            qb = q[:, i:min(i + QUERY_BLOCK, stop)].float().transpose(1, 2)
            probs = torch.softmax((qb @ kt) * scale, dim=-1).to(v.dtype).float()
            out.append((probs @ vh).transpose(1, 2).to(q.dtype))
    return torch.cat(out, dim=1)


def causal_block(p: R.Block, x, eps: float, gelu: str, rope, tokens_per_frame: int):
    """`model.block` with frame-causal attention over (B, S * P, C)."""
    B, N, C = x.shape
    a = p.attn
    h = R.layer_norm(p.norm1, x, eps)
    q, k, v = R.lin(a.qkv, h).reshape(B, N, 3, a.heads, C // a.heads).unbind(2)
    if a.q_norm is not None:
        q, k = R.layer_norm(a.q_norm, q, eps), R.layer_norm(a.k_norm, k, eps)
    if rope is not None:
        q, k = R.rotate(q, *rope), R.rotate(k, *rope)
    o = attend_causal(q, k, v, tokens_per_frame).reshape(B, N, C)
    x = x + R.lin(a.proj, o) * p.ls1.gamma.to(x.dtype)
    h = F.gelu(R.lin(p.mlp.fc1, R.layer_norm(p.norm2, x, eps)), approximate=gelu)
    return x + R.lin(p.mlp.fc2, h) * p.ls2.gamma.to(x.dtype)


def aggregate(p: R.Aggregator, a: dict, images, dt=torch.float32):
    """`model.aggregate` of images alone, the global blocks frame-causal.
    Returns ({layer: (B, S, P, 2C)} of the layers the heads read, the index
    of the first patch token)."""
    B, S, H, W, _ = images.shape
    C, ps, eps = a["embed_dim"], a["patch_size"], a["ln_eps"]
    gh, gw = H // ps, W // ps
    psi = 1 + a["num_register_tokens"]
    P = psi + gh * gw
    dev = images.device
    mean = torch.tensor(R.RESNET_MEAN, device=dev, dtype=dt)
    std = torch.tensor(R.RESNET_STD, device=dev, dtype=dt)
    x = ((images.to(dt) - mean) / std).reshape(B * S, H, W, 3).permute(0, 3, 1, 2)
    if a["patch_embed"] == "conv":
        patches = R.conv(p.patch_embed.proj, x).flatten(2).transpose(1, 2)
    else:
        patches = R.dino(p.patch_embed, a, x, False)
    patches = patches.reshape(B, S, gh * gw, C) + p.depth_placeholder.to(dt)[None]

    def special(tok):  # slot 0 for the clip's first frame, slot 1 for the rest
        tok = tok.to(dt)
        return torch.cat([tok[:, :1].expand(B, 1, -1, -1), tok[:, 1:].expand(B, S - 1, -1, -1)], 1)

    pose = torch.zeros(B, S, a["pose_hidden_dim"], device=dev, dtype=dt)
    no_camera = torch.zeros(B, S, 1, device=dev, dtype=dt)
    cam_tok = special(p.camera_token)
    cam_tok = cam_tok + R.lin(p.camera_adapters[0], R.lin(p.pose_embeddings[0], pose) * no_camera)[:, :, None]
    tokens = torch.cat([cam_tok, special(p.register_token), patches], dim=2)

    cos, sin = R.rope_tables(gh, gw, psi, C // a["num_heads"], a["rope_freq"], dev)
    rope_f, rope_g = (cos, sin), (cos.repeat(S, 1), sin.repeat(S, 1))
    gelu = a["trunk_gelu"]
    wanted = set(a["dpt"]["intermediate_layer_idx"]) | {a["depth"] - 1}
    layers = {}
    for i in range(a["depth"]):
        f = R.block(p.frame_blocks[i], tokens.reshape(B * S, P, C), eps, gelu, rope_f)
        f = f.reshape(B, S, P, C)
        inj = R.lin(p.camera_adapters[i + 1], R.lin(p.pose_embeddings[i + 1], pose) * no_camera)
        f = torch.cat([f[:, :, :1] + inj[:, :, None], f[:, :, 1:]], dim=2)
        tokens = causal_block(p.global_blocks[i], f.reshape(B, S * P, C), eps, gelu, rope_g, P)
        tokens = tokens.reshape(B, S, P, C)
        if i in wanted:
            layers[i] = torch.cat([f, tokens], dim=-1)
    return layers, psi


def camera_head(p: R.CameraHead, a: dict, last):
    """`model.camera_head` with its trunk frame-causal (one token a frame)."""
    c = a["camera_head"]
    eps = c["ln_eps"]
    tokens = R.layer_norm(p.token_norm, last[:, :, 0], eps)
    B, S, _ = tokens.shape
    normed = R.layer_norm(None, tokens, c["adaln_eps"])
    mod = p.poseLN_modulation[1]
    pred, out = None, []
    for it in range(c["num_iterations"]):
        prev = p.empty_pose_tokens.to(tokens.dtype).expand(B, S, -1) if it == 0 else pred
        shift, scale, gate = R.lin(mod, F.silu(R.lin(p.embed_pose, prev))).chunk(3, -1)
        x = gate * (normed * (1 + scale) + shift) + tokens
        for blk in p.trunk:
            x = causal_block(blk, x, eps, "none", None, 1)
        h = R.lin(p.pose_branch.fc1, R.layer_norm(p.trunk_norm, x, eps))
        delta = R.lin(p.pose_branch.fc2, F.gelu(h))
        pred = delta if it == 0 else pred + delta
        pf = pred.float()
        out.append(torch.cat([pf[..., :7], F.relu(pf[..., 7:])], dim=-1))
    return torch.stack(out)


class StreamVGGT(R.OmniVGGT):
    """The parameters of `model.OmniVGGT` under the published names;
    `forward` of whole clips, frame-causal."""

    def forward(self, images):
        """images (B, S, H, W, 3) in [0, 1], each clip's frames in order.
        Returns the prediction dict of every frame (pose_enc,
        pose_enc_list, depth, depth_conf, world_points, world_points_conf),
        channels last, float32."""
        a = self.arch
        layers, psi = aggregate(self.aggregator, a, images)
        pose_list = camera_head(self.camera_head, a, layers[a["depth"] - 1])
        out = {"pose_enc": pose_list[-1], "pose_enc_list": pose_list}
        H, W = images.shape[2:4]
        for name, head, key in (("depth_head", self.depth_head, "depth"),
                                ("point_head", self.point_head, "world_points")):
            raw = R.dpt_head(head, a, [layers[i] for i in a["dpt"]["intermediate_layer_idx"]],
                             (H, W), psi, False).float()
            vals, conf = raw[..., :-1], raw[..., -1]
            if a[name]["activation"] == "exp":
                vals = torch.exp(vals)
            else:  # inv_log
                vals = torch.sign(vals) * torch.expm1(vals.abs())
            out[key], out[f"{key}_conf"] = vals, 1 + torch.exp(conf)
        return out
