"""OmniVGGT in plain float32 PyTorch: the benchmark's reference.

Written from the published model (Livioni/OmniVGGT-official
`omnivggt/models/omnivggt.py`, arXiv 2511.10560, on VGGT's layers): a DINOv2
ViT patch embedder with register tokens, alternating frame / global
attention blocks with 2D RoPE and qk-norm, GT cameras injected through
per-layer adapters into the camera token, GT depth patchified into the
patch tokens, an iterative adaLN camera head and two DPT heads. The
parameter names are the published state dict's, so one state dict loads
into this module and into the program under test.

Everything runs in float32 with TF32 off (`exact_float32()`; the layers
compute in their input's dtype, which the model keeps float32). Attention
is computed in blocks of query rows so that a 32-view scene's global
attention (43,968 tokens) fits. Departures from the
published code: the DINOv2 position embedding is resampled only when the
patch grid differs from the stored one (bicubic with antialias, as
published); padding and masking of shape-padded frames are absent, since
the reference always runs the real frames alone.

This module imports torch and numpy only.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

RESNET_MEAN = (0.485, 0.456, 0.406)
RESNET_STD = (0.229, 0.224, 0.225)
# query rows a block of the blocked attention; scores of one block are
# (B, heads, rows, keys) float32
QUERY_BLOCK = 1024


@contextlib.contextmanager
def exact_float32():
    """TF32 off for matrix products and convolutions inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


class LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.empty(dim))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, out: Optional[int] = None):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, out or dim)


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int, qk_norm: bool):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.q_norm = nn.LayerNorm(dim // heads) if qk_norm else None
        self.k_norm = nn.LayerNorm(dim // heads) if qk_norm else None


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: float, qk_norm: bool = False):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim)
        self.attn = Attention(dim, heads, qk_norm)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.ls1 = LayerScale(dim)
        self.ls2 = LayerScale(dim)


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, cin: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(cin, dim, patch, stride=patch)


def layer_norm(p: Optional[nn.LayerNorm], x, eps: float):
    """Statistics and affine in float32, the result in x's dtype."""
    return F.layer_norm(x.float(), (x.shape[-1],), None if p is None else p.weight,
                        None if p is None else p.bias, eps).to(x.dtype)


def lin(m: nn.Linear, x):
    """A linear layer in x's dtype (its weights cast where used)."""
    return F.linear(x, m.weight.to(x.dtype), None if m.bias is None else m.bias.to(x.dtype))


def conv(m, x, transposed: bool = False):
    fn = F.conv_transpose2d if transposed else F.conv2d
    return fn(x, m.weight.to(x.dtype), None if m.bias is None else m.bias.to(x.dtype),
              stride=m.stride, padding=m.padding)


def attend(q, k, v):
    """softmax(q k^T / sqrt(d)) v over (B, N, H, D): scores and softmax in
    float32, the probabilities rounded to v's dtype, P V accumulated in
    float32; in blocks of query rows."""
    scale = q.shape[-1] ** -0.5
    kt = k.float().permute(0, 2, 3, 1)  # (B, H, D, Nk)
    vh = v.float().transpose(1, 2)  # (B, H, Nk, D)
    out = []
    for i in range(0, q.shape[1], QUERY_BLOCK):
        qb = q[:, i:i + QUERY_BLOCK].float().transpose(1, 2)  # (B, H, n, D)
        probs = torch.softmax((qb @ kt) * scale, dim=-1).to(v.dtype).float()
        out.append((probs @ vh).transpose(1, 2).to(q.dtype))
    return torch.cat(out, dim=1)


def rotate(x, cos, sin):
    """2D RoPE: the first half of the head dim turns with y, the second
    with x; within each half, rotate-half at a quarter."""
    y1, y2, x1, x2 = x.split(x.shape[-1] // 4, dim=-1)
    cos, sin = cos.to(x.dtype)[None, :, None], sin.to(x.dtype)[None, :, None]
    return x * cos + torch.cat([-y2, y1, -x2, x1], dim=-1) * sin


def block(p: Block, x, eps: float, gelu: str, rope=None):
    B, N, C = x.shape
    a = p.attn
    h = layer_norm(p.norm1, x, eps)
    q, k, v = lin(a.qkv, h).reshape(B, N, 3, a.heads, C // a.heads).unbind(2)
    if a.q_norm is not None:
        q, k = layer_norm(a.q_norm, q, eps), layer_norm(a.k_norm, k, eps)
    if rope is not None:
        q, k = rotate(q, *rope), rotate(k, *rope)
    o = attend(q, k, v).reshape(B, N, C)
    x = x + lin(a.proj, o) * p.ls1.gamma.to(x.dtype)
    h = F.gelu(lin(p.mlp.fc1, layer_norm(p.norm2, x, eps)), approximate=gelu)
    return x + lin(p.mlp.fc2, h) * p.ls2.gamma.to(x.dtype)


def rope_tables(gh: int, gw: int, specials: int, head_dim: int, freq: float, device):
    """(N, head_dim) cos and sin: special tokens at position (0, 0), the
    patch grid row-major at (y + 1, x + 1)."""
    yy, xx = torch.meshgrid(torch.arange(gh, dtype=torch.float64),
                            torch.arange(gw, dtype=torch.float64), indexing="ij")
    pos = torch.stack([yy.reshape(-1), xx.reshape(-1)], -1) + 1
    pos = torch.cat([torch.zeros(specials, 2, dtype=torch.float64), pos])
    half = head_dim // 2
    inv = 1.0 / freq ** (torch.arange(0, half, 2, dtype=torch.float64) / half)
    ang = [torch.cat([pos[:, a:a + 1] * inv] * 2, dim=-1) for a in (0, 1)]
    ang = torch.cat(ang, dim=-1)
    return ang.cos().float().to(device), ang.sin().float().to(device)


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------


def se3_inverse(m):
    R, t = m[..., :3, :3], m[..., :3, 3:]
    Rt = R.transpose(-1, -2)
    top = torch.cat([Rt, -Rt @ t], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def homog(ex):
    bottom = torch.zeros_like(ex[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([ex, bottom], dim=-2)


def rebase(ex, mask):
    """(B, S, 3, 4) world-to-camera extrinsics relative to the first camera
    that `mask` (B, S) selects, translations divided by the mean distance
    of the other selected cameras' translations to it."""
    B, S = ex.shape[:2]
    first = mask.int().argmax(dim=1)
    b = torch.arange(B, device=ex.device)
    new = homog(ex) @ se3_inverse(homog(ex)[b, first])[:, None]
    t = new[:, :, :3, 3]
    dist = (t - t[b, first][:, None]).norm(dim=-1)
    others = mask & (torch.arange(S, device=ex.device)[None] != first[:, None])
    n = others.sum(dim=1)
    mean = (dist * others).sum(dim=1) / n.clamp_min(1)
    scale = torch.where(n > 0, mean.clamp_min(1e-6), 1.0)
    return torch.cat([new[:, :, :3, :3], (t / scale[:, None, None])[..., None]], dim=-1)


def matrix_to_quaternion(m):
    """Rotations (..., 3, 3) -> unit quaternions (x, y, z, w) with w >= 0,
    from the best conditioned of the four candidate forms."""
    m00, m01, m02, m10, m11, m12, m20, m21, m22 = m.reshape(m.shape[:-2] + (9,)).unbind(-1)
    sq = torch.stack([1 + m00 + m11 + m22, 1 + m00 - m11 - m22,
                      1 - m00 + m11 - m22, 1 - m00 - m11 + m22], dim=-1)
    q_abs = torch.where(sq > 0, torch.sqrt(sq.clamp_min(0)), 0.0)
    cand = torch.stack([
        torch.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], dim=-1),
        torch.stack([m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20], dim=-1),
        torch.stack([m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21], dim=-1),
        torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2], dim=-1),
    ], dim=-2) / (2.0 * q_abs[..., None].clamp_min(0.1))
    best = q_abs.argmax(dim=-1)
    q = torch.gather(cand, -2, best[..., None, None].expand(*best.shape, 1, 4))[..., 0, :]
    q = q[..., [1, 2, 3, 0]]
    return torch.where(q[..., 3:4] < 0, -q, q)


def pose_encoding(ex, K, hw):
    """(B, S, 9): translation, quaternion (x, y, z, w), vertical and
    horizontal field of view."""
    H, W = hw
    fov_h = 2 * torch.atan((H / 2) / K[..., 1, 1])
    fov_w = 2 * torch.atan((W / 2) / K[..., 0, 0])
    return torch.cat([ex[..., :3, 3], matrix_to_quaternion(ex[..., :3, :3]),
                      fov_h[..., None], fov_w[..., None]], dim=-1)


def masked_pose_encoding(ex, K, mask, hw):
    """The pose encoding of GT cameras rebased on the frames `mask` selects;
    unselected frames take identity cameras."""
    m = mask[:, :, None, None]
    ex = torch.where(m, ex, torch.eye(3, 4, device=ex.device))
    K = torch.where(m, K, torch.eye(3, device=ex.device))
    return pose_encoding(rebase(ex, mask), K, hw)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


class Dino(nn.Module):
    def __init__(self, a: dict):
        super().__init__()
        d = a["dino"]
        C, grid = d["embed_dim"], d["img_size"] // a["patch_size"]
        self.patch_embed = PatchEmbed(a["patch_size"], 3, C)
        self.cls_token = nn.Parameter(torch.empty(1, 1, C))
        self.pos_embed = nn.Parameter(torch.empty(1, grid * grid + 1, C))
        self.register_tokens = nn.Parameter(torch.empty(1, a["num_register_tokens"], C))
        self.blocks = nn.ModuleList(Block(C, d["num_heads"], d["mlp_ratio"]) for _ in range(d["depth"]))
        self.norm = nn.LayerNorm(C)


class Aggregator(nn.Module):
    def __init__(self, a: dict):
        super().__init__()
        C, depth = a["embed_dim"], a["depth"]
        if a["patch_embed"] == "conv":
            self.patch_embed = PatchEmbed(a["patch_size"], 3, C)
        else:
            self.patch_embed = Dino(a)
        self.camera_token = nn.Parameter(torch.empty(1, 2, 1, C))
        self.register_token = nn.Parameter(torch.empty(1, 2, a["num_register_tokens"], C))

        def stack():
            return nn.ModuleList(Block(C, a["num_heads"], a["mlp_ratio"], qk_norm=True)
                                 for _ in range(depth))

        self.frame_blocks = stack()
        self.global_blocks = stack()
        self.pose_embeddings = nn.ModuleList(nn.Linear(a["pose_hidden_dim"], C)
                                             for _ in range(depth + 1))
        self.camera_adapters = nn.ModuleList(nn.Linear(C, C) for _ in range(depth + 1))
        self.depth_placeholder = nn.Parameter(torch.empty(1, 1, C))
        self.depth_patch_embed = PatchEmbed(a["patch_size"], 2, C)


class CameraHead(nn.Module):
    def __init__(self, a: dict):
        super().__init__()
        c, D = a["camera_head"], 2 * a["embed_dim"]
        self.trunk = nn.ModuleList(Block(D, c["num_heads"], c["mlp_ratio"])
                                   for _ in range(c["trunk_depth"]))
        self.token_norm = nn.LayerNorm(D)
        self.trunk_norm = nn.LayerNorm(D)
        self.empty_pose_tokens = nn.Parameter(torch.empty(1, 1, 9))
        self.embed_pose = nn.Linear(9, D)
        self.poseLN_modulation = nn.Sequential(nn.SiLU(), nn.Linear(D, 3 * D))
        self.pose_branch = Mlp(D, D // 2, 9)


class ResidualConvUnit(nn.Module):
    def __init__(self, f: int):
        super().__init__()
        self.conv1 = nn.Conv2d(f, f, 3, padding=1)
        self.conv2 = nn.Conv2d(f, f, 3, padding=1)


class FusionBlock(nn.Module):
    def __init__(self, f: int, residual: bool = True):
        super().__init__()
        self.out_conv = nn.Conv2d(f, f, 1)
        self.resConfUnit1 = ResidualConvUnit(f) if residual else None
        self.resConfUnit2 = ResidualConvUnit(f)


class Scratch(nn.Module):
    def __init__(self, f: int, channels, out_dim: int):
        super().__init__()
        for i, c in enumerate(channels, start=1):
            setattr(self, f"layer{i}_rn", nn.Conv2d(c, f, 3, padding=1, bias=False))
        self.refinenet1 = FusionBlock(f)
        self.refinenet2 = FusionBlock(f)
        self.refinenet3 = FusionBlock(f)
        self.refinenet4 = FusionBlock(f, residual=False)
        self.output_conv1 = nn.Conv2d(f, f // 2, 3, padding=1)
        self.output_conv2 = nn.Sequential(nn.Conv2d(f // 2, 32, 3, padding=1), nn.ReLU(),
                                          nn.Conv2d(32, out_dim, 1))


class DPTHead(nn.Module):
    def __init__(self, a: dict, out_dim: int):
        super().__init__()
        d = a["dpt"]
        oc, D = d["out_channels"], 2 * a["embed_dim"]
        self.norm = nn.LayerNorm(D)
        self.projects = nn.ModuleList(nn.Conv2d(D, c, 1) for c in oc)
        self.resize_layers = nn.ModuleList([
            nn.ConvTranspose2d(oc[0], oc[0], 4, stride=4),
            nn.ConvTranspose2d(oc[1], oc[1], 2, stride=2),
            nn.Identity(),
            nn.Conv2d(oc[3], oc[3], 3, stride=2, padding=1),
        ])
        self.scratch = Scratch(d["features"], oc, out_dim)


class OmniVGGT(nn.Module):
    """Parameters under the published names; `forward` of one batch."""

    def __init__(self, arch: dict):
        super().__init__()
        self.arch = arch
        self.aggregator = Aggregator(arch)
        self.camera_head = CameraHead(arch)
        self.depth_head = DPTHead(arch, arch["depth_head"]["output_dim"])
        self.point_head = DPTHead(arch, arch["point_head"]["output_dim"])

    def forward(self, images, extrinsics=None, intrinsics=None, depth=None, depth_valid=None,
                camera_mask=None, depth_mask=None, checkpoint_blocks: bool = False):
        """images (B, S, H, W, 3) in [0, 1]; GT cameras (B, S, 3, 4) and
        (B, S, 3, 3) with camera_mask (B, S); GT depth (B, S, H, W, 1) with
        its validity (B, S, H, W) and depth_mask (B, S). Returns the
        prediction dict (pose_enc, pose_enc_list, depth, depth_conf,
        world_points, world_points_conf), channels last, float32.
        checkpoint_blocks recomputes each block in the backward (training
        memory)."""
        a = self.arch
        layers, psi = aggregate(self.aggregator, a, images, extrinsics, intrinsics, depth,
                                depth_valid, camera_mask, depth_mask, checkpoint_blocks)
        pose_list = camera_head(self.camera_head, a, layers[a["depth"] - 1])
        out = {"pose_enc": pose_list[-1], "pose_enc_list": pose_list}
        H, W = images.shape[2:4]
        for name, head, key in (("depth_head", self.depth_head, "depth"),
                                ("point_head", self.point_head, "world_points")):
            raw = dpt_head(head, a, [layers[i] for i in a["dpt"]["intermediate_layer_idx"]],
                           (H, W), psi, checkpoint_blocks)
            raw = raw.float()
            vals, conf = raw[..., :-1], raw[..., -1]
            if a[name]["activation"] == "exp":
                vals = torch.exp(vals)
            else:  # inv_log
                vals = torch.sign(vals) * torch.expm1(vals.abs())
            out[key], out[f"{key}_conf"] = vals, 1 + torch.exp(conf)
        return out


def _run(fn, *args, ckpt: bool = False):
    if ckpt and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def dino(p: Dino, a: dict, x, ckpt: bool):
    d = a["dino"]
    B, _, H, W = x.shape
    gh, gw = H // a["patch_size"], W // a["patch_size"]
    t = conv(p.patch_embed.proj, x).flatten(2).transpose(1, 2)
    pe = p.pos_embed
    n = pe.shape[1] - 1
    if n != gh * gw:
        M = math.isqrt(n)
        grid = pe[:, 1:].reshape(1, M, M, -1).permute(0, 3, 1, 2)
        grid = F.interpolate(grid, size=(gh, gw), mode="bicubic", antialias=True)
        pe = torch.cat([pe[:, :1], grid.permute(0, 2, 3, 1).reshape(1, gh * gw, -1)], dim=1)
    dt = x.dtype
    t = torch.cat([p.cls_token.to(dt).expand(B, 1, -1), t], dim=1) + pe.to(dt)
    t = torch.cat([t[:, :1], p.register_tokens.to(dt).expand(B, -1, -1), t[:, 1:]], dim=1)
    for blk in p.blocks:
        t = _run(lambda z, blk=blk: block(blk, z, d["ln_eps"], a["trunk_gelu"]), t, ckpt=ckpt)
    t = layer_norm(p.norm, t, d["ln_eps"])
    return t[:, 1 + a["num_register_tokens"]:]


def aggregate(p: Aggregator, a: dict, images, extrinsics, intrinsics, depth, depth_valid,
              camera_mask, depth_mask, ckpt: bool, dt=torch.float32):
    B, S, H, W, _ = images.shape
    C, ps, eps = a["embed_dim"], a["patch_size"], a["ln_eps"]
    gh, gw = H // ps, W // ps
    psi = 1 + a["num_register_tokens"]
    P = psi + gh * gw
    dev = images.device
    mean = torch.tensor(RESNET_MEAN, device=dev, dtype=dt)
    std = torch.tensor(RESNET_STD, device=dev, dtype=dt)
    x = ((images.to(dt) - mean) / std).reshape(B * S, H, W, 3).permute(0, 3, 1, 2)
    if a["patch_embed"] == "conv":
        patches = conv(p.patch_embed.proj, x).flatten(2).transpose(1, 2)
    else:
        patches = dino(p.patch_embed, a, x, ckpt)
    patches = patches.reshape(B, S, gh * gw, C)

    def special(tok):
        tok = tok.to(dt)
        return torch.cat([tok[:, :1].expand(B, 1, -1, -1), tok[:, 1:].expand(B, S - 1, -1, -1)], 1)

    cam_tok, reg_tok = special(p.camera_token), special(p.register_token)
    if camera_mask is not None:
        pose = masked_pose_encoding(extrinsics.float(), intrinsics.float(), camera_mask,
                                    (H, W)).to(dt)
        cam_f = camera_mask[..., None].to(dt)
    else:
        pose = torch.zeros(B, S, a["pose_hidden_dim"], device=dev, dtype=dt)
        cam_f = torch.zeros(B, S, 1, device=dev, dtype=dt)
    gt_cam = lin(p.pose_embeddings[0], pose) * cam_f
    cam_tok = cam_tok + lin(p.camera_adapters[0], gt_cam)[:, :, None]

    if depth_mask is not None:
        d, valid = depth[..., 0].float(), depth_valid.float()
        sel = valid * depth_mask[:, :, None, None]
        total, cnt = (d * sel).sum(dim=(1, 2, 3)), sel.sum(dim=(1, 2, 3))
        m = (total / cnt.clamp_min(1.0))[:, None, None, None]
        dn = torch.where(cnt[:, None, None, None] > 0, d / (m + 1e-8), 0.0) * valid
        dm = torch.stack([dn, valid], dim=-1).reshape(B * S, H, W, 2).permute(0, 3, 1, 2)
        dtok = conv(p.depth_patch_embed.proj, dm.to(dt)).flatten(2).transpose(1, 2)
        dtok = dtok.reshape(B, S, gh * gw, C)
        patches = patches + torch.where(depth_mask[:, :, None, None], dtok,
                                        p.depth_placeholder.to(dt)[None])
    else:
        patches = patches + p.depth_placeholder.to(dt)[None]
    tokens = torch.cat([cam_tok, reg_tok, patches], dim=2)

    cos, sin = rope_tables(gh, gw, psi, C // a["num_heads"], a["rope_freq"], dev)
    rope_f, rope_g = (cos, sin), (cos.repeat(S, 1), sin.repeat(S, 1))
    gelu = a["trunk_gelu"]

    def pair(t, i):
        f = block(p.frame_blocks[i], t.reshape(B * S, P, C), eps, gelu, rope_f).reshape(B, S, P, C)
        inj = lin(p.camera_adapters[i + 1], lin(p.pose_embeddings[i + 1], pose) * cam_f)
        f = torch.cat([f[:, :, :1] + inj[:, :, None], f[:, :, 1:]], dim=2)
        g = block(p.global_blocks[i], f.reshape(B, S * P, C), eps, gelu, rope_g).reshape(B, S, P, C)
        return f, g

    wanted = set(a["dpt"]["intermediate_layer_idx"]) | {a["depth"] - 1}
    layers = {}
    for i in range(a["depth"]):
        f, tokens = _run(pair, tokens, i, ckpt=ckpt)
        if i in wanted:
            layers[i] = torch.cat([f, tokens], dim=-1)
    return layers, psi


def camera_head(p: CameraHead, a: dict, last):
    c = a["camera_head"]
    eps = c["ln_eps"]
    tokens = layer_norm(p.token_norm, last[:, :, 0], eps)
    B, S, _ = tokens.shape
    normed = layer_norm(None, tokens, c["adaln_eps"])
    mod = p.poseLN_modulation[1]
    pred, out = None, []
    for it in range(c["num_iterations"]):
        prev = p.empty_pose_tokens.to(tokens.dtype).expand(B, S, -1) if it == 0 else pred.detach()
        shift, scale, gate = lin(mod, F.silu(lin(p.embed_pose, prev))).chunk(3, -1)
        x = gate * (normed * (1 + scale) + shift) + tokens
        for blk in p.trunk:
            x = block(blk, x, eps, "none")
        delta = lin(p.pose_branch.fc2, F.gelu(lin(p.pose_branch.fc1, layer_norm(p.trunk_norm, x, eps))))
        pred = delta if it == 0 else pred + delta
        pf = pred.float()
        out.append(torch.cat([pf[..., :7], F.relu(pf[..., 7:])], dim=-1))
    return torch.stack(out)


def uv_embedding(w: int, h: int, dim: int, aspect: float, device):
    """(dim, h, w) sinusoidal embedding of the UV grid normalised by the
    image diagonal, built in float64."""
    diag = (aspect ** 2 + 1) ** 0.5
    sx, sy = aspect / diag, 1 / diag
    f64 = dict(dtype=torch.float64, device=device)
    xs = torch.linspace(-sx * (w - 1) / w, sx * (w - 1) / w, w, **f64)
    ys = torch.linspace(-sy * (h - 1) / h, sy * (h - 1) / h, h, **f64)
    v, u = torch.meshgrid(ys, xs, indexing="ij")
    half = dim // 2
    omega = 1.0 / 100.0 ** (torch.arange(half // 2, **f64) / (half / 2.0))

    def sincos(x):
        x = x.reshape(-1, 1) * omega
        return torch.cat([x.sin(), x.cos()], dim=1)

    return torch.cat([sincos(u), sincos(v)], dim=-1).float().reshape(h, w, dim).permute(2, 0, 1)


def _with_uv(x, W: int, H: int):
    c, h, w = x.shape[1:]
    return x + (0.1 * uv_embedding(w, h, c, W / H, x.device)).to(x.dtype)


def _rcu(p: ResidualConvUnit, x):
    x = F.relu(x)
    return conv(p.conv2, F.relu(conv(p.conv1, x))) + x


def _fuse(p: FusionBlock, x, residual=None, size=None):
    if residual is not None:
        x = x + _rcu(p.resConfUnit1, residual)
    x = _rcu(p.resConfUnit2, x)
    size = size if size is not None else (2 * x.shape[-2], 2 * x.shape[-1])
    return conv(p.out_conv, F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=True))


def _dpt_frames(p: DPTHead, a: dict, levels, hw, ph: int, pw: int):
    H, W = hw
    D = 2 * a["embed_dim"]
    feats = []
    for i, x in enumerate(levels):
        x = layer_norm(p.norm, x, a["dpt"]["ln_eps"]).transpose(1, 2).reshape(x.shape[0], D, ph, pw)
        x = _with_uv(conv(p.projects[i], x), W, H)
        if i != 2:
            x = conv(p.resize_layers[i], x, transposed=i < 2)
        feats.append(x)
    s = p.scratch
    l1, l2, l3, l4 = (conv(getattr(s, f"layer{i + 1}_rn"), feats[i]) for i in range(4))
    out = _fuse(s.refinenet4, l4, size=l3.shape[-2:])
    out = _fuse(s.refinenet3, out, l3, size=l2.shape[-2:])
    out = _fuse(s.refinenet2, out, l2, size=l1.shape[-2:])
    out = _fuse(s.refinenet1, out, l1)
    out = conv(s.output_conv1, out)
    out = F.interpolate(out, size=(ph * a["patch_size"], pw * a["patch_size"]), mode="bilinear",
                        align_corners=True)
    out = _with_uv(out, W, H)
    out = F.relu(conv(s.output_conv2[0], out))
    return conv(s.output_conv2[2], out).permute(0, 2, 3, 1)


def dpt_head(p: DPTHead, a: dict, layers: List[torch.Tensor], hw, psi: int, ckpt: bool,
             chunk: int = 8):
    """Raw (B, S, H, W, out_dim) head output, frames in chunks of `chunk`."""
    H, W = hw
    ph, pw = H // a["patch_size"], W // a["patch_size"]
    B, S = layers[0].shape[:2]
    toks = [t[:, :, psi:].reshape(B * S, ph * pw, -1) for t in layers]
    outs = [_run(lambda *lv: _dpt_frames(p, a, lv, hw, ph, pw),
                 *[t[i:i + chunk] for t in toks], ckpt=ckpt)
            for i in range(0, B * S, chunk)]
    out = torch.cat(outs)
    return out.reshape(B, S, *out.shape[1:])


def state_shapes(arch: dict) -> Dict[str, tuple]:
    """{published parameter name: shape} of the model `arch` describes."""
    with torch.device("meta"):
        model = OmniVGGT(arch)
    return {name: tuple(t.shape) for name, t in model.state_dict().items()}
