"""The benchmark's frozen analytic counts: floating-point operations of the
forward, layer by layer (a multiply-add is 2), and the operations and bytes
of each attention call, with the card's peaks.

Peaks: NVIDIA H100 SXM5 80 GB data sheet, dense (no sparsity): 989 TFLOP/s
bf16 on the tensor cores, 3.35 TB/s of HBM3. A share of a peak is stated
against them whatever the card's power limit; the run reports the limit.

Counted: every matrix product and convolution of the published model (the
DINOv2 patchify and blocks, the aggregator's frame and global blocks and
its camera and depth injections, the camera head's four iterations, and
each DPT head convolution by convolution at its own resolution). Not
counted: LayerNorm, activations, softmax, resampling and other elementwise
work. Attention counts its two products over the valid keys of the
requested frames only: shape padding is work the request did not need.
"""

from __future__ import annotations

from typing import List, Tuple

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def _block(tokens: int, dim: int, mlp_ratio: float) -> float:
    """Linear layers of a transformer block (qkv, proj, fc1, fc2)."""
    return 2.0 * tokens * dim * dim * (4 + 2 * mlp_ratio)


def _attn(nq: int, nk: int, dim: int) -> float:
    """The two products of one attention (QK^T, PV), all heads."""
    return 4.0 * nq * nk * dim


def _conv(pixels: int, cin: int, cout: int, k: int) -> float:
    return 2.0 * pixels * cin * cout * k * k


def dpt_flops(arch: dict, out_dim: int, H: int, W: int) -> float:
    """One DPT head on one frame, convolution by convolution."""
    d = arch["dpt"]
    ps, f, oc = arch["patch_size"], d["features"], d["out_channels"]
    ph, pw = H // ps, W // ps
    n = ph * pw
    D = 2 * arch["embed_dim"]
    total = sum(_conv(n, D, c, 1) for c in oc)  # projections
    total += _conv(16 * n, oc[0], oc[0], 1)  # 4x4 stride-4 transposed conv
    total += _conv(4 * n, oc[1], oc[1], 1)  # 2x2 stride-2 transposed conv
    h4, w4 = (ph - 1) // 2 + 1, (pw - 1) // 2 + 1
    total += _conv(h4 * w4, oc[3], oc[3], 3)  # 3x3 stride-2 conv
    res = [(4 * ph, 4 * pw), (2 * ph, 2 * pw), (ph, pw), (h4, w4)]
    px = [h * w for h, w in res]
    total += sum(_conv(p, c, f, 3) for p, c in zip(px, oc))  # layer{i}_rn
    rcu = 2 * _conv(1, f, f, 3)  # one residual conv unit, per pixel
    # refinenet4: unit 2 at level 4, 1x1 at level 3; refinenet3..1: units 1
    # and 2 at their level, 1x1 at the next level up (2x level 1 for the last)
    total += rcu * px[3] + _conv(px[2], f, f, 1)
    for lvl, up in ((2, px[1]), (1, px[0]), (0, 4 * px[0])):
        total += 2 * rcu * px[lvl] + _conv(up, f, f, 1)
    total += _conv(4 * px[0], f, f // 2, 3)  # output_conv1 at 2x level 1
    total += _conv(H * W, f // 2, 32, 3) + _conv(H * W, 32, out_dim, 1)
    return total


def forward_flops(arch: dict, S: int, H: int, W: int, depth_gt: bool = False) -> float:
    """One scene of S frames through the whole model."""
    ps, C, R = arch["patch_size"], arch["embed_dim"], arch["num_register_tokens"]
    n = (H // ps) * (W // ps)
    P = 1 + R + n
    total = 0.0
    if arch["patch_embed"] == "conv":
        total += S * _conv(n, 3, C, ps)
    else:
        dn = arch["dino"]
        Cd = dn["embed_dim"]
        total += S * _conv(n, 3, Cd, ps)
        total += S * dn["depth"] * (_block(P, Cd, dn["mlp_ratio"]) + _attn(P, P, Cd))
    if depth_gt:
        total += S * _conv(n, 2, C, ps)
    L = arch["depth"]
    total += L * S * (_block(P, C, arch["mlp_ratio"]) + _attn(P, P, C))
    total += L * (_block(S * P, C, arch["mlp_ratio"]) + _attn(S * P, S * P, C))
    total += (L + 1) * S * 2.0 * (arch["pose_hidden_dim"] * C + C * C)  # injections
    c, D = arch["camera_head"], 2 * C
    per_iter = 2.0 * S * (9 * D + D * 3 * D + D * D // 2 + D // 2 * 9)
    per_iter += c["trunk_depth"] * (_block(S, D, c["mlp_ratio"]) + _attn(S, S, D))
    total += c["num_iterations"] * per_iter
    for head in ("depth_head", "point_head"):
        total += S * dpt_flops(arch, arch[head]["output_dim"], H, W)
    return total


def attention_calls(arch: dict, S: int, H: int, W: int) -> List[Tuple[int, int, int, int, int]]:
    """(calls, query rows, keys, width, heads) of the forward's attention
    over image tokens (DINOv2, frame, global); the camera head's attention
    over S tokens is left out."""
    ps, R = arch["patch_size"], arch["num_register_tokens"]
    P = 1 + R + (H // ps) * (W // ps)
    L, C, h = arch["depth"], arch["embed_dim"], arch["num_heads"]
    calls = [(L * S, P, P, C, h), (L, S * P, S * P, C, h)]
    if arch["patch_embed"] != "conv":
        dn = arch["dino"]
        calls.append((dn["depth"] * S, P, P, dn["embed_dim"], dn["num_heads"]))
    return calls


def attention_bound_s(arch: dict, S: int, H: int, W: int, backward: bool = False) -> float:
    """Least time of the forward's attention calls on the card: for each
    call max(operations / bf16 peak, bytes / HBM bandwidth), bf16 Q, K, V, O
    read or written once. backward adds the four backward products (8 Nq
    Nk d h) and dO, LSE (fp32), dQ, dK, dV once each; a recomputed forward
    is not counted."""
    total = 0.0
    for calls, nq, nk, C, heads in attention_calls(arch, S, H, W):
        ops = _attn(nq, nk, C)
        nbytes = 2.0 * C * (2 * nq + 2 * nk)
        if backward:
            ops += 2 * _attn(nq, nk, C)
            nbytes += 2.0 * C * (2 * nq + 2 * nk) + 4.0 * nq * heads
        total += calls * max(ops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)
    return total
