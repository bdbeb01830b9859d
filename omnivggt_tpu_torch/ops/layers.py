"""Transformer layers: parameter modules plus plain functions over them.

Counterpart of omnivggt_tpu/ops/layers.py. The modules hold parameters
under the reference's state-dict names (`qkv`, `proj`, `q_norm`, `norm1`,
`mlp.fc1`, `ls1.gamma`, `patch_embed.proj`, ...); the computation lives in
plain functions that take a module the way the JAX functions take a
parameter dict, and cast each weight to the activation dtype at its point
of use:

  - linear, layer_norm (fp32 statistics), mlp (exact-erf or tanh GELU, or
    SwiGLU: silu(x1) * x2 through a fused `w12`, then `w3`);
  - qlinear_int8 / dense / qconv2d_int8: the W8A8 fast modes. Weights are
    quantised per output channel at each use, activations per row (per
    image for a convolution), the product is an exact int8 x int8 -> int32
    one, and the epilogue dequantises and adds the bias. These products sit
    outside any kernel of the JAX package (XLA ran them), so on the card
    they go to the library's int8 product (`torch._int_mm`); on the CPU an
    exact float64 product stands in;
  - conv2d_s2d: the 3x3 convolution as one stride-2 4x4 convolution with
    2x2 output pixels folded into channels (an exact rewrite);
  - attention: fused qkv, per-head-dim q/k LayerNorm, 2D RoPE
    (`attention_qkv`), the attention, the projection (`attention_proj`);
    with a `kv_cache` (models/stream.LayerCache) the keys and values go
    into the cache and the queries attend to its prefix (a frame-causal
    stream);
  - block: pre-LN with LayerScale and, when training, stochastic depth
    (drop_path) from keep masks the caller draws; `block_rest` is its part
    after the attention;
  - run_forward_hooks: block, attention, mlp and the model's parts run the
    global module forward hooks and their module's own on their outputs,
    and block runs its module's forward pre-hooks first
    (run_forward_pre_hooks), as a module's __call__ would;
  - patch_embed and conv2d, channels-last like the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.modules import module as _nn_module

from omnivggt_tpu_torch.ops.attention import scaled_dot_product_attention
from omnivggt_tpu_torch.ops.kernels.flash_attention import _scale_of
from omnivggt_tpu_torch.ops.rope import apply_rope


class LayerScale(nn.Module):
    def __init__(self, dim: int, init_values: float = 1.0):
        super().__init__()
        self.init_values = init_values
        self.gamma = nn.Parameter(torch.full((dim,), float(init_values)))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, out_dim: Optional[int] = None, bias: bool = True):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden, bias=bias)
        self.fc2 = nn.Linear(hidden, out_dim or dim, bias=bias)


class SwiGLUFFN(nn.Module):
    """SwiGLU feed-forward parameters under the reference's names: `w12`
    (dim -> 2 * hidden, the two gates fused) and `w3` (hidden -> out)."""

    def __init__(self, dim: int, hidden: int, out_dim: Optional[int] = None, bias: bool = True):
        super().__init__()
        self.w12 = nn.Linear(dim, 2 * hidden, bias=bias)
        self.w3 = nn.Linear(hidden, out_dim or dim, bias=bias)


def swiglu_hidden_fused(hidden_features: int) -> int:
    """The fused SwiGLU's hidden width: 2/3 of the GELU MLP's, rounded up to
    a multiple of 8 (ops/layers.py::swiglu_hidden_fused)."""
    return (int(hidden_features * 2 / 3) + 7) // 8 * 8


def make_ffn(dim: int, mlp_ratio: float, ffn_layer: str = "mlp", bias: bool = True) -> nn.Module:
    """The block's feed-forward for an `ffn_layer` of "mlp", "swiglu" or
    "swiglufused", as the JAX package's block_init builds it."""
    hidden = int(dim * mlp_ratio)
    if ffn_layer == "mlp":
        return Mlp(dim, hidden, bias=bias)
    if ffn_layer in ("swiglu", "swiglufused"):
        if ffn_layer == "swiglufused":
            hidden = swiglu_hidden_fused(hidden)
        return SwiGLUFFN(dim, hidden, bias=bias)
    raise NotImplementedError(ffn_layer)


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, *, qkv_bias=True, proj_bias=True, qk_norm=False):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim, bias=proj_bias)
        if qk_norm:
            self.q_norm = nn.LayerNorm(dim // num_heads)
            self.k_norm = nn.LayerNorm(dim // num_heads)
        else:
            self.q_norm = self.k_norm = None


class Block(nn.Module):
    """Pre-LN transformer block parameters (norm1, attn, norm2, mlp, and
    ls1/ls2 when init_values is set); `ffn_layer` picks the feed-forward
    (make_ffn)."""

    def __init__(
        self, dim: int, num_heads: int, *, mlp_ratio: float = 4.0, qkv_bias=True,
        proj_bias=True, ffn_bias=True, init_values: Optional[float] = None,
        qk_norm=False, ffn_layer: str = "mlp",
    ):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim)
        self.attn = Attention(
            dim, num_heads, qkv_bias=qkv_bias, proj_bias=proj_bias, qk_norm=qk_norm
        )
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = make_ffn(dim, mlp_ratio, ffn_layer, bias=ffn_bias)
        if init_values:
            self.ls1 = LayerScale(dim, init_values)
            self.ls2 = LayerScale(dim, init_values)
        else:
            self.ls1 = self.ls2 = None


class PatchEmbed(nn.Module):
    """Convolutional patchify parameters (`proj`, a stride-p conv)."""

    def __init__(self, patch_size: int, in_chans: int, embed_dim: int):
        super().__init__()
        self.patch_size = patch_size
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size, stride=patch_size)


# ---------------------------------------------------------------------------
# plain functions
# ---------------------------------------------------------------------------


def run_forward_pre_hooks(p: nn.Module, args: tuple) -> None:
    """Run the module's own forward pre-hooks
    (module.register_forward_pre_hook) before a layer, as nn.Module.__call__
    does before a module's forward; their results are not used. FSDP
    (parallel/fsdp.py) gathers a block's sharded parameters in one."""
    for hook in tuple(p._forward_pre_hooks.values()):
        hook(p, args)


def run_forward_hooks(p: nn.Module, args: tuple, out):
    """Run the global module forward hooks
    (torch.nn.modules.module.register_module_forward_hook), then the
    module's own (module.register_forward_hook), on a layer's output, as
    nn.Module.__call__ does for a module's forward. The port's layers are
    plain functions over their modules, so without this such a hook
    (utils.validation.enable_nan_debugging; FSDP's release of a block's
    gathered parameters) would see only the top-level call. Nothing runs
    while no hook is registered."""
    hooks = _nn_module._global_forward_hooks
    if not hooks and not p._forward_hooks:
        return out
    with_kwargs = _nn_module._global_forward_hooks_with_kwargs
    for hook_id, hook in tuple(hooks.items()):
        res = hook(p, args, {}, out) if with_kwargs.get(hook_id) else hook(p, args, out)
        if res is not None:
            out = res
    for hook in tuple(p._forward_hooks.values()):
        res = hook(p, args, out)
        if res is not None:
            out = res
    return out


def _cast(t: Optional[torch.Tensor], dtype):
    return None if t is None else t.to(dtype)


def linear(p: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, p.weight.to(x.dtype), _cast(p.bias, x.dtype))


def _int8_matmul(a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """Exact int32-valued product of int8 a (M, K) with the transpose of
    int8 b_t (N, K), returned as fp32 (M, N).

    On the card: `torch._int_mm`, which takes more than 16 rows and K and N
    in multiples of 8, so the operands are zero-padded up to that (zeros
    add nothing to an integer sum). On the CPU: a float64 product, exact
    because 127^2 K stays far below 2^53 (an fp32 product is not: 127^2 *
    4096 > 2^24)."""
    M, K = a.shape
    N = b_t.shape[0]
    if a.device.type != "cuda":
        return (a.double() @ b_t.double().t()).float()
    pad_m, pad_k, pad_n = max(32 - M, 0) + (-max(M, 32)) % 8, (-K) % 8, (-N) % 8
    if pad_m or pad_k:
        a = F.pad(a, (0, pad_k, 0, pad_m))
    if pad_n or pad_k:
        b_t = F.pad(b_t, (0, pad_k, 0, pad_n))
    y = torch._int_mm(a.contiguous(), b_t.contiguous().t())
    return y[:M, :N].float()


def _int8_step(amax: torch.Tensor) -> torch.Tensor:
    """max-abs -> the int8 step max(amax, 1e-12) / 127, as the jitted JAX
    package computes it (a multiplication by fp32(1 / 127): `_scale_of`)."""
    return _scale_of(amax, 1e-12)


def _quantise_weight(w: torch.Tensor):
    """(int8 weight, (out,) fp32 scales): symmetric max-abs per output
    channel (the leading axis), round(w / scale)."""
    wf = w.float()
    ws = _int8_step(wf.abs().flatten(1).amax(dim=1))
    wq = torch.round(wf / ws.reshape(-1, *([1] * (w.dim() - 1)))).to(torch.int8)
    return wq, ws


def _quantise_rows(x: torch.Tensor):
    """(int8 activations, (..., 1) fp32 scales): symmetric max-abs per row
    of the last axis, the max taken in x's dtype, round(x / scale)."""
    ax = _int8_step(x.abs().amax(dim=-1, keepdim=True).float())
    return torch.round(x.float() / ax).to(torch.int8), ax


def qlinear_int8(p: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """W8A8 dense (counterpart of ops/layers.py::qlinear_int8): weights
    quantised per output channel, activations per row from max |x| over the
    last axis (taken in x's dtype), an exact int8 x int8 -> int32 product,
    then (y * a_scale) * w_scale + bias in fp32, cast to x's dtype. The
    weights are quantised at each use, so no separate int8 state exists."""
    wq, ws = _quantise_weight(p.weight)  # (out, in), (out,)
    xq, ax = _quantise_rows(x)
    y = _int8_matmul(xq.reshape(-1, x.shape[-1]), wq).reshape(*x.shape[:-1], -1)
    y = y * ax * ws
    if p.bias is not None:
        y = y + p.bias.float()
    return y.to(x.dtype)


def dense(p: nn.Linear, x: torch.Tensor, int8: bool = False) -> torch.Tensor:
    """linear() or qlinear_int8() on one flag (the trunk-quant dispatch)."""
    return qlinear_int8(p, x) if int8 else linear(p, x)


def _quant_gates(trunk_quant):
    """(quantise the LayerNorm-fed matmuls, quantise the residual writers)
    for a trunk_quant mode: "int8" quantises all four block matmuls,
    "int8_ln" only qkv and fc1, whose inputs are LayerNorm outputs and whose
    outputs pass through qk-norm / GELU instead of writing the residual
    stream."""
    if trunk_quant in (True, "int8"):
        return True, True
    if trunk_quant == "int8_ln":
        return True, False
    return False, False


def layer_norm(p: Optional[nn.LayerNorm], x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis with fp32 statistics whatever x's dtype;
    p=None normalises without an affine transform."""
    w = b = None
    if p is not None:
        w, b = p.weight.float(), p.bias.float()
    return F.layer_norm(x.float(), (x.shape[-1],), w, b, eps).to(x.dtype)


def mlp(p, x: torch.Tensor, approx_gelu: bool = False, int8_dense=False) -> torch.Tensor:
    """fc1 -> GELU (exact erf, or tanh with approx_gelu) -> fc2 for an Mlp;
    w12 -> silu(x1) * x2 -> w3 for a SwiGLUFFN (approx_gelu does not apply).
    int8_dense (a trunk_quant mode) picks which of the two products run
    W8A8: fc1 / w12 take the LayerNorm-fed gate, fc2 / w3 the residual
    writers'."""
    q_ln, q_res = _quant_gates(int8_dense)
    if isinstance(p, SwiGLUFFN):
        x1, x2 = dense(p.w12, x, q_ln).chunk(2, dim=-1)
        return run_forward_hooks(p, (x,), dense(p.w3, F.silu(x1) * x2, q_res))
    h = F.gelu(dense(p.fc1, x, q_ln), approximate="tanh" if approx_gelu else "none")
    return run_forward_hooks(p, (x,), dense(p.fc2, h, q_res))


def conv2d(p, x: torch.Tensor, stride=1, padding=0, int8: bool = False) -> torch.Tensor:
    """NCHW convolution with the module's weight cast to x's dtype; int8
    runs it W8A8 (qconv2d_int8). p: an nn.Conv2d or anything with `weight`
    (out, in, kh, kw) and `bias`."""
    if int8:
        return qconv2d_int8(p, x, stride=stride, padding=padding)
    return F.conv2d(x, p.weight.to(x.dtype), _cast(p.bias, x.dtype), stride, padding)


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def qconv2d_int8(p, x: torch.Tensor, stride=1, padding=0) -> torch.Tensor:
    """W8A8 NCHW convolution (counterpart of ops/layers.py::qconv2d_int8):
    weights quantised per output channel, activations per image, an exact
    int8 x int8 -> int32 convolution, then (y * a_scale) * w_scale + bias
    in fp32, cast to x's dtype.

    PyTorch has no int8 convolution, and an fp32 one of integer values is
    not exact (9 * 256 * 127^2 > 2^24). On the card the convolution is the
    sum over the kh * kw taps of one `torch._int_mm` each: the quantised
    image is padded once in channels-last int8, each tap's shifted (and
    strided) window is copied to an (B * Ho * Wo, cin) int8 matrix and
    multiplied by that tap's (cin, cout) weights, and the int32 results
    are added. On the CPU a float64 convolution is exact."""
    w = p.weight
    cout, cin, kh, kw = w.shape
    (sh, sw), (ph, pw) = _pair(stride), _pair(padding)
    wq, ws = _quantise_weight(w)
    xf = x.float()
    ax = _int8_step(xf.abs().amax(dim=(1, 2, 3), keepdim=True))
    xq = torch.round(xf / ax)
    if x.device.type != "cuda":
        y = F.conv2d(xq.double(), wq.double(), None, (sh, sw), (ph, pw)).float()
    else:
        B, _, H, W = x.shape
        ho, wo = (H + 2 * ph - kh) // sh + 1, (W + 2 * pw - kw) // sw + 1
        xp = F.pad(xq.to(torch.int8).permute(0, 2, 3, 1), (0, 0, pw, pw, ph, ph))
        acc = None
        for dy in range(kh):
            for dx in range(kw):
                win = xp[:, dy : dy + sh * (ho - 1) + 1 : sh, dx : dx + sw * (wo - 1) + 1 : sw]
                part = _int8_matmul(win.reshape(-1, cin), wq[:, :, dy, dx])
                acc = part if acc is None else acc.add_(part)
        y = acc.reshape(B, ho, wo, cout).permute(0, 3, 1, 2)
    y = y * ax * ws.reshape(1, -1, 1, 1)
    if p.bias is not None:
        y = y + p.bias.float().reshape(1, -1, 1, 1)
    return y.to(x.dtype)


class _ConvParams:
    """A weight and bias held like an nn.Conv2d's, for derived kernels."""

    def __init__(self, weight, bias=None):
        self.weight, self.bias = weight, bias


def conv2d_s2d(p, x: torch.Tensor, int8: bool = False) -> torch.Tensor:
    """3x3 stride-1 pad-1 convolution with 2x2 output pixels folded into
    channels (counterpart of ops/layers.py::conv2d_s2d): one stride-2 4x4
    convolution with 4 * cout output channels whose extra taps are exact
    zeros, then a depth-to-space pass. Numerically the 3x3 convolution up
    to the order of the sum. Needs a 3x3 kernel and even H, W."""
    w = p.weight
    cout, cin, kh, kw = w.shape
    B, _, H, W = x.shape
    if kh != 3 or kw != 3 or H % 2 or W % 2:
        raise ValueError(
            f"conv2d_s2d needs a 3x3 kernel and even H, W; got {tuple(w.shape)}, {tuple(x.shape)}"
        )
    # w4[(dy, dx, co), ci, ty, tx] = w[co, ci, ty - dy, tx - dx], zero out of range
    w4 = w.new_zeros(2, 2, cout, cin, 4, 4)
    for dy in range(2):
        for dx in range(2):
            w4[dy, dx, :, :, dy : dy + 3, dx : dx + 3] = w
    y = conv2d(_ConvParams(w4.reshape(4 * cout, cin, 4, 4)), x, stride=2, padding=1, int8=int8)
    y = y.reshape(B, 2, 2, cout, H // 2, W // 2).permute(0, 3, 4, 1, 5, 2).reshape(B, cout, H, W)
    if p.bias is not None:
        y = y + p.bias.to(y.dtype).reshape(1, -1, 1, 1)
    return y


def drop_path_masks(n: int, count: int, rate: float, generator: torch.Generator,
                    device) -> torch.Tensor:
    """(count, n) fp32 per-sample Bernoulli(1 - rate) keep masks for
    `count` residual branches, drawn from `generator` (on `device`)."""
    keep = torch.full((count, n), 1.0 - rate, device=device)
    return torch.bernoulli(keep, generator=generator)


def drop_path(x: torch.Tensor, keep: torch.Tensor, rate: float) -> torch.Tensor:
    """Stochastic depth (counterpart of ops/layers.py::drop_path): x times a
    per-sample keep mask over the leading axis, scaled by 1/keep_prob. The
    mask is an input, drawn before any activation checkpoint, so the
    recomputed forward drops the same samples."""
    shape = (x.shape[0],) + (1,) * (x.ndim - 1)
    return x * (keep.reshape(shape) / (1.0 - rate)).to(x.dtype)


def attention_qkv(
    p: Attention,
    x: torch.Tensor,
    rope_cos: Optional[torch.Tensor] = None,
    rope_sin: Optional[torch.Tensor] = None,
    *,
    ln_eps: float = 1e-5,
    int8_dense=False,
):
    """The attention's (q, k, v), (B, N, H, D) each, of (B, N, C) tokens:
    fused qkv, optional per-head-dim q/k LayerNorm, RoPE on q and k from
    (N, head_dim) tables. int8_dense (a trunk_quant mode) runs qkv W8A8."""
    B, N, C = x.shape
    H = p.num_heads
    q_ln, _ = _quant_gates(int8_dense)
    qkv = dense(p.qkv, x, q_ln).reshape(B, N, 3, H, C // H)
    q, k, v = qkv.unbind(2)  # (B, N, H, D) views
    if p.q_norm is not None:
        q = layer_norm(p.q_norm, q, ln_eps)
        k = layer_norm(p.k_norm, k, ln_eps)
    if rope_cos is not None:
        q = apply_rope(q, rope_cos, rope_sin)
        k = apply_rope(k, rope_cos, rope_sin)
    return q, k, v


def attention_proj(p: Attention, x: torch.Tensor, o: torch.Tensor, int8_dense=False):
    """The attention's output projection of o (B, N, H, D); x is the
    attention's (B, N, C) input, which its module's hooks are given."""
    _, q_res = _quant_gates(int8_dense)
    return run_forward_hooks(p, (x,), dense(p.proj, o.reshape(x.shape), q_res))


def attention(
    p: Attention,
    x: torch.Tensor,
    rope_cos: Optional[torch.Tensor] = None,
    rope_sin: Optional[torch.Tensor] = None,
    *,
    ln_eps: float = 1e-5,
    impl: str = "auto",
    shard=None,
    kv_valid=None,
    allow_bounded: bool = True,
    int8_dense=False,
    int8_qk: bool = False,
    kv_cache=None,
) -> torch.Tensor:
    """Multi-head self-attention over (B, N, C) tokens: `attention_qkv`,
    the attention, `attention_proj`.
    kv_cache: a models/stream.LayerCache: k and v (after the norm and RoPE)
    are written into its slot and q attends to every cached key up to and
    including them (`LayerCache.append`), a strided view of the cache.
    int8_dense (a trunk_quant mode) runs qkv and proj W8A8; int8_qk asks
    the flash kernels for int8 scores (config.attn_quant, serving only).
    shard: an AttnShard (parallel/sharding.py) that runs the attention
    itself under a mesh-parallel strategy; int8_qk is passed to it as is.

    The fixed-max softmax is used when qk-norm is present and allow_bounded
    holds: after the norm, |q.k|/sqrt(D) <= sqrt(D)*(max|g_q|+max|b_q|)*
    (max|g_k|+max|b_k|), which checkpoint loading checks against the
    kernel's clamp (utils/validation)."""
    q, k, v = attention_qkv(p, x, rope_cos, rope_sin, ln_eps=ln_eps, int8_dense=int8_dense)
    if kv_cache is not None:
        k, v = kv_cache.append(k, v)
    bounded = allow_bounded and p.q_norm is not None
    if shard is not None:
        o = shard.attend(
            q, k, v, impl, kv_valid=kv_valid, bounded_logits=bounded, qk_int8=int8_qk
        )
    else:
        o = scaled_dot_product_attention(
            q, k, v, impl=impl, kv_valid=kv_valid, bounded_logits=bounded, qk_int8=int8_qk
        )
    return attention_proj(p, x, o, int8_dense)


def block(
    p: Block,
    x: torch.Tensor,
    rope_cos: Optional[torch.Tensor] = None,
    rope_sin: Optional[torch.Tensor] = None,
    *,
    ln_eps: float = 1e-5,
    attn_impl: str = "auto",
    shard=None,
    kv_valid=None,
    allow_bounded: bool = True,
    approx_gelu: bool = False,
    drop_path_rate: float = 0.0,
    drop_path_keep: Optional[torch.Tensor] = None,
    int8_dense=False,
    int8_qk: bool = False,
    kv_cache=None,
) -> torch.Tensor:
    """x += DP(LS1(Attn(LN(x), rope))); x += DP(LS2(MLP(LN(x)))), where DP
    is stochastic depth, active only when `drop_path_keep` (2, x.shape[0]
    keep masks, drop_path_masks) is given and drop_path_rate > 0.
    kv_cache: the attention's (`attention`)."""
    run_forward_pre_hooks(p, (x,))
    h = attention(
        p.attn, layer_norm(p.norm1, x, ln_eps), rope_cos, rope_sin,
        ln_eps=ln_eps, impl=attn_impl, shard=shard, kv_valid=kv_valid,
        allow_bounded=allow_bounded, int8_dense=int8_dense, int8_qk=int8_qk,
        kv_cache=kv_cache,
    )
    return block_rest(p, x, h, ln_eps=ln_eps, approx_gelu=approx_gelu,
                      drop_path_rate=drop_path_rate, drop_path_keep=drop_path_keep,
                      int8_dense=int8_dense)


def block_rest(
    p: Block,
    x: torch.Tensor,
    h: torch.Tensor,
    *,
    ln_eps: float = 1e-5,
    approx_gelu: bool = False,
    drop_path_rate: float = 0.0,
    drop_path_keep: Optional[torch.Tensor] = None,
    int8_dense=False,
) -> torch.Tensor:
    """The block after its attention: x + DP(LS1(h)), then its MLP's
    residual (`block`); h is the attention's output on the block's input
    x, whose hooks are run on the result."""
    use_dp = drop_path_rate > 0.0 and drop_path_keep is not None
    x_in = x
    if p.ls1 is not None:
        h = h * p.ls1.gamma.to(h.dtype)
    if use_dp:
        h = drop_path(h, drop_path_keep[0], drop_path_rate)
    x = x + h
    h = mlp(p.mlp, layer_norm(p.norm2, x, ln_eps), approx_gelu=approx_gelu,
            int8_dense=int8_dense)
    if p.ls2 is not None:
        h = h * p.ls2.gamma.to(h.dtype)
    if use_dp:
        h = drop_path(h, drop_path_keep[1], drop_path_rate)
    return run_forward_hooks(p, (x_in,), x + h)


def patch_embed(p: PatchEmbed, x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C_in) channels-last images -> (B, N, D) patch tokens."""
    H, W = x.shape[1:3]
    ps = p.patch_size
    if H % ps or W % ps:
        raise ValueError(f"image size {(H, W)} not divisible by patch size {ps}")
    y = conv2d(p.proj, x.permute(0, 3, 1, 2), stride=ps)  # (B, D, gh, gw)
    return y.flatten(2).transpose(1, 2)
