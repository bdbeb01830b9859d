"""Fused ring flash attention for a sequence sharded over logical ranks,
and its plain version.

Counterparts of the TPU kernels of omnivggt_tpu/ops/pallas/ring_attention.py:

  - `ring_flash_attention` replaces `_ring_kernel`: shards that meet its
    contract (nl <= MAX_LOCAL_SEQ, divisible by the query chunk and the
    blocks) attend `CHUNK_Q` query rows at a time, and the K/V ring makes
    one whole rotation per query chunk; any other shard is handed to
  - `ring_flash_attention_hbm`, which replaces `_ring_hbm_kernel`: state
    for the whole shard, one rotation whatever the shard length, ragged
    shards allowed (the tail of a shard's last key tile is masked in every
    rotating shard; the TPU kernel's padding to whole blocks is not needed
    and `hbm_ring_padded_len` only feeds the dispatch).

Both take (B, N, H, D) tensors whose token axis is sharded over the
`seq_axis` ranks of a mesh (parallel/mesh.py): rank r owns rows
[r * nl, (r + 1) * nl) of q and of the output, and its own two-slot K/V
ring buffer. They compute, per rank, softmax(q_r K_all^T D^-0.5) V_all with
fp32 accumulation, non-causal, so the order in which shards arrive does not
matter.

  - `bounded_logits=True`: fixed softmax max of 0 with exp(min(s, 80));
    otherwise a running max carried across the ring steps.
  - `qk_int8=True`: q, k and v are quantised per head by `quant_ring` (q on
    each rank's own max-abs, k and v on the max over all ranks, so every
    rotating shard shares one int8 grid), the scores are an exact s8 x s8
    product times c0 = q_s k_s D^-0.5, int8 v is converted to bf16 (exactly)
    for P @ V, and its scale c1 multiplies the final acc / l. The quantisation
    pass is plain torch ops, outside the kernel as on the TPU. Serving only.

On CUDA tensors both wrappers launch csrc/ring_attention.cu (one staging
launch and one launch per ring step with the ranks as a grid axis; the
rotation is done by dedicated blocks of the step's own launch; see the
source) or raise; they take bf16 with head dim 64 or 128 and return bf16.
On the card the two TPU kernels are the same kernel, `ring_step_tma` (the
forward kernel's TMA + wgmma tile, 128 query rows a block), in a bf16 form
and an int8 form (s8 scores; the int8 V tiles converted to bf16 in shared
memory, so the ring buffer and the rotation stay int8); the wrappers keep
their contracts, their dispatch and their launch counters here
(`_ring_launch`: quantise, then `_ring_run`: the kernel). On CPU
tensors they compute `ring_attention_plain`: per-rank shards in a list, the
(m, l, acc) carry step by step in fp32, P rounded to v's dtype before
P @ V as the TPU kernels round it, the rotation as a rotation of the
list, chunked as the first kernel is, padded and masked as the second is.
Neither wrapper has a backward (the TPU kernels have none): a gradient asked
of them on CUDA raises. The TPU wrappers' `interpret` and `handshake`
arguments have no meaning here and are not carried over.

Each wrapper counts the calls in which it launched its kernel in a plain
integer attribute, `launches` (one per call: a call is n + 1 kernel
launches per query chunk).
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading

import torch

from omnivggt_tpu_torch.ops.kernels import build
from omnivggt_tpu_torch.ops.kernels.flash_attention import (
    BOUNDED_CLAMP,
    HEAD_DIMS,
    NEG_INF,
    _on_cpu,
    _raise_on,
    _scale_of,
    _strides,
    _vector_aligned,
    _wants_grad,
)

DEFAULT_BLOCK_Q = 512
DEFAULT_BLOCK_K = 512
# The dispatch constants of the TPU kernels, kept so that both packages send
# a shape to the same wrapper. They come from the TPU's on-chip memory, not
# from this card (both ring buffers live in device memory here).
CHUNK_Q = 2048  # query rows per ring pass of ring_flash_attention
MAX_LOCAL_SEQ = 16384  # longest shard ring_flash_attention takes itself
MAX_LOCAL_SEQ_HBM = 28672  # longest (padded) shard ring_flash_attention_hbm takes
MAX_RANKS = 16  # the kernel's per-rank pointer tables
SOURCE = "ring_attention.cu"


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def hbm_ring_padded_len(nl: int, block_q: int = DEFAULT_BLOCK_Q,
                        block_k: int = DEFAULT_BLOCK_K) -> int:
    """The shard length rounded up to lcm(block_q, block_k): what the TPU
    kernel pads to, and the value the dispatch holds against
    MAX_LOCAL_SEQ_HBM."""
    return _round_up(nl, math.lcm(block_q, block_k))


def fits_hbm_ring(nl: int, block_q: int = DEFAULT_BLOCK_Q,
                  block_k: int = DEFAULT_BLOCK_K) -> bool:
    return hbm_ring_padded_len(nl, block_q, block_k) <= MAX_LOCAL_SEQ_HBM


def _local_len(q, n_ranks: int) -> int:
    N = q.shape[1]
    if n_ranks < 1 or N % n_ranks:
        raise ValueError(f"sequence length {N} does not divide over {n_ranks} ranks")
    return N // n_ranks


def quant_ring(q, k, v, n_ranks: int, scale: float):
    """Counterpart of `_quant_ring`, for all ranks at once: (B, N, H, D)
    float tensors whose rows [r * nl, (r + 1) * nl) are rank r's shard ->
    int8 q, k, v of the same shape and the (n_ranks, B*H, 2) fp32 table the
    kernel reads. q uses each rank's own per-head max-abs (it never leaves
    the rank); k and v use the per-head max over all ranks, taken as one
    reduction of the stacked per-rank maxes, so every rotating shard shares
    one int8 grid, equal to that of the whole array. Column 0 of the table
    is q_s * k_s * scale (per rank), column 1 is v_s. Divisions are by a
    tensor (`_scale_of`), so the card's grid equals the CPU's."""
    B, N, H, D = q.shape
    nl = _local_len(q, n_ranks)

    def ranks(x):  # (B, n, nl, H, D) view
        return x.reshape(B, n_ranks, nl, H, D)

    q_s = _scale_of(ranks(q).float().abs().amax(dim=(2, 4)), 1e-30)  # (B, n, H)
    q8 = torch.round(ranks(q).float() / q_s[:, :, None, :, None]).to(torch.int8)
    local = torch.stack(
        [ranks(k).float().abs().amax(dim=(2, 4)), ranks(v).float().abs().amax(dim=(2, 4))], dim=-1
    )  # (B, n, H, 2): each rank's own maxes
    kv_s = _scale_of(local.amax(dim=1), 1e-30)  # (B, H, 2): the max over the ranks
    k_s, v_s = kv_s[..., 0], kv_s[..., 1]
    k8 = torch.round(k.float() / k_s[:, None, :, None]).to(torch.int8)
    v8 = torch.round(v.float() / v_s[:, None, :, None]).to(torch.int8)
    c0 = q_s * k_s[:, None] * scale  # (B, n, H)
    c = torch.stack([c0, v_s[:, None].expand_as(c0)], dim=-1)  # (B, n, H, 2)
    c = c.permute(1, 0, 2, 3).reshape(n_ranks, B * H, 2).contiguous()
    return q8.reshape(B, N, H, D), k8, v8, c


def _ring_plain(qs, ks, vs, score_mul, out_mul, bounded, chunk, nl_pad, p_dtype):
    """The ring in plain fp32 torch ops. qs, ks, vs: per-rank lists of fp32
    (B, nl, H, D) shards. score_mul: per-rank (B, H) tensors or one float;
    out_mul: a (B, H) tensor or None (the int8 form). p_dtype: the type the
    probabilities are rounded to before P @ V, as the TPU kernels round
    them to their v tiles' type (bf16 for bf16 v and for the int8 form's
    converted v; fp32, no rounding, for fp32 v); the row sums stay fp32.
    Returns the per-rank fp32 outputs."""
    n = len(qs)
    B, nl, H, D = qs[0].shape
    pad = nl_pad - nl
    if pad:
        qs, ks, vs = ([torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad)) for x in xs]
                      for xs in (qs, ks, vs))
    key_masked = torch.arange(nl_pad, device=qs[0].device) >= nl
    outs = [[] for _ in range(n)]
    for q0 in range(0, nl_pad, chunk):
        # one whole rotation per query chunk, from a fresh copy of the shards
        cur_k, cur_v = list(ks), list(vs)
        dev = qs[0].device
        m = [torch.full((B, H, chunk), NEG_INF, device=dev) for _ in range(n)]
        l = [torch.zeros((B, H, chunk), device=dev) for _ in range(n)]
        acc = [torch.zeros((B, H, chunk, D), device=dev) for _ in range(n)]
        for step in range(n):
            for r in range(n):
                mul = score_mul[r][:, :, None, None] if isinstance(score_mul, list) else score_mul
                s = torch.einsum("bqhd,bkhd->bhqk", qs[r][:, q0:q0 + chunk], cur_k[r]) * mul
                if pad:
                    s = s.masked_fill(key_masked, NEG_INF)
                vr = cur_v[r].transpose(1, 2)  # (B, H, nl, D)
                if bounded:
                    p = s.clamp_max(BOUNDED_CLAMP).exp()
                else:
                    m_new = torch.maximum(m[r], s.amax(-1))
                    p = (s - m_new[..., None]).exp()
                    corr = (m[r] - m_new).exp()
                    l[r], acc[r], m[r] = l[r] * corr, acc[r] * corr[..., None], m_new
                l[r] = l[r] + p.sum(-1)
                acc[r] = acc[r] + p.to(p_dtype).float() @ vr
            if step + 1 < n:
                # every shard moves to its right neighbour: rank r now holds
                # what rank r - 1 held
                cur_k = [cur_k[(r - 1) % n] for r in range(n)]
                cur_v = [cur_v[(r - 1) % n] for r in range(n)]
        for r in range(n):
            o = acc[r] / l[r][..., None]  # only now
            if out_mul is not None:
                o = o * out_mul[:, :, None, None]
            outs[r].append(o.transpose(1, 2))
    return [torch.cat(o, dim=1)[:, :nl] for o in outs]


def ring_attention_plain(q, k, v, n_ranks: int, bounded_logits: bool = False,
                         chunk_q: int = None, pad_to: int = None, qk_int8: bool = False):
    """Plain PyTorch version of both ring kernels: (B, N, H, D) with rank
    r's shard in rows [r * nl, (r + 1) * nl) -> (B, N, H, D) in q's dtype.
    chunk_q: query rows per ring pass (the first kernel; default: the whole
    shard). pad_to: shard length after zero padding, the padded keys masked
    at -1e30 (the second kernel; default: no padding). qk_int8: on the int8
    grids of `quant_ring`."""
    nl = _local_len(q, n_ranks)
    B, _, H, D = q.shape
    scale, out_dtype = D**-0.5, q.dtype
    nl_pad = nl if pad_to is None else pad_to
    chunk = nl_pad if chunk_q is None else min(chunk_q, nl_pad)
    if nl_pad < nl or nl_pad % chunk:
        raise ValueError(f"shard {nl} padded to {nl_pad} does not divide into chunks of {chunk}")
    if qk_int8:
        q8, k8, v8, c = quant_ring(q, k, v, n_ranks, scale)
        table = c.reshape(n_ranks, B, H, 2)
        score_mul, out_mul = [table[r, :, :, 0] for r in range(n_ranks)], table[0, :, :, 1]
        q, k, v = q8, k8, v8
        p_dtype = torch.bfloat16  # the kernels' int8 v converts to bf16
    else:
        score_mul, out_mul, p_dtype = scale, None, v.dtype
    qs, ks, vs = (list(x.float().chunk(n_ranks, dim=1)) for x in (q, k, v))
    outs = _ring_plain(qs, ks, vs, score_mul, out_mul, bool(bounded_logits), chunk, nl_pad,
                       p_dtype)
    return torch.cat(outs, dim=1).to(out_dtype)


def reorder_tolerance(ref, v, n_keys: int):
    """Per-entry bound on the difference between two bf16 kernels that
    compute the same bounded-mode attention from the same bf16 inputs and
    differ only in the order of their fp32 sums (the fixed max makes every
    probability, and its bf16 rounding, independent of the tiling): each
    accumulates P @ V in n_keys / 16 tensor-core steps, each step rounding
    the partial sum (at most l max|v|) by at most 2^-23 of itself, so the
    two quotients acc / l differ by at most 2 (n_keys / 16) 2^-23 max|v|;
    each row sum l adds n_keys / 4 terms per thread in fp32, which moves
    the quotient by at most 2 (n_keys / 4) 2^-24 of itself; and rounding
    two such values to bf16 can land them one bf16 step apart, at most
    2^-7 of the value. The counts hold for the wgmma tile that the bf16
    ring and the head-major kernel share (64 x 128 tiles: a thread holds 2
    rows x 32 columns, n_keys / 4 of a row's terms in all, and P @ V steps
    16 keys at a time). Not in the bound: two score products that sum the
    same D terms in another order may round a score differently, and a P
    that then crosses a bf16 rounding boundary moves o by 2^-8 p / l |v|;
    that takes an ulp of S to land on a boundary, a chance of about 2^-16
    per score (worst err/tol on the H100 at the flagship shape: 0.909)."""
    steps = n_keys / 16
    return (2 * steps * 2.0**-23 * v.float().abs().max()
            + (2.0**-7 + 2 * (n_keys / 4) * 2.0**-24) * ref.float().abs())


_BUILD_LOCK = threading.Lock()


def _library():
    with _BUILD_LOCK:
        return _library_locked()


@functools.lru_cache(maxsize=None)
def _library_locked():
    lib, log = build.load(SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    ptrs = ctypes.POINTER(ctypes.c_void_p)
    fn = lib.omnivggt_ring_attention
    fn.argtypes = [
        i32, i32, i32,                  # bounded, D, int8
        ptrs, ptrs, ptrs, ptrs,         # q, k, v, o: per-rank pointers
        ptrs, ptrs, ptrs, ptrs,         # slots, acc, ml, c
        ctypes.POINTER(ctypes.c_longlong),  # 12 strides
        i32, i32, i32, i32, i32, i32,   # B, H, nl, q0, q_rows, n_ranks
        i32, ctypes.c_float, ptr,       # skip_rotation_at, scale, stream
        i32, i32,                       # kv_head_shift, drop_last_key_tile
    ]
    fn.restype = ctypes.c_int
    return fn, log


def load_kernels() -> str:
    """Build and load the kernel now (it otherwise builds at first launch);
    returns the compiler log, empty where the library was cached."""
    return _library()[1]


def _pointer_table(tensors):
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def ring_launch_shape(head_dim: int, int8: bool) -> tuple:
    """(threads a block, dynamic shared-memory bytes a block) of the ring's
    step kernel at this head dim in the bf16 or the int8 form: the layout of
    csrc/attend_sm90.cuh's `Smem` (a Q tile, the K, bf16 V and, int8, int8 V
    stages of 128 rows, the mbarriers, 1 KB to align the base), worked out
    here so that the CPU checks it against the block's 227 KB;
    chip_smoke.py holds it against the built source's own count."""
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"the ring kernel takes head dim in {HEAD_DIMS}, got {head_dim}")
    esize = 1 if int8 else 2  # q and k (and the ring buffer)
    stages = (4 if head_dim == 64 else 3) if int8 else (3 if head_dim == 64 else 2)
    stage_bytes = esize + 2 + (1 if int8 else 0)  # K, bf16 V, int8 V: bytes a value
    tiles = 128 * head_dim * (esize + stages * stage_bytes)
    barriers = 8 * (1 + (4 if int8 else 3) * stages)
    return 384, tiles + barriers + 1024


def built_launch_shape(head_dim: int, int8: bool) -> tuple:
    """`ring_launch_shape` as the built kernel library reports it (needs
    the card's toolkit)."""
    lib, _ = build.load(SOURCE)
    threads, smem = lib.omnivggt_ring_attention_threads, lib.omnivggt_ring_attention_smem_bytes
    threads.argtypes, smem.argtypes = [], [ctypes.c_int, ctypes.c_int]
    threads.restype = smem.restype = ctypes.c_int
    return threads(), smem(int(head_dim), int(bool(int8)))


def _check_shapes(q, k, v, n_ranks) -> int:
    """One (B, N, H, D) shape for q, k, v, N divisible over the ranks;
    returns the shard length."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one (B, N, H, D) shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    return _local_len(q, n_ranks)


def _ring_run(q, k, v, table, n_ranks, bounded_logits, chunk_q=None, skip_rotation_at=-1,
              kv_head_shift=0, drop_last_key_tile=False):
    """The ring kernel on CUDA tensors as it takes them: bf16 q, k, v with
    table None, or the int8 grids and the (n_ranks, B*H, 2) fp32 table of
    `quant_ring` (the int8 form). One ring pass per query chunk; returns
    (o, slots), slots the per-rank ring buffers (2, 2, B*H, nl, D) as the
    last pass left them. Counts nothing: `_ring_launch` counts, and a bench
    times the kernel alone through this on grids made once. Planted faults
    for the checks (-1 / 0 / False on every real call): skip_rotation_at, a
    step whose rotation is left out; kv_head_shift, K and V read from head
    (h + shift) % H; drop_last_key_tile, the last 128-key tile of every
    shard left out."""
    nl = _check_shapes(q, k, v, n_ranks)
    B, N, H, D = q.shape
    int8 = table is not None
    want = torch.int8 if int8 else torch.bfloat16
    if (q.dtype, k.dtype, v.dtype) != (want,) * 3:
        raise TypeError(f"the ring kernel takes {want} q, k, v here, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"the ring kernel takes head dim in {HEAD_DIMS}, got {D}")
    if n_ranks > MAX_RANKS or B * H > 65535:
        raise ValueError(f"the ring kernel takes up to {MAX_RANKS} ranks and B*H <= 65535")
    dev = q.device
    if int8:
        if table.shape != (n_ranks, B * H, 2) or table.device != dev:
            raise ValueError(f"the int8 table must be (n_ranks, B*H, 2) = {(n_ranks, B * H, 2)} "
                             f"on {dev}, got {tuple(table.shape)} on {table.device}")
        table = table.float().contiguous()
    q, k, v = (_vector_aligned(x) for x in (q, k, v))
    o = torch.empty((B, N, H, D), dtype=torch.bfloat16, device=dev)
    chunk = nl if chunk_q is None else min(chunk_q, nl)

    def shards(x):
        return [x[:, r * nl:(r + 1) * nl] for r in range(n_ranks)]

    # every rank's own buffers: its ring slots and its softmax state, for
    # whole 128-row query tiles (the state's layout is the kernel's own)
    rows = _round_up(chunk, 128)
    slots = [torch.empty((2, 2, B * H, nl, D), dtype=k.dtype, device=dev) for _ in range(n_ranks)]
    acc = [torch.empty((B * H, rows, D), dtype=torch.float32, device=dev) for _ in range(n_ranks)]
    ml = [torch.empty((2, B * H, rows), dtype=torch.float32, device=dev) for _ in range(n_ranks)]
    tables = [_pointer_table(shards(x)) for x in (q, k, v, o)]
    tables += [_pointer_table(x) for x in (slots, acc, ml)]
    c_table = _pointer_table(list(table)) if int8 else None
    fn = _library()[0]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for q0 in range(0, nl, chunk):
            err = fn(
                int(bool(bounded_logits)), D, int(int8), *tables, c_table,
                _strides(q, k, v, o), B, H, nl, q0, min(chunk, nl - q0), n_ranks,
                skip_rotation_at, D**-0.5, stream, int(kv_head_shift),
                int(bool(drop_last_key_tile)),
            )
            _raise_on(err, "ring attention")
    return o, slots


def _ring_launch(counter, q, k, v, n_ranks, bounded_logits, qk_int8, chunk_q=None,
                 skip_rotation_at=-1, kv_head_shift=0, drop_last_key_tile=False):
    """The ring on bf16 CUDA tensors, counted on `counter`: qk_int8 puts q,
    k, v on the grids of `quant_ring` first; then `_ring_run` (which
    returns (o, slots) and takes the same planted faults in both forms)."""
    _check_shapes(q, k, v, n_ranks)
    D = q.shape[-1]
    if (q.dtype, k.dtype, v.dtype) != (torch.bfloat16,) * 3:
        raise TypeError(f"the ring kernel takes bf16 q, k, v, got {q.dtype}/{k.dtype}/{v.dtype}")
    if _wants_grad(q, k, v):
        raise ValueError("the ring kernels are forward only (no gradient)")
    table = None
    if qk_int8:
        q, k, v, table = quant_ring(q, k, v, n_ranks, D**-0.5)
    out = _ring_run(q, k, v, table, n_ranks, bounded_logits, chunk_q, skip_rotation_at,
                    kv_head_shift, drop_last_key_tile)
    counter.launches += 1
    return out


def ring_flash_attention_hbm(q, k, v, mesh, seq_axis: str = "seq",
                             block_q: int = DEFAULT_BLOCK_Q, block_k: int = DEFAULT_BLOCK_K,
                             bounded_logits: bool = False, qk_int8: bool = False):
    """Ring flash attention over (B, N, H, D) with N sharded on the
    `seq_axis` ranks of `mesh`, shards of any length up to
    MAX_LOCAL_SEQ_HBM (after `hbm_ring_padded_len`), one rotation in all.
    Counterpart of ring_attention.py::_ring_hbm_kernel."""
    n_ranks = mesh.shape[seq_axis]
    nl = _local_len(q, n_ranks)
    nl_pad = hbm_ring_padded_len(nl, block_q, block_k)
    if nl_pad > MAX_LOCAL_SEQ_HBM:
        raise ValueError(
            f"per-device sequence {nl} (padded {nl_pad}) exceeds the "
            f"HBM-staged cap {MAX_LOCAL_SEQ_HBM}; use "
            f"parallel.attention.ring_attention instead"
        )
    if _on_cpu(q, k, v):
        return ring_attention_plain(q, k, v, n_ranks, bounded_logits, pad_to=nl_pad,
                                    qk_int8=qk_int8)
    return _ring_launch(ring_flash_attention_hbm, q, k, v, n_ranks, bounded_logits, qk_int8)[0]


ring_flash_attention_hbm.launches = 0


def ring_flash_attention(q, k, v, mesh, seq_axis: str = "seq",
                         block_q: int = DEFAULT_BLOCK_Q, block_k: int = DEFAULT_BLOCK_K,
                         chunk_q: int = CHUNK_Q, bounded_logits: bool = False,
                         qk_int8: bool = False):
    """Ring flash attention over (B, N, H, D) with N sharded on the
    `seq_axis` ranks of `mesh`. Shards within MAX_LOCAL_SEQ that divide into
    the query chunk and the blocks run here, one ring pass per query chunk
    (counterpart of ring_attention.py::_ring_kernel); longer or ragged
    shards go to `ring_flash_attention_hbm`, as in the JAX package."""
    n_ranks = mesh.shape[seq_axis]
    nl = _local_len(q, n_ranks)
    chunk = min(chunk_q, nl)
    fits = (
        nl <= MAX_LOCAL_SEQ
        and nl % chunk == 0
        and chunk % min(block_q, chunk) == 0
        and nl % min(block_k, nl) == 0
    )
    if not fits:
        return ring_flash_attention_hbm(
            q, k, v, mesh, seq_axis, block_q=block_q, block_k=block_k,
            bounded_logits=bounded_logits, qk_int8=qk_int8,
        )
    if _on_cpu(q, k, v):
        return ring_attention_plain(q, k, v, n_ranks, bounded_logits, chunk_q=chunk,
                                    qk_int8=qk_int8)
    return _ring_launch(ring_flash_attention, q, k, v, n_ranks, bounded_logits, qk_int8,
                        chunk_q=chunk)[0]


ring_flash_attention.launches = 0

KERNELS = (ring_flash_attention, ring_flash_attention_hbm)


def reset_launches() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launches() -> dict:
    """{wrapper name: calls that launched the kernel since the last reset}."""
    return {fn.__name__: fn.launches for fn in KERNELS}
